"""Wall ms a train step spends in the gradient exchange on the mesh (the
phase grad_sync between the program's marks, `benchmark/phases.py`): the
gradients' concatenation, the all-reduce with its wait for the other
ranks, the division and the copy back, as far as nothing else hides it."""

from benchmark.phases import split


def read(run):
    trace = run.get("trace")
    phases = None if trace is None else split(trace)
    return None if phases is None else phases.wall_ms.get("grad_sync")

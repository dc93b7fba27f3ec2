"""Host ms a train call spends in the program's own work: the mean length
of the program's "train_step/call" ranges in the traced window (the
step's inputs made, staged into the graph's buffers, the replay launched,
the outputs cloned), less the time covered by what is nested in each and
is not the program's work: the CUDA runtime and driver calls, where the
host stands blocked while the device's launch queue is full or waits for
the device, and the profiler's own records (CUPTI's overhead: its
buffers flushed and requested, "Command Buffer Full"), absent from an
untraced run."""

import re

from benchmark.trace import union_us

SPAN = "train_step/call"
NOT_OWN = re.compile(r"^cu(da)?[A-Z]|^(Command Buffer Full|Buffer Flush|Activity Buffer Request)$")


def read(run):
    trace = run.get("trace")
    if trace is None:
        return None
    calls = [h for h in trace.host if h[0] == SPAN]
    other = [h for h in trace.host if NOT_OWN.match(h[0])]
    own = [(e - s) - union_us([(n, max(s, lo), min(e, hi)) for n, lo, hi in other
                               if lo < e and hi > s])
           for _, s, e in calls]
    return sum(own) / len(own) / 1e3 if own else None

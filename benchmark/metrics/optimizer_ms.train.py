"""Device ms a train step busy in the optimizer's update (the phase
optimizer between the program's marks, `benchmark/phases.py`)."""

from benchmark.phases import busy_ms


def read(run):
    return busy_ms(run, "optimizer")

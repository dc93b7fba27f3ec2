"""Device ms a train step busy in the geometry, SSIM and loss stack, its
forward and its backward (the phases loss_fwd and loss_bwd between the
program's marks, `benchmark/phases.py`), whatever the kernels' names."""

from benchmark.phases import busy_ms


def read(run):
    return busy_ms(run, "loss_fwd", "loss_bwd")

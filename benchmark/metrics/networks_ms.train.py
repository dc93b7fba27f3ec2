"""Device ms a train step busy in the depth and pose networks, forward and
backward (the phases networks_fwd and networks_bwd between the program's
marks, `benchmark/phases.py`): convolutions, batch norm, activations,
adds, upsamples, concatenations and casts. NCCL's kernels are left out:
on a mesh synced batch norm's sums spin while they wait for the other
ranks, so their time follows the ranks' skew, not the networks' work."""

from benchmark.phases import busy_ms


def read(run):
    return busy_ms(run, "networks_fwd", "networks_bwd", nccl=False)

"""Device ms a train step in NCCL's kernels on rank 0 (the gradient
all-reduce and synced batch norm's sums, each kernel's time including its
wait for the other ranks)."""


def read(run):
    trace = run.get("trace")
    return None if trace is None else trace.class_ms_per_call("nccl")

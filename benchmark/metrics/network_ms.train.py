"""Device ms a train step in the network's kernels (convolutions, GEMMs,
batch norm and their layout transforms: `kernel_classes.json`)."""


def read(run):
    trace = run.get("trace")
    return None if trace is None else trace.class_ms_per_call("network")

"""Device ms a train step in the kernels no other class claims: the
geometry, SSIM and loss stack and its backward, and the network's
activations, pools and resizes."""


def read(run):
    trace = run.get("trace")
    return None if trace is None else trace.class_ms_per_call("elementwise")

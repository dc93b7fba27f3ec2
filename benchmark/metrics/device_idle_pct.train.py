"""The device's idle share of the traced train window: 1 - the union of
the device operations' intervals over the window's seconds, in %."""


def read(run):
    trace = run.get("trace")
    if trace is None or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)

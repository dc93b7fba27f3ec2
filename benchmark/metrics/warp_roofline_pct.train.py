"""The warp kernels' share of their roofline in a train step: the least
time for the bytes the step's K1 and K1-bwd launches must move
(`counts.warp_train_bytes`) at the card's memory rate, over those
kernels' device time, in %."""


def read(run):
    trace, rate = run.get("trace"), run["peaks"].get("hbm_bytes_per_s")
    if trace is None or not rate:
        return None
    k1 = trace.class_ms_per_call("k1")
    k1_bwd = trace.class_ms_per_call("k1_bwd")
    if k1 is None or k1_bwd is None:
        return None
    return 100.0 * (run["warp_bytes_per_call"] / rate) / ((k1 + k1_bwd) / 1e3)

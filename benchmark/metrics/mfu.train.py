"""The whole train step's share of the cards' bf16 peak: the networks'
counted forward and backward operations of every step of the measured
window, over the window's seconds, over the peak times the cards, in %."""


def read(run):
    peak = run["peaks"].get("bf16_flops_per_s")
    if not peak or not run["attempted"]:
        return None
    done = run["flops_per_call"] * run["attempted"] * run["chips"]
    return 100.0 * done / run["window_s"] / (peak * run["chips"])

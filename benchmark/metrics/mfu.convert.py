"""The whole conversion's share of the card's peak: the model's operations
in the window (counted over the plain reference, `roofline.py`) over the
window's length times the dense peak of the dtype it runs in."""

from benchmark import roofline


def read(trace):
    return roofline.mfu_percent(trace.work.get("model_flops"), trace.window_s,
                                trace.work.get("dtype", "float32"))

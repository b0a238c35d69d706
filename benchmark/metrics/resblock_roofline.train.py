"""Roofline share of the fp32 resblock kernel (`resblock_tc`) in the training step's forward:
the least time its launches could take on the card (`roofline.py`, each
launch bound by its operations or its bytes) over the time they took in
the trace.  Nothing when the trace's launches and the window's count
differ, or the kernel is off the path."""

from benchmark import roofline


def read(trace):
    shapes = trace.work.get("resblock_shapes")
    ms = trace.kernel_ms("resblock_tc_step_kernel")
    got = roofline.roofline_share(shapes or [], ms, trace.work.get("resblock_dtype", "float32"))
    if got is None:
        return None
    share, by = got
    trace.work.setdefault("notes", []).append(
        "resblock_roofline.train: bound by " + ", ".join(f"{k} in {v} launches" for k, v in by.items()))
    return share

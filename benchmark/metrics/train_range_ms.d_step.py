"""Device milliseconds per training step of the kernels launched while
the port's `train.d_step` range was open (the backward's own thread included), in the traced run's second
window (`harness.Trace`)."""


def read(trace):
    ms, steps = trace.range_ms.get("train.d_step"), trace.range_work.get("steps")
    if not ms or not steps:
        return None
    return ms / steps

"""Share of the traced window in which the device ran no operation
(whole-song conversion): 100 x (1 - the union of the device's operation intervals /
the window)."""


def read(trace):
    if trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)

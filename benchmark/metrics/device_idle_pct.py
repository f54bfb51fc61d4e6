"""Share of the traced window in which no activity ran on the device:
100 (1 - union of device activity / window)."""


def read(rec):
    if rec.trace is None:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)

"""1 - the union of the profiler's device intervals (kernels, copies, sets)
inside the traced window over the window, in percent."""


def read(rec):
    if rec.trace is None or rec.trace.window_s <= 0 or rec.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)

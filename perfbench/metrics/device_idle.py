"""device_idle: the share of the traced window in which no device operation
ran, from the union of their intervals, in %."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)

"""denoise_device_ms: device time, as the union of intervals, of the
kernels a traced request launched outside its encode call, a request's
mean, in ms."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0 or not any(t.encode_ms):
        return None
    return sum(t.outside_encode_ms) / t.units

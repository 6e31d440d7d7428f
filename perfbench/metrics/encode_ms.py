"""encode_ms: host time of the model's ``encode_conditioning`` calls in a
traced request, a request's mean, in ms (a profiler range around the
model instance's method)."""


def read(run):
    t = run.trace
    if t is None or not any(t.encode_ms):
        return None
    return sum(t.encode_ms) / t.units

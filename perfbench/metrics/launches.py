"""launches: kernels (the port's and PyTorch's) launched in a traced
request or step, a unit's mean, counted from the trace."""


def read(run):
    t = run.trace
    return None if t is None or t.busy_s <= 0 or not t.units else sum(t.launches) / t.units

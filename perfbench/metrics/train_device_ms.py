"""train_device_ms: device time, as the union of intervals, of the kernels
a traced train step launched, a step's mean, in ms."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0 or run.cell.traffic["task"] != "train":
        return None
    return sum(t.device_ms) / t.units

"""train_mfu: model FLOPs of the train steps of the window after the trace
stopped (the forward's products times three), over that time and the
configuration's peak, in %."""

from perfbench.metrics.mfu import read  # noqa: F401

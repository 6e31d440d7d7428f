"""sample_mfu: model FLOPs of the scenes sampled in the window after the
trace stopped (the encode and T denoiser steps a scene), over that time and
the configuration's peak, in %."""

from perfbench.metrics.mfu import read  # noqa: F401

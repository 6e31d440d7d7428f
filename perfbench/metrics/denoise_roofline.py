"""denoise_roofline: the least time the denoise loop's work could take on
the device, over its measured device time (``denoise_device_ms``), in %.

The work is counted from the configuration's widths
(``reference/sdm_counts.py``): the products of T denoiser steps and of their
timestep embeddings at the peak of the configuration's dtype, and the
loop's inputs and outputs each moved once at the HBM rate; the least time
is the larger of the two."""

from perfbench.metrics import denoise_device_ms
from perfbench.peaks import HBM_BYTES_PER_S


def read(run):
    ms = denoise_device_ms.read(run)
    if not ms:
        return None
    least = max(run.loop_flops / run.cell.family.peak_flops(run.cell.cfg),
                run.loop_bytes / HBM_BYTES_PER_S)
    return 100.0 * least * 1e3 / ms

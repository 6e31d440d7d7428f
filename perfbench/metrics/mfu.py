"""The whole model's share of the device's peak over a window: model FLOPs
of the scenes completed, over the seconds and the configuration's peak
FLOP/s, in %.  In a ``--trace 1`` run only the window after the trace
stopped counts, so the profiler's cost does not."""


def read(run):
    part = run.untraced()
    if not part or not run.flops_per_scene:
        return None
    scenes, seconds = part
    return 100.0 * scenes * run.flops_per_scene / seconds / run.cell.family.peak_flops(run.cell.cfg)

"""sample_scenes_per_s: scenes of every request of the window over the
window, from the first request's start to the end of the last (which ran
past ``--seconds``)."""

from perfbench.stats import rate


def read(run):
    if run.cell.traffic["task"] != "sample":
        return None
    return rate([n for _, _, n in run.units], *run.window)

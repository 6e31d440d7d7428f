"""train_scenes_per_s: scenes of every step of the window over the time from
the window's start to the synchronise that ends its last step."""

from perfbench.stats import rate


def read(run):
    if run.cell.traffic["task"] != "train":
        return None
    return rate([n for _, _, n in run.units], *run.window)

"""Training: one train step after another, dispatched as the port's trainer
dispatches them, with no read back to the host between steps.

Set-up builds the port's train state (model and AdamW) once and drives it
through its first steps with the window's own call and feed, each step on a
fresh seeded batch with seeded timesteps, noise and dropout: the losses of
the first three, the first gradients (from AdamW's first moments after one
step) and the parameters after three are kept.  The window then continues
the same state.  Afterwards the plain reference follows the same three
steps from the same weights, and the readings are compared with its.
"""

from __future__ import annotations

import time

import torch

from perfbench import traffic as traffic_lib
from perfbench.harness import Run, unit_range

CHECKED = 3  # steps the reference follows


def _norms(tensors):
    return torch.stack([t.double().norm() for t in tensors]).cpu()


def compare(losses, grads, changes, r_losses, r_grads, r_changes) -> dict:
    """The numbers compared: the relative gap of the first step's loss; of
    the worst leaf, the gap between the program's and the reference's
    first gradient norm, and between their norms of the parameters' change
    over the checked steps, each over the larger of the reference's norm
    of that leaf and of the median leaf.  The later steps' losses are not
    compared: AdamW's sign-like first update turns round-off in small
    gradients into moves of +-lr, which they see, while the first step's
    loss is steady from seed to seed.  The change leaves out leaves whose
    reference gradient is under a thousandth of the median leaf's: their
    moves are round-off.  Arguments are lists of floats or of per-leaf
    norms."""
    loss = torch.tensor([abs(losses[0] - r_losses[0]) / abs(r_losses[0])])
    gmed = float(r_grads.median())
    grad = (grads - r_grads).abs() / r_grads.clamp_min(gmed)
    moved = r_grads >= 1e-3 * gmed
    cmed = float(r_changes[moved].median())
    change = ((changes - r_changes).abs() / r_changes.clamp_min(cmed))[moved]
    return {k: float(v.nan_to_num(nan=float("inf")).max())
            for k, v in (("loss", loss), ("grad", grad), ("update", change))}


def run(cell) -> Run:
    cfg, tr, fam, dev = cell.cfg, cell.traffic, cell.family, cell.device
    sd = fam.make_weights(cfg, cell.seed, dev)
    state, step = fam.port_trainer(cfg, sd, tr, dev)
    cell.mark("model")
    names = fam.trained_names(cfg)
    params = dict(state.model.named_parameters())
    if sorted(params) != sorted(names):
        raise RuntimeError("the port's parameters are not the model's: "
                           f"{sorted(set(params) ^ set(names))[:5]}")

    def one(i):
        batch, t, noise, keep = traffic_lib.train_step(cfg, tr, cell.seed, i, dev)
        return step(state, *batch, t=t, noise=noise, dropout_mask=keep)

    losses = []
    for i in range(max(CHECKED, tr["warmup"])):
        metrics = one(i)
        if i < CHECKED:
            losses.append(metrics["loss"].detach())
        if i == 0:
            beta1 = state.optimizer.param_groups[0]["betas"][0]
            moments = [state.optimizer.state[params[n]].get("exp_avg") for n in names]
            grads = _norms([torch.zeros_like(params[n]) if m is None else m / (1 - beta1)
                            for n, m in zip(names, moments)])
        if i == CHECKED - 1:
            changes = _norms([params[n].detach() - sd[n] for n in names])
    losses = [float(x) for x in losses]
    cell.mark("checked steps")
    run = Run(cell, setup_s=time.perf_counter() - cell.t_start)
    first = max(CHECKED, tr["warmup"])
    deadline = time.perf_counter() + cell.seconds
    while not run.units or time.perf_counter() < deadline:
        n = len(run.units)
        cell.trace_step(n)
        start = time.perf_counter()
        with unit_range(cell.tracing):
            one(first + n)
        run.units.append((start, time.perf_counter(), tr["batch"]))
    cell.sync()
    run.close_window(time.perf_counter())
    cell.trace_step(len(run.units), last=True)
    del state, step, params
    cell.free()

    def reference(control: bool = False):
        steps = [traffic_lib.train_step(cfg, tr, cell.seed, i, dev) for i in range(CHECKED)]
        r_losses, r_first, r_params = fam.reference_train(cfg, sd, steps, control)
        return (r_losses, _norms([r_first[k] for k in names]),
                _norms([r_params[k] - sd[k] for k in names]))

    t_ref = time.perf_counter()
    refs = reference()
    run.reference_s = time.perf_counter() - t_ref
    run.check(compare(losses, grads, changes, *refs))
    run.leaves = (names, grads, changes, refs[1], refs[2])
    run.losses = {"program": losses, "reference": refs[0]}

    def control():
        ctl = reference(control=True)
        run.losses["control"] = ctl[0]
        return compare(*ctl, *refs)

    run.control = control
    run.flops_per_scene = fam.train_flops(cfg, tr["batch"]) / tr["batch"]
    return run

"""Closed-loop sampling: one client sends a request, waits for its sample on
the host, and sends the next, as ``run/test_sdm.py`` samples a test set.

A request is ``batch`` fresh scenes (``traffic.scenes``) sampled through the
port's ``sample_sdm`` with a generator seeded for the request, from which
the sampler draws its first image and its T noise tables; it ends when the
sample has been copied to the host.  The window opens with the first
request after set-up and closes when the request running at ``--seconds``
has ended.  Afterwards a seeded choice of the window's requests is sampled
again by the plain reference from the same scenes and draws, and the
program's sample and last denoiser output are compared with it.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import traffic as traffic_lib
from perfbench.harness import Run, unit_range
from perfbench.seeds import sub_seed


def _gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The relative gap ||got - want|| / ||want|| over a request's entries,
    in float64; infinite where ``got`` is not finite."""
    got, want = got.double().cpu(), want.double().cpu()
    if not torch.isfinite(got).all():
        return float("inf")
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def compare(outputs, refs) -> dict:
    """The numbers compared, each the largest over the checked requests:
    the relative gaps of the sample and of the last step's x0 and guiding
    points."""
    out = {"sample": 0.0, "x0": 0.0, "guiding": 0.0}
    for got, want in zip(outputs, refs):
        for k, g, w in zip(("sample", "x0", "guiding"), got, want):
            out[k] = max(out[k], _gap(g, w))
    return out


def check_indices(seed: int, done: int, k: int):
    """``k`` of the window's ``done`` requests, drawn from the seed, the last
    one always among them."""
    rng = np.random.default_rng(sub_seed(seed, "check"))
    picks = rng.choice(done - 1, size=min(k, done) - 1, replace=False) if done > 1 else []
    return sorted(int(i) for i in picks) + [done - 1]


def run(cell) -> Run:
    cfg, tr, fam, dev = cell.cfg, cell.traffic, cell.family, cell.device
    sd = fam.make_weights(cfg, cell.seed, dev)
    model, schedule, fused_step = fam.port_sampler(cfg, sd, tr, dev)
    if cell.encode_hook is not None:
        fam.wrap_encode(model, cell.encode_hook)

    def request(i):
        inputs = traffic_lib.scenes(cfg, tr, cell.seed, i, dev)
        gen = traffic_lib.draws(dev, cell.seed, i)
        start = time.perf_counter()
        with unit_range(cell.tracing):
            sample, last = fam.port_sample(model, schedule, fused_step, inputs, gen)
            host = sample.cpu()
        end = time.perf_counter()
        return start, end, (host, last.x0, last.guiding)

    cell.mark("model")
    with torch.no_grad():
        for k in range(tr["warmup"]):
            request(-1 - k)
        cell.mark("warm-up")
        run = Run(cell, setup_s=time.perf_counter() - cell.t_start)
        outputs = []
        deadline = None
        while deadline is None or time.perf_counter() < deadline:
            i = len(outputs)
            cell.trace_step(i)
            start, end, out = request(i)
            deadline = deadline or start + cell.seconds
            run.units.append((start, end, tr["batch"]))
            outputs.append(out)
        cell.trace_step(len(outputs), last=True)
    run.close_window()
    picks = check_indices(cell.seed, len(outputs), tr["check_units"])
    kept = [tuple(t.detach().cpu() for t in outputs[i]) for i in picks]
    run.failed = sum(not torch.isfinite(o[0]).all() for o in outputs)
    del model, schedule, outputs
    cell.free()

    def reference(control: bool = False):
        outs = []
        for i in picks:
            inputs = traffic_lib.scenes(cfg, tr, cell.seed, i, dev)
            gen = traffic_lib.draws(dev, cell.seed, i)
            sample, x0, _, guiding = fam.reference_sample(cfg, sd, inputs, gen, control)
            outs.append((sample.cpu(), x0.cpu(), guiding.cpu()))
        return outs

    t_ref = time.perf_counter()
    refs = reference()
    run.reference_s = time.perf_counter() - t_ref
    run.check(compare(kept, refs))
    run.control = lambda: compare(reference(control=True), refs)
    run.flops_per_scene = fam.sample_flops(cfg, tr["batch"]) / tr["batch"]
    run.loop_flops = fam.loop_flops(cfg, tr["batch"])
    run.loop_bytes = fam.loop_bytes(cfg, tr["batch"])
    return run

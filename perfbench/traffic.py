"""The general generator of the benchmark's traffic.

A traffic mix is a JSON file ``perfbench/traffic/<name>.json`` of
parameters, found by its name in ``BENCHMARK.json``; this module is the
one reader of them.  Keys:

* ``task``: the loop that drives the port, ``perfbench/tasks/<task>.py``
  (``sample``: closed-loop sampling requests; ``train``: train steps);
* ``batch``: scenes a request or a step;
* ``given_objects``: [least, most] objects given a scene besides the
  human, drawn uniformly;
* ``warmup``: requests or steps of set-up before the window (at least 1);
* ``trace_units``: requests or steps the ``--trace 1`` run traces, from
  the window's start;
* ``check_units``: requests checked against the reference after the window;
* ``fused_step``: the sampler's loop, as ``test_sdm --fused_step`` takes
  it ("auto" where absent: the whole-loop kernel on CUDA).

Scenes are synthetic, from the seed, as the port's profilers made them: a
standard-normal cloud of ``pcd_points`` points in each of ``max_objs``
slots (slot 0 the human), one-hot categories, a ``clip_dim`` text
embedding.  A request's scenes and a step's batch and draws depend only on
(seed, index), and every slot is computed whatever the mask, so every seed
asks the same work.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from perfbench.seeds import sub_seed

DIR = Path(__file__).resolve().parent / "traffic"


def load(name: str, directory: Path = DIR) -> dict:
    return json.loads((directory / f"{name}.json").read_text())


def _generator(device, seed: int, purpose: str, index: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, purpose, index))


def scenes(cfg: dict, traffic: dict, seed: int, index: int, device) -> dict:
    """Request ``index``'s scenes: mask (B, O), objs (B, O, N, 3), cats
    (B, O, C) one-hot, text (B, clip_dim)."""
    m = cfg["model"]
    B, O, N, C = traffic["batch"], m["max_objs"], m["pcd_points"], m["max_cats"]
    g = _generator(device, seed, "scenes", index)
    lo, hi = traffic["given_objects"]
    given = torch.randint(lo, hi + 1, (B, 1), generator=g, device=device)
    slot = torch.arange(O, device=device)[None, :]
    mask = ((slot >= 1) & (slot <= given)).float()
    objs = torch.randn(B, O, N, 3, generator=g, device=device)
    cats = torch.nn.functional.one_hot(
        torch.randint(0, C, (B, O), generator=g, device=device), C).float()
    text = torch.randn(B, m["clip_dim"], generator=g, device=device)
    return {"mask": mask, "objs": objs, "cats": cats, "text": text}


def draws(device, seed: int, index: int) -> torch.Generator:
    """The generator a request's sampler draws its first image and noise
    from."""
    return _generator(device, seed, "draws", index)


def train_step(cfg: dict, traffic: dict, seed: int, index: int, device):
    """Step ``index``'s ((mask, objs, cats, target, target_cat, text), t,
    noise, dropout keep-mask), as the train step takes them."""
    m = cfg["model"]
    B, O, N, C = traffic["batch"], m["max_objs"], m["pcd_points"], m["max_cats"]
    s = scenes(cfg, traffic, seed, index, device)
    g = _generator(device, seed, "train", index)
    target = 0.3 * torch.randn(B, N, 3, generator=g, device=device)
    target_cat = torch.nn.functional.one_hot(
        torch.randint(0, C, (B,), generator=g, device=device), C).float()
    t = torch.randint(0, cfg["diffusion"]["steps"], (B,), generator=g, device=device)
    noise = torch.randn(B, N, 3, generator=g, device=device)
    keep = torch.rand(B * O, N, 128, generator=g, device=device) < 0.5
    batch = (s["mask"], s["objs"], s["cats"], target, target_cat, s["text"])
    return batch, t, noise, keep

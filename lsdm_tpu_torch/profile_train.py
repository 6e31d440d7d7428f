"""Where the time of one SDM train step goes, on a CUDA device.

    python -m lsdm_tpu_torch.profile_train [--batch 6] [--steps 5]
        [--configs default attn_xla sg chamfer_pallas]

Builds ``sdm_proxd()`` with seeded random weights and trains it on a
seeded random batch (``--batch`` scenes of ``max_objs`` clouds of 1024
points, fp32, T=1000 cosine) with the train step of
``train/trainer.py``, in four configurations:

* ``default``: what ``train_sdm`` runs on CUDA, ``ball_impl`` and
  ``attn_impl`` "pallas" (K1, K2, K3 selection; K4/K5 attention);
* ``attn_xla``: the same with the composed attention (``--attn_impl xla``);
* ``sg``: ``--ball_impl sg`` (K10 in the SA stages);
* ``chamfer_pallas``: the default with the K11 chamfer loss.

For each it prints the wall time per step (host clock around a
synchronised step, all of ``--steps`` steps after two warm-up steps),
steps/s and scenes/s of the best step, and the peak device memory.  It
then traces two more default steps with ``torch.profiler`` and prints the
device time of each kernel and the busy share: summed kernel time over the
traced wall.  The last line is one JSON object with all of it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from lsdm_tpu_torch.config import SDMConfig, sdm_proxd
from lsdm_tpu_torch.diffusion.schedule import make_schedule
from lsdm_tpu_torch.models.sdm import SceneDiffusionModel
from lsdm_tpu_torch.profile_sampling import _kernel_times
from lsdm_tpu_torch.train.state import create_train_state
from lsdm_tpu_torch.train.trainer import make_train_step
from lsdm_tpu_torch.weights import init_weights

# name: (ball_impl, attn_impl, chamfer_impl)
CONFIGS = {"default": ("pallas", "pallas", "xla"),
           "attn_xla": ("pallas", "xla", "xla"),
           "sg": ("sg", "pallas", "xla"),
           "chamfer_pallas": ("pallas", "pallas", "pallas")}


def seeded_batch(cfg: SDMConfig, batch: int, seed: int, device: torch.device):
    """(mask, objs, cats, target, target_cat, text) as the train step takes
    them: ``cfg.max_objs`` object slots per scene, slots 1-4 given."""
    O, N = cfg.max_objs, cfg.pcd_points
    g = torch.Generator(device=device).manual_seed(seed)
    mask = torch.zeros(batch, O, device=device)
    mask[:, 1:5] = 1.0
    objs = torch.randn(batch, O, N, 3, generator=g, device=device)
    cats = torch.nn.functional.one_hot(
        torch.randint(0, cfg.max_cats, (batch, O), generator=g, device=device),
        cfg.max_cats).float()
    target = 0.3 * torch.randn(batch, N, 3, generator=g, device=device)
    target_cat = torch.nn.functional.one_hot(
        torch.randint(0, cfg.max_cats, (batch,), generator=g, device=device),
        cfg.max_cats).float()
    text = torch.randn(batch, cfg.clip_dim, generator=g, device=device)
    return mask, objs, cats, target, target_cat, text


def build(cfg: SDMConfig, ball_impl: str, attn_impl: str, seed: int,
          device: torch.device):
    """A seeded model of ``cfg`` on ``device`` with its AdamW state."""
    model = SceneDiffusionModel(dataclasses.replace(
        cfg, ball_impl=ball_impl, attn_impl=attn_impl))
    return create_train_state(init_weights(model, seed).to(device))


def profile(batch: int, steps: int, seed: int, configs) -> dict:
    dev = torch.device("cuda", 0)
    cfg = sdm_proxd()
    schedule = make_schedule("cosine", 1000, device=dev)
    inputs = seeded_batch(cfg, batch, seed, dev)
    result = {"card": torch.cuda.get_device_name(0), "batch": batch,
              "clouds": batch * cfg.max_objs, "configs": {}}

    def timed(step, state, gen):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        step(state, *inputs, generator=gen)
        torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    for name in configs:
        ball, attn_impl, chamfer = CONFIGS[name]
        state = build(cfg, ball, attn_impl, seed, dev)
        step = make_train_step(schedule, chamfer_impl=chamfer)
        gen = torch.Generator(device=dev).manual_seed(seed)
        for _ in range(2):  # warm-up: kernel build, allocator, cuBLAS
            timed(step, state, gen)
        torch.cuda.reset_peak_memory_stats(dev)
        walls = [timed(step, state, gen) for _ in range(steps)]
        ms = [w * 1e3 for w in walls]
        result["configs"][name] = {
            "ball_impl": ball, "attn_impl": attn_impl, "chamfer_impl": chamfer,
            "step_ms": ms, "best_step_ms": min(ms), "steps_per_s": 1.0 / min(walls),
            "scenes_per_s": batch / min(walls),
            "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
        print(f"{name}: step ms {[round(x, 3) for x in ms]}, "
              f"{1.0 / min(walls):.2f} steps/s, {batch / min(walls):.1f} scenes/s, "
              f"peak {result['configs'][name]['peak_mem_gib']:.2f} GiB")
        del state

    state = build(cfg, *CONFIGS["default"][:2], seed, dev)
    step = make_train_step(schedule)
    gen = torch.Generator(device=dev).manual_seed(seed)
    timed(step, state, gen)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall_ms = sum(timed(step, state, gen) for _ in range(2)) * 1e3
    kernels = sorted(_kernel_times(prof).items(), key=lambda kv: -kv[1][0])
    busy = sum(ms for ms, _ in dict(kernels).values())
    print(f"traced 2 default steps: wall {wall_ms:.3f} ms, summed kernel time "
          f"{busy:.3f} ms, busy share {busy / wall_ms:.3f}")
    for kname, (ms, calls) in kernels[:20]:
        print(f"  {ms:10.3f} ms {100 * ms / max(busy, 1e-9):5.1f}%  "
              f"{calls:6d} calls  {kname[:90]}")
    result["trace"] = {"steps": 2, "wall_ms": wall_ms, "kernel_ms": busy,
                       "busy_share": busy / wall_ms,
                       "kernels": {n: {"ms": ms, "calls": c}
                                   for n, (ms, c) in kernels}}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=6)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--configs", nargs="+", default=list(CONFIGS),
                    choices=list(CONFIGS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps(profile(args.batch, args.steps, args.seed, args.configs)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Where the time of one SDM sample goes, on a CUDA device.

    python -m lsdm_tpu_torch.profile_sampling [--batch 1 4 8] [--steps 1000]
        [--ball_impl fused|pallas]

Builds ``sdm_proxd()`` with seeded random weights and samples seeded
random inputs through the kernel path (``sample_sdm`` with
``fused_step="chain"``): the fused encode (K7, K8, K4, K3; the default,
what ``resolve_fast_path`` gives on CUDA) or, with ``--ball_impl pallas``,
the composed encode over the selection kernels (K1, K2, K3).  For each
batch size it prints the wall time per scene (host clock around a
synchronised call, best and all of ``--repeats`` runs after one warm-up),
the DDPM steps per second, the peak device memory and the wall time of
the conditioning encode alone.  For the first batch size it then traces
one more sample with ``torch.profiler`` and prints the device time of
each kernel and the busy share: summed kernel time over the traced wall.
The last line is one JSON object with all of it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from collections import defaultdict

import torch

from lsdm_tpu_torch.config import SDMConfig, sdm_proxd
from lsdm_tpu_torch.diffusion.schedule import make_schedule
from lsdm_tpu_torch.models.sampling import resolve_fast_path, sample_sdm
from lsdm_tpu_torch.models.sdm import SceneDiffusionModel
from lsdm_tpu_torch.weights import init_weights


def seeded_inputs(cfg: SDMConfig, batch: int, steps: int, seed: int,
                  device: torch.device):
    """(mask, objs, cats, text, x_init, noise) as ``bench.py`` makes its
    inputs: ``cfg.max_objs`` object slots per scene, slots 1-4 given."""
    O, N = cfg.max_objs, cfg.pcd_points
    g = torch.Generator(device=device).manual_seed(seed)
    mask = torch.zeros(batch, O, device=device)
    mask[:, 1:5] = 1.0
    objs = torch.randn(batch, O, N, 3, generator=g, device=device)
    cats = torch.nn.functional.one_hot(
        torch.randint(0, cfg.max_cats, (batch, O), generator=g, device=device),
        cfg.max_cats).float()
    text = torch.randn(batch, cfg.clip_dim, generator=g, device=device)
    x_init = torch.randn(batch, N, 3, generator=g, device=device)
    noise = torch.randn(steps, batch, N, 3, generator=g, device=device)
    return mask, objs, cats, text, x_init, noise


def _kernel_times(prof) -> dict:
    """{kernel name: (device ms, calls)} of a finished profiler.  User
    annotations on the device timeline (``Optimizer.step#AdamW.step``)
    span kernels counted on their own and are left out."""
    out = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            out[e.name][0] += e.device_time_total / 1e3
            out[e.name][1] += 1
    return dict(out)


def profile(batches, steps: int, repeats: int, seed: int,
            ball_impl: str = "fused") -> dict:
    dev = torch.device("cuda", 0)
    ball_impl, step = resolve_fast_path(ball_impl, None, dev)
    cfg = dataclasses.replace(sdm_proxd(), ball_impl=ball_impl)
    model = init_weights(SceneDiffusionModel(cfg), seed).to(dev).eval()
    schedule = make_schedule("cosine", steps, device=dev)
    result = {"card": torch.cuda.get_device_name(0), "steps": steps,
              "ball_impl": ball_impl, "fused_step": step, "batches": {}}

    def run(inputs):
        mask, objs, cats, text, x_init, noise = inputs
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        sample_sdm(model, schedule, mask, objs, cats, text, fused_step=step,
                   x_init=x_init, noise=noise)
        torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    def encode_ms(inputs):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        model.encode_conditioning(*inputs[:4])
        torch.cuda.synchronize(dev)
        return (time.perf_counter() - t0) * 1e3

    for b in batches:
        inputs = seeded_inputs(cfg, b, steps, seed, dev)
        run(inputs)  # warm-up: kernel build, allocator
        torch.cuda.reset_peak_memory_stats(dev)
        walls = [run(inputs) for _ in range(repeats)]
        ms = [w * 1e3 / b for w in walls]
        encode = [encode_ms(inputs) for _ in range(repeats)]
        result["batches"][b] = {
            "ms_per_scene": ms, "best_ms_per_scene": min(ms),
            "steps_per_s": steps * b / min(walls),
            "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            "encode_ms": encode}
        print(f"batch {b}: ms/scene {[round(x, 3) for x in ms]}, "
              f"{steps * b / min(walls):.1f} steps/s, peak "
              f"{result['batches'][b]['peak_mem_gib']:.2f} GiB; encode alone "
              f"{[round(x, 3) for x in encode]} ms")

    b = batches[0]
    inputs = seeded_inputs(cfg, b, steps, seed, dev)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall_ms = run(inputs) * 1e3
    kernels = sorted(_kernel_times(prof).items(), key=lambda kv: -kv[1][0])
    busy = sum(ms for ms, _ in dict(kernels).values())
    print(f"traced batch {b}: wall {wall_ms:.3f} ms, summed kernel time "
          f"{busy:.3f} ms, busy share {busy / wall_ms:.3f}")
    for name, (ms, calls) in kernels[:15]:
        print(f"  {ms:10.3f} ms {100 * ms / max(busy, 1e-9):5.1f}%  "
              f"{calls:6d} calls  {name[:90]}")
    result["trace"] = {"batch": b, "wall_ms": wall_ms, "kernel_ms": busy,
                       "busy_share": busy / wall_ms,
                       "kernels": {n: {"ms": ms, "calls": c}
                                   for n, (ms, c) in kernels}}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 4, 8])
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ball_impl", default="fused", choices=["fused", "pallas"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_sampling: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.no_grad():
        result = profile(args.batch, args.steps, args.repeats, args.seed,
                         args.ball_impl)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

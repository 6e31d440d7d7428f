"""Time K5 (rank-1 attention backward) and K3 (farthest-point sampling) on
the card, queued behind a sleep so that only the device's time counts.

    python -m lsdm_tpu_torch.profile_kernels [--clouds 9 54 72]
                                             [--fps_sweep [--ppt 1 2 4]]
                                             [--csrc DIR]

K5 at the train step's shape (54 clouds, 1024 points, 12 heads), from the
forward's row denominators; K3 at the SA stages sa2..sa4 of seeded clouds
of 1024 points (1024 -> 256 -> 64 -> 16), every cloud from index 0, at
each cloud count (9: a b1 sample; 54: a batch-6 train step; 72: a b8
sample).  K5's line also carries its largest error against the plain
version, on these inputs and with k and v offset by +8 (the same ``out``
on both sides); K3's, at 1024 points, the time of one round and the fixed
cost of a launch, fitted from 16 and 256 rounds.  Prints one JSON line per
case and the card's name and power limit.

``--fps_sweep`` times every launch plan (warps a cloud, points a lane,
the latter from ``--ppt``) of the FPS entry at each stage and cloud
count, against which ``ops/fps.py:fps_plan`` was chosen.  ``--csrc DIR``
builds the kernels from another copy of ``csrc/`` (an edited copy for an
ablation, kept in a git-ignored directory, e.g. one whose FPS entry takes
8 points a lane), so variants are timed by this same script.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import torch

from lsdm_tpu_torch import kernels
from lsdm_tpu_torch.ops import attn, fps
from lsdm_tpu_torch.ops.pointcloud import index_points
from lsdm_tpu_torch.profile_encode import time_queued_ms

REPS = 20
STAGES = ((1024, 256), (256, 64), (64, 16))  # (points, npoint) of sa2..sa4


def queued_ms(fn) -> float:
    """Device ms per call of fn(), queued behind a sleep on the card."""
    return time_queued_ms(fn, REPS)[0]


def fps_call(xyz: torch.Tensor, npoint: int, plan=None):
    """One FPS launch from index 0 (no start tensor), returning its
    indices: the wrapper, or with ``plan`` (warps, points a lane) the C
    entry."""
    if plan is None:
        return lambda: fps.farthest_point_sample_kernel(xyz, npoint)
    B, N, _ = xyz.shape
    lib = kernels.load()
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    stream = kernels.stream(xyz.device)
    return lambda: kernels.check(lib.lsdm_fps(
        xyz.data_ptr(), None, B, N, npoint, *plan, out.data_ptr(), stream),
        "fps") or out


def fps_levels(clouds: int, g: torch.Generator):
    """Seeded clouds of 1024 points and the point sets of sa2..sa4."""
    levels = [torch.randn(clouds, 1024, 3, generator=g, device="cuda")]
    for _, npoint in STAGES:
        idx = fps.farthest_point_sample_plain(levels[-1], npoint)
        levels.append(index_points(levels[-1], idx).contiguous())
    return levels


def k5_call(C: int, N: int = 1024, H: int = 12, seed: int = 0, offset: float = 0.0):
    """(K5's call, its plain version's result) on seeded inputs, k and v
    shifted by ``offset``; both from the kernel's forward ``out``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, gout = (torch.randn(C, N, H, generator=g, device="cuda") for _ in range(4))
    k, v = k + offset, v + offset
    out, den = attn.rank1_mha_kernel(q, k, v, denominator=True)
    fn = lambda: attn.rank1_mha_bwd_kernel(q, k, v, out, gout, den)
    return fn, attn.rank1_mha_bwd_plain(q, k, v, out, gout)


def k5_err(fn, want) -> float:
    return max((a - b).abs().max().item() for a, b in zip(fn(), want))


def plans(n: int, ppts=(1, 2, 4)):
    """Every (warps, points a lane in ``ppts``) that covers n points."""
    for ppt in ppts:
        warps = -(-n // (32 * ppt))
        if warps <= 32:
            yield warps, ppt


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clouds", type=int, nargs="+", default=[9, 54, 72])
    ap.add_argument("--fps_sweep", action="store_true")
    ap.add_argument("--ppt", type=int, nargs="+", default=[1, 2, 4],
                    help="points a lane of the sweep's plans")
    ap.add_argument("--csrc", help="build the kernels from this copy of csrc/")
    args = ap.parse_args()
    if args.csrc:
        kernels.CSRC = Path(args.csrc).resolve()
    if not torch.cuda.is_available():
        raise SystemExit("profile_kernels: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    t0 = time.perf_counter()
    kernels.load()
    print(f"build {time.perf_counter() - t0:.1f} s")

    fn, want = k5_call(54)
    err = k5_err(fn, want)
    ms = queued_ms(fn)
    del want
    fn, want = k5_call(54, offset=8.0)
    print(json.dumps({"kernel": "rank1_attn_bwd", "shape": [54, 1024, 12], "ms": ms,
                      "max_abs_err": err, "offset_max_abs_err": k5_err(fn, want),
                      "card": card}))
    del fn, want
    g = torch.Generator(device="cuda").manual_seed(0)
    for clouds in args.clouds:
        levels = fps_levels(clouds, g)
        stages = [queued_ms(fps_call(levels[i], npoint))
                  for i, (_, npoint) in enumerate(STAGES)]
        short = queued_ms(fps_call(levels[0], 16))
        round_ms = (stages[0] - short) / (STAGES[0][1] - 16)
        print(json.dumps({"kernel": "fps", "clouds": clouds, "stages_ms": stages,
                          "ms": sum(stages), "round_us_1024": round_ms * 1e3,
                          "launch_us_1024": (short - 16 * round_ms) * 1e3,
                          "card": card}))
        if args.fps_sweep:
            for i, (n, npoint) in enumerate(STAGES):
                want = fps.farthest_point_sample_plain(levels[i], npoint)
                for plan in plans(n, args.ppt):
                    fn = fps_call(levels[i], npoint, plan)
                    if not torch.equal(fn(), want):
                        raise AssertionError(f"FPS plan {plan}: indices differ")
                    print(json.dumps({"kernel": "fps", "clouds": clouds, "points": n,
                                      "plan": plan, "ms": queued_ms(fn)}))


if __name__ == "__main__":
    main()

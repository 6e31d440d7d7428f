"""Time K5 and K4 (rank-1 attention backward and forward), K3 (farthest-
point sampling) and K1 (ball query) on the card, queued behind a sleep so
that only the device's time counts.

    python -m lsdm_tpu_torch.profile_kernels [--clouds 9 54 72]
                                             [--fps_sweep [--ppt 1 2 4]]
                                             [--bq_sweep] [--csrc DIR]

K5 at the train step's shape (54 clouds, 1024 points, 12 heads), from the
forward's row denominators; K4 at a b1 sample's (9, 1024, 12) and, with
the row denominators the training forward keeps, at (54, 1024, 12),
beside SDPA's forward on the same inputs; K3 at the SA stages sa2..sa4 of
seeded clouds of 1024 points (1024 -> 256 -> 64 -> 16), every cloud from
index 0, and K1 at sa1..sa4 (radii 0.1, 0.2, 0.4, 0.8, 32 samples) on
those point sets, at each cloud count (9: a b1 sample; 54: a batch-6
train step; 72: a b8 sample).  K5's and K4's lines also carry their
largest errors against the plain versions, on these inputs and with k and
v offset by +8 (K5: the same ``out`` on both sides; K4: and the row
denominators' relative error); K1's, whether its indices equal the plain
version's at every stage; K3's, at 1024 points, the time of one round and
the fixed cost of a launch, fitted from 16 and 256 rounds.  Prints one
JSON line per case and the card's name and power limit.

``--fps_sweep`` times every launch plan (warps a cloud, points a lane,
the latter from ``--ppt``) of the FPS entry at each stage and cloud
count, against which ``ops/fps.py:fps_plan`` was chosen; ``--bq_sweep``
every plan (queries a warp 1, 2 or 4) of the ball query entry, against
which ``ops/ballquery.py:ball_query_plan`` was chosen.  ``--csrc DIR``
builds the kernels from another copy of ``csrc/`` (an edited copy for an
ablation, such as another ``kBallWarps``, kept in a git-ignored
directory), so variants are timed by this same script.  Without the
sweeps it calls the kernels' wrappers only, so a copy of it times a
parent tree whose wrappers take the same arguments.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import torch

from lsdm_tpu_torch import kernels
from lsdm_tpu_torch.ops import attn, ballquery, fps
from lsdm_tpu_torch.ops.pointcloud import index_points
from lsdm_tpu_torch.profile_encode import time_queued_ms

REPS = 20
STAGES = ((1024, 256), (256, 64), (64, 16))  # (points, npoint) of sa2..sa4
RADII = (0.1, 0.2, 0.4, 0.8)  # sa1..sa4 (models/pointnet2.py)
NSAMPLE = 32


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


def k4_case(C: int, N: int = 1024, H: int = 12, seed: int = 0,
            offset: float = 0.0):
    """Seeded (q, k, v) on the card, k and v shifted by ``offset``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(C, N, H, generator=g, device="cuda") for _ in range(3))
    return q, k + offset, v + offset


def k4_errors(q, k, v):
    """(max |out - plain|, max relative error of the row denominators)."""
    got, den = attn.rank1_mha_kernel(q, k, v, denominator=True)
    want, wden = attn.rank1_mha_plain(q, k, v, denominator=True)
    return ((got - want).abs().max().item(),
            ((den - wden).abs() / wden).max().item())


def ball_query_call(r: float, xyz: torch.Tensor, new_xyz: torch.Tensor,
                    plan=None):
    """One K1 launch at radius r, 32 samples (fewer where the cloud is
    smaller): the wrapper, or with ``plan`` (queries a warp) the C
    entry."""
    ns = min(NSAMPLE, xyz.shape[1])
    if plan is None:
        return lambda: ballquery.query_ball_point_kernel(r, ns, xyz, new_xyz)
    B, N, _ = xyz.shape
    S = new_xyz.shape[1]
    lib = kernels.load()
    out = torch.empty((B, S, ns), dtype=torch.int32, device=xyz.device)
    stream = kernels.stream(xyz.device)
    r2 = ballquery._radius2(r)
    return lambda: kernels.check(lib.lsdm_ball_query(
        xyz.data_ptr(), new_xyz.data_ptr(), B, N, S, r2, ns, plan,
        out.data_ptr(), stream), "ball_query") or out


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
    ap.add_argument("--bq_sweep", action="store_true")
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
    for C, denominator in ((9, False), (54, True)):
        q, k, v = k4_case(C)
        err, den_err = k4_errors(q, k, v)
        off_err, off_den_err = k4_errors(*k4_case(C, offset=8.0))
        q4, k4, v4 = (t.transpose(1, 2)[..., None].contiguous() for t in (q, k, v))
        print(json.dumps({
            "kernel": "rank1_attn", "shape": [C, 1024, 12], "denominator": denominator,
            "ms": queued_ms(lambda: attn.rank1_mha_kernel(q, k, v, denominator)),
            "sdpa_ms": queued_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q4, k4, v4, scale=1.0)),
            "max_abs_err": err, "den_max_rel_err": den_err,
            "offset_max_abs_err": off_err, "offset_den_max_rel_err": off_den_err,
            "card": card}))
        del q, k, v, q4, k4, v4
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
        sets = [levels[0], *levels]  # sa1 keeps every point: l1 = l0
        stages, equal = [], True
        for r, xyz, new_xyz in zip(RADII, sets[:4], sets[1:5]):
            fn = ball_query_call(r, xyz, new_xyz)
            want = ballquery.query_ball_point_plain(r, min(NSAMPLE, xyz.shape[1]),
                                                    xyz, new_xyz)
            equal = equal and torch.equal(fn(), want)
            stages.append(queued_ms(fn))
            if args.bq_sweep:
                for plan in (1, 2, 4):
                    fw = ball_query_call(r, xyz, new_xyz, plan)
                    if not torch.equal(fw(), want):
                        raise AssertionError(f"ball query plan {plan}: indices differ")
                    print(json.dumps({"kernel": "ball_query", "clouds": clouds,
                                      "points": xyz.shape[1], "queries": new_xyz.shape[1],
                                      "plan": plan, "ms": queued_ms(fw)}))
        print(json.dumps({"kernel": "ball_query", "clouds": clouds, "stages_ms": stages,
                          "ms": sum(stages), "equal": equal, "card": card}))


if __name__ == "__main__":
    main()

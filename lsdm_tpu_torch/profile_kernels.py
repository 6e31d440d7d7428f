"""Time K5 and K4 (rank-1 attention backward and forward), K3 (farthest-
point sampling), K1 (ball query), K2 (3-NN), K11 (chamfer nearest
neighbour), K10 (the train select-gather) and K9 (one denoise step) on
the card, queued behind a sleep so that only the device's time counts.

    python -m lsdm_tpu_torch.profile_kernels [--clouds 9 54 72]
                                             [--fps_sweep [--ppt 1 2 4]]
                                             [--bq_sweep] [--nn_sweep]
                                             [--sg_sweep] [--step_sweep]
                                             [--chain_sweep]
                                             [--step_stamps]
                                             [--only step sg ...]
                                             [--csrc DIR]

K5 at the train step's shape (54 clouds, 1024 points, 12 heads), from the
forward's row denominators; K4 at a b1 sample's (9, 1024, 12) and, with
the row denominators the training forward keeps, at (54, 1024, 12),
beside SDPA's forward on the same inputs; K3 at the SA stages sa2..sa4 of
seeded clouds of 1024 points (1024 -> 256 -> 64 -> 16), every cloud from
index 0, K1 at sa1..sa4 (radii 0.1, 0.2, 0.4, 0.8, 32 samples) and K2 at
fp4..fp1 (targets 64, 256, 1024, 1024 against sources 16, 64, 256 and, at
fp1, the targets themselves) on those point sets, at each cloud count (9:
a b1 sample; 54: a batch-6 train step; 72: a b8 sample); K11 at an ICP
iteration's (64, 1024) against (64, 1024) and at the chamfer train step's
(6, 1024), both ways.  K5's and K4's lines also carry their largest errors
against the plain versions, on these inputs and with k and v offset by +8
(K5: the same ``out`` on both sides; K4: and the row denominators'
relative error); K1's, K2's and K11's, whether their outputs equal the
plain versions' (K2's and K11's distances bit for bit) at every stage;
K3's, at 1024 points, the time of one round and the fixed cost of a
launch, fitted from 16 and 256 rounds.  K10 at sa1..sa4 of those point
sets (the stages' widths 6, 67, 131, 259 columns, 32 samples) at each
cloud count, with whether its indices and values equal the plain
version's; K9 per launch at b1 and b8 (N = 1024, D = 128, seeded weights
at the flagship widths), clip off, with its error against the plain
version, through the bound step a sampler calls (``make_denoise_step``),
and the same in its bf16 mode (``denoise_step_bf16``, the error against
the plain bf16 version), each with the sha256 of its output's bytes (so
two trees' outputs can be held bit for bit); K6 in its bf16 mode (``denoise_chain_bf16``) at b1
and b8, T = 1000 (N = 1024, D = 128, the cosine schedule's DDPM
coefficients) in an event loop, with its first pass alone over the
chain's chunks, the second pass as the rest, the second pass's product
TFLOP/s and bound at 989 TFLOP/s, the plan (warps a tile, tiles a block)
and the sample's BF16 gate readings against the
plain bf16 version (``chip_smoke._bf16_gate``'s), beside the float32
mode's time.
Prints one JSON line per case and the card's name and power limit.

``--fps_sweep`` times every launch plan (warps a cloud, points a lane,
the latter from ``--ppt``) of the FPS entry at each stage and cloud
count, against which ``ops/fps.py:fps_plan`` was chosen; ``--bq_sweep``
every plan (queries a warp 1, 2 or 4) of the ball query entry, against
which ``ops/ballquery.py:ball_query_plan`` was chosen; ``--nn_sweep``
every plan of the 3-NN and chamfer entries at K2's and K11's shapes
(lanes a target 1-32; K11 also 1, 2 or 4 targets a lane, K2 one),
against which ``ops/ballquery.py:three_nn_plan`` and
``ops/chamfer.py:chamfer_nn_plan``
were chosen; ``--sg_sweep`` every plan (centers a warp 1, 2 or 4) of the
select-gather entry at K10's shapes; ``--step_sweep`` K9's two launches
apart, u2 and the tile kernel at every cluster size the card runs (1 to
8), with the card's occupancy of the tile kernel at each, at b1 to b8,
against which ``ops/denoise.py:step_plan`` was chosen, and K9 bf16's two
launches apart, its tile kernel at 1, 2 and 4 m16 tiles a block, with the
blocks of each the card runs at once, against which
``ops/denoise.py:step_bf16_plan`` was chosen; ``--chain_sweep``
K6 bf16 at every plan of its second pass (``chain_plans``, each forced by
standing in for ``ops/denoise.py:chain_bf16_plan``) at b1 to b8 and b16,
against which that planner was chosen.  ``--step_stamps`` builds the
kernels with ``-DLSDM_STEP_STAMPS`` (a library of its own) and times
nothing else: K9 bf16's tile launch at b1 and b8 (u2 launched once
before), then where one launch's time goes, from the ``%globaltimer``
and ``clock64`` stamps each block's thread 0 records
(``csrc/denoise_step_bf16.cu``): the blocks' start spread and span, and
the median over the blocks of the prologue, each layer, and each layer's
waits for its copies and at the barrier.  ``--only`` times those
kernels alone (names: attn, fps, bq, nn, chamfer, sg, step, chain).
``--csrc DIR`` builds the kernels from another copy of
``csrc/`` (an edited copy for an ablation, such as another
``kBallWarps``, kept in a git-ignored directory), so variants are timed
by this same script.  Without the sweeps it calls the
kernels' wrappers only, so a copy of it times a parent tree whose
wrappers take the same arguments.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from lsdm_tpu_torch import kernels
from lsdm_tpu_torch.ops import attn, ballquery, chamfer, denoise, fps, sg_fused
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


NN_LANES = (1, 2, 4, 8, 16, 32)
NN_PLANS = [(lanes, group) for lanes in NN_LANES for group in (1, 2, 4)]


def three_nn_call(xyz1: torch.Tensor, xyz2: torch.Tensor, plan=None):
    """One K2 launch (k = 3): the wrapper, or with ``plan`` (lanes a
    target) the C entry."""
    if plan is None:
        return lambda: ballquery.three_nn_kernel(xyz1, xyz2, 3)
    B, N, _ = xyz1.shape
    S = xyz2.shape[1]
    lib = kernels.load()
    dist = torch.empty((B, N, 3), dtype=torch.float32, device=xyz1.device)
    idx = torch.empty((B, N, 3), dtype=torch.int32, device=xyz1.device)
    stream = kernels.stream(xyz1.device)
    return lambda: kernels.check(lib.lsdm_three_nn(
        xyz1.data_ptr(), xyz2.data_ptr(), B, N, S, 3, plan, dist.data_ptr(),
        idx.data_ptr(), stream), "three_nn") or (dist, idx)


def chamfer_nn_call(x: torch.Tensor, y: torch.Tensor, plan=None):
    """One K11 launch: the wrapper, or with ``plan`` the C entry."""
    if plan is None:
        return lambda: chamfer.directed_nn_kernel(x, y)
    B, N, _ = x.shape
    lib = kernels.load()
    mins = torch.empty((B, N), dtype=torch.float32, device=x.device)
    args = torch.empty((B, N), dtype=torch.int32, device=x.device)
    stream = kernels.stream(x.device)
    return lambda: kernels.check(lib.lsdm_chamfer_nn(
        x.data_ptr(), y.data_ptr(), B, N, y.shape[1], *plan, mins.data_ptr(),
        args.data_ptr(), stream), "chamfer_nn") or (mins, args)


def same_bits(got, want) -> bool:
    """Outputs (floats, indices) equal, the floats bit for bit."""
    return all(torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                           b.view(torch.int32) if b.is_floating_point() else b)
               for a, b in zip(got, want))


def chamfer_cases(g: torch.Generator):
    """(name, x, y) of K11's calls: an ICP iteration's 64 moved copies of
    a 1024-point source against the target repeated, and the chamfer train
    step's (6, 1024) x0 and target, each way."""
    source = torch.rand(64, 1024, 3, generator=g, device="cuda")
    target = (source[0] + 0.01 * torch.randn(1024, 3, generator=g, device="cuda"))
    icp = (source, target.expand(64, -1, -1).contiguous())
    x = torch.randn(6, 1024, 3, generator=g, device="cuda")
    y = 0.3 * torch.randn(6, 1024, 3, generator=g, device="cuda")
    return [("icp", *icp), ("train x0 -> target", x, y), ("train target -> x0", y, x)]


SG_WIDTHS = (6, 67, 131, 259)  # base columns of sa1..sa4 at the flagship


def sg_call(r: float, xyz, new_xyz, base, plan=None):
    """One K10 launch at radius r, 32 samples: the wrapper, or with
    ``plan`` (centers a warp) the C entry."""
    ns = min(NSAMPLE, xyz.shape[1])
    if plan is None:
        return lambda: sg_fused.select_gather_kernel(r, ns, xyz, new_xyz, base)
    B, N, C = base.shape
    S = new_xyz.shape[1]
    lib = kernels.load()
    out = torch.empty((B, S, ns, C), dtype=torch.float32, device=xyz.device)
    idx = torch.empty((B, S, ns), dtype=torch.int32, device=xyz.device)
    stream = kernels.stream(xyz.device)
    r2 = ballquery._radius2(r)
    return lambda: kernels.check(lib.lsdm_select_gather(
        xyz.data_ptr(), new_xyz.data_ptr(), base.data_ptr(), B, N, S, C, r2, ns,
        plan, out.data_ptr(), idx.data_ptr(), stream), "select_gather") or (out, idx)


def step_case(B: int, N: int = 1024, D: int = 128, seed: int = 0):
    """Seeded K9 arguments at the flagship widths on the card: (x, noise,
    cond_pcd, e2, coefs) and the weights, scaled as the model's init."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def t(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    dh, d15 = D // 2, D * 3 // 2
    p = denoise.DenoiseStepParams(
        t(128, 1), t(128, 1, scale=0.1), t(512, 128, scale=128 ** -0.5),
        t(512, 1, scale=0.1), t(N, 512, scale=512 ** -0.5), t(N, 1, scale=0.1),
        t(2 * D, D, scale=(2 * D) ** -0.5), t(1, D, scale=0.1),
        t(3, dh, scale=0.5), t(1, dh, scale=0.1), t(dh, D, scale=dh ** -0.5),
        t(1, D, scale=0.1), t(2 * D, d15, scale=(2 * D) ** -0.5),
        t(1, d15, scale=0.1), t(d15, D, scale=d15 ** -0.5), t(1, D, scale=0.1),
        t(D, dh, scale=D ** -0.5), t(1, dh, scale=0.1), t(dh, 3, scale=dh ** -0.5),
        t(1, 3, scale=0.1))
    coefs = torch.tensor([0.6, 0.7, 0.1], device="cuda")
    return (t(B, N, 3), t(B, N, 3), t(B, N, 3), t(B, 2 * D), coefs), p


def step_sweep(B: int, card: str) -> None:
    """K9's u2 launch and its tile launch at every plan, at B scenes,
    through the bound step's launches, beside the device's occupancy of
    the tile kernel at each plan and the plan the host picks: in the
    float32 mode every cluster size, in the bf16 mode every count of m16
    tiles a block."""
    args, p = step_case(B)
    x, noise, cpcd, e2, coefs = args
    for dtype, name, plans in ((None, "denoise_step", denoise.STEP_CLUSTERS),
                               (torch.bfloat16, "denoise_step_bf16",
                                denoise.STEP_BF16_MTILES)):
        bound = denoise.bind_step(p, x.shape[1], x.device, False, dtype)
        stream = kernels.stream(x.device)
        scratch, out = bound.scratch(B), torch.empty_like(x)
        u2 = queued_ms(lambda: bound.launch_u2(e2, scratch, stream))
        tiles = {c: queued_ms(lambda: bound.launch_tiles(x, noise, cpcd, coefs, out,
                                                         scratch, stream, c))
                 for c in plans if bound.occupancy[c] > 0}
        print(json.dumps({"kernel": name, "sweep": True, "batch": B, "u2_ms": u2,
                          "tiles_ms": tiles, "occupancy": bound.occupancy,
                          "plan": bound.plan(B), "card": card}))


# K9 bf16's layers in the tile kernel's order, and a block's stamp slots
STEP_BF16_LAYERS = ("u4", "emb", "p1", "p2", "h1", "h2", "h3", "x0")
STAMP_SLOTS = 32


def step_stamps(card: str) -> None:
    """K9 bf16's tile launch, from a build with ``-DLSDM_STEP_STAMPS``, at
    b1 and b8 (N = 1024, D = 128): its queued time in that build, and the
    last launch's stamps in µs, as medians over the blocks (each layer
    from the end of the one before; the waits converted from cycles by
    each block's ns a cycle)."""
    lib = kernels.load()
    read = lib.lsdm_denoise_step_bf16_stamps
    read.argtypes, read.restype = (ctypes.c_void_p, ctypes.c_int), ctypes.c_int
    for B in (1, 8):
        args, p = step_case(B)
        x, noise, cpcd, e2, coefs = args
        bound = denoise.bind_step(p, x.shape[1], x.device, False, torch.bfloat16)
        stream = kernels.stream(x.device)
        scratch, out = bound.scratch(B), torch.empty_like(x)
        bound.launch_u2(e2, scratch, stream)
        mt = bound.plan(B)

        def tiles():
            bound.launch_tiles(x, noise, cpcd, coefs, out, scratch, stream, mt)

        ms = queued_ms(tiles)
        tiles()
        torch.cuda.synchronize()
        blocks = B * -(-x.shape[1] // (16 * mt))
        buf = np.zeros(blocks * STAMP_SLOTS, dtype=np.uint64)
        kernels.check(read(buf.ctypes.data, blocks), "denoise_step_bf16")
        s = buf.reshape(blocks, STAMP_SLOTS).astype(np.int64)
        per_cycle = (s[:, 1] - s[:, 0]) / (s[:, 12] - s[:, 3])  # ns a cycle
        ends = (s[:, 4:13] - s[:, 3:4]) * per_cycle[:, None]  # prologue, layers

        def med(v):
            return round(float(np.median(v)) / 1e3, 3)

        layers = np.diff(ends, axis=1)
        print(json.dumps({
            "kernel": "denoise_step_bf16", "stamps": True, "batch": B, "mt": mt,
            "blocks": blocks, "sms": int(len(np.unique(s[:, 2]))),
            "tiles_ms_stamped_build": ms,
            "start_spread_us": round(float(s[:, 0].max() - s[:, 0].min()) / 1e3, 3),
            "span_us": round(float(s[:, 1].max() - s[:, 0].min()) / 1e3, 3),
            "block_us": med(s[:, 1] - s[:, 0]),
            "prologue_us": med(ends[:, 0]),
            "layer_us": {n: med(layers[:, i]) for i, n in enumerate(STEP_BF16_LAYERS)},
            "copy_wait_us": {n: med(s[:, 13 + i] * per_cycle)
                             for i, n in enumerate(STEP_BF16_LAYERS)},
            "barrier_wait_us": {n: med(s[:, 21 + i] * per_cycle)
                                for i, n in enumerate(STEP_BF16_LAYERS)},
            "ns_per_cycle": round(float(np.median(per_cycle)), 4), "card": card}))


def event_ms(fn, reps: int = 3) -> float:
    """Device ms per call of fn() over ``reps`` calls after one warm-up,
    by CUDA events around the loop."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def chain_plans(sweep: bool):
    """The pass-2 plans to time: the planner's (None), and with ``sweep``
    every (warps a tile, tiles a block) the kernel takes: 4 or 8 warps a
    tile, up to 16 warps a block."""
    yield None
    if sweep:
        yield from ((w, t) for w in (4, 8) for t in range(1, 16 // w + 1))


def chain_cases(B: int, sweep: bool, card: str, T: int = 1000) -> None:
    """K6 at B scenes of 1024 points, T steps, in the bf16 mode (at the
    plan's choice; with ``sweep`` also at each plan of ``chain_plans``)
    and in the float32 mode: ms of the whole call, of pass 1 alone over its
    chunks and of pass 2 (the rest), pass 2's TFLOP/s and bound."""
    from lsdm_tpu_torch.diffusion.schedule import make_schedule
    from lsdm_tpu_torch.models.sampling import chain_coefficients

    (x, _, cpcd, _, _), p = step_case(B, seed=B)
    g = torch.Generator(device="cuda").manual_seed(B + 1)
    N, D = x.shape[1], p.wc_t.shape[1]
    noise = torch.randn(B, T, N, 3, generator=g, device="cuda")
    e2 = torch.randn(B, T, 2 * D, generator=g, device="cuda")
    coef = chain_coefficients(make_schedule("cosine", T, device="cuda"), False)
    data = (x, noise, cpcd, e2, coef)
    tail = sum(w.numel() for w in (p.wp0_t, p.wp2_t, p.wx2_t, p.wo0_t, p.wo2_t))
    ops2 = 2 * B * T * N * (tail + D * p.wx0_t.shape[1])
    bf = torch.bfloat16
    pb = denoise.bf16_step_params(p)
    want = denoise.denoise_chain_plain(*data, p, compute_dtype=bf)
    want32 = denoise.denoise_chain_plain(*data, p)
    for dtype in (bf, None):
        q = pb if dtype else p
        tc = denoise.chain_chunk_steps(B, T, q, dtype)
        pass1 = 0.0
        for steps, count in ((tc, T // tc), (T % tc, 1)):
            if steps and count:
                rows = e2[:, :steps].contiguous()
                pass1 += count * event_ms(lambda: denoise._tables_scratch(
                    rows, q, dtype, keep_emb=False))
        planner = denoise.chain_bf16_plan
        for plan in chain_plans(sweep) if dtype else [None]:
            if plan:
                denoise.chain_bf16_plan = lambda *_, plan=plan: plan
            try:
                got = denoise.fused_denoise_chain(*data, q, compute_dtype=dtype)
                ms = event_ms(lambda: denoise.fused_denoise_chain(
                    *data, q, compute_dtype=dtype))
            finally:
                denoise.chain_bf16_plan = planner
            rec = {"kernel": "denoise_chain_bf16" if dtype else "denoise_chain",
                   "batch": B, "steps": T, "points": N, "ms": ms, "pass1_ms": pass1,
                   "pass2_ms": ms - pass1, "card": card}
            if dtype:
                diff = [(a - w).abs() for a, w in zip(got, want)]
                rec.update(
                    forced=plan is not None,
                    plan=plan or planner(B, N),
                    pass2_tflop_s=ops2 / (ms - pass1) * 1e-9,
                    pass2_bound_ms=ops2 / 989e12 * 1e3,
                    max_abs_err=max(d.max().item() for d in diff),
                    mean_abs_err=max(d.mean().item() for d in diff),
                    bf16_gap=min((w - w32).abs().mean().item()
                                 for w, w32 in zip(want, want32)))
            else:
                rec["max_abs_err"] = max((a - w).abs().max().item() for a, w in zip(
                    got, want32))
            print(json.dumps(rec))


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
    ap.add_argument("--nn_sweep", action="store_true")
    ap.add_argument("--sg_sweep", action="store_true")
    ap.add_argument("--step_sweep", action="store_true")
    ap.add_argument("--chain_sweep", action="store_true")
    ap.add_argument("--step_stamps", action="store_true",
                    help="K9 bf16's stamps, from a build with -DLSDM_STEP_STAMPS")
    ap.add_argument("--only", nargs="+",
                    choices=["attn", "fps", "bq", "nn", "chamfer", "sg", "step", "chain"])
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
    if args.step_stamps:
        kernels.NVCC_FLAGS = (*kernels.NVCC_FLAGS, "-DLSDM_STEP_STAMPS")
    t0 = time.perf_counter()
    kernels.load()
    print(f"build {time.perf_counter() - t0:.1f} s")
    if args.step_stamps:
        step_stamps(card)
        return

    def on(name):
        return args.only is None or name in args.only

    if on("attn"):
        attn_cases(card)
    g = torch.Generator(device="cuda").manual_seed(0)
    for clouds in args.clouds:
        levels = fps_levels(clouds, g)
        if on("fps"):
            fps_cases(levels, clouds, args, card)
        sets = [levels[0], *levels]  # sa1 keeps every point: l1 = l0
        if on("bq"):
            bq_cases(sets, clouds, args, card)
        if on("nn"):
            nn_cases(sets, clouds, args, card)
        if on("sg"):
            sg_cases(sets, clouds, args, card, g)
    if on("chamfer"):
        chamfer_all(g, args, card)
    if on("step"):
        for dtype, name in ((None, "denoise_step"),
                            (torch.bfloat16, "denoise_step_bf16")):
            for B in (1, 8):
                step_args, p = step_case(B)
                step = denoise.make_denoise_step(p, step_args[0].shape[1],
                                                 step_args[0].device,
                                                 compute_dtype=dtype)
                got = step(*step_args)
                err = (got - denoise.denoise_step_plain(
                    *step_args, p, compute_dtype=dtype)).abs().max().item()
                sha = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()[:16]
                print(json.dumps({"kernel": name, "batch": B, "points": 1024,
                                  "ms": queued_ms(lambda: step(*step_args)),
                                  "max_abs_err": err, "sha256": sha, "card": card}))
        if args.step_sweep:
            for B in range(1, 9):
                step_sweep(B, card)
    if on("chain"):
        for B in (*range(1, 9), 16) if args.chain_sweep else (1, 8):
            chain_cases(B, args.chain_sweep, card)


def attn_cases(card: str) -> None:
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


def fps_cases(levels, clouds: int, args, card: str) -> None:
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


def bq_cases(sets, clouds: int, args, card: str) -> None:
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


def nn_cases(sets, clouds: int, args, card: str) -> None:
    stages, equal = [], True  # K2 at fp4..fp1
    for xyz1, xyz2 in zip(sets[3::-1], sets[4:0:-1]):
        want = ballquery.three_nn_plain(xyz1, xyz2, 3)
        fn = three_nn_call(xyz1, xyz2)
        equal = equal and same_bits(fn(), want)
        stages.append(queued_ms(fn))
        if args.nn_sweep:
            for plan in NN_LANES:
                fw = three_nn_call(xyz1, xyz2, plan)
                if not same_bits(fw(), want):
                    raise AssertionError(f"3-NN plan {plan}: outputs differ")
                print(json.dumps({"kernel": "three_nn", "clouds": clouds,
                                  "targets": xyz1.shape[1], "sources": xyz2.shape[1],
                                  "plan": plan, "ms": queued_ms(fw)}))
    print(json.dumps({"kernel": "three_nn", "clouds": clouds, "stages_ms": stages,
                      "ms": sum(stages), "equal": equal, "card": card}))


def sg_cases(sets, clouds: int, args, card: str, g: torch.Generator) -> None:
    """K10 at sa1..sa4: equal indices and values, and its queued time."""
    stages, equal = [], True
    for r, c, xyz, new_xyz in zip(RADII, SG_WIDTHS, sets[:4], sets[1:5]):
        base = torch.cat([xyz, torch.randn(clouds, xyz.shape[1], c - 3, generator=g,
                                           device="cuda")], -1).contiguous()
        fn = sg_call(r, xyz, new_xyz, base)
        want = sg_fused.select_gather_plain(r, min(NSAMPLE, xyz.shape[1]), xyz,
                                            new_xyz, base)
        equal = equal and same_bits(fn(), want)
        stages.append(queued_ms(fn))
        if args.sg_sweep:
            for plan in (1, 2, 4):
                fw = sg_call(r, xyz, new_xyz, base, plan)
                if not same_bits(fw(), want):
                    raise AssertionError(f"select-gather plan {plan}: outputs differ")
                print(json.dumps({"kernel": "select_gather", "clouds": clouds,
                                  "points": xyz.shape[1], "queries": new_xyz.shape[1],
                                  "plan": plan, "ms": queued_ms(fw)}))
        del want
    print(json.dumps({"kernel": "select_gather", "clouds": clouds, "stages_ms": stages,
                      "ms": sum(stages), "equal": equal, "card": card}))


def chamfer_all(g: torch.Generator, args, card: str) -> None:
    for name, x, y in chamfer_cases(g):
        want = chamfer.directed_nn_plain(x, y)
        fn = chamfer_nn_call(x, y)
        print(json.dumps({"kernel": "chamfer_nn", "case": name, "shape": list(x.shape[:2]),
                          "ms": queued_ms(fn), "equal": same_bits(fn(), want),
                          "card": card}))
        if args.nn_sweep:
            for plan in NN_PLANS:
                fw = chamfer_nn_call(x, y, plan)
                if not same_bits(fw(), want):
                    raise AssertionError(f"chamfer plan {plan}: outputs differ")
                print(json.dumps({"kernel": "chamfer_nn", "case": name, "plan": plan,
                                  "ms": queued_ms(fw)}))


if __name__ == "__main__":
    main()

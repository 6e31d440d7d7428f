#!/usr/bin/env python3
"""Smoke test of lsdm_tpu_torch on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

1. Requires a CUDA device and prints its name and power limit.
2. Builds the CUDA kernels from ``lsdm_tpu_torch/csrc`` (nvcc, sm_90a, one
   nvcc per source, in parallel).
3. Holds each kernel against its plain PyTorch version on the card at the
   shapes of the flagship sampling paths: ball query (K1), 3-NN (K2) and
   FPS (K3) must give equal indices; the fused SA stage (K7, sa1-sa4 and a
   center with an empty ball) and FP stage (K8, fp4-fp1 with the head)
   must agree to STAGE_ATOL, the rank-1 attention (K4) to ATTN_ATOL; the
   denoise chain (K6, N=1024, D=128, T=1000) to CHAIN_ATOL, and its first
   pass's tables to TABLE_ATOL.  Prints both times and each kernel's
   bound: the least time the card could take for the call's work, bytes
   over HBM_BYTES_PER_S or float32 operations over FP32_OPS_PER_S.
4. The "pallas" path: samples one object at full width (``sdm_proxd()``:
   9 objects x 1024 points, T=1000 DDPM, batch 1, seeded random weights
   and inputs) with ``ball_impl="pallas"`` through the kernels (K1, K2,
   K3, K6) and once on the plain path with the same draws; checks the
   sample is finite and agrees to CHAIN_ATOL, and that each of its kernels
   was launched during the kernel run.
5. The "fused" path, what ``resolve_fast_path`` gives on CUDA
   (``ball_impl="fused"``, ``fused_step="chain"``): the same sample through
   the kernels (K3, K7, K8, K4, K6; no K1 or K2) and through the plain
   versions of the same configuration, agreeing to FUSED_ATOL; the fused
   encode's ``cond_pcd`` against the composed ("pallas") encode at the
   JAX package's fused-vs-composed bound COND_RTOL / COND_ATOL.  Prints
   ms/scene and peak memory of both paths.
6. The CLI: ``lsdm_tpu_torch.run.test_sdm`` on a synthetic proxd test
   split (4 sequences x 1024 points, batch 2, T=1000) on CUDA; checks the
   output files and that the fused kernels ran.
7. The training kernels at the train step's shapes (batch 6 = 54 clouds
   of 1024 points): the rank-1 attention backward (K5) to ATTN_BWD_ATOL,
   with SDPA's backward timed beside it; the select-gather (K10, sa1-sa4
   and an empty ball) and the chamfer nearest neighbour (K11, each way)
   equal to their plain versions.
8. The train step of ``sdm_proxd()`` at batch 6 (fp32, T=1000, seeded
   weights and batch) in the configuration ``train_sdm`` runs by default
   on CUDA (K1-K5), with ``ball_impl="sg"`` (K10) and with the K11 chamfer:
   each through the kernels and through the plain versions from the same
   weights, t, noise and dropout keep-mask, agreeing in the loss, the
   gradients and the parameters after one AdamW step; prints ms/step and
   peak memory.
9. ``lsdm_tpu_torch.run.train_sdm`` on a synthetic split (one epoch of
   two steps, validation on the fused path), its ``final.pt`` read back.
10. Prints one JSON line of kernel records, then, as its last line,
   ``{"ok": true, "device": {...}}``.

Any failure raises, so the exit code is non-zero and no result line is
printed; without a CUDA device it exits with code 2.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time

SEED = 0
T_STEPS = 1000
# K6 and the full sample.  Both sides compute in float32 with exact-erf
# GELU; they differ only in the order of the sums (the kernel's FMA loops
# against cuBLAS), and selection indices are bit-equal, so nothing else
# differs between the two runs.  On an H100 the difference read 8.9e-08
# at T=1000 in every run.
CHAIN_ATOL = 1e-6
# K6's first pass (the per-step tables emb and g), checked on its own: the
# sample barely moves with pass 1's rounding, so only this check shows
# whether pass 1 computes in exact float32 with an erf GELU.  TABLE_ATOL
# sits a few times above the H100 reading of the exact kernel and far
# below those of a build with TF32 products or a tanh GELU (PERF.md).
TABLE_ATOL = 1e-6
TABLE_STEPS = 64  # the last steps of the chain, as their own batch
# K2 distances: kernel and plain version round the same float32 ops.
DIST_ATOL = 1e-6
# K7 and K8 on outputs of order 1: the same selection (equal distance
# bits), float32 sums of up to 768 products in another order (FMA chains
# against cuBLAS).  H100 readings: K7 <= 4.2e-07, K8 <= 6.0e-07.
STAGE_ATOL = 2e-6
# K4: the kernel's compensated sums over 1024 keys against the plain
# version's rounded weights and its 1024-term products.  H100 reading
# 7.2e-07 with these seeded inputs, which is the plain version's own
# rounding: it reads 7.3e-07 from a float64 evaluation on the CPU.
ATTN_ATOL = 1e-6
# The fused path's sample against the plain versions of the same
# configuration: the encode's rounding differences pass through T steps.
# H100 reading 1.3e-07.
FUSED_ATOL = 1e-6
# The fused encode against the composed one: the JAX package's own bound
# (tests/test_sdm_model.py), BatchNorm folded against applied.
COND_RTOL, COND_ATOL = 2e-4, 2e-5
# K5 on (54, 1024, 12): compensated sums of 1024 terms against the plain
# version's rounded weights and its reductions in another order.  H100
# reading 2.9e-06.
ATTN_BWD_ATOL = 1e-5
# K11's minimum distances: the same float32 operations as the plain version
CHAMFER_ATOL = 0.0
# The train step, kernels against plain versions from the same weights and
# draws: the loss, each gradient leaf's max |a - b| / max |b| (max |b| no
# less than 1e-3 of the largest gradient of the model), and the
# parameters after one AdamW step where the gradient is not rounding noise.
# The gradients differ by K4/K5's rounding and by the order of the atomic
# sums of the gathers' backward (index_add_/scatter_add_), which changes
# from run to run; AdamW's first update is lr * sign(g), so a parameter
# whose gradient is rounding noise (a conv bias ahead of a train-mode
# BatchNorm has an exactly zero gradient in exact arithmetic) can move by
# +-lr either way, and those entries are excluded from the parameter check.
# H100 readings at batch 6 (NVIDIA H100 80GB HBM3, 700 W), over the three
# configurations and every run so far: loss 0, gradients <= 3.0e-07,
# parameters <= 3.6e-07 (a few ulp of the parameters).
TRAIN_LOSS_RTOL = 1e-6
TRAIN_GRAD_RTOL = 1e-5
TRAIN_PARAM_ATOL = 1e-6
TRAIN_BATCH = 6
TRAIN_STEPS = 3  # timed steps of each train configuration
# H100 SXM peaks (NVIDIA's data sheet, dense, at the 700 W limit): HBM
# bytes per second and float32 operations per second outside the tensor
# cores.  A kernel's bound counts each input byte read once and each output
# byte written once, and one operation per float32 add, multiply, compare
# or exp that its function needs on this run's data.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
KERNELS = {  # name: (source, the TPU kernel it replaces, path it is counted on)
    "ball_query": ("lsdm_tpu_torch/csrc/ballquery.cu",
                   "lsdm_tpu/ops/ballquery_pallas.py:65", "pallas"),
    "three_nn": ("lsdm_tpu_torch/csrc/ballquery.cu",
                 "lsdm_tpu/ops/ballquery_pallas.py:133", "pallas"),
    "fps": ("lsdm_tpu_torch/csrc/fps.cu", "lsdm_tpu/ops/fps_pallas.py:62",
            "fused"),
    "denoise_chain": ("lsdm_tpu_torch/csrc/denoise_chain.cu",
                      "lsdm_tpu/ops/denoise_pallas.py:278", "fused"),
    "rank1_attn": ("lsdm_tpu_torch/csrc/rank1_attn.cu",
                   "lsdm_tpu/ops/attn_pallas.py:60", "fused"),
    "sa_fused": ("lsdm_tpu_torch/csrc/sa_fused.cu",
                 "lsdm_tpu/ops/sa_fused_pallas.py:134", "fused"),
    "fp_fused": ("lsdm_tpu_torch/csrc/fp_fused.cu",
                 "lsdm_tpu/ops/fp_fused_pallas.py:93", "fused"),
    "rank1_attn_bwd": ("lsdm_tpu_torch/csrc/rank1_attn_bwd.cu",
                       "lsdm_tpu/ops/attn_pallas.py:138", "train"),
    "select_gather": ("lsdm_tpu_torch/csrc/sg_fused.cu",
                      "lsdm_tpu/ops/sg_fused_pallas.py:128", "train_sg"),
    "chamfer_nn": ("lsdm_tpu_torch/csrc/chamfer.cu",
                   "lsdm_tpu/ops/chamfer_pallas.py:75", "train_chamfer"),
}
PATH_KERNELS = {"pallas": ("ball_query", "three_nn", "fps", "denoise_chain"),
                "fused": ("fps", "sa_fused", "fp_fused", "rank1_attn",
                          "denoise_chain"),
                "train": ("ball_query", "three_nn", "fps", "rank1_attn",
                          "rank1_attn_bwd"),
                "train_sg": ("select_gather", "three_nn", "fps", "rank1_attn",
                             "rank1_attn_bwd"),
                "train_chamfer": ("chamfer_nn", "ball_query", "three_nn", "fps",
                                  "rank1_attn", "rank1_attn_bwd"),
                # train_sdm: the default train steps, then validation
                # samples on the fused path
                "train_cli": ("ball_query", "three_nn", "fps", "rank1_attn",
                              "rank1_attn_bwd", "sa_fused", "fp_fused",
                              "denoise_chain")}
# (module, the name it calls a kernel wrapper by, module, plain version):
# swapped in to run a path through the plain versions of its kernels
PLAIN_VERSIONS = (
    ("lsdm_tpu_torch.ops.pointcloud", "farthest_point_sample_kernel",
     "lsdm_tpu_torch.ops.fps", "farthest_point_sample_plain"),
    ("lsdm_tpu_torch.ops.pointcloud", "query_ball_point_kernel",
     "lsdm_tpu_torch.ops.ballquery", "query_ball_point_plain"),
    ("lsdm_tpu_torch.ops.pointcloud", "three_nn_kernel",
     "lsdm_tpu_torch.ops.ballquery", "three_nn_plain"),
    ("lsdm_tpu_torch.models.pointnet2", "sa_stage_fused_kernel",
     "lsdm_tpu_torch.ops.sa_fused", "sa_stage_fused_plain"),
    ("lsdm_tpu_torch.models.pointnet2", "fp_stage_fused_kernel",
     "lsdm_tpu_torch.ops.fp_fused", "fp_stage_fused_plain"),
    ("lsdm_tpu_torch.ops.attention", "rank1_mha_kernel",
     "lsdm_tpu_torch.ops.attn", "rank1_mha_plain"),
    ("lsdm_tpu_torch.ops.attn", "rank1_mha_kernel",
     "lsdm_tpu_torch.ops.attn", "rank1_mha_plain"),
    ("lsdm_tpu_torch.ops.attn", "rank1_mha_bwd_kernel",
     "lsdm_tpu_torch.ops.attn", "rank1_mha_bwd_plain"),
    ("lsdm_tpu_torch.ops.sg_fused", "select_gather_kernel",
     "lsdm_tpu_torch.ops.sg_fused", "select_gather_plain"),
    ("lsdm_tpu_torch.ops.chamfer", "directed_nn_kernel",
     "lsdm_tpu_torch.ops.chamfer", "directed_nn_plain"),
    ("lsdm_tpu_torch.models.sampling", "fused_denoise_chain",
     "lsdm_tpu_torch.ops.denoise", "denoise_chain_plain"),
)


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _time_ms(fn, reps: int, dev) -> float:
    """Mean time of fn() in ms after one warm-up: CUDA events on the card
    (the synchronised host clock elsewhere)."""
    import torch

    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / reps


def _card() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip()


@contextlib.contextmanager
def plain_versions():
    """Run every kernel wrapper of the main paths as its plain version,
    on any device, for the duration of the block (this script's yardstick;
    the package itself never falls back)."""
    saved = []
    for mod, name, pmod, pname in PLAIN_VERSIONS:
        m = importlib.import_module(mod)
        saved.append((m, name, getattr(m, name)))
        setattr(m, name, getattr(importlib.import_module(pmod), pname))
    try:
        yield
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


def _record(rec, name, err, ms, pms, line, nbytes, ops, lib_ms=None):
    """Add one call of kernel ``name`` to ``rec``: its error, its and its
    plain version's time, and the least time the card could take for the
    call's work (``nbytes`` moved, ``ops`` float32 operations)."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    lib = "" if lib_ms is None else f", library {lib_ms:.4f} ms"
    print(f"{line}; kernel {ms:.4f} ms, plain {pms:.4f} ms{lib}, bound "
          f"{max(bytes_ms, ops_ms):.4f} ms")
    r = rec.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                              "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
                              "library_ms": None})
    r["max_abs_err"] = max(r["max_abs_err"], float(err))
    r["ms"] += ms
    r["plain_ms"] += pms
    r["bound_ms"] += max(bytes_ms, ops_ms)
    r["bytes_ms"] += bytes_ms
    r["ops_ms"] += ops_ms
    if lib_ms is not None:
        r["library_ms"] = (r["library_ms"] or 0.0) + lib_ms


def _kernel_record(r: dict) -> dict:
    """The JSON fields of a kernel's accumulated record."""
    out = {k: v for k, v in r.items() if k not in ("bytes_ms", "ops_ms")}
    out["bound_by"] = "bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations"
    return out


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _ball_scan(radius, nsample, xyz, new_xyz) -> int:
    """Distances a ball query needs on this data: per center, the points up
    to its nsample-th in-radius one, or all N where the ball holds fewer."""
    import torch

    from lsdm_tpu_torch.ops.ballquery import _radius2, square_distance

    inside = square_distance(new_xyz, xyz) <= _radius2(radius)
    full = inside.sum(-1) >= nsample
    kth = (inside.cumsum(-1) >= nsample).int().argmax(-1)
    return int(torch.where(full, kth + 1, xyz.shape[1]).sum())


DIST_OPS = 10  # a squared distance (6 multiplies, 4 adds) and its compare


def kernel_checks(dev, model, T: int = T_STEPS) -> dict:
    """Phase 3: every kernel against its plain version at the shapes the
    model's sampling path gives it (9 clouds of the model's width).
    Returns {kernel: {max_abs_err, ms, plain_ms}}; times sum the path's
    calls of each kernel."""
    import torch

    from lsdm_tpu_torch.diffusion.schedule import make_schedule
    from lsdm_tpu_torch.models.pointnet2 import HEAD_ACTS, fold_mlp
    from lsdm_tpu_torch.models.sampling import chain_coefficients
    from lsdm_tpu_torch.ops import attn, ballquery, denoise, fp_fused, fps, sa_fused
    from lsdm_tpu_torch.ops.pointcloud import index_points

    bb = model.pcd_backbone
    stages = (bb.sa1, bb.sa2, bb.sa3, bb.sa4)
    N, D = model.cfg.pcd_points, model.cfg.latent_dim
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    start = torch.zeros(9, dtype=torch.int32, device=dev)
    levels = [torch.randn(9, N, 3, generator=g, device=dev)]
    levels.append(levels[0])  # sa1 keeps all N points (no FPS)
    rec: dict = {}

    for st in stages[1:]:  # K3 at sa2..sa4
        xyz, npoint = levels[-1], st.npoint
        got = fps.farthest_point_sample_kernel(xyz, npoint, start)
        want = fps.farthest_point_sample_plain(xyz, npoint, start)
        if not torch.equal(got, want):
            raise AssertionError(f"FPS {xyz.shape[1]}->{npoint}: indices differ")
        _record(rec, "fps", (got.long() - want.long()).abs().max().item(),
                _time_ms(lambda: fps.farthest_point_sample_kernel(xyz, npoint, start), 10, dev),
                _time_ms(lambda: fps.farthest_point_sample_plain(xyz, npoint, start), 3, dev),
                f"K3 fps (9,{xyz.shape[1]},3)->{npoint}: equal indices",
                _nbytes(xyz, start, got), DIST_OPS * 9 * npoint * xyz.shape[1])
        levels.append(index_points(xyz, want).contiguous())

    for st, xyz, new_xyz in zip(stages, levels[:4], levels[1:5]):  # K1 at sa1..sa4
        r, ns = st.radius, min(st.nsample, xyz.shape[1])
        got = ballquery.query_ball_point_kernel(r, ns, xyz, new_xyz)
        want = ballquery.query_ball_point_plain(r, ns, xyz, new_xyz)
        if not torch.equal(got, want):
            raise AssertionError(f"ball query N={xyz.shape[1]} S={new_xyz.shape[1]}: "
                                 "indices differ")
        _record(rec, "ball_query", (got.long() - want.long()).abs().max().item(),
                _time_ms(lambda: ballquery.query_ball_point_kernel(r, ns, xyz, new_xyz), 20, dev),
                _time_ms(lambda: ballquery.query_ball_point_plain(r, ns, xyz, new_xyz), 5, dev),
                f"K1 ball query N={xyz.shape[1]} S={new_xyz.shape[1]} r={r}: equal indices",
                _nbytes(xyz, new_xyz, got), DIST_OPS * _ball_scan(r, ns, xyz, new_xyz))

    for xyz1, xyz2 in zip(levels[3::-1], levels[4:0:-1]):  # K2 at fp4..fp1
        k = min(3, xyz2.shape[1])
        gd, gi = ballquery.three_nn_kernel(xyz1, xyz2, k)
        wd, wi = ballquery.three_nn_plain(xyz1, xyz2, k)
        derr = (gd - wd).abs().max().item()
        if not torch.equal(gi, wi) or derr > DIST_ATOL:
            raise AssertionError(f"3-NN N={xyz1.shape[1]} S={xyz2.shape[1]}: "
                                 f"indices differ or distance error {derr}")
        _record(rec, "three_nn", derr,
                _time_ms(lambda: ballquery.three_nn_kernel(xyz1, xyz2, k), 20, dev),
                _time_ms(lambda: ballquery.three_nn_plain(xyz1, xyz2, k), 5, dev),
                f"K2 3-NN N={xyz1.shape[1]} S={xyz2.shape[1]}: equal indices, "
                f"max distance error {derr:.3g}",
                _nbytes(xyz1, xyz2, gd, gi), (DIST_OPS + 1) * gi.shape[0]
                * xyz1.shape[1] * xyz2.shape[1])

    # K7 at sa1..sa4 with the model's folded weights: base = [xyz, features]
    # (sa1's features are the xyz themselves), features of order 1
    feats = [levels[0]]
    for st, xyz, new_xyz in zip(stages, levels[:4], levels[1:5]):
        folded = fold_mlp(st)
        base = torch.cat([xyz, feats[-1]], -1).contiguous()
        r, ns = st.radius, min(st.nsample, xyz.shape[1])
        cases = [(new_xyz, "")]
        if st is stages[1]:  # a center far from the cloud: an empty ball
            far = new_xyz.clone()
            far[0, 0] = 50.0
            cases.append((far, ", one empty ball"))
        for q, note in cases:
            got = sa_fused.sa_stage_fused_kernel(r, ns, xyz, q, base, folded)
            want = sa_fused.sa_stage_fused_plain(r, ns, xyz, q, base, folded)
            err = (got - want).abs().max().item()
            line = (f"K7 fused SA N={xyz.shape[1]} S={q.shape[1]} K={ns} "
                    f"{tuple(w.shape[1] for w, _ in folded)}{note}: max error "
                    f"{err:.3g} (tolerance {STAGE_ATOL})")
            if not (torch.isfinite(got).all() and err <= STAGE_ATOL):
                raise AssertionError(line)
            if note:  # not a call of the path: its error counts, its time not
                if not (ballquery.query_ball_point_plain(r, ns, xyz, q, empty=0)[0, 0] == 0).all():
                    raise AssertionError("the empty ball did not select point 0")
                rec["sa_fused"]["max_abs_err"] = max(rec["sa_fused"]["max_abs_err"], err)
                print(line)
                continue
            widths = [base.shape[2]] + [w.shape[1] for w, _ in folded]
            B_, N_, S_ = xyz.shape[0], xyz.shape[1], q.shape[1]
            ops = (2 * B_ * N_ * widths[0] * widths[1]  # Z1 at the N points
                   + 2 * B_ * S_ * 3 * widths[1]        # the center term
                   + 2 * B_ * S_ * ns * sum(a * b for a, b in zip(widths[1:-1], widths[2:]))
                   + DIST_OPS * _ball_scan(r, ns, xyz, q))
            _record(rec, "sa_fused", err,
                    _time_ms(lambda: sa_fused.sa_stage_fused_kernel(r, ns, xyz, q, base, folded), 20, dev),
                    _time_ms(lambda: sa_fused.sa_stage_fused_plain(r, ns, xyz, q, base, folded), 5, dev),
                    line, _nbytes(xyz, q, base, got, *(t for wb in folded for t in wb)), ops)
        feats.append(torch.randn(9, new_xyz.shape[1], folded[-1][0].shape[1],
                                 generator=g, device=dev))

    # K8 at fp4..fp1; fp1 carries the head (ReLU) and conv2 (none)
    for i, fp in zip((3, 2, 1, 0), (bb.fp4, bb.fp3, bb.fp2, bb.fp1)):
        folded = fold_mlp(fp)
        acts = ["relu"] * len(folded)
        p1 = feats[i] if i > 0 else None  # the SA output at the targets
        if fp is bb.fp1:
            folded += bb.head_folded()
            acts += HEAD_ACTS
        xyz1, xyz2 = levels[i], levels[i + 1]
        d2 = folded[0][0].shape[0] - (0 if p1 is None else p1.shape[2])
        p2 = torch.randn(9, xyz2.shape[1], d2, generator=g, device=dev)
        args = (xyz1, xyz2, p1, p2, folded, acts)
        got = fp_fused.fp_stage_fused_kernel(*args)
        want = fp_fused.fp_stage_fused_plain(*args)
        err = (got - want).abs().max().item()
        if not (torch.isfinite(got).all() and err <= STAGE_ATOL):
            raise AssertionError(f"fused FP N={xyz1.shape[1]} S={xyz2.shape[1]}: "
                                 f"max error {err} > {STAGE_ATOL}")
        B_, N_, S_ = xyz1.shape[0], xyz1.shape[1], xyz2.shape[1]
        ops = ((DIST_OPS + 1) * B_ * N_ * S_ + 2 * B_ * N_ * min(3, S_) * d2
               + 2 * B_ * N_ * sum(w.numel() for w, _ in folded))
        _record(rec, "fp_fused", err,
                _time_ms(lambda: fp_fused.fp_stage_fused_kernel(*args), 20, dev),
                _time_ms(lambda: fp_fused.fp_stage_fused_plain(*args), 5, dev),
                f"K8 fused FP N={xyz1.shape[1]} S={xyz2.shape[1]} in {folded[0][0].shape[0]} "
                f"{tuple(w.shape[1] for w, _ in folded)}: max error {err:.3g} "
                f"(tolerance {STAGE_ATOL})",
                _nbytes(xyz1, xyz2, p1, p2, got, *(t for wb in folded for t in wb)), ops)

    # K4 at pcd_attention's shapes: 9 clouds, L = S = N, 12 heads
    H = model.cfg.translation_params
    q = torch.randn(9, N, H, generator=g, device=dev)
    k = torch.randn(9, N, H, generator=g, device=dev)
    v = torch.randn(9, N, H, generator=g, device=dev)
    got = attn.rank1_mha_kernel(q, k, v)
    want = attn.rank1_mha_plain(q, k, v)
    err = (got - want).abs().max().item()
    if not (torch.isfinite(got).all() and err <= ATTN_ATOL):
        raise AssertionError(f"rank-1 attention: max error {err} > {ATTN_ATOL}")
    q4, k4, v4 = (t.transpose(1, 2)[..., None].contiguous() for t in (q, k, v))
    _record(rec, "rank1_attn", err,
            _time_ms(lambda: attn.rank1_mha_kernel(q, k, v), 20, dev),
            _time_ms(lambda: attn.rank1_mha_plain(q, k, v), 5, dev),
            f"K4 rank-1 attention (9,{N},{H}): max error {err:.3g} "
            f"(tolerance {ATTN_ATOL})",
            _nbytes(q, k, v, got), 6 * 9 * H * N * N,
            _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q4, k4, v4, scale=1.0), 20, dev))

    # K6 at batch 1 with the model's own tail weights
    p = denoise.extract_step_params(model)
    args = (torch.randn(1, N, 3, generator=g, device=dev),
            torch.randn(1, T, N, 3, generator=g, device=dev),
            torch.randn(1, N, 3, generator=g, device=dev),
            torch.randn(1, T, 2 * D, generator=g, device=dev),
            chain_coefficients(make_schedule("cosine", T, device=dev), False),
            p)
    got = denoise.fused_denoise_chain(*args)
    want = denoise.denoise_chain_plain(*args)
    err = max((a - b).abs().max().item() for a, b in zip(got, want))
    if not (all(torch.isfinite(a).all() for a in got) and err <= CHAIN_ATOL):
        raise AssertionError(f"denoise chain: max error {err} > {CHAIN_ATOL}")
    up = sum(w.numel() for w in (p.w_up0, p.w_up2, p.w_up4))  # on 2D rows
    rows = sum(w.numel() for w in (p.wc_t, p.wp0_t, p.wp2_t, p.wx0_t, p.wx2_t,
                                   p.wo0_t, p.wo2_t))         # on N rows
    _record(rec, "denoise_chain", err,
            _time_ms(lambda: denoise.fused_denoise_chain(*args), 3, dev),
            _time_ms(lambda: denoise.denoise_chain_plain(*args), 2, dev),
            f"K6 denoise chain N={N} D={D} T={T}: max error {err:.3g} "
            f"(tolerance {CHAIN_ATOL})",
            _nbytes(*args[:5], *p, *got), 2 * T * (2 * D * up + N * rows))
    e2 = args[3][:, -TABLE_STEPS:].contiguous()
    got = denoise.denoise_chain_tables(e2, p)
    want = denoise.denoise_chain_tables_plain(e2, p)
    terr = max((a - b).abs().max().item() for a, b in zip(got, want))
    print(f"K6 pass 1 tables (emb, g) of {e2.shape[1]} steps: max error "
          f"{terr:.3g} (tolerance {TABLE_ATOL})")
    if terr > TABLE_ATOL:
        raise AssertionError(f"denoise chain pass 1: max error {terr} > {TABLE_ATOL}")
    rec["denoise_chain"]["max_abs_err"] = max(err, terr)
    return rec


def train_kernel_checks(dev, model, batch: int = TRAIN_BATCH) -> dict:
    """Phase 7: the training kernels against their plain versions at the
    shapes of the train step at ``batch`` scenes (``batch * max_objs``
    clouds): K5 on the pcd_attention's (clouds, N, 12), K10 at sa1-sa4 and
    on a center with an empty ball, K11 on (batch, N, 3) each way.
    Returns {kernel: record}, as :func:`kernel_checks`."""
    import torch

    from lsdm_tpu_torch.ops import attn, chamfer, fps, sg_fused
    from lsdm_tpu_torch.ops.pointcloud import index_points

    cfg = model.cfg
    C_, N, H = batch * cfg.max_objs, cfg.pcd_points, cfg.translation_params
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    rec: dict = {}

    # K5 at (clouds, N, 12), with SDPA's backward on the same inputs as the
    # library yardstick (head_dim 1, scale 1)
    q, k, v, gout = (torch.randn(C_, N, H, generator=g, device=dev) for _ in range(4))
    out = attn.rank1_mha_kernel(q, k, v)
    got = attn.rank1_mha_bwd_kernel(q, k, v, out, gout)
    want = attn.rank1_mha_bwd_plain(q, k, v, out, gout)
    err = max((a - b).abs().max().item() for a, b in zip(got, want))
    if not (all(torch.isfinite(a).all() for a in got) and err <= ATTN_BWD_ATOL):
        raise AssertionError(f"rank-1 attention backward: max error {err} > {ATTN_BWD_ATOL}")
    q4, k4, v4 = (t.transpose(1, 2)[..., None].contiguous().requires_grad_()
                  for t in (q, k, v))
    out4 = torch.nn.functional.scaled_dot_product_attention(q4, k4, v4, scale=1.0)
    g4 = gout.transpose(1, 2)[..., None].contiguous()
    lib = _time_ms(lambda: torch.autograd.grad(out4, (q4, k4, v4), g4,
                                               retain_graph=True), 5, dev)
    del q4, k4, v4, out4
    _record(rec, "rank1_attn_bwd", err,
            _time_ms(lambda: attn.rank1_mha_bwd_kernel(q, k, v, out, gout), 10, dev),
            _time_ms(lambda: attn.rank1_mha_bwd_plain(q, k, v, out, gout), 3, dev),
            f"K5 rank-1 attention backward ({C_},{N},{H}): max error {err:.3g} "
            f"(tolerance {ATTN_BWD_ATOL})",
            _nbytes(q, k, v, out, gout, *got), 13 * C_ * H * N * N, lib)
    del want

    # K10 at sa1..sa4: centers by FPS as the stages pick them, features of
    # the stages' input widths
    bb = model.pcd_backbone
    stages = (bb.sa1, bb.sa2, bb.sa3, bb.sa4)
    xyz = torch.randn(C_, N, 3, generator=g, device=dev)
    start = torch.zeros(C_, dtype=torch.int32, device=dev)
    for st in stages:
        new_xyz = (xyz if st.npoint == xyz.shape[1] else index_points(
            xyz, fps.farthest_point_sample_kernel(xyz, st.npoint, start)).contiguous())
        width = st.mlp_convs[0].weight.shape[1]
        base = torch.cat([xyz, torch.randn(C_, xyz.shape[1], width - 3, generator=g,
                                           device=dev)], -1).contiguous()
        r, ns = st.radius, min(st.nsample, xyz.shape[1])
        cases = [(new_xyz, "")]
        if st is stages[1]:
            far = new_xyz.clone()
            far[0, 0] = 50.0
            cases.append((far, ", one empty ball"))
        for qc, note in cases:
            got, gi = sg_fused.select_gather_kernel(r, ns, xyz, qc, base)
            want, wi = sg_fused.select_gather_plain(r, ns, xyz, qc, base)
            line = (f"K10 select-gather N={xyz.shape[1]} S={qc.shape[1]} K={ns} "
                    f"C={base.shape[2]}{note}: ")
            if not (torch.equal(gi, wi) and torch.equal(got, want)):
                raise AssertionError(line + "differs from the plain version")
            if note:
                if not (gi[0, 0] == xyz.shape[1] - 1).all():
                    raise AssertionError(line + "the empty ball did not select N - 1")
                print(line + "equal indices and values")
                continue
            _record(rec, "select_gather", 0.0,
                    _time_ms(lambda: sg_fused.select_gather_kernel(r, ns, xyz, qc, base), 10, dev),
                    _time_ms(lambda: sg_fused.select_gather_plain(r, ns, xyz, qc, base), 3, dev),
                    line + "equal indices and values",
                    _nbytes(xyz, qc, base, got, gi),
                    DIST_OPS * _ball_scan(r, ns, xyz, qc) + 3 * gi.numel())
        del got, want
        xyz = new_xyz

    # K11 both ways on (batch, N, 3): the loss's x0 and target
    x = torch.randn(batch, N, 3, generator=g, device=dev)
    y = 0.3 * torch.randn(batch, N, 3, generator=g, device=dev)
    for a, b, name in ((x, y, "x0 -> target"), (y, x, "target -> x0")):
        gm, ga = chamfer.directed_nn_kernel(a, b)
        wm, wa = chamfer.directed_nn_plain(a, b)
        err = (gm - wm).abs().max().item()
        if not torch.equal(ga, wa) or err > CHAMFER_ATOL:
            raise AssertionError(f"chamfer {name}: indices differ or error {err}")
        _record(rec, "chamfer_nn", err,
                _time_ms(lambda: chamfer.directed_nn_kernel(a, b), 20, dev),
                _time_ms(lambda: chamfer.directed_nn_plain(a, b), 5, dev),
                f"K11 nearest neighbour {name} ({batch},{N},3): equal indices, "
                f"max error {err:.3g}", _nbytes(a, b, gm, ga),
                (DIST_OPS + 2) * batch * N * b.shape[1])
    return rec


def train_step_check(dev, cfg, label: str, chamfer_impl: str = "xla",
                     batch: int = TRAIN_BATCH, T: int = T_STEPS, **impls):
    """Phase 8, one configuration: a train step at ``batch`` scenes through
    the kernels and through the plain versions, from the same weights, t,
    noise and dropout keep-mask.  Returns (launch counts of the kernel
    step, {loss, grad, param} errors, ms per kernel step over TRAIN_STEPS
    steps after the compared one, peak GiB of the kernel steps)."""
    import torch

    from lsdm_tpu_torch import kernels
    from lsdm_tpu_torch.diffusion.schedule import make_schedule
    from lsdm_tpu_torch.profile_train import build, seeded_batch
    from lsdm_tpu_torch.train.trainer import make_train_step

    inputs = seeded_batch(cfg, batch, SEED, dev)
    schedule = make_schedule("cosine", T, device=dev)
    step = make_train_step(schedule, chamfer_impl=chamfer_impl)
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    draws = dict(
        t=torch.randint(0, T, (batch,), generator=g, device=dev),
        noise=torch.randn(batch, cfg.pcd_points, 3, generator=g, device=dev),
        dropout_mask=torch.rand(batch * cfg.max_objs, cfg.pcd_points, 128,
                                generator=g, device=dev) < 0.5)

    def run(state):
        metrics = step(state, *inputs, **draws)
        grads = {n: p.grad.detach().clone() for n, p in state.model.named_parameters()}
        params = {n: p.detach().clone() for n, p in state.model.named_parameters()}
        return float(metrics["loss"]), grads, params

    cfg = dataclasses.replace(cfg, **impls)
    kstate, pstate = (build(cfg, cfg.ball_impl, cfg.attn_impl, SEED, dev)
                      for _ in range(2))
    _sync(dev)
    kernels.reset_launches()
    loss_k, grads_k, params_k = run(kstate)
    _sync(dev)
    launches = dict(kernels.LAUNCHES)
    with plain_versions():
        kernels.reset_launches()
        loss_p, grads_p, params_p = run(pstate)
        if any(kernels.LAUNCHES.values()):
            raise AssertionError(f"the plain train step launched kernels: {kernels.LAUNCHES}")
    del pstate
    if not all(torch.isfinite(t).all() for t in grads_k.values()):
        raise AssertionError(f"{label}: non-finite gradients")
    grad_err, param_err, noise = 0.0, 0.0, 0
    floor = 1e-3 * max(g.abs().max().item() for g in grads_p.values())
    for n, gp in grads_p.items():
        scale = gp.abs().max().item()
        # a leaf whose gradient is rounding noise (a conv bias ahead of a
        # train-mode BatchNorm: ~1e-14) is held to 1e-3 of the largest
        grad_err = max(grad_err, (grads_k[n] - gp).abs().max().item() / max(scale, floor))
        real = gp.abs() > 1e-4 * scale  # not rounding noise
        noise += int((~real).sum())
        if real.any():
            param_err = max(param_err, (params_k[n] - params_p[n])[real].abs().max().item())
    errs = {"loss": abs(loss_k - loss_p) / abs(loss_p), "grad": grad_err,
            "param": param_err}
    peak = _reset_peak(dev)
    sec = []
    for _ in range(TRAIN_STEPS):
        _sync(dev)
        t0 = time.perf_counter()
        step(kstate, *inputs, generator=g)
        _sync(dev)
        sec.append(time.perf_counter() - t0)
    ms = [x * 1e3 for x in sec]
    print(f"train step {label} B={batch} ({batch * cfg.max_objs} clouds of "
          f"{cfg.pcd_points}): loss {loss_k:.6f} (plain {loss_p:.6f}); errors "
          f"{errs} (tolerances loss {TRAIN_LOSS_RTOL}, grad {TRAIN_GRAD_RTOL}, "
          f"param {TRAIN_PARAM_ATOL}; {noise} gradient entries below 1e-4 of "
          f"their leaf's max left out of the parameter check); step ms "
          f"{[round(x, 3) for x in ms]}; peak {peak():.2f} GiB; launches {launches}")
    return launches, errs, ms, peak()


def train_cli_phase(dev, points: int = 1024, T: int = T_STEPS) -> dict:
    """Phase 9: the port's train_sdm on a synthetic proxd split (12 train
    sequences: 2 steps of batch 6; 2 validation sequences), one epoch with
    validation, then ``final.pt`` read back.  Returns the launch counts."""
    import torch

    from lsdm_tpu_torch import kernels
    from lsdm_tpu_torch.checkpoint import load_torch_checkpoint
    from lsdm_tpu_torch.data.synthetic import generate
    from lsdm_tpu_torch.models.sdm import SceneDiffusionModel
    from lsdm_tpu_torch.run import train_sdm

    with tempfile.TemporaryDirectory() as root:
        train = generate(root, "proxd", n_scenes=2, n_seqs=12, pnt_size=points,
                         seed=SEED, split="train")
        valid = generate(root, "proxd", n_scenes=2, n_seqs=2, pnt_size=points,
                         seed=SEED + 1, split="valid")
        out = os.path.join(root, "out")
        kernels.reset_launches()
        t0 = time.perf_counter()
        state = train_sdm.main([
            "--train_data_dir", train, "--valid_data_dir", valid,
            "--objs_data_dir", os.path.join(root, "objs"), "--save_dir", out,
            "--epochs", "1", "--eval_every", "1", "--diffusion_steps", str(T),
            "--pcd_points", str(points), "--device", str(dev)])
        sec = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        names = sorted(f for f in os.listdir(out) if f.endswith(".pt"))
        if names != ["best_model_cfd.pt", "best_model_train_loss.pt",
                     "epoch_0000.pt", "final.pt"]:
            raise AssertionError(f"checkpoints written: {names}")
        back = SceneDiffusionModel(state.model.cfg)
        extra = load_torch_checkpoint(os.path.join(out, "final.pt"), back)
        for n, t in state.model.state_dict().items():
            if not torch.equal(back.state_dict()[n], t.cpu()):
                raise AssertionError(f"final.pt: {n} differs from the trained model")
        with open(os.path.join(out, "logs", "events.jsonl")) as f:
            logged = {k for line in f for k in json.loads(line) if "/" in k}
        if not {"train/loss", "valid/cfd"} <= logged:
            raise AssertionError(f"logged {sorted(logged)}")
    print(f"CLI train_sdm, 12 synthetic sequences of {points} points, batch 6, "
          f"1 epoch + validation (T={T}) on {dev}: {sec:.1f} s; {state.step} "
          f"steps; final.pt read back equal ({extra}); launches {launches}")
    return launches


def full_path(dev, cfg, model, plain, T: int = T_STEPS):
    """Phase 4: one batch-1 sample through the kernels and one through the
    plain path, same draws.  Returns (launch counts of the kernel run,
    max |kernel - plain| per output, seconds of each run, peak GiB of the
    kernel run)."""
    import torch

    from lsdm_tpu_torch import kernels
    from lsdm_tpu_torch.diffusion.schedule import make_schedule
    from lsdm_tpu_torch.models.sampling import resolve_fast_path, sample_sdm
    from lsdm_tpu_torch.profile_sampling import seeded_inputs

    _, fused_step = resolve_fast_path("pallas", None, dev)
    B, N = 1, cfg.pcd_points
    mask, objs, cats, text, x_init, noise = seeded_inputs(cfg, B, T, SEED, dev)
    schedule = make_schedule("cosine", T, device=dev)

    def run(m, step):
        _sync(dev)
        t0 = time.perf_counter()
        out = sample_sdm(m, schedule, mask, objs, cats, text, fused_step=step,
                         x_init=x_init, noise=noise)
        _sync(dev)
        return out, time.perf_counter() - t0

    run(model, fused_step)  # warm-up
    peak = _reset_peak(dev)
    kernels.reset_launches()
    (s_k, o_k), sec_k = run(model, fused_step)
    launches = dict(kernels.LAUNCHES)
    peak = peak()
    run(plain, None)  # warm-up
    (s_p, o_p), sec_p = run(plain, None)
    if s_k.shape != (B, N, 3) or not torch.isfinite(s_k).all():
        raise AssertionError(f"kernel-path sample is not a finite {(B, N, 3)} cloud")
    errs = {"sample": (s_k - s_p).abs().max().item(),
            "x0": (o_k.x0 - o_p.x0).abs().max().item(),
            "guiding": (o_k.guiding - o_p.guiding).abs().max().item(),
            "cat": (o_k.cat - o_p.cat).abs().max().item()}
    return launches, errs, (sec_k, sec_p), peak


def _reset_peak(dev):
    """Reset the device's peak-memory count; returns a function that reads
    it in GiB (nan off the card)."""
    import torch

    if dev.type != "cuda":
        return lambda: float("nan")
    torch.cuda.reset_peak_memory_stats(dev)
    return lambda: torch.cuda.max_memory_allocated(dev) / 2 ** 30


def fused_path(dev, cfg, model, composed, T: int = T_STEPS):
    """Phase 5: the configuration ``resolve_fast_path`` gives on CUDA, one
    batch-1 sample through the kernels and one through the plain versions
    of the same configuration, same draws; and the fused encode against the
    composed encode of ``composed`` (same weights, ``ball_impl="pallas"``).
    Returns (launch counts of the kernel run, max |kernel - plain| per
    output, the cond_pcd check's worst |a - b| / (atol + rtol |b|),
    (seconds of each run), peak GiB of the kernel run)."""
    import torch

    from lsdm_tpu_torch import kernels
    from lsdm_tpu_torch.diffusion.schedule import make_schedule
    from lsdm_tpu_torch.models.sampling import sample_sdm
    from lsdm_tpu_torch.profile_sampling import seeded_inputs

    B, N = 1, cfg.pcd_points
    mask, objs, cats, text, x_init, noise = seeded_inputs(cfg, B, T, SEED, dev)
    schedule = make_schedule("cosine", T, device=dev)

    def run():
        _sync(dev)
        t0 = time.perf_counter()
        out = sample_sdm(model, schedule, mask, objs, cats, text,
                         fused_step="chain", x_init=x_init, noise=noise)
        _sync(dev)
        return out, time.perf_counter() - t0

    run()  # warm-up
    peak = _reset_peak(dev)
    kernels.reset_launches()
    (s_k, o_k), sec_k = run()
    launches = dict(kernels.LAUNCHES)
    peak = peak()
    with plain_versions():
        run()  # warm-up
        kernels.reset_launches()
        (s_p, o_p), sec_p = run()
        if any(kernels.LAUNCHES.values()):
            raise AssertionError(f"the plain run launched kernels: {kernels.LAUNCHES}")
    if s_k.shape != (B, N, 3) or not torch.isfinite(s_k).all():
        raise AssertionError(f"fused-path sample is not a finite {(B, N, 3)} cloud")
    errs = {"sample": (s_k - s_p).abs().max().item(),
            "x0": (o_k.x0 - o_p.x0).abs().max().item(),
            "guiding": (o_k.guiding - o_p.guiding).abs().max().item(),
            "cat": (o_k.cat - o_p.cat).abs().max().item()}
    with torch.no_grad():
        fused = model.encode_conditioning(mask, objs, cats, text).cond_pcd
        ref = composed.encode_conditioning(mask, objs, cats, text).cond_pcd
    cond = ((fused - ref).abs() / (COND_ATOL + COND_RTOL * ref.abs())).max().item()
    return launches, errs, cond, (sec_k, sec_p), peak


def cli_phase(dev, points: int = 1024, T: int = T_STEPS) -> dict:
    """Phase 6: the port's test_sdm on a synthetic proxd test split of 4
    sequences of ``points`` points, batch 2.  Returns the launch counts of
    the run."""
    import numpy as np

    from lsdm_tpu_torch import kernels
    from lsdm_tpu_torch.data.synthetic import generate
    from lsdm_tpu_torch.run import test_sdm

    with tempfile.TemporaryDirectory() as root:
        data = generate(root, "proxd", n_scenes=1, n_seqs=4, pnt_size=points,
                        seed=SEED, split="test")
        out = os.path.join(root, "out")
        kernels.reset_launches()
        t0 = time.perf_counter()
        final = test_sdm.main([data, "--objs_data_dir", os.path.join(root, "objs"),
                               "--output_dir", out, "--batch_size", "2",
                               "--diffusion_steps", str(T), "--pcd_points",
                               str(points), "--device", str(dev)])
        sec = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        with open(os.path.join(out, "results.txt")) as f:
            tail = [line.split(":")[0] for line in f.read().splitlines()[-5:]]
        if tail != ["Final Chamfer distance", "Final EMD", "Final F1 score",
                    "Category accuracy", "Top 3 accuracy"]:
            raise AssertionError(f"results.txt ends in {tail}")
        for sub in ("predictions", "guiding_points"):
            names = sorted(os.listdir(os.path.join(out, sub)))
            if len(names) != 4:
                raise AssertionError(f"{sub}: {len(names)} files, not 4")
            for name in names:
                a = np.load(os.path.join(out, sub, name))
                if a.shape != (points, 3) or a.dtype != np.float32 or not np.isfinite(a).all():
                    raise AssertionError(f"{sub}/{name}: not a finite ({points}, 3) "
                                         "float32 array")
    print(f"CLI test_sdm, 4 synthetic sequences, batch 2, T={T}: {final}; "
          f"{sec:.1f} s; launches {launches}")
    return launches


def _check_launches(path: str, launches: dict) -> None:
    for name in PATH_KERNELS[path]:
        if launches[name] < 1:
            raise AssertionError(f"kernel {name} was not launched on the {path} path")
    if path == "fused" and launches["ball_query"] + launches["three_nn"]:
        raise AssertionError(f"the fused path ran K1/K2: {launches}")
    if path == "train_sg" and launches["ball_query"]:
        raise AssertionError(f"the sg train step ran K1: {launches}")


def build_models(cfg, dev):
    """The seeded model on the kernel path, and a copy forced onto the
    plain selection versions."""
    from lsdm_tpu_torch.models.sdm import SceneDiffusionModel
    from lsdm_tpu_torch.weights import init_weights

    model = init_weights(SceneDiffusionModel(cfg), SEED).to(dev).eval()
    plain = SceneDiffusionModel(dataclasses.replace(cfg, ball_impl="topk"))
    plain.load_state_dict(model.state_dict())
    return model, plain.to(dev).eval()


def build_fused(cfg, model, dev):
    """``model``'s weights in the configuration that ``resolve_fast_path``
    gives on ``dev``."""
    from lsdm_tpu_torch.models.sampling import resolve_fast_path
    from lsdm_tpu_torch.models.sdm import SceneDiffusionModel

    ball_impl, _ = resolve_fast_path("auto", None, dev)
    fused = SceneDiffusionModel(dataclasses.replace(cfg, ball_impl=ball_impl))
    fused.load_state_dict(model.state_dict())
    return fused.to(dev).eval()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from lsdm_tpu_torch import kernels
    from lsdm_tpu_torch.config import sdm_proxd

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(_card())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    kernels.load()
    print(f"build: kernels built and loaded in {time.perf_counter() - t0:.1f} s")

    cfg = sdm_proxd()  # ball_impl "auto": the kernels, for CUDA tensors
    model, plain = build_models(cfg, dev)
    records = kernel_checks(dev, model)

    launches = {}
    path_launches, errs, (sec_k, sec_p), peak = full_path(dev, cfg, model, plain)
    print(f"pallas path sdm_proxd B=1 9x{cfg.pcd_points} T={T_STEPS}: launches "
          f"{path_launches}; max |kernel - plain| {errs} (tolerance {CHAIN_ATOL})")
    _check_launches("pallas", path_launches)
    launches["pallas"] = path_launches
    if max(errs.values()) > CHAIN_ATOL:
        raise AssertionError("pallas path disagrees with the plain path")
    ms, peaks = {"pallas": sec_k * 1e3}, {"pallas": peak}
    for label, sec in (("pallas path, kernels", sec_k), ("pallas path, plain", sec_p)):
        print(f"{label}: {sec * 1e3:.1f} ms/scene, {T_STEPS / sec:.1f} steps/s")

    fused = build_fused(cfg, model, dev)
    path_launches, errs, cond, (sec_k, sec_p), peak = fused_path(dev, cfg, fused, model)
    print(f"fused path sdm_proxd B=1 9x{cfg.pcd_points} T={T_STEPS}: launches "
          f"{path_launches}; max |kernel - plain| {errs} (tolerance {FUSED_ATOL}); "
          f"fused vs composed cond_pcd: worst |a - b| / ({COND_ATOL} + {COND_RTOL} |b|) "
          f"= {cond:.3g} (must be <= 1)")
    _check_launches("fused", path_launches)
    launches["fused"] = path_launches
    if max(errs.values()) > FUSED_ATOL:
        raise AssertionError("fused path disagrees with its plain versions")
    if cond > 1.0:
        raise AssertionError("fused encode disagrees with the composed encode")
    ms["fused"], peaks["fused"] = sec_k * 1e3, peak
    for label, sec in (("fused path, kernels", sec_k), ("fused path, plain", sec_p)):
        print(f"{label}: {sec * 1e3:.1f} ms/scene, {T_STEPS / sec:.1f} steps/s")
    for path in ("pallas", "fused"):
        print(f"kernel path {path} at b1: {ms[path]:.1f} ms/scene, peak memory "
              f"{peaks[path]:.2f} GiB")

    _check_launches("fused", cli_phase(dev))

    from lsdm_tpu_torch.models.sampling import resolve_train_attn_impl

    records.update(train_kernel_checks(dev, model))
    del model, plain, fused
    # ball_impl "auto": the selection kernels K1, K2, K3
    train_cfg = dataclasses.replace(
        cfg, attn_impl=resolve_train_attn_impl("auto", dev))
    for path, label, chamfer_impl, impls in (
            ("train", "default", "xla", {}),
            ("train_sg", "ball_impl=sg", "xla", {"ball_impl": "sg"}),
            ("train_chamfer", "chamfer_impl=pallas", "pallas", {})):
        step_launches, errs, step_ms, peak = train_step_check(
            dev, train_cfg, label, chamfer_impl, **impls)
        _check_launches(path, step_launches)
        launches[path] = step_launches
        if (errs["loss"] > TRAIN_LOSS_RTOL or errs["grad"] > TRAIN_GRAD_RTOL
                or errs["param"] > TRAIN_PARAM_ATOL):
            raise AssertionError(f"train step {label} disagrees with its plain versions")
        print(f"train step {label} at B={TRAIN_BATCH}: {min(step_ms):.1f} ms/step, "
              f"{TRAIN_BATCH * 1e3 / min(step_ms):.1f} scenes/s, peak memory "
              f"{peak:.2f} GiB")
    _check_launches("train_cli", train_cli_phase(dev))

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "path": path, "launches": launches[path][name],
         **_kernel_record(records[name])}
        for name, (src, rep, path) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

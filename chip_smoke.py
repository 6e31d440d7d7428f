#!/usr/bin/env python3
"""Smoke test of lsdm_tpu_torch on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

1. Requires a CUDA device and prints its name and power limit.
2. Builds the CUDA kernels from ``lsdm_tpu_torch/csrc`` (nvcc, sm_90a, one
   nvcc per source, in parallel).
3. Holds each kernel against its plain PyTorch version on the card at the
   shapes of the flagship sampling paths: ball query (K1), 3-NN (K2) and
   FPS (K3, from index 0 with no start tensor, as the SDM calls it) must
   give equal indices, and that FPS call must capture into a CUDA graph
   (no host sync); the fused SA stage (K7, sa1-sa4 and a
   center with an empty ball) and FP stage (K8, fp4-fp1 with the head)
   must agree to STAGE_ATOL, the rank-1 attention (K4) to ATTN_ATOL and
   its row denominators (kept by the training forward) to ATTN_DEN_RTOL; the
   denoise chain (K6, N=1024, D=128, T=1000) to CHAIN_ATOL at batch 1 and,
   clip on, at batch CHAIN_BATCH, and its first pass's tables to
   TABLE_ATOL.  Prints both times and each kernel's bound: the least time
   the card could take for the call's work, the largest of its bytes over
   HBM_BYTES_PER_S, its float32 operations over FP32_OPS_PER_S (for the
   distance kernels K1-K3, K10 and K11, whose products and sums are rounded
   on their own, its issued float32 instructions over FP32_INSTR_PER_S:
   DIST_INSTRS or FPS_DIST_INSTRS a pair) and its exponentials over
   SFU_EXPS_PER_S (K4, K5); K1-K5 are timed queued behind a sleep on the
   card, K4 beside SDPA's forward; K6's time also split into its
   two passes, each beside its bound, pass 1 (``denoise_tables.cu``) also
   as TFLOP/s, as a share of the FP32 peak, and beside its cuBLAS
   yardstick (its four products as ``torch.baddbmm`` calls, TF32 off).
   K7 and K8 are held and timed per stage at b1 (9 clouds) and b8 (72
   clouds), queued behind a sleep on the card: the kernel alone (K7
   without its wrapper's layer-1 matmul) and the wrapper, each stage with
   its launch plan (``ops/rowmlp.py``), bound, TFLOP/s and FP32 share on
   its layers; the ``kernels`` line carries them as ``stages_b1`` /
   ``stages_b8`` and their sums.
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
7. The one-step denoise kernel K9 against its plain version at N=1024,
   D=128, batch 1 and 8, clip off and on, to STEP_ATOL; its time per
   launch is taken with the launches queued behind a sleep on the card,
   so that the host's pace between them does not count (the host-paced
   time and the host's own time per call are printed beside it).
8. The "step" path: ``sdm_proxd()`` at full width, batch 1, T=1000,
   ``ball_impl="fused"``, ``fused_step="step"`` (K9 once per step from
   the host): through the kernels and through the plain versions with the
   same draws (FUSED_ATOL), and against the chain path with the same draws
   (CHAIN_ATOL); K9 launched T times and K6 never.  Prints ms/scene and
   peak memory.
9. ``test_sdm --fused_step step`` on the synthetic split, and
   ``lsdm_tpu_torch.run.scene_edit`` on a synthetic proxd test split (2
   sequences x 1024 points, T=1000) whose prompts hit the keyword table:
   checks the output files, the ICP lines and that K1, K2, K3 (the
   composed encode) and K11 (the ICP's nearest neighbours) ran.  Then the
   ICP alone: K11 against its plain version at the ICP's shapes (64 tries
   of 1024 points against the 1024-point target), and a 64-try ICP from
   fixed rotations through the kernels and through the plain versions,
   agreeing to ICP_ATOL with equal inlier counts.
10. The training kernels at the train step's shapes (batch 6 = 54 clouds
   of 1024 points): the rank-1 attention forward (K4, with the row
   denominators the training forward keeps) to ATTN_ATOL and
   ATTN_DEN_RTOL with SDPA's forward timed beside it, and its backward
   (K5, from K4's saved row denominators) to ATTN_BWD_ATOL, also with k
   and v offset by +8, with SDPA's backward timed beside it; K3, K1 and K2
   at the stages' shapes (equal indices); K1-K4 timed queued (the
   ``train_b6`` field of their records); the select-gather (K10, sa1-sa4
   and an empty ball) and the chamfer nearest neighbour (K11, each way)
   equal to their plain versions.
11. The train step of ``sdm_proxd()`` at batch 6 (fp32, T=1000, seeded
   weights and batch) in the configuration ``train_sdm`` runs by default
   on CUDA (K1-K5), with ``ball_impl="sg"`` (K10) and with the K11 chamfer:
   each through the kernels and through the plain versions from the same
   weights, t, noise and dropout keep-mask, agreeing in the loss, the
   gradients and the parameters after one AdamW step; prints ms/step and
   peak memory.
12. ``lsdm_tpu_torch.run.train_sdm`` on a synthetic split (one epoch of
   two steps, validation on the fused path), its ``final.pt`` read back.
13. Prints one JSON line of kernel records, then, as its last line,
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
CHAIN_BATCH = 8   # K6 is also checked and timed at this batch, clip on
# K2 distances: kernel and plain version round the same float32 ops.
DIST_ATOL = 1e-6
# K7 and K8 on outputs of order 1: the same selection (equal distance
# bits), float32 sums of up to 768 products in another order (FMA chains
# against cuBLAS).  H100 readings: K7 <= 4.2e-07, K8 <= 6.0e-07.
STAGE_ATOL = 2e-6
# K4: the kernel's one SFU exponential a pair and its shallow sum tree
# over 1024 keys (4 keys a thread, the warp, 8 warps) against the plain
# version's rounded weights and its 1024-term products.  H100 readings
# 4.8e-07 at 9 clouds and 6.0e-07 at 54; the compensated sums of the
# kernel before it read 7.2e-07 at 9, which is the plain version's own
# rounding (7.3e-07 from a float64 evaluation on the CPU).
ATTN_ATOL = 1e-6
# K4's row denominators (the training forward keeps them for K5): sums of
# 1024 exponentials against torch's sum of its own exp.  H100 readings
# 3.0e-07 at 9 clouds and 4.5e-07 at 54 (the compensated sums: 2.5e-07).
ATTN_DEN_RTOL = 1e-6
# The fused path's sample against the plain versions of the same
# configuration: the encode's rounding differences pass through T steps.
# H100 reading 1.3e-07.
FUSED_ATOL = 1e-6
# The fused encode against the composed one: the JAX package's own bound
# (tests/test_sdm_model.py), BatchNorm folded against applied.
COND_RTOL, COND_ATOL = 2e-4, 2e-5
# K5 on (54, 1024, 12): one SFU exponential a pair and sums in groups of
# 32 rows, against the plain version's rounded weights and its reductions
# in another order; q k - m and g v - D rounded as the plain version rounds
# them.  H100 readings 4.3e-06 from K4's denominators (3.8e-06 from those
# of the compensated K4 before it), and 5.6e-06 with k and v offset by +8
# (2.9e-06 for the compensated two-pass kernel before it).
ATTN_BWD_ATOL = 1e-5
# K11's minimum distances: the same float32 operations as the plain version
CHAMFER_ATOL = 0.0
# scene_edit's multi-start ICP, through K11 and through its plain version
# from the same rotations: equal correspondences, then the same torch ops
# on the same inputs, so the transformations differ by nothing but the
# batched SVD's own run-to-run rounding.  H100 reading: 0, equal inliers.
ICP_TRIES, ICP_ITERS = 64, 30  # scene_edit's --icp_tries and icp's iters
ICP_ATOL = 1e-6
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
# K9 against its plain version, one step: float32 sums in another order
# (FMA loops against cuBLAS) and erff against torch's erf.  H100 reading
# 2.4e-07 at b1 and b8, clip off and on.
STEP_ATOL = 1e-6
STEP_REPS = 200  # launches timed per K9 case
ENCODE_REPS = 50  # launches timed per K7 / K8 stage
QUEUED_REPS = 20  # launches timed queued behind a sleep per K1-K5 call
# H100 SXM peaks (NVIDIA's data sheet, dense, at the 700 W limit): HBM
# bytes per second and float32 operations per second outside the tensor
# cores.  A kernel's bound counts each input byte read once and each output
# byte written once, and one operation per float32 add, multiply, compare
# or exp that its function needs on this run's data.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# exponentials a second on the special-function units: 16 a clock per SM
# (NVIDIA's CUDA C++ Programming Guide, arithmetic-instruction throughput
# for compute capability 9.0) on 132 SMs at the 1.98 GHz that the FP32
# peak above assumes.  A kernel whose function takes n exponentials cannot
# take less than n / SFU_EXPS_PER_S, whatever its other operations.
SFU_EXPS_PER_S = 132 * 16 * 1.98e9
# float32 instructions a second outside the tensor cores: 128 lanes a clock
# per SM on 132 SMs at 1.98 GHz, half of FP32_OPS_PER_S, which counts an FMA
# as two operations.  The distance kernels round every product and sum on
# its own, as the plain versions do, so few of their operations fuse: their
# bound counts the float32 instructions a pair must issue at this rate.
FP32_INSTR_PER_S = 132 * 128 * 1.98e9
# (-2 (q.x) + |q|^2) + |x|^2 (pointdist.cuh's sq_dist; K11's
# (|q|^2 + |x|^2) - 2 (q.x) alike) and its compare: 3 multiplies and 2 adds
# for the dot product, one FMA for -2 (q.x) + |q|^2 (a product by -2 is
# exact, so the FMA gives the separately rounded bits), the add of |x|^2
# and the compare; the norms are taken once a point, not once a pair.
DIST_INSTRS = 8
# FPS's (x - c)^2 form: 3 subtracts, 3 multiplies, 2 adds, the running
# minimum and the compare of the round's argmax.
FPS_DIST_INSTRS = 10
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
    "denoise_step": ("lsdm_tpu_torch/csrc/denoise_step.cu",
                     "lsdm_tpu/ops/denoise_pallas.py:173", "step"),
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
                              "denoise_chain"),
                # the fused encode, then K9 once per step
                "step": ("fps", "sa_fused", "fp_fused", "rank1_attn",
                         "denoise_step"),
                # the composed encode over the selection kernels, the
                # composed loop; K11 in the ICP
                "scene_edit": ("ball_query", "three_nn", "fps", "chamfer_nn")}
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
    ("lsdm_tpu_torch.ops.icp", "directed_nn_kernel",
     "lsdm_tpu_torch.ops.chamfer", "directed_nn_plain"),
    ("lsdm_tpu_torch.models.sampling", "fused_denoise_chain",
     "lsdm_tpu_torch.ops.denoise", "denoise_chain_plain"),
    ("lsdm_tpu_torch.models.sampling", "make_denoise_step",
     "lsdm_tpu_torch.ops.denoise", "make_denoise_step_plain"),
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


def _time_queued_ms(fn, reps: int, dev):
    """(device ms, host ms) per call of fn(), queued behind a sleep on the
    card (``profile_encode.time_queued_ms``); off the card, the
    synchronised host clock for both."""
    if dev.type != "cuda":
        ms = _time_ms(fn, reps, dev)
        return ms, ms
    from lsdm_tpu_torch.profile_encode import time_queued_ms

    return time_queued_ms(fn, reps, dev)


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
    # every module imported before any name is swapped: a module imported
    # in the block would bind the plain version for good
    swaps = [(importlib.import_module(mod), name,
              getattr(importlib.import_module(pmod), pname))
             for mod, name, pmod, pname in PLAIN_VERSIONS]
    saved = [(m, name, getattr(m, name)) for m, name, _ in swaps]
    for m, name, fn in swaps:
        setattr(m, name, fn)
    try:
        yield
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


def _record(rec, name, err, ms, pms, line, nbytes, ops, lib_ms=None, exps=0,
            instrs=False):
    """Add one call of kernel ``name`` to ``rec``: its error, its and its
    plain version's time, and the least time the card could take for the
    call's work (``nbytes`` moved, ``ops`` float32 operations, of which
    ``exps`` exponentials, which also bound it on the SFUs).  ``instrs``:
    ``ops`` counts issued float32 instructions, at FP32_INSTR_PER_S."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = max(ops / (FP32_INSTR_PER_S if instrs else FP32_OPS_PER_S),
                 exps / SFU_EXPS_PER_S) * 1e3
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


def encode_stage_checks(dev, model, levels, g, rec=None) -> list:
    """K7 at sa1-sa4 and K8 at fp4-fp1 (fp1 with the head and conv2) at
    the stages' widths on these point levels (``profile_encode``): each
    against its plain version (STAGE_ATOL), then timed queued behind a
    sleep, so the host's pace does not count: the kernel alone (K7's launch
    after its layer-1 matmul; K8's wrapper, which runs nothing else on the
    card) and the wrapper (K7's with its matmul ``Z1 = base @ W1' + b1'``).
    With ``rec`` (batch 1) each stage is also recorded with its plain
    version's time and sa2 is checked with a centre whose ball is empty.
    Returns a record a stage: its launch plan, times, bound, TFLOP/s and
    FP32 share on its layers (2..L of an SA stage, all of an FP stage)."""
    import torch

    from lsdm_tpu_torch.ops import ballquery, fp_fused, rowmlp, sa_fused
    from lsdm_tpu_torch.profile_encode import stage_cases

    stages = []
    for case in stage_cases(model.pcd_backbone, levels, g):
        args = case["args"]
        if case["kind"] == "sa":
            r, ns, xyz, q, base, folded = args
            name = "sa_fused"
            wrapper = lambda: sa_fused.sa_stage_fused_kernel(*args)
            plain = lambda: sa_fused.sa_stage_fused_plain(*args)
            w1, b1 = folded[0]
            z1, w1x = torch.matmul(base, w1) + b1, w1[:3].contiguous()
            widths = tuple(w.shape[1] for w, _ in folded)
            alone = lambda: sa_fused.sa_stage_launch(r, ns, xyz, q, z1, w1x,
                                                     folded, widths)
            if dev.type != "cuda":  # a rehearsal: the launch needs the card
                alone = wrapper
            plan = rowmlp.plan_sa(xyz.shape[0], xyz.shape[1], q.shape[1], ns,
                                  widths)
        else:
            xyz1, xyz2, p1, p2, folded, acts = args
            name = "fp_fused"
            wrapper = alone = lambda: fp_fused.fp_stage_fused_kernel(*args)
            plain = lambda: fp_fused.fp_stage_fused_plain(*args)
            plan = rowmlp.plan_fp(xyz1.shape[0], xyz1.shape[1], xyz2.shape[1],
                                  (folded[0][0].shape[0],
                                   *(w.shape[1] for w, _ in folded)))
        got, want = wrapper(), plain()
        err = (got - want).abs().max().item()
        clouds = got.shape[0]
        line = (f"{'K7 fused SA' if case['kind'] == 'sa' else 'K8 fused FP'} "
                f"{case['name']} {clouds} clouds {case['desc']}: max error "
                f"{err:.3g} (tolerance {STAGE_ATOL})")
        if not (torch.isfinite(got).all() and err <= STAGE_ATOL):
            raise AssertionError(line)
        if not torch.equal(alone(), got):
            raise AssertionError(f"{line}: the launch alone differs from the wrapper")
        kernel_ms = _time_queued_ms(alone, ENCODE_REPS, dev)[0]
        wrapper_ms = (kernel_ms if alone is wrapper
                      else _time_queued_ms(wrapper, ENCODE_REPS, dev)[0])
        bound = max(case["nbytes"] / HBM_BYTES_PER_S, case["ops"] / FP32_OPS_PER_S) * 1e3
        tflops = case["layer_flops"] / kernel_ms / 1e9
        st = {"kernel": name, "stage": case["name"], "clouds": clouds,
              "blocks": plan.blocks, "cluster": plan.cluster, "rows": plan.rows,
              "smem": plan.smem, "kernel_ms": kernel_ms, "wrapper_ms": wrapper_ms,
              "bound_ms": bound, "tflops": tflops,
              "fp32_share": tflops * 1e12 / FP32_OPS_PER_S}
        stages.append(st)
        detail = (f"{plan.blocks} blocks (cluster {plan.cluster}, {plan.rows} "
                  f"rows, {plan.smem} B), kernel alone {kernel_ms:.4f} ms "
                  f"queued, {tflops:.2f} TFLOP/s on its layers "
                  f"({st['fp32_share']:.3f} of FP32)")
        if rec is None:
            print(f"{line}; {detail}; wrapper {wrapper_ms:.4f} ms queued, "
                  f"bound {bound:.4f} ms")
            continue
        _record(rec, name, err, wrapper_ms, _time_ms(plain, 5, dev),
                f"{line}; {detail}; wrapper queued", case["nbytes"], case["ops"])
        if case["name"] == "sa2":  # a center far from the cloud: an empty ball
            far = q.clone()
            far[0, 0] = 50.0
            got = sa_fused.sa_stage_fused_kernel(r, ns, xyz, far, base, folded)
            err = (got - sa_fused.sa_stage_fused_plain(r, ns, xyz, far, base, folded)
                   ).abs().max().item()
            if not (torch.isfinite(got).all() and err <= STAGE_ATOL):
                raise AssertionError(f"K7 sa2 with an empty ball: max error {err}")
            if not (ballquery.query_ball_point_plain(r, ns, xyz, far, empty=0)[0, 0] == 0).all():
                raise AssertionError("the empty ball did not select point 0")
            # not a call of the path: its error counts, its time not
            rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], err)
            print(f"K7 fused SA sa2, one empty ball: max error {err:.3g} "
                  f"(tolerance {STAGE_ATOL})")
    return stages


def selection_checks(dev, stages, xyz, rec) -> list:
    """K3 at sa2..sa4 (every cloud from index 0: no start tensor, as the
    SDM calls it), K1 at sa1..sa4 and K2 at fp4..fp1, on the point sets the
    SA stages ``stages`` make of the clouds ``xyz`` (C, N, 3): each equal to
    its plain version, each call's device time queued behind a sleep.  Adds
    the calls to ``rec``; returns the levels [l0, l1 = l0, l2, l3, l4]."""
    import torch

    from lsdm_tpu_torch.ops import ballquery, fps
    from lsdm_tpu_torch.ops.pointcloud import index_points
    from lsdm_tpu_torch.profile_encode import ball_scan

    C = xyz.shape[0]
    levels = [xyz, xyz]  # sa1 keeps all N points (no FPS)
    for st in stages[1:]:  # K3 at sa2..sa4
        pts, npoint = levels[-1], st.npoint
        got = fps.farthest_point_sample_kernel(pts, npoint)
        want = fps.farthest_point_sample_plain(pts, npoint)
        if not torch.equal(got, want):
            raise AssertionError(f"FPS ({C},{pts.shape[1]})->{npoint}: indices differ")
        _record(rec, "fps", 0,
                _time_queued_ms(lambda: fps.farthest_point_sample_kernel(pts, npoint),
                                QUEUED_REPS, dev)[0],
                _time_ms(lambda: fps.farthest_point_sample_plain(pts, npoint), 3, dev),
                f"K3 fps ({C},{pts.shape[1]},3)->{npoint} from index 0: equal indices",
                _nbytes(pts, got), FPS_DIST_INSTRS * C * npoint * pts.shape[1],
                instrs=True)
        levels.append(index_points(pts, want).contiguous())

    for st, pts, new_xyz in zip(stages, levels[:4], levels[1:5]):  # K1 at sa1..sa4
        r, ns = st.radius, min(st.nsample, pts.shape[1])
        got = ballquery.query_ball_point_kernel(r, ns, pts, new_xyz)
        want = ballquery.query_ball_point_plain(r, ns, pts, new_xyz)
        if not torch.equal(got, want):
            raise AssertionError(f"ball query C={C} N={pts.shape[1]} S={new_xyz.shape[1]}: "
                                 "indices differ")
        _record(rec, "ball_query", 0,
                _time_queued_ms(lambda: ballquery.query_ball_point_kernel(
                    r, ns, pts, new_xyz), QUEUED_REPS, dev)[0],
                _time_ms(lambda: ballquery.query_ball_point_plain(r, ns, pts, new_xyz), 5, dev),
                f"K1 ball query C={C} N={pts.shape[1]} S={new_xyz.shape[1]} r={r}: "
                "equal indices",
                _nbytes(pts, new_xyz, got), DIST_INSTRS * ball_scan(r, ns, pts, new_xyz),
                instrs=True)

    for xyz1, xyz2 in zip(levels[3::-1], levels[4:0:-1]):  # K2 at fp4..fp1
        k = min(3, xyz2.shape[1])
        gd, gi = ballquery.three_nn_kernel(xyz1, xyz2, k)
        wd, wi = ballquery.three_nn_plain(xyz1, xyz2, k)
        derr = (gd - wd).abs().max().item()
        if not torch.equal(gi, wi) or derr > DIST_ATOL:
            raise AssertionError(f"3-NN C={C} N={xyz1.shape[1]} S={xyz2.shape[1]}: "
                                 f"indices differ or distance error {derr}")
        _record(rec, "three_nn", derr,
                _time_queued_ms(lambda: ballquery.three_nn_kernel(xyz1, xyz2, k),
                                QUEUED_REPS, dev)[0],
                _time_ms(lambda: ballquery.three_nn_plain(xyz1, xyz2, k), 5, dev),
                f"K2 3-NN C={C} N={xyz1.shape[1]} S={xyz2.shape[1]}: equal indices, "
                f"max distance error {derr:.3g}",
                _nbytes(xyz1, xyz2, gd, gi), (DIST_INSTRS + 1) * C * xyz1.shape[1]
                * xyz2.shape[1], instrs=True)
    return levels


def fps_graph_check(xyz, npoint: int) -> None:
    """The SDM's FPS call (no start tensor) reads nothing back from the
    card, so it captures into a CUDA graph; the replay gives the indices
    of the direct call."""
    import torch

    from lsdm_tpu_torch.ops import fps

    if xyz.device.type != "cuda":
        return  # a CUDA graph needs the card
    want = fps.farthest_point_sample_kernel(xyz, npoint)
    torch.cuda.synchronize(xyz.device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = fps.farthest_point_sample_kernel(xyz, npoint)
    graph.replay()
    torch.cuda.synchronize(xyz.device)
    if not torch.equal(got, want):
        raise AssertionError("FPS replayed from a CUDA graph differs from the direct call")
    print(f"K3 fps {tuple(xyz.shape)}->{npoint} from index 0: captured into a CUDA "
          "graph (no host sync), replay equal")


def rank1_attn_check(dev, rec, q, k, v, denominator: bool = False):
    """K4 on q (C, L, H), k and v (C, S, H) against its plain version: the
    output within ATTN_ATOL, the row denominators within ATTN_DEN_RTOL, and
    the output the same bits with and without them; timed queued behind a
    sleep with ``denominator`` as the path calls it (the training forward
    keeps them), beside SDPA's forward on the same inputs (head_dim 1,
    scale 1) as the library yardstick.  Adds the call to ``rec``; returns
    the kernel's (out, row denominators)."""
    import torch

    from lsdm_tpu_torch.ops import attn

    C, L, H = q.shape
    S = k.shape[1]
    got, den = attn.rank1_mha_kernel(q, k, v, denominator=True)
    want, wden = attn.rank1_mha_plain(q, k, v, denominator=True)
    err = (got - want).abs().max().item()
    if not (torch.isfinite(got).all() and err <= ATTN_ATOL):
        raise AssertionError(f"rank-1 attention ({C},{L},{H}): max error {err} > {ATTN_ATOL}")
    derr = ((den - wden).abs() / wden).max().item()
    if not derr <= ATTN_DEN_RTOL:
        raise AssertionError(f"rank-1 attention ({C},{L},{H}) row denominators: max "
                             f"relative error {derr} > {ATTN_DEN_RTOL}")
    if not torch.equal(attn.rank1_mha_kernel(q, k, v), got):
        raise AssertionError("rank-1 attention: the output moved with the denominators")
    del want, wden
    q4, k4, v4 = (t.transpose(1, 2)[..., None].contiguous() for t in (q, k, v))
    _record(rec, "rank1_attn", err,
            _time_queued_ms(lambda: attn.rank1_mha_kernel(q, k, v, denominator),
                            QUEUED_REPS, dev)[0],
            _time_ms(lambda: attn.rank1_mha_plain(q, k, v, denominator), 3, dev),
            f"K4 rank-1 attention ({C},{L},{H}){' with denominators' * denominator}: "
            f"max error {err:.3g} (tolerance {ATTN_ATOL}); row denominators max "
            f"relative error {derr:.3g} (tolerance {ATTN_DEN_RTOL})",
            _nbytes(q, k, v, got, den if denominator else None), 6 * C * H * L * S,
            _time_queued_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q4, k4, v4, scale=1.0), QUEUED_REPS, dev)[0], exps=C * H * L * S)
    rec["rank1_attn"]["den_max_rel_err"] = max(
        rec["rank1_attn"].get("den_max_rel_err", 0.0), derr)
    return got, den


def kernel_checks(dev, model, T: int = T_STEPS) -> dict:
    """Phase 3: every kernel against its plain version at the shapes the
    model's sampling path gives it (9 clouds of the model's width).
    Returns {kernel: {max_abs_err, ms, plain_ms}}; times sum the path's
    calls of each kernel."""
    import torch

    from lsdm_tpu_torch.diffusion.schedule import make_schedule
    from lsdm_tpu_torch.models.sampling import chain_coefficients
    from lsdm_tpu_torch.ops import denoise
    from lsdm_tpu_torch.profile_encode import encode_levels

    bb = model.pcd_backbone
    stages = (bb.sa1, bb.sa2, bb.sa3, bb.sa4)
    N, D = model.cfg.pcd_points, model.cfg.latent_dim
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    rec: dict = {}
    levels = selection_checks(dev, stages, torch.randn(9, N, 3, generator=g, device=dev),
                              rec)
    fps_graph_check(levels[0], stages[1].npoint)

    # K7 at sa1..sa4 and K8 at fp4..fp1 (fp1 with the head): at b1 on
    # these levels, then at b8 (72 clouds)
    stages_b1 = encode_stage_checks(dev, model, levels, g, rec)
    stages_b8 = encode_stage_checks(dev, model, encode_levels(bb, 72, g, dev), g)
    for name in ("sa_fused", "fp_fused"):
        for label, recs in (("b1", stages_b1), ("b8", stages_b8)):
            mine = [st for st in recs if st["kernel"] == name]
            rec[name][f"stages_{label}"] = mine
            rec[name][f"kernel_ms_{label}"] = sum(st["kernel_ms"] for st in mine)
            rec[name][f"wrapper_ms_{label}"] = sum(st["wrapper_ms"] for st in mine)

    # K4 at pcd_attention's shapes: 9 clouds, L = S = N, 12 heads
    H = model.cfg.translation_params
    rank1_attn_check(dev, rec, *(torch.randn(9, N, H, generator=g, device=dev)
                                 for _ in range(3)))

    # K6 with the model's own tail weights: the path's case (batch 1, no
    # clip), then batch 8 with clip on, whose error counts.  Each time is
    # split into pass 1 (its tables, timed alone over the chain's chunks)
    # and pass 2 (the rest).
    p = denoise.extract_step_params(model)
    coef = chain_coefficients(make_schedule("cosine", T, device=dev), False)
    up = sum(w.numel() for w in (p.w_up0, p.w_up2, p.w_up4))  # on 2D rows
    tail = (p.wp0_t.numel() + p.wp2_t.numel() + D * p.wx0_t.shape[1]
            + p.wx2_t.numel() + p.wo0_t.numel() + p.wo2_t.numel())  # pass 2
    table = p.wc_t.numel() + D * p.wx0_t.shape[1]  # pass 1's, on N rows
    for B, clip in ((1, False), (CHAIN_BATCH, True)):
        args = (torch.randn(B, N, 3, generator=g, device=dev),
                torch.randn(B, T, N, 3, generator=g, device=dev),
                torch.randn(B, N, 3, generator=g, device=dev),
                torch.randn(B, T, 2 * D, generator=g, device=dev), coef, p)
        got = denoise.fused_denoise_chain(*args, clip_denoised=clip)
        want = denoise.denoise_chain_plain(*args, clip_denoised=clip)
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        if not (all(torch.isfinite(a).all() for a in got) and err <= CHAIN_ATOL):
            raise AssertionError(f"denoise chain B={B}: max error {err} > {CHAIN_ATOL}")
        ms = _time_ms(lambda: denoise.fused_denoise_chain(*args, clip_denoised=clip),
                      3, dev)
        pass1 = _chain_pass1_ms(args[3], p, dev)
        ops1 = 2 * B * T * (2 * D * up + N * table)
        ops2 = 2 * B * T * N * tail
        pass1_rec = {"source": "lsdm_tpu_torch/csrc/denoise_tables.cu",
                     "ms": pass1, "bound_ms": ops1 / FP32_OPS_PER_S * 1e3,
                     "library_ms": _chain_pass1_library_ms(args[3], p, dev),
                     "tflop_s": ops1 / pass1 * 1e-9,
                     "fp32_share": ops1 / pass1 * 1e3 / FP32_OPS_PER_S}
        line = (f"K6 denoise chain B={B} N={N} D={D} T={T} clip={clip}: max error "
                f"{err:.3g} (tolerance {CHAIN_ATOL}); pass 1 {pass1:.3f} ms "
                f"(bound {pass1_rec['bound_ms']:.3f}; {pass1_rec['tflop_s']:.2f} "
                f"TFLOP/s, {pass1_rec['fp32_share']:.1%} of the FP32 peak; "
                f"cuBLAS baddbmm floor, no GELU or u0: "
                f"{pass1_rec['library_ms']:.3f}), pass 2 {ms - pass1:.3f} ms "
                f"(bound {ops2 / FP32_OPS_PER_S * 1e3:.3f})")
        if B != 1:
            print(f"{line}; kernel {ms:.4f} ms")
            rec["denoise_chain"]["max_abs_err"] = max(
                rec["denoise_chain"]["max_abs_err"], err)
            rec["denoise_chain"][f"pass1_b{B}"] = pass1_rec
            continue
        _record(rec, "denoise_chain", err, ms,
                _time_ms(lambda: denoise.denoise_chain_plain(*args), 2, dev), line,
                _nbytes(*args[:5], *p, *got), ops1 + ops2)
        rec["denoise_chain"].update(pass1_b1=pass1_rec, pass2_ms=ms - pass1)
        e2_path = args[3]
    e2 = e2_path[:, -TABLE_STEPS:].contiguous()
    got = denoise.denoise_chain_tables(e2, p)
    want = denoise.denoise_chain_tables_plain(e2, p)
    terr = max((a - b).abs().max().item() for a, b in zip(got, want))
    print(f"K6 pass 1 tables (emb, g) of {e2.shape[1]} steps: max error "
          f"{terr:.3g} (tolerance {TABLE_ATOL})")
    if terr > TABLE_ATOL:
        raise AssertionError(f"denoise chain pass 1: max error {terr} > {TABLE_ATOL}")
    rec["denoise_chain"]["max_abs_err"] = max(rec["denoise_chain"]["max_abs_err"], terr)
    return rec


def _chain_pass1_ms(e2, p, dev) -> float:
    """Device ms of K6's first pass over the step rows e2 (B, T, 2D), as the
    chain runs it: pass 1 alone (``denoise_chain_tables``) over each of the
    chain's chunks of steps."""
    from lsdm_tpu_torch.ops import denoise

    B, T = e2.shape[:2]
    tc = denoise.chain_chunk_steps(B, T, p)
    ms = 0.0
    for steps, count in ((tc, T // tc), (T % tc, 1)):
        if steps and count:
            rows = e2[:, :steps].contiguous()
            ms += count * _time_ms(lambda: denoise.denoise_chain_tables(rows, p), 3, dev)
    return ms


def _chain_pass1_library_ms(e2, p, dev) -> float:
    """Device ms of pass 1's library yardstick over the step rows e2 (B, T,
    2D), chunked as ``_chain_pass1_ms`` chunks them: for each chunk of z =
    B x steps (scene, step) pairs, its four products with their biases as
    ``torch.baddbmm`` calls (cuBLAS in full float32, TF32 off) on tables of
    the kernel's shapes.  Without the GELUs and u0, it is a floor for the
    kernel rather than the same function; timed here only, never called by
    the port."""
    import torch

    from lsdm_tpu_torch.ops import denoise

    B, T, D2 = e2.shape
    N, U0, U2, D = (p.w_up4.shape[0], p.w_up0.shape[0], p.w_up2.shape[0],
                    p.wc_t.shape[1])
    tc = denoise.chain_chunk_steps(B, T, p)
    g = torch.Generator(device=dev).manual_seed(0)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    ms = 0.0
    try:
        for steps, count in ((tc, T // tc), (T % tc, 1)):
            if not (steps and count):
                continue
            z = B * steps
            u0, u2, u4, emb = (torch.randn(z, r, c, generator=g, device=dev)
                               for r, c in ((U0, D2), (U2, D2), (N, D2), (N, D)))
            w_up2, w_up4, wc, wx = (w.expand(z, -1, -1) for w in (
                p.w_up2, p.w_up4, p.wc_t, p.wx0_t[D:]))

            def products():
                torch.baddbmm(p.b_up2, w_up2, u0)
                torch.baddbmm(p.b_up4, w_up4, u2)
                torch.baddbmm(p.bc, u4, wc)
                torch.baddbmm(p.bx0, emb, wx)
            ms += count * _time_ms(products, 3, dev)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return ms


def train_kernel_checks(dev, model, batch: int = TRAIN_BATCH) -> dict:
    """Phase 10: the training kernels against their plain versions at the
    shapes of the train step at ``batch`` scenes (``batch * max_objs``
    clouds): K4 on the pcd_attention's (clouds, N, 12) with its row
    denominators and K5 from them, and on k, v offset by +8; K3, K1 and K2
    at the SA and FP stages (K1-K4 under the key "train_shapes"); K10 at
    sa1-sa4 and on a center with an empty ball; K11 on (batch, N, 3) each
    way.  Returns {kernel: record}, as :func:`kernel_checks`."""
    import torch

    from lsdm_tpu_torch.ops import attn, chamfer, sg_fused
    from lsdm_tpu_torch.profile_encode import ball_scan

    cfg = model.cfg
    C_, N, H = batch * cfg.max_objs, cfg.pcd_points, cfg.translation_params
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    rec: dict = {"train_shapes": {}}

    # K4 at (clouds, N, 12) with the row denominators the training forward
    # keeps; then K5 from them, with SDPA's
    # backward on the same inputs as the library yardstick (head_dim 1,
    # scale 1); then on k and v shifted by +8, where a factored form of the
    # gradients would cancel
    q, k, v, gout = (torch.randn(C_, N, H, generator=g, device=dev) for _ in range(4))
    out, den = rank1_attn_check(dev, rec["train_shapes"], q, k, v, denominator=True)
    got = attn.rank1_mha_bwd_kernel(q, k, v, out, gout, den)
    want = attn.rank1_mha_bwd_plain(q, k, v, out, gout)
    err = max((a - b).abs().max().item() for a, b in zip(got, want))
    if not (all(torch.isfinite(a).all() for a in got) and err <= ATTN_BWD_ATOL):
        raise AssertionError(f"rank-1 attention backward: max error {err} > {ATTN_BWD_ATOL}")
    del want
    q4, k4, v4 = (t.transpose(1, 2)[..., None].contiguous().requires_grad_()
                  for t in (q, k, v))
    out4 = torch.nn.functional.scaled_dot_product_attention(q4, k4, v4, scale=1.0)
    g4 = gout.transpose(1, 2)[..., None].contiguous()
    lib = _time_ms(lambda: torch.autograd.grad(out4, (q4, k4, v4), g4,
                                               retain_graph=True), 5, dev)
    del q4, k4, v4, out4
    _record(rec, "rank1_attn_bwd", err,
            _time_queued_ms(lambda: attn.rank1_mha_bwd_kernel(q, k, v, out, gout, den),
                            QUEUED_REPS, dev)[0],
            _time_ms(lambda: attn.rank1_mha_bwd_plain(q, k, v, out, gout), 3, dev),
            f"K5 rank-1 attention backward ({C_},{N},{H}): max error {err:.3g} "
            f"(tolerance {ATTN_BWD_ATOL})",
            _nbytes(q, k, v, out, gout, den, *got), 13 * C_ * H * N * N, lib,
            exps=C_ * H * N * N)
    ks, vs = k + 8.0, v + 8.0
    out, den = attn.rank1_mha_kernel(q, ks, vs, denominator=True)
    got = attn.rank1_mha_bwd_kernel(q, ks, vs, out, gout, den)
    want = attn.rank1_mha_bwd_plain(q, ks, vs, out, gout)
    err = max((a - b).abs().max().item() for a, b in zip(got, want))
    print(f"K5 rank-1 attention backward ({C_},{N},{H}), k and v offset by +8: max "
          f"error {err:.3g} (tolerance {ATTN_BWD_ATOL})")
    if not (all(torch.isfinite(a).all() for a in got) and err <= ATTN_BWD_ATOL):
        raise AssertionError(f"rank-1 attention backward, offset inputs: max error "
                             f"{err} > {ATTN_BWD_ATOL}")
    rec["rank1_attn_bwd"]["offset_max_abs_err"] = err
    del got, want, out, den, ks, vs

    # K3, K1 and K2 at the train step's clouds
    bb = model.pcd_backbone
    stages = (bb.sa1, bb.sa2, bb.sa3, bb.sa4)
    levels = selection_checks(dev, stages, torch.randn(C_, N, 3, generator=g, device=dev),
                              rec["train_shapes"])

    # K10 at sa1..sa4: centers by FPS as the stages pick them, features of
    # the stages' input widths
    for st, xyz, new_xyz in zip(stages, levels[:4], levels[1:5]):
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
                    DIST_INSTRS * ball_scan(r, ns, xyz, qc) + 3 * gi.numel(),
                    instrs=True)
        del got, want

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
                (DIST_INSTRS + 2) * batch * N * b.shape[1], instrs=True)
    return rec


def train_step_check(dev, cfg, label: str, chamfer_impl: str = "xla",
                     batch: int = TRAIN_BATCH, T: int = T_STEPS, **impls):
    """Phase 11, one configuration: a train step at ``batch`` scenes through
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
    """Phase 12: the port's train_sdm on a synthetic proxd split (12 train
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


def step_kernel_checks(dev, model, batches=(1, 8)) -> dict:
    """Phase 7: K9 against its plain version with the model's tail
    weights, one step at each batch of ``batches``, clip off and on.  The
    record holds the path's case (batch 1, no clip): time per launch, its
    bound and the plain version's time; the other cases add their error.
    Returns {"denoise_step": record}."""
    import torch

    from lsdm_tpu_torch.diffusion.schedule import make_schedule
    from lsdm_tpu_torch.models.sampling import chain_coefficients
    from lsdm_tpu_torch.ops import denoise

    N, D = model.cfg.pcd_points, model.cfg.latent_dim
    p = denoise.extract_step_params(model)
    coef = chain_coefficients(make_schedule("cosine", T_STEPS, device=dev), False)
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    up = sum(w.numel() for w in (p.w_up0, p.w_up2, p.w_up4))  # on 2D rows
    rows = sum(w.numel() for w in (p.wc_t, p.wp0_t, p.wp2_t, p.wx0_t, p.wx2_t,
                                   p.wo0_t, p.wo2_t))         # on N rows
    rec: dict = {}
    for B in batches:
        args = [torch.randn(B, N, 3, generator=g, device=dev),
                torch.randn(B, N, 3, generator=g, device=dev),
                torch.randn(B, N, 3, generator=g, device=dev),
                torch.randn(B, 2 * D, generator=g, device=dev), coef[500], p]
        for clip in (False, True):
            got = denoise.fused_denoise_step(*args, clip_denoised=clip)
            want = denoise.denoise_step_plain(*args, clip_denoised=clip)
            err = (got - want).abs().max().item()
            # timed as the step sampler calls it: the weights bound once
            step = denoise.make_denoise_step(p, N, dev, clip)
            ms, host = _time_queued_ms(lambda: step(*args[:5]), STEP_REPS, dev)
            paced = _time_ms(lambda: step(*args[:5]), STEP_REPS, dev)
            line = (f"K9 denoise step B={B} N={N} D={D} clip={clip}: max error "
                    f"{err:.3g} (tolerance {STEP_ATOL}); host-paced {paced:.4f} "
                    f"ms per launch, the host's own {host:.4f}")
            if not (torch.isfinite(got).all() and err <= STEP_ATOL):
                raise AssertionError(line)
            if B != 1 or clip:  # not the path's case: its error counts
                print(f"{line}; kernel {ms:.4f} ms per launch")
                rec["denoise_step"]["max_abs_err"] = max(
                    rec["denoise_step"]["max_abs_err"], err)
                continue
            _record(rec, "denoise_step", err, ms,
                    _time_ms(lambda: denoise.denoise_step_plain(*args), 20, dev),
                    line, _nbytes(*args[:5], *p, got), 2 * B * (2 * D * up + N * rows))
    return rec


def step_path(dev, cfg, model, T: int = T_STEPS):
    """Phase 8: one batch-1 sample on the step path (``model`` with the
    fused encode, ``fused_step="step"``) through the kernels, through the
    plain versions and on the chain path, same draws.  Returns (launch
    counts of the kernel run, max |kernel - plain| per output, max |step -
    chain| per output, seconds of the kernel run, peak GiB of it)."""
    import torch

    from lsdm_tpu_torch import kernels
    from lsdm_tpu_torch.diffusion.schedule import make_schedule
    from lsdm_tpu_torch.models.sampling import sample_sdm
    from lsdm_tpu_torch.profile_sampling import seeded_inputs

    B, N = 1, cfg.pcd_points
    mask, objs, cats, text, x_init, noise = seeded_inputs(cfg, B, T, SEED, dev)
    schedule = make_schedule("cosine", T, device=dev)

    def run(step):
        _sync(dev)
        t0 = time.perf_counter()
        out = sample_sdm(model, schedule, mask, objs, cats, text,
                         fused_step=step, x_init=x_init, noise=noise)
        _sync(dev)
        return out, time.perf_counter() - t0

    run("step")  # warm-up
    peak = _reset_peak(dev)
    kernels.reset_launches()
    (s_k, o_k), sec_k = run("step")
    launches = dict(kernels.LAUNCHES)
    peak = peak()
    with plain_versions():
        kernels.reset_launches()
        (s_p, o_p), _ = run("step")
        if any(kernels.LAUNCHES.values()):
            raise AssertionError(f"the plain run launched kernels: {kernels.LAUNCHES}")
    (s_c, o_c), _ = run("chain")
    if s_k.shape != (B, N, 3) or not torch.isfinite(s_k).all():
        raise AssertionError(f"step-path sample is not a finite {(B, N, 3)} cloud")

    def errs(s, o):
        return {"sample": (s_k - s).abs().max().item(),
                "x0": (o_k.x0 - o.x0).abs().max().item(),
                "guiding": (o_k.guiding - o.guiding).abs().max().item(),
                "cat": (o_k.cat - o.cat).abs().max().item()}

    return launches, errs(s_p, o_p), errs(s_c, o_c), sec_k, peak


def scene_edit_phase(dev, points: int = 1024, T: int = T_STEPS) -> dict:
    """Phase 9: the port's scene_edit on a synthetic proxd test split of
    2 sequences of ``points`` points whose prompts name a desk, with the
    desk's object file written: the keyword hits and ICP aligns the
    replacement.  Returns the launch counts of the run."""
    import numpy as np

    from lsdm_tpu_torch import kernels
    from lsdm_tpu_torch.data.synthetic import generate
    from lsdm_tpu_torch.run import scene_edit

    with tempfile.TemporaryDirectory() as root:
        data = generate(root, "proxd", n_scenes=1, n_seqs=2, pnt_size=points,
                        seed=SEED, split="test")
        ctx = os.path.join(data, "context")
        for name in os.listdir(ctx):
            with open(os.path.join(ctx, name)) as f:
                lines = f.readlines()
            lines[0] = "place a desk next to the person\n"
            with open(os.path.join(ctx, name), "w") as f:
                f.writelines(lines)
        os.makedirs(os.path.join(root, "objs", "N3Office"))
        np.save(os.path.join(root, "objs", "N3Office", "table_0.npy"),
                np.random.RandomState(SEED).rand(points, 3).astype(np.float32))
        out = os.path.join(root, "out")
        kernels.reset_launches()
        t0 = time.perf_counter()
        final = scene_edit.main([data, "--objs_data_dir", os.path.join(root, "objs"),
                                 "--output_dir", out, "--diffusion_steps", str(T),
                                 "--pcd_points", str(points), "--device", str(dev)])
        sec = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        with open(os.path.join(out, "results.txt")) as f:
            tail = [line.split(":")[0] for line in f.read().splitlines()[-8:]]
        if tail != ["Final Chamfer distance", "Final EMD", "Final F1 score",
                    "Category accuracy", "Top 3 accuracy", "Fitness", "MSE",
                    "Corr set"]:
            raise AssertionError(f"results.txt ends in {tail}")
        if not 0.0 < final["fitness"] <= 1.0:
            raise AssertionError(f"ICP fitness {final['fitness']}")
        for sub in ("predictions", "guiding_points"):
            names = sorted(os.listdir(os.path.join(out, sub)))
            if len(names) != 2:
                raise AssertionError(f"{sub}: {len(names)} files, not 2")
            for name in names:
                a = np.load(os.path.join(out, sub, name))
                if a.shape != (points, 3) or a.dtype != np.float32 or not np.isfinite(a).all():
                    raise AssertionError(f"{sub}/{name}: not a finite ({points}, 3) "
                                         "float32 array")
    print(f"CLI scene_edit, 2 synthetic sequences of {points} points, a keyword "
          f"hit, T={T}: {final}; {sec:.1f} s ({sec / 2:.2f} s per sequence); "
          f"launches {launches}")
    return launches


def icp_check(dev, points: int = 1024, tries: int = ICP_TRIES) -> dict:
    """Phase 9, the ICP of ``scene_edit`` on its own: K11 against its plain
    version at the shapes the ICP gives it (each try's moved source,
    (tries, points, 3), against the target repeated per try), then one
    ``random_restart_icp`` from the same rotations through the kernels and
    through the plain versions, agreeing to ICP_ATOL with equal inlier
    counts.  Returns ({kernel: record}, as :func:`kernel_checks`, and K11's
    launches in the kernel run of the ICP)."""
    import torch

    from lsdm_tpu_torch import kernels
    from lsdm_tpu_torch.ops import chamfer
    from lsdm_tpu_torch.ops.icp import random_restart_icp
    from lsdm_tpu_torch.ops.rotations import quaternion_to_matrix

    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    source = torch.rand(points, 3, generator=g, device=dev)
    turn = quaternion_to_matrix(torch.randn(4, generator=g, device=dev))
    target = (source @ turn.T + 0.5
              + 0.01 * torch.randn(points, 3, generator=g, device=dev))
    quats = torch.randn(tries, 4, generator=g, device=dev)
    # the first iteration's correspondences, as ops/icp.py:_icp_batched
    # builds them from random_restart_icp's initial poses
    src = (source @ quaternion_to_matrix(quats).transpose(1, 2)
           + (target.mean(0) - source.mean(0))).contiguous()
    tgt = target.expand(tries, -1, -1).contiguous()
    gm, ga = chamfer.directed_nn_kernel(src, tgt)
    wm, wa = chamfer.directed_nn_plain(src, tgt)
    err = (gm - wm).abs().max().item()
    if not torch.equal(ga, wa) or err > CHAMFER_ATOL:
        raise AssertionError(f"K11 at the ICP's shapes: indices differ or error {err}")
    rec: dict = {}
    _record(rec, "chamfer_nn", err,
            _time_ms(lambda: chamfer.directed_nn_kernel(src, tgt), 20, dev),
            _time_ms(lambda: chamfer.directed_nn_plain(src, tgt), 5, dev),
            f"K11 nearest neighbour, ICP ({tries},{points},3): equal indices, "
            f"max error {err:.3g}", _nbytes(src, tgt, gm, ga),
            (DIST_INSTRS + 2) * tries * points * points, instrs=True)

    _sync(dev)
    kernels.reset_launches()
    got = random_restart_icp(source, target, quats=quats, iters=ICP_ITERS)
    _sync(dev)
    launched = kernels.LAUNCHES["chamfer_nn"]
    with plain_versions():
        kernels.reset_launches()
        want = random_restart_icp(source, target, quats=quats, iters=ICP_ITERS)
        if any(kernels.LAUNCHES.values()):
            raise AssertionError(f"the plain ICP launched kernels: {kernels.LAUNCHES}")
        pms = _time_ms(lambda: random_restart_icp(source, target, quats=quats), 3, dev)
    ms = _time_ms(lambda: random_restart_icp(source, target, quats=quats), 3, dev)
    terr = (got.transformation - want.transformation).abs().max().item()
    line = (f"ICP {tries} tries x {ICP_ITERS} iterations on {points} points: "
            f"fitness {float(got.fitness):.4f} (plain {float(want.fitness):.4f}), "
            f"{int(got.n_correspondences)} inliers (plain "
            f"{int(want.n_correspondences)}), max transformation error {terr:.3g} "
            f"(tolerance {ICP_ATOL}); K11 launched {launched} times; "
            f"{ms:.3f} ms, plain {pms:.3f} ms")
    print(line)
    if (int(got.n_correspondences) != int(want.n_correspondences)
            or float(got.fitness) != float(want.fitness) or terr > ICP_ATOL
            or not 0.0 < float(got.fitness) <= 1.0):
        raise AssertionError(line)
    return rec, launched


def cli_phase(dev, points: int = 1024, T: int = T_STEPS,
              fused_step: str = "auto") -> dict:
    """Phase 6 (and 9 with ``fused_step="step"``): the port's test_sdm on
    a synthetic proxd test split of 4 sequences of ``points`` points,
    batch 2.  Returns the launch counts of the run."""
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
                               str(points), "--device", str(dev),
                               "--fused_step", fused_step])
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
    print(f"CLI test_sdm --fused_step {fused_step}, 4 synthetic sequences, batch 2, "
          f"T={T}: {final}; {sec:.1f} s; launches {launches}")
    return launches


def _check_launches(path: str, launches: dict) -> None:
    for name in PATH_KERNELS[path]:
        if launches[name] < 1:
            raise AssertionError(f"kernel {name} was not launched on the {path} path")
    if path in ("fused", "step") and launches["ball_query"] + launches["three_nn"]:
        raise AssertionError(f"the {path} path ran K1/K2: {launches}")
    if path == "fused" and launches["denoise_step"]:
        raise AssertionError(f"the fused path ran K9: {launches}")
    if path == "step" and launches["denoise_chain"]:
        raise AssertionError(f"the step path ran K6: {launches}")
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

    records.update(step_kernel_checks(dev, fused))
    path_launches, errs, vs_chain, sec_k, peak = step_path(dev, cfg, fused)
    print(f"step path sdm_proxd B=1 9x{cfg.pcd_points} T={T_STEPS}: launches "
          f"{path_launches}; max |kernel - plain| {errs} (tolerance {FUSED_ATOL}); "
          f"max |step - chain| {vs_chain} (tolerance {CHAIN_ATOL})")
    _check_launches("step", path_launches)
    launches["step"] = path_launches
    if path_launches["denoise_step"] != T_STEPS:
        raise AssertionError(f"K9 launched {path_launches['denoise_step']} times, "
                             f"not {T_STEPS}")
    if max(errs.values()) > FUSED_ATOL:
        raise AssertionError("step path disagrees with its plain versions")
    if max(vs_chain.values()) > CHAIN_ATOL:
        raise AssertionError("step path disagrees with the chain path")
    print(f"kernel path step at b1: {sec_k * 1e3:.1f} ms/scene, "
          f"{T_STEPS / sec_k:.1f} steps/s, peak memory {peak:.2f} GiB")
    _check_launches("step", cli_phase(dev, fused_step="step"))
    _check_launches("scene_edit", scene_edit_phase(dev))
    icp_rec, icp_launches = icp_check(dev)
    if icp_launches != ICP_ITERS + 1:  # once per iteration, once for the result
        raise AssertionError(f"the ICP launched K11 {icp_launches} times, not "
                             f"{ICP_ITERS + 1}")

    from lsdm_tpu_torch.models.sampling import resolve_train_attn_impl

    records.update(train_kernel_checks(dev, model))
    # K1-K4 at the train step's clouds, beside their sampling-path records
    for name, r in records.pop("train_shapes").items():
        records[name][f"train_b{TRAIN_BATCH}"] = _kernel_record(r)
    # K11's record keeps the train step's times; the ICP's call adds its error
    records["chamfer_nn"]["max_abs_err"] = max(
        records["chamfer_nn"]["max_abs_err"], icp_rec["chamfer_nn"]["max_abs_err"])
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

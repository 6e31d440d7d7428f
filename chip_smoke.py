#!/usr/bin/env python3
"""Smoke test of lsdm_tpu_torch on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

1. Requires a CUDA device and prints its name and power limit.
2. Builds the CUDA kernels from ``lsdm_tpu_torch/csrc`` (nvcc, sm_90a, one
   nvcc per source, in parallel).
3. Holds each kernel against its plain PyTorch version on the card at the
   shapes of the flagship sampling paths: ball query (K1), 3-NN (K2) and
   FPS (K3, from index 0 with no start tensor, as the SDM calls it) must
   give equal indices (K2 also distances of the same bits), and that FPS
   call must capture into a CUDA graph (no host sync); the fused SA stage
   (K7, sa1-sa4 and a center with an empty ball) and FP stage (K8,
   fp4-fp1 with the head) must agree to STAGE_ATOL, the rank-1 attention (K4) to ATTN_ATOL and
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
   ms/scene and peak memory of both paths.  Then the encode alone at
   ``--pcd_points`` LARGE_POINTS (9 clouds of 4096 points; vert_dims 2048,
   so that the human branch yields as many points): the fused
   encode (K3, K7, K8, K4) against the plain versions of the same
   configuration at the COND bound, and the composed encode over K1, K2
   and K3 against the plain selection to FUSED_ATOL.
6. The CLI: ``lsdm_tpu_torch.run.test_sdm`` on a synthetic proxd test
   split (4 sequences x 1024 points, batch 2, T=1000) on CUDA; checks the
   output files and that the fused kernels ran.
7. The one-step denoise kernel K9 against its plain version at N=1024,
   D=128, batch 1 and 8, clip off and on, to STEP_ATOL; its time per
   launch is taken with the launches queued behind a sleep on the card,
   so that the host's pace between them does not count (the host-paced
   time and the host's own time per call are printed beside it), and so
   are its two launches apart (u2, and the tile kernel on clusters of the
   plan's size); the record carries both batches as ``b1`` / ``b8``.
8. The "step" path: ``sdm_proxd()`` at full width, batch 1, T=1000,
   ``ball_impl="fused"``, ``fused_step="step"`` (K9 once per step, the T
   calls captured into one CUDA graph by the first sample and replayed by
   the timed one): through the kernels and through the plain versions
   with the same draws (FUSED_ATOL), and against the chain path with the
   same draws (CHAIN_ATOL); the timed sample must make no K9 call from the
   host and replay the graph once, which holds T u2 and T tile kernel
   nodes; K9 launched T times (by the replay, counted from those nodes)
   and K6 never; ``test_sdm --fused_step step`` must likewise make its K9
   calls by replays, with no host call beyond the one before the capture.  Prints ms/scene, peak memory and the graph's
   capture and instantiation times.
8b. The bf16 fused path (``sdm_proxd()`` at ``dtype="bfloat16"``, the JAX
   bench's ``--dtype bfloat16``): first the bf16 modes of K7 and K8 per
   stage at 9 clouds on bf16 features, of K6 at b1 and CHAIN_BATCH (clip
   on; pass 1 timed apart, as the chain runs it, beside its bf16
   ``baddbmm`` yardstick and the bytes its tables move, pass 2 with its
   TFLOP/s and its plan's warps a tile, and its tables emb and g held to
   their plain bf16 versions) and of K9
   at b1 and b8, clip off and on, on the loop's last step and a mid-loop
   step (u2 and the tile launch also timed apart, with the tile launch's
   m16 tiles a block), each against its plain bf16 version by
   the BF16 gate (BF16_RTOL, BF16_GAP_SHARE), its bound its bytes or its
   products over BF16_TC_OPS_PER_S; then the bf16 model sampled at b1,
   T=1000, on the chain path (K3 and K7, K8, K4, K6 in their bf16 modes)
   and on the step path (the K9 bf16 graph replayed T times, no host
   call), each against its plain versions by the BF16 gate, launching no
   float32 mode; ms/scene and peak memory beside the float32 paths'.
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
   and an empty ball, timed queued) and the chamfer nearest neighbour
   (K11, each way) equal to their plain versions.
   Then the bf16 modes at those shapes (phase 10b): K4 and K5 on bf16
   q, k, v within ATTN_BF16_ATOL / ATTN_BWD_BF16_ATOL of their plain bf16
   versions (K4's row denominators the float32 mode's bits; K4 also at the
   bf16 encode's 9 clouds, timed beside SDPA's bf16 forward, the record's
   ``clouds9``), K10 on bf16 stage columns equal to its plain version, each
   timed queued with its bound (records ``rank1_attn_bf16``,
   ``rank1_attn_bwd_bf16``, ``select_gather_bf16``).
11. The train step of ``sdm_proxd()`` at batch 6 (fp32, T=1000, seeded
   weights and batch) in the configuration ``train_sdm`` runs by default
   on CUDA (K1-K5), with ``ball_impl="sg"`` (K10) and with the K11 chamfer:
   each through the kernels and through the plain versions from the same
   weights, t, noise and dropout keep-mask, agreeing in the loss, the
   gradients and the parameters after one AdamW step; prints ms/step and
   peak memory.  Then the same step at ``dtype="bfloat16"`` with
   ``bn_dtype`` float32 and bf16, on the default path (K1-K3, K4/K5 in
   their bf16 modes) and with ``ball_impl="sg"`` (K10's bf16 mode), each
   agreeing with its plain versions within the TRAIN_BF16_* gates and
   launching no float32 mode of K4, K5, K10 and no fused eval kernel; its
   ms/step and peak memory beside the float32 step's.
12. ``lsdm_tpu_torch.run.train_sdm`` on a synthetic split (one epoch of
   two steps, validation on the fused path), its ``final.pt`` read back;
   then ``--dtype bfloat16 --bn_dtype bfloat16`` at BF16_CLI_STEPS steps
   (validation on the fused path in bf16: K7, K8, K4 and K6 in their bf16
   modes), its ``final.pt`` read back into a float32 model.
13. The text towers: the full-width CLIP text tower (its tokens from a
   small BPE merges file the phase writes) and BERT-base (read from a
   local snapshot the phase writes, tokens from its WordPiece vocabulary),
   seeded weights, encode TEXT_PROMPTS prompts through ``TextEncoder`` on
   the card and on the CPU, agreeing to TEXT_RTOL; each tower's time per
   batch by CUDA events.  Then ``test_sdm --text_encoder CLIP --bpe_path
   ... --clip_weights ...`` (a seeded OpenAI-named state dict) with the
   output checks of phase 6, the CLIP tower on the card.
14. PLMS: ``plms_sample_loop`` (order 2) over ``sdm_proxd()`` at b1 on a
   PLMS_STEPS-step respacing (the fused encode, then the composed
   denoiser), through the kernels and through the plain versions from the
   same initial image, agreeing to PLMS_ATOL.
15. The alternate backbones (``backbones_phase``): ``sdm_proxd()`` with
   ``pcd_backbone_type="DGCNN"`` and ``human_backbone_type="P2R"`` at full
   width (9 x 1024, T=1000, b1, seeded weights), sampled on the fused
   chain path (K4, K6) and on the step path (K4, the K9 graph replayed T
   times), each through the kernels and through the plain versions with
   the same draws (FUSED_ATOL; the fused encode's ``cond_pcd`` against the
   composed one at the COND bound; the step path against the chain at
   CHAIN_ATOL), then one train step at batch 6 with ``attn_impl="pallas"``
   (K4, K5) against the plain step at the TRAIN_* gates (DGCNN's two
   dropouts on given keep-masks).  None of these may launch K1, K2, K3,
   K7, K8 or K10.  Prints ms/scene, ms/step and peak memory.
16. Fitting (``fitting_phase``): ``lsdm_tpu_torch.run.fit_custom_obj`` on
   the card (its default ``--device cuda``) over a synthetic library of
   two table meshes, a 64-frame human sequence of 655 vertices and a
   1024-point predicted table top, at ``--sdf_dim`` FIT_SDF_DIM with the
   full 36 x 11 x 11 grid and 200 Adam steps; every ``grid_search`` and
   ``refine_pose`` call it makes is replayed on the CPU: equal grid poses
   (or, where the picks differ, losses within FIT_GRID_RTOL), refined
   losses within FIT_REFINE_RTOL and poses within FIT_REFINE_ATOL.
   Prints the card's ms per grid search and per refinement.
16b. ContactFormer (``contactformer_phase``; no port kernel may launch):
   each decoder mode 0-4 at ``train_contactformer``'s widths (d_hid 512,
   6 + 6 layers, 8 heads) over CF_FRAMES frames of the synthetic 655-vertex
   body, on the card against the same weights and noise on the CPU
   (CF_RTOL), timed; one Adam step of mode 1 against the CPU at
   CF_TRAIN_FRAMES frames, in float32 and in float64 (CF_GRAD_RTOL,
   CF_F64_RTOL); CF_STEPS timed steps at
   CF_FRAMES with their peak memory; ``train_contactformer`` for 2 epochs of
   2 steps on the card over a synthetic contact split.
16c. ``lsdm_tpu_torch.run.predict_contact`` on a synthetic proxd test split
   (4 sequences x 1024 points, batch 2, T=1000) on the card: 4 finite
   predictions, and the fused path's kernels (K3, K7, K8, K4, K6; no K1, K2
   or K9); the sampling's ms per scene.
16d. ATISS / MIME (``atiss_phase``; no port kernel may launch), at the
   reference widths (ResNet18 features, 4 layers of 512, MIME 528, 8 heads,
   ff 1024, 20 classes) with cuDNN's TF32 setting left on (the extractors
   and the backward turn it off themselves): the forward of ATISS, its
   batch-axis quirk, the PE variant and MIME at ATISS_BATCH scenes of 9
   slots on the card against the CPU (ATISS_RTOL), timed; one AdamW step
   of ATISS and of MIME against the CPU in float32 and in float64
   (``_step_gates``); ATISS_STEPS
   timed steps with their peak memory; ``generate_boxes`` and
   ``complete_scene`` replaying the CPU's draws (float64 to ATISS_GEN_RTOL,
   equal classes and counts), the ms a box of a float32 scene; then
   ``train_atiss``, ``test_atiss``, ``test_mime``, ``test_cf_atiss``,
   ``generate_scenes`` and ``get_next_obj_class`` on a synthetic split on
   the card.
18. The (data, model) mesh (``parallel_phase``): two ranks, one a card with
   NCCL where there are two cards, else sharing the one card over gloo
   (never on the CPU); the sharded train step of ``sdm_proxd()`` at
   TRAIN_BATCH scenes with per-scene masks at meshes 2x1 and 1x2 against
   the single-rank step (MESH_LOSS_RTOL, MESH_PARAM_ATOL, every gradient
   leaf to MESH_GRAD_RTOL), the ranks' parameters bitwise equal, K1-K5
   launched on every rank, ms/step beside the single rank's; the same step
   with each of MESH_FAULTS planted must fail the gradient gate; sharded
   sampling at 2x1, MESH_SAMPLE_BATCH scenes,
   T=1000, on the fused path against the single-rank sample (CHAIN_ATOL).
   The ``kernels`` line's K1-K5 records carry each rank's launches as
   ``train_mesh``, the fused path's as ``sample_mesh``.
19. ``train_atiss_3dfront`` on the card (``threed_front_phase``): the
   default ResNet18 ATISS for THREED_FRONT_STEPS steps on a synthetic
   3D-FRONT cache, cuDNN's TF32 setting on, against the same run on the
   CPU (THREED_FRONT_RTOL); no port kernel may launch.
20. Prints one JSON line of kernel records, then, as its last line,
   ``{"ok": true, "device": {...}}``.

Any failure raises, so the exit code is non-zero and no result line is
printed; without a CUDA device it exits with code 2.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib
import json
import math
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
# --pcd_points of the large-cloud encode phase: past the 3072 points the
# selection kernels once refused, as the JAX kernels take any N
LARGE_POINTS = 4096
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
# The bf16 modes at the train shapes.  K4 and K5 against their plain bf16
# versions: each weight w = e / Z is rounded to bf16, and where the SFU's
# exponential and torch's differ across a rounding boundary the weight moves
# by 2^-8 of itself, so the bound is a share of max(1, max |v|) (of the
# largest gradient entry for K5), never looser than 2^-7.  H100 readings
# (NVIDIA H100 80GB HBM3, 700 W) at (54, 1024, 12): K4 1.1e-3 on max |v|
# 4.5 (2.4e-4 of the scale), K5 dq 9.8e-4, dk 3.9e-3, dv 3.9e-3 (at most
# 5.8e-4 of their scales).  K10's bf16 mode must equal its plain version.
ATTN_BF16_ATOL = 1e-3
ATTN_BWD_BF16_ATOL = 2e-3
# The bf16 train step, kernels against plain versions from the same weights
# and draws (the float32 step's comparison, phase 11): the loss; each
# gradient leaf's 2-norm distance over its 2-norm (a leaf below 1e-3 of the
# largest leaf norm measured against that floor), since a bf16 rounding
# that flips between K4/K5 and their plain versions, or between two orders
# of the gathers' atomic float32 sums, can move a max-pool's argmax or a
# chamfer's nearest point; and the parameters after one AdamW step where
# the gradient exceeds 5e-2 of its leaf's largest entry, whose sign a flip
# cannot turn, in leaves above that floor (AdamW's first step is
# lr g / (|g| + 1e-8): a leaf of rounding noise near 1e-8, such as a conv
# bias ahead of a train-mode BatchNorm, whose exact gradient is zero, moves
# by a share of lr that its noise sets).
TRAIN_BF16_LOSS_RTOL = 1e-2
TRAIN_BF16_GRAD_RTOL = 5e-2
TRAIN_BF16_PARAM_ATOL = 1e-6
# --diffusion_steps of the bf16 train_sdm run: its validation samples the
# bf16 model on the fused path (K7, K8, K4 and K6 in their bf16 modes)
BF16_CLI_STEPS = 100
# The bf16 modes of K6-K9 and the bf16 sampling paths (phase 8b), each
# against its plain bf16 version: tests/test_torch_bf16.py:_check_bf16's
# criterion, every entry within BF16_RTOL x max(1, |plain|), and the mean
# absolute difference within BF16_GAP_SHARE of the plain version's own
# mean gap between its bf16 and float32 results on the same inputs (which
# shows that bf16 is computed).  Kernel and plain version round the same
# values; their float32 sums run in other orders, so a rounding that falls
# near a bf16 boundary can flip and travel through the later layers.
BF16_RTOL = 3e-2
BF16_GAP_SHARE = 0.5
ENCODE_BF16_CLOUDS = (9, 72)  # K7 / K8 bf16 checked and timed at b1 and b8
TRAIN_BATCH = 6
TRAIN_STEPS = 3  # timed steps of each train configuration
# the alternate backbones of backbones_phase (JAX models/sdm.py:96-118)
ALT_BACKBONES = {"pcd_backbone_type": "DGCNN", "human_backbone_type": "P2R"}
# fitting_phase: the fitting CLIs' default SDF grid; the card's grid losses
# against the CPU's (float32 sums in another order) and its refined losses
# after 200 Adam steps from equal starts; its refined poses (radians,
# metres) within one Adam step at the default lr 0.003, which is as far
# apart as the two runs' best-so-far steps can lie where neighbouring steps'
# losses differ by rounding
FIT_SDF_DIM = 256
FIT_GRID_RTOL = 1e-5
FIT_REFINE_RTOL = 1e-4
FIT_REFINE_ATOL = 3e-3
# ContactFormer (contactformer_phase, no port kernel: the JAX model reaches
# no Pallas kernel) on the card against the same weights and noise on the
# CPU, TF32 off: float32 sums in another order through the POSA VAE and the
# temporal decoder.  Bound: |card - CPU| <= CF_RTOL * max(1, |CPU|) on the
# logits, mu and logvar of each decoder mode.  H100 reading (NVIDIA H100
# 80GB HBM3, 700 W) at 256 frames: 1.65e-6 to 2.38e-6.
CF_RTOL = 1e-5
# Its train step (mode 1, CF_TRAIN_FRAMES frames) on the card against the
# CPU, TF32 off.  In float32 the loss and the parameters by the train
# step's gates (TRAIN_LOSS_RTOL, TRAIN_PARAM_ATOL) and each gradient leaf's
# 2-norm distance over its 2-norm (a leaf below 1e-3 of the largest leaf
# norm measured against that floor) within CF_GRAD_RTOL.  Some of these
# gradients are sums of cancelling terms, whose float32 value depends on
# the order of the sum: against the CPU's float64 gradients
# (profile_contact.py --grad_check, NVIDIA H100 80GB HBM3, 700 W) the
# card's float32 ones lie 1.8e-4 away in mode 1 and 1.3e-6 in mode 4, the
# CPU's 1.3e-6 in mode 1 and 1.0e-3 in mode 4.  H100 reading of the mode-1
# check: 1.80e-4 on posa.encoder.en_log_var.weight; with TF32 products
# 6.9e-2 (tests/test_torch_cuda.py).  In float64 the card's gradients lie
# within 1.6e-14 of the CPU's, so the step itself is the same: float64 is
# held to CF_F64_RTOL.  The parameters are compared where the gradient
# exceeds CF_PARAM_CUT of its leaf's max (train_step_check's cut is
# 1e-4): a smaller gradient may change sign between the two, and Adam's
# first step moves an entry by about lr either way (1.0e-5 read with the
# 1e-4 cut).
CF_GRAD_RTOL = 5e-4
CF_PARAM_CUT = 1e-3
CF_F64_RTOL = 1e-12
CF_FRAMES = 256  # seg_len = --max_frame, train_contactformer's default
CF_TRAIN_FRAMES = 32  # the train step compared with the CPU (the CPU's time)
CF_REPS = 5  # forwards timed per decoder mode
CF_STEPS = 3  # timed train steps at CF_FRAMES, after one warm-up step
# ATISS / MIME (atiss_phase; no port kernel: the JAX models reach no Pallas
# kernel) at the reference widths, ATISS_BATCH scenes of 9 box slots, on the
# card against the same weights and inputs on the CPU, with cuDNN's TF32
# setting left at its default (on): the extractors and the train step's
# backward turn it off themselves (models/cudnn.py).  Bound on the forward:
# |card - CPU| <= ATISS_RTOL * max(1, |CPU|) on every BBoxPrediction
# member; the train step of ATISS and of MIME by _step_gates (each float32
# gradient leaf's relative 2-norm within CF_GRAD_RTOL: 1.6e-6 on an NVIDIA
# H100 80GB HBM3, 700 W, and 4.0e-2 with the extractor's convolutions in
# TF32, test_atiss_grad_gate_sees_tf32_convolutions).  Generation in float64 (a scalar
# head's outputs feed the next box's sin/cos encoding, which turns float32
# roundings into visible differences): equal classes and counts, values
# within ATISS_GEN_RTOL; the float32 reading is printed beside it.
ATISS_RTOL = 1e-5
ATISS_GEN_RTOL = 1e-9
ATISS_BATCH = 4
ATISS_REPS = 5  # forwards timed per kind
ATISS_STEPS = 3  # timed train steps, after one warm-up step
ATISS_GEN_BOXES = 12  # slots of a generated scene
# K9 against its plain version, one step: float32 sums in another order
# (FMA loops against cuBLAS) and erff against torch's erf.  H100 reading
# 2.4e-07 at b1 and b8, clip off and on.
# parallel_phase: the sharded train step at these (data, model) meshes, two
# ranks, against the single-rank step at JAX's float32 bounds
# (tests/test_parallel.py:134,137): the loss to MESH_LOSS_RTOL, the
# parameters to MESH_PARAM_ATOL where the single-rank gradient is at least
# parallel/dryrun.py:WELL_CONDITIONED (below it Adam's first step moves an
# entry by a share of the learning rate whatever the gradient's rounding).
# Adam's first step moves an entry by about lr * sign(g), so no error in a
# gradient's size shows in the parameters: every gradient leaf is held to
# MESH_GRAD_RTOL of its 2-norm as well, and the same step with each fault of
# MESH_FAULTS planted (parallel/dryrun.py:planted) must fail that gate.
# H100 readings (flagship, B=6): 1.37e-3 sound, the mask read per rank
# 1.69e-2, every gradient counted once a model rank 1.0 (PERF.md).
# Sharded sampling at 2x1 against the single-rank sample at CHAIN_ATOL.
MESH_SHAPES = ((2, 1), (1, 2))
MESH_FAULTS = ((2, 1, "local_mask"), (1, 2, "model_axis"))
MESH_LOSS_RTOL = 1e-5
MESH_PARAM_ATOL = 1e-5
MESH_GRAD_RTOL = 5e-3
MESH_SAMPLE_BATCH = 2
# threed_front_phase: train_atiss_3dfront on the card against the same run
# on the CPU, per-epoch losses (the bound the port's CLI meets against
# JAX's, tests/test_torch_threed_front.py)
THREED_FRONT_RTOL = 1e-4
THREED_FRONT_STEPS = 3
STEP_ATOL = 1e-6
STEP_REPS = 200  # launches timed per K9 case
ENCODE_REPS = 50  # launches timed per K7 / K8 stage
# The text towers (CLIP ViT-B/32's text tower and BERT-base, seeded
# weights, 32 prompts) on the card against the same towers on the CPU, TF32
# off on the card: float32 sums in another order through 12 layers, on
# outputs of order 1.  Bound: max |card - CPU| <= TEXT_RTOL * max(1, |CPU|).
# H100 readings: CLIP 5.8e-06 on outputs up to 4.0, BERT 3.0e-06.
TEXT_RTOL = 1e-5
TEXT_REPS = 20  # forwards timed per tower
TEXT_PROMPTS = 32
# PLMS (order 2) over sdm_proxd() at b1 on a 50-step respacing, through
# the kernels against the plain versions from the same initial image: the
# encode's rounding passes through 51 denoiser calls.  H100 reading 9.3e-09.
PLMS_STEPS, PLMS_ATOL = 50, 1e-5
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
# dense bf16 operations a second on the tensor cores (the H100 SXM5 data
# sheet's 989 TFLOP/s, at the 700 W limit): the bound of a bf16 mode's
# products, whose operands are bf16, whatever units the kernel runs them on
BF16_TC_OPS_PER_S = 989e12
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
    # the bf16 modes (the JAX kernels at compute_dtype=bfloat16)
    "rank1_attn_bf16": ("lsdm_tpu_torch/csrc/rank1_attn.cu",
                        "lsdm_tpu/ops/attn_pallas.py:60", "train_bf16"),
    "rank1_attn_bwd_bf16": ("lsdm_tpu_torch/csrc/rank1_attn_bwd.cu",
                            "lsdm_tpu/ops/attn_pallas.py:138", "train_bf16"),
    "select_gather_bf16": ("lsdm_tpu_torch/csrc/sg_fused.cu",
                           "lsdm_tpu/ops/sg_fused_pallas.py:128", "train_bf16_sg"),
    "sa_fused_bf16": ("lsdm_tpu_torch/csrc/sa_fused_bf16.cu",
                      "lsdm_tpu/ops/sa_fused_pallas.py:134", "fused_bf16"),
    "fp_fused_bf16": ("lsdm_tpu_torch/csrc/fp_fused_bf16.cu",
                      "lsdm_tpu/ops/fp_fused_pallas.py:93", "fused_bf16"),
    "denoise_chain_bf16": ("lsdm_tpu_torch/csrc/denoise_chain_bf16.cu",
                           "lsdm_tpu/ops/denoise_pallas.py:278", "fused_bf16"),
    "denoise_step_bf16": ("lsdm_tpu_torch/csrc/denoise_step_bf16.cu",
                          "lsdm_tpu/ops/denoise_pallas.py:173", "step_bf16"),
}
PATH_KERNELS = {"pallas": ("ball_query", "three_nn", "fps", "denoise_chain"),
                "fused": ("fps", "sa_fused", "fp_fused", "rank1_attn",
                          "denoise_chain"),
                "fused_encode": ("fps", "sa_fused", "fp_fused", "rank1_attn"),
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
                "scene_edit": ("ball_query", "three_nn", "fps", "chamfer_nn"),
                # the bf16 train steps (dtype bf16, either bn_dtype): K4/K5
                # in their bf16 modes; K10's with ball_impl "sg"
                "train_bf16": ("ball_query", "three_nn", "fps", "rank1_attn_bf16",
                               "rank1_attn_bwd_bf16"),
                "train_bf16_sg": ("select_gather_bf16", "three_nn", "fps",
                                  "rank1_attn_bf16", "rank1_attn_bwd_bf16"),
                # train_sdm --dtype bfloat16: the bf16 train steps, then
                # validation of the bf16 model on the fused path
                "train_cli_bf16": ("ball_query", "three_nn", "fps",
                                   "rank1_attn_bf16", "rank1_attn_bwd_bf16",
                                   "sa_fused_bf16", "fp_fused_bf16",
                                   "denoise_chain_bf16"),
                # a bf16 model sampled on the fused path: the fused encode
                # and the chain, or K9 once per step, in their bf16 modes
                "fused_bf16": ("fps", "sa_fused_bf16", "fp_fused_bf16",
                               "rank1_attn_bf16", "denoise_chain_bf16"),
                "step_bf16": ("fps", "sa_fused_bf16", "fp_fused_bf16",
                              "rank1_attn_bf16", "denoise_step_bf16"),
                # a DGCNN + P2R model: K4 in pcd_attention, K6 or K9 in the
                # loop, K4/K5 in its train step; no PointNet++ kernel
                "backbones_fused": ("rank1_attn", "denoise_chain"),
                "backbones_step": ("rank1_attn", "denoise_step"),
                "backbones_train": ("rank1_attn", "rank1_attn_bwd"),
                # ATISS / MIME: plain convolutions and attention, no kernel
                "atiss": (),
                # the sharded train step, on every rank: its part of the
                # clouds through K1-K5
                "train_mesh": ("ball_query", "three_nn", "fps", "rank1_attn",
                               "rank1_attn_bwd"),
                # sharded sampling, on every rank: the fused encode and the
                # chain over its scenes
                "sample_mesh": ("fps", "sa_fused", "fp_fused", "rank1_attn",
                                "denoise_chain")}
# the PointNet++ kernels, which no path of the alternate backbones launches
POINTNET2_KERNELS = ("ball_query", "three_nn", "fps", "sa_fused", "fp_fused",
                     "select_gather")
# kernels no bf16 path may launch: the float32 modes of K4-K10
NOT_ON_BF16_PATHS = ("rank1_attn", "rank1_attn_bwd", "select_gather", "sa_fused",
                     "fp_fused", "denoise_chain", "denoise_step")
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
    ("lsdm_tpu_torch.models.sampling", "make_denoise_step_loop",
     "lsdm_tpu_torch.ops.denoise", "make_denoise_step_loop_plain"),
)


def _launches() -> dict:
    """Kernel launches per kernel since the last reset: the wrappers' own
    and those of CUDA graph replays (``kernels.GRAPH_LAUNCHES``)."""
    from lsdm_tpu_torch import kernels

    return {k: v + kernels.GRAPH_LAUNCHES[k] for k, v in kernels.LAUNCHES.items()}


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
            instrs=False, bf16=False):
    """Add one call of kernel ``name`` to ``rec``: its error, its and its
    plain version's time, and the least time the card could take for the
    call's work (``nbytes`` moved, ``ops`` float32 operations, of which
    ``exps`` exponentials, which also bound it on the SFUs).  ``instrs``:
    ``ops`` counts issued float32 instructions, at FP32_INSTR_PER_S;
    ``bf16``: ``ops`` counts a bf16 mode's products, at BF16_TC_OPS_PER_S."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    rate = (BF16_TC_OPS_PER_S if bf16 else FP32_INSTR_PER_S if instrs
            else FP32_OPS_PER_S)
    ops_ms = max(ops / rate, exps / SFU_EXPS_PER_S) * 1e3
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
        if not (torch.equal(gi, wi) and torch.equal(gd.view(torch.int32),
                                                    wd.view(torch.int32))):
            raise AssertionError(f"3-NN C={C} N={xyz1.shape[1]} S={xyz2.shape[1]}: "
                                 f"indices differ or distances not the same bits "
                                 f"(max error {derr})")
        _record(rec, "three_nn", derr,
                _time_queued_ms(lambda: ballquery.three_nn_kernel(xyz1, xyz2, k),
                                QUEUED_REPS, dev)[0],
                _time_ms(lambda: ballquery.three_nn_plain(xyz1, xyz2, k), 5, dev),
                f"K2 3-NN C={C} N={xyz1.shape[1]} S={xyz2.shape[1]}, "
                f"{ballquery.three_nn_plan(C, xyz1.shape[1], xyz2.shape[1])} lanes a "
                f"target: equal indices, distances the same bits",
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


def _chain_pass1_ms(e2, p, dev, compute_dtype=None) -> float:
    """Device ms of K6's first pass over the step rows e2 (B, T, 2D), as the
    chain runs it: pass 1 alone (the launches of ``denoise_chain_tables``,
    in ``compute_dtype``'s mode, emb^T not kept, as the chain does not
    keep it, and not read back) over each of the chain's chunks of steps."""
    from lsdm_tpu_torch.ops import denoise

    B, T = e2.shape[:2]
    tc = denoise.chain_chunk_steps(B, T, p, compute_dtype)
    ms = 0.0
    for steps, count in ((tc, T // tc), (T % tc, 1)):
        if steps and count:
            rows = e2[:, :steps].contiguous()
            if dev.type == "cuda":
                fn = functools.partial(denoise._tables_scratch, rows, p, compute_dtype,
                                       keep_emb=False)
            else:
                fn = functools.partial(denoise.denoise_chain_tables, rows, p, compute_dtype)
            ms += count * _time_ms(fn, 3, dev)
    return ms


def _chain_pass1_bytes(B: int, T: int, p) -> int:
    """Bytes the bf16 mode's first pass moves over B scenes and T steps as
    ``_chain_pass1_ms`` runs it: its bf16 tables u0, u2 and u4^T each
    written once and read once, g (float32) written once, the step rows e2
    read once, and its bf16 operand copies read once a chunk (the weights'
    reads beyond the first come from L2).  emb^T stays on chip."""
    import torch

    from lsdm_tpu_torch.ops import denoise

    N, D2, U0, U2, D15 = (p.w_up4.shape[0], p.wc_t.shape[0], p.w_up0.shape[0],
                          p.w_up2.shape[0], p.wx0_t.shape[1])
    tables = 2 * 2 * ((U0 + U2) * D2 + D2 * denoise._ldn(N, True)) + 4 * N * D15
    chunks = -(-T // denoise.chain_chunk_steps(B, T, p, torch.bfloat16))
    return B * T * (tables + 4 * D2) + chunks * _nbytes(*p.operands)


def _chain_pass1_library_ms(e2, p, dev, dtype=None) -> float:
    """Device ms of pass 1's library yardstick over the step rows e2 (B, T,
    2D), chunked as ``_chain_pass1_ms`` chunks them: for each chunk of z =
    B x steps (scene, step) pairs, its four products with their biases as
    ``torch.baddbmm`` calls (cuBLAS in full float32, TF32 off; with
    ``dtype`` bf16 on bf16 tensors, the tensor cores) on tables of the
    kernel's shapes.  Without the GELUs and u0, it is a floor for the
    kernel rather than the same function; timed here only, never called by
    the port."""
    import torch

    from lsdm_tpu_torch.ops import denoise

    B, T, D2 = e2.shape
    N, U0, U2, D = (p.w_up4.shape[0], p.w_up0.shape[0], p.w_up2.shape[0],
                    p.wc_t.shape[1])
    tc = denoise.chain_chunk_steps(B, T, p, dtype)
    g = torch.Generator(device=dev).manual_seed(0)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = dtype or torch.float32
    b_up2, b_up4, bc, bx0 = (b.to(dt) for b in (p.b_up2, p.b_up4, p.bc, p.bx0))
    ms = 0.0
    try:
        for steps, count in ((tc, T // tc), (T % tc, 1)):
            if not (steps and count):
                continue
            z = B * steps
            u0, u2, u4, emb = (torch.randn(z, r, c, generator=g, device=dev).to(dt)
                               for r, c in ((U0, D2), (U2, D2), (N, D2), (N, D)))
            w_up2, w_up4, wc, wx = (w.to(dt).expand(z, -1, -1) for w in (
                p.w_up2, p.w_up4, p.wc_t, p.wx0_t[D:]))

            def products():
                torch.baddbmm(b_up2, w_up2, u0)
                torch.baddbmm(b_up4, w_up4, u2)
                torch.baddbmm(bc, u4, wc)
                torch.baddbmm(bx0, emb, wx)
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
                    _time_queued_ms(lambda: sg_fused.select_gather_kernel(
                        r, ns, xyz, qc, base), QUEUED_REPS, dev)[0],
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
                _time_queued_ms(lambda: chamfer.directed_nn_kernel(a, b),
                                QUEUED_REPS, dev)[0],
                _time_ms(lambda: chamfer.directed_nn_plain(a, b), 5, dev),
                f"K11 nearest neighbour {name} ({batch},{N},3) plan "
                f"{chamfer.chamfer_nn_plan(batch, N, b.shape[1])}: equal indices, "
                f"max error {err:.3g}", _nbytes(a, b, gm, ga),
                (DIST_INSTRS + 2) * batch * N * b.shape[1], instrs=True)
    return rec


def bf16_kernel_checks(dev, model, batch: int = TRAIN_BATCH) -> dict:
    """Phase 10b: the bf16 modes at the train step's shapes (``batch`` x
    max_objs clouds of N points): K4 on bf16 (clouds, N, 12) with its row
    denominators, within ATTN_BF16_ATOL x max(1, max |v|) of its plain bf16
    version, SDPA's bf16 forward timed beside it; K5 from those
    denominators, each of dq, dk, dv within ATTN_BWD_BF16_ATOL x max(1, its
    largest entry), SDPA's bf16 backward beside it; K10 on bf16 stage
    columns at sa1-sa4, equal to its plain version, outputs and indices.
    Each timed queued behind a sleep; K4 also at 9 clouds without
    denominators, as the bf16 encode calls it, beside SDPA's bf16 forward
    (``clouds9``).  Returns {kernel: record}."""
    import torch

    from lsdm_tpu_torch.ops import attn, fps, sg_fused
    from lsdm_tpu_torch.ops.pointcloud import index_points
    from lsdm_tpu_torch.profile_encode import ball_scan

    cfg = model.cfg
    C_, N, H = batch * cfg.max_objs, cfg.pcd_points, cfg.translation_params
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    rec: dict = {}
    bf = torch.bfloat16
    q, k, v = (torch.randn(C_, N, H, generator=g, device=dev).to(bf) for _ in range(3))
    gout = torch.randn(C_, N, H, generator=g, device=dev)
    out, den = attn.rank1_mha_kernel(q, k, v, denominator=True)
    want, wden = attn.rank1_mha_plain(q, k, v, denominator=True)
    tol = ATTN_BF16_ATOL * max(1.0, v.abs().max().item())
    err = (out - want).abs().max().item()
    derr = ((den - wden).abs() / wden).max().item()
    if not (torch.isfinite(out).all() and err <= tol and derr <= ATTN_DEN_RTOL):
        raise AssertionError(f"rank-1 attention bf16: max error {err} (tolerance {tol}), "
                             f"denominators {derr} (tolerance {ATTN_DEN_RTOL})")
    # the float32 mode's summation order, which K5 relies on: the same bits
    if not torch.equal(den, attn.rank1_mha_kernel(q.float(), k.float(), v.float(),
                                                  denominator=True)[1]):
        raise AssertionError("rank-1 attention bf16: row denominators differ from the "
                             "float32 mode's on the same values")
    del want, wden
    q4, k4, v4 = (t.transpose(1, 2)[..., None].contiguous() for t in (q, k, v))
    _record(rec, "rank1_attn_bf16", err,
            _time_queued_ms(lambda: attn.rank1_mha_kernel(q, k, v, True),
                            QUEUED_REPS, dev)[0],
            _time_ms(lambda: attn.rank1_mha_plain(q, k, v, True), 3, dev),
            f"K4 rank-1 attention bf16 ({C_},{N},{H}) with denominators: max error "
            f"{err:.3g} (tolerance {tol:.3g} = {ATTN_BF16_ATOL:.3g} x max(1, max |v|)); "
            f"row denominators max relative error {derr:.3g}",
            _nbytes(q, k, v, out, den), 6 * C_ * H * N * N,
            _time_queued_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q4, k4, v4, scale=1.0), QUEUED_REPS, dev)[0], exps=C_ * H * N * N)
    rec["rank1_attn_bf16"]["den_max_rel_err"] = derr
    # the bf16 encode's call: 9 clouds (a b1 sample), no denominators
    q9, k9, v9 = (t[:9].contiguous() for t in (q, k, v))
    got9 = attn.rank1_mha_kernel(q9, k9, v9)
    err9 = (got9 - attn.rank1_mha_plain(q9, k9, v9)).abs().max().item()
    tol9 = ATTN_BF16_ATOL * max(1.0, v9.abs().max().item())
    if not (torch.isfinite(got9).all() and err9 <= tol9):
        raise AssertionError(f"rank-1 attention bf16 (9,{N},{H}): max error {err9} "
                             f"(tolerance {tol9})")
    sdpa9 = [t.transpose(1, 2)[..., None].contiguous() for t in (q9, k9, v9)]
    ms9 = _time_queued_ms(lambda: attn.rank1_mha_kernel(q9, k9, v9), QUEUED_REPS, dev)[0]
    lib9 = _time_queued_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        *sdpa9, scale=1.0), QUEUED_REPS, dev)[0]
    bound9 = max(_nbytes(q9, k9, v9, got9) / HBM_BYTES_PER_S,
                 6 * 9 * H * N * N / FP32_OPS_PER_S, 9 * H * N * N / SFU_EXPS_PER_S) * 1e3
    print(f"K4 rank-1 attention bf16 (9,{N},{H}), the bf16 encode's call: max error "
          f"{err9:.3g} (tolerance {tol9:.3g}); kernel {ms9:.4f} ms, SDPA bf16 forward "
          f"{lib9:.4f} ms, bound {bound9:.4f} ms")
    rec["rank1_attn_bf16"]["clouds9"] = {"ms": ms9, "library_ms": lib9,
                                         "bound_ms": bound9, "max_abs_err": err9}
    del sdpa9, got9

    got = attn.rank1_mha_bwd_kernel(q, k, v, out, gout, den)
    want = attn.rank1_mha_bwd_plain(q, k, v, out, gout)
    errs, tols = [], []
    for a, w in zip(got, want):
        errs.append((a.float() - w.float()).abs().max().item())
        tols.append(ATTN_BWD_BF16_ATOL * max(1.0, w.float().abs().max().item()))
    if not (all(torch.isfinite(a).all() and a.dtype == bf for a in got)
            and all(e <= t for e, t in zip(errs, tols))):
        raise AssertionError(f"rank-1 attention backward bf16: errors {errs} "
                             f"(tolerances {tols})")
    del want
    q4, k4, v4 = (t.requires_grad_() for t in (q4, k4, v4))
    out4 = torch.nn.functional.scaled_dot_product_attention(q4, k4, v4, scale=1.0)
    g4 = gout.to(bf).transpose(1, 2)[..., None].contiguous()
    lib = _time_ms(lambda: torch.autograd.grad(out4, (q4, k4, v4), g4,
                                               retain_graph=True), 5, dev)
    del q4, k4, v4, out4
    _record(rec, "rank1_attn_bwd_bf16", max(errs),
            _time_queued_ms(lambda: attn.rank1_mha_bwd_kernel(q, k, v, out, gout, den),
                            QUEUED_REPS, dev)[0],
            _time_ms(lambda: attn.rank1_mha_bwd_plain(q, k, v, out, gout), 3, dev),
            f"K5 rank-1 attention backward bf16 ({C_},{N},{H}): max errors dq, dk, dv "
            f"{[f'{e:.3g}' for e in errs]} (tolerances {[f'{t:.3g}' for t in tols]} = "
            f"{ATTN_BWD_BF16_ATOL:.3g} x max(1, max |grad|))",
            _nbytes(q, k, v, out, gout, den, *got), 13 * C_ * H * N * N, lib,
            exps=C_ * H * N * N)
    del got, out, den

    # K10 at sa1..sa4 on bf16 columns: centers by FPS as the stages pick them
    bb = model.pcd_backbone
    stages = (bb.sa1, bb.sa2, bb.sa3, bb.sa4)
    levels = [torch.randn(C_, N, 3, generator=g, device=dev)] * 2
    for st in stages[1:]:
        idx = fps.farthest_point_sample_plain(levels[-1], st.npoint)
        levels.append(index_points(levels[-1], idx).contiguous())
    for st, xyz, new_xyz in zip(stages, levels[:4], levels[1:5]):
        width = st.mlp_convs[0].weight.shape[1]
        base = torch.cat([xyz, torch.randn(C_, xyz.shape[1], width - 3, generator=g,
                                           device=dev)], -1).to(bf).contiguous()
        r, ns = st.radius, min(st.nsample, xyz.shape[1])
        got, gi = sg_fused.select_gather_kernel(r, ns, xyz, new_xyz, base)
        want, wi = sg_fused.select_gather_plain(r, ns, xyz, new_xyz, base)
        line = (f"K10 select-gather bf16 N={xyz.shape[1]} S={new_xyz.shape[1]} K={ns} "
                f"C={base.shape[2]}: ")
        if not (got.dtype == bf and torch.equal(gi, wi) and torch.equal(got, want)):
            raise AssertionError(line + "differs from the plain version")
        _record(rec, "select_gather_bf16", 0.0,
                _time_queued_ms(lambda: sg_fused.select_gather_kernel(
                    r, ns, xyz, new_xyz, base), QUEUED_REPS, dev)[0],
                _time_ms(lambda: sg_fused.select_gather_plain(r, ns, xyz, new_xyz, base),
                         3, dev),
                line + "equal indices and values",
                _nbytes(xyz, new_xyz, base, got, gi),
                DIST_INSTRS * ball_scan(r, ns, xyz, new_xyz) + 3 * gi.numel(),
                instrs=True)
        del got, want
    return rec


def train_step_check(dev, cfg, label: str, chamfer_impl: str = "xla",
                     batch: int = TRAIN_BATCH, T: int = T_STEPS,
                     noise_leaves=(), **impls):
    """Phase 11, one configuration: a train step at ``batch`` scenes through
    the kernels and through the plain versions, from the same weights, t,
    noise and dropout keep-mask.  Returns (launch counts of the kernel
    step, {loss, grad, param} errors, ms per kernel step over TRAIN_STEPS
    steps after the compared one, peak GiB of the kernel steps).  A bf16
    configuration (``cfg.dtype``) measures its gradients by each leaf's
    relative 2-norm and its parameters where the gradient exceeds 5e-2 of
    the leaf's largest entry (TRAIN_BF16_*).  ``noise_leaves``: parameters
    whose gradient is analytically zero, so that both runs hold rounding
    noise there and Adam's first step, which moves every entry by about
    the learning rate whatever its gradient's size, moves them apart; they
    stay in the gradient check (held to its floor) and leave the
    parameter check."""
    import torch

    from lsdm_tpu_torch import kernels
    from lsdm_tpu_torch.diffusion.schedule import make_schedule
    from lsdm_tpu_torch.profile_train import build, seeded_batch
    from lsdm_tpu_torch.train.trainer import dropout_draws, make_train_step

    inputs = seeded_batch(cfg, batch, SEED, dev)
    schedule = make_schedule("cosine", T, device=dev)
    step = make_train_step(schedule, chamfer_impl=chamfer_impl)
    cfg = dataclasses.replace(cfg, **impls)
    kstate, pstate = (build(cfg, cfg.ball_impl, cfg.attn_impl, SEED, dev)
                      for _ in range(2))
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    # the object backbone's keep-masks: PointNet++'s head or DGCNN's two
    draws = dict(
        t=torch.randint(0, T, (batch,), generator=g, device=dev),
        noise=torch.randn(batch, cfg.pcd_points, 3, generator=g, device=dev),
        dropout_mask=dropout_draws(kstate.model, batch * cfg.max_objs, g, dev))

    def run(state):
        metrics = step(state, *inputs, **draws)
        grads = {n: p.grad.detach().clone() for n, p in state.model.named_parameters()}
        params = {n: p.detach().clone() for n, p in state.model.named_parameters()}
        return float(metrics["loss"]), grads, params

    _sync(dev)
    kernels.reset_launches()
    loss_k, grads_k, params_k = run(kstate)
    _sync(dev)
    launches = _launches()
    with plain_versions():
        kernels.reset_launches()
        loss_p, grads_p, params_p = run(pstate)
        if any(kernels.LAUNCHES.values()):
            raise AssertionError(f"the plain train step launched kernels: {kernels.LAUNCHES}")
    del pstate
    if not all(torch.isfinite(t).all() for t in grads_k.values()):
        raise AssertionError(f"{label}: non-finite gradients")
    bf16 = cfg.dtype == "bfloat16"
    grad_err, param_err, noise, worst = 0.0, 0.0, 0, {"grad": "", "param": ""}
    norm = (lambda t: t.norm().item()) if bf16 else (lambda t: t.abs().max().item())
    floor = 1e-3 * max(norm(g) for g in grads_p.values())
    for n, gp in grads_p.items():
        scale = norm(gp)
        # a leaf whose gradient is rounding noise (a conv bias ahead of a
        # train-mode BatchNorm: ~1e-14) is held to 1e-3 of the largest
        e = norm(grads_k[n] - gp) / max(scale, floor)
        if e > grad_err:
            grad_err, worst["grad"] = e, n
        real = gp.abs() > (5e-2 if bf16 else 1e-4) * gp.abs().max()  # not noise
        if (bf16 and scale < floor) or n in noise_leaves:  # a leaf of rounding noise
            real = torch.zeros_like(real)
        noise += int((~real).sum())
        if real.any():
            e = (params_k[n] - params_p[n])[real].abs().max().item()
            if e > param_err:
                param_err, worst["param"] = e, n
    errs = {"loss": abs(loss_k - loss_p) / abs(loss_p), "grad": grad_err,
            "param": param_err}
    gates = ((TRAIN_BF16_LOSS_RTOL, TRAIN_BF16_GRAD_RTOL, TRAIN_BF16_PARAM_ATOL)
             if bf16 else (TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL, TRAIN_PARAM_ATOL))
    peak = _reset_peak(dev)
    sec = []
    for _ in range(TRAIN_STEPS):
        _sync(dev)
        t0 = time.perf_counter()
        step(kstate, *inputs, generator=g)
        _sync(dev)
        sec.append(time.perf_counter() - t0)
    ms = [x * 1e3 for x in sec]
    left = f"; left out as rounding noise: {', '.join(noise_leaves)}" if noise_leaves else ""
    print(f"train step {label} B={batch} ({batch * cfg.max_objs} clouds of "
          f"{cfg.pcd_points}): loss {loss_k:.6f} (plain {loss_p:.6f}); errors "
          f"{errs} (tolerances loss {gates[0]}, grad {gates[1]}, "
          f"param {gates[2]}; {noise} gradient entries below "
          f"{5e-2 if bf16 else 1e-4} of their leaf's max left out of the parameter "
          f"check{left}; worst leaves {worst}); step ms {[round(x, 3) for x in ms]}; "
          f"peak {peak():.2f} GiB; launches {launches}")
    if errs["loss"] > gates[0] or errs["grad"] > gates[1] or errs["param"] > gates[2]:
        raise AssertionError(f"train step {label} disagrees with its plain versions")
    return launches, errs, ms, peak()


def train_cli_phase(dev, points: int = 1024, T: int = T_STEPS,
                    dtype_args=()) -> dict:
    """Phase 12: the port's train_sdm on a synthetic proxd split (12 train
    sequences: 2 steps of batch 6; 2 validation sequences), one epoch with
    validation, then ``final.pt`` read back into a float32 model.  With
    ``dtype_args`` (``--dtype bfloat16 --bn_dtype bfloat16``) the bf16 run.
    Returns the launch counts."""
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
            "--pcd_points", str(points), "--device", str(dev), *dtype_args])
        sec = time.perf_counter() - t0
        launches = _launches()
        names = sorted(f for f in os.listdir(out) if f.endswith(".pt"))
        if names != ["best_model_cfd.pt", "best_model_train_loss.pt",
                     "epoch_0000.pt", "final.pt"]:
            raise AssertionError(f"checkpoints written: {names}")
        back = SceneDiffusionModel(dataclasses.replace(
            state.model.cfg, dtype="float32", bn_dtype="float32"))
        extra = load_torch_checkpoint(os.path.join(out, "final.pt"), back)
        for n, t in state.model.state_dict().items():
            if not torch.equal(back.state_dict()[n], t.cpu()):
                raise AssertionError(f"final.pt: {n} differs from the trained model")
        with open(os.path.join(out, "logs", "events.jsonl")) as f:
            logged = {k for line in f for k in json.loads(line) if "/" in k}
        with open(os.path.join(out, "logs", "events.jsonl")) as f:
            losses = [json.loads(line).get("train/loss") for line in f]
        if not {"train/loss", "valid/cfd"} <= logged or not all(
                math.isfinite(x) for x in losses if x is not None):
            raise AssertionError(f"logged {sorted(logged)}, train losses {losses}")
    print(f"CLI train_sdm {' '.join(dtype_args)}, 12 synthetic sequences of "
          f"{points} points, batch 6, 1 epoch + validation (T={T}) on {dev}: "
          f"{sec:.1f} s; {state.step} steps; final.pt read back equal into a "
          f"float32 model ({extra}); launches {launches}")
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
    launches = _launches()
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
    launches = _launches()
    peak = peak()
    with plain_versions():
        run()  # warm-up
        kernels.reset_launches()
        (s_p, o_p), sec_p = run()
        if any(_launches().values()):
            raise AssertionError(f"the plain run launched kernels: {_launches()}")
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


def encode_large_phase(dev, points: int = LARGE_POINTS) -> dict:
    """Phase 5, large clouds: the conditioning encode of ``sdm_proxd()`` at
    ``--pcd_points points`` (b1: 9 clouds), past the 3072 points the
    selection kernels once refused.  The fused encode (K3, K7, K8, K4)
    against the plain versions of the same configuration, within the
    fused-vs-composed bound; the composed encode over the selection kernels
    (K1, K2, K3) against the plain selection, within FUSED_ATOL.  The
    human branch yields 2 x vert_dims points (POSA's x2 upsampling: 1310 at
    the reference's 655 vertices), so the configuration takes vert_dims
    ``points / 2``.  Returns the launch counts of the fused kernel run."""
    import torch

    from lsdm_tpu_torch import kernels
    from lsdm_tpu_torch.config import sdm_proxd
    from lsdm_tpu_torch.profile_sampling import seeded_inputs

    cfg = dataclasses.replace(sdm_proxd(), pcd_points=points,
                              vert_dims=max(sdm_proxd().vert_dims, points // 2))
    composed, plain = build_models(cfg, dev)
    fused = build_fused(cfg, composed, dev)
    inputs = seeded_inputs(cfg, 1, 1, SEED, dev)[:4]

    def encode(m):
        _sync(dev)
        kernels.reset_launches()
        with torch.no_grad():
            out = m.encode_conditioning(*inputs).cond_pcd
        _sync(dev)
        return out, _launches()

    got, launches = encode(fused)
    with plain_versions():
        want, plain_launches = encode(fused)
    comp, comp_launches = encode(composed)
    ref, ref_launches = encode(plain)
    if any(plain_launches.values()) or any(ref_launches.values()):
        raise AssertionError(f"a plain encode launched kernels: {plain_launches}, "
                             f"{ref_launches}")
    for name in ("ball_query", "three_nn", "fps"):
        if comp_launches[name] < 1:
            raise AssertionError(f"the composed encode at {points} points did not "
                                 f"launch {name}")
    if not (torch.isfinite(got).all() and got.shape == want.shape):
        raise AssertionError(f"fused cond_pcd at {points} points: not finite or "
                             f"shape {tuple(got.shape)}")
    cond = ((got - want).abs() / (COND_ATOL + COND_RTOL * want.abs())).max().item()
    err_f = (got - want).abs().max().item()
    err_c = (comp - ref).abs().max().item()
    print(f"encode sdm_proxd B=1 9x{points}: fused launches {launches}; fused vs "
          f"its plain versions max |a - b| {err_f:.3g}, worst |a - b| / ({COND_ATOL} "
          f"+ {COND_RTOL} |b|) = {cond:.3g} (must be <= 1); composed over K1/K2/K3 "
          f"vs the plain selection max |a - b| {err_c:.3g} (tolerance {FUSED_ATOL})")
    if cond > 1.0 or err_c > FUSED_ATOL:
        raise AssertionError(f"the encode at {points} points disagrees with its "
                             "plain versions")
    return launches


def step_part_calls(p, args, clip: bool, dev, compute_dtype=None):
    """The two launches of one K9 call on ``args`` (x, noise, cond_pcd, e2,
    coefs) in ``compute_dtype``'s mode, each alone, through the bound
    step's methods (which count nothing: these launches time the parts):
    (u2, tiles, the tile launch's plan: its cluster size, or in the bf16
    mode its m16 tiles a block)."""
    import torch

    from lsdm_tpu_torch import kernels
    from lsdm_tpu_torch.ops import denoise

    x, noise, cpcd, e2, coef = args
    bound = denoise.bind_step(p, x.shape[1], dev, clip, compute_dtype)
    stream = kernels.stream(dev)
    scratch, out = bound.scratch(x.shape[0]), torch.empty_like(x)
    return (lambda: bound.launch_u2(e2, scratch, stream),
            lambda: bound.launch_tiles(x, noise, cpcd, coef, out, scratch, stream),
            bound.plan(x.shape[0]))


def step_kernel_checks(dev, model, batches=(1, 8)) -> dict:
    """Phase 7: K9 against its plain version with the model's tail
    weights, one step at each batch of ``batches``, clip off and on.  Each
    case is timed queued behind a sleep: the call (both launches) and,
    apart, its u2 launch and its tile launch (the plan's cluster size
    beside them).  The record holds the path's case (batch 1, no clip):
    time per launch, its bound and the plain version's time, its parts and
    the b8 case's times under ``b{B}``; the other cases add their error.
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
    parts = {}
    for B in batches:
        args = [torch.randn(B, N, 3, generator=g, device=dev),
                torch.randn(B, N, 3, generator=g, device=dev),
                torch.randn(B, N, 3, generator=g, device=dev),
                torch.randn(B, 2 * D, generator=g, device=dev), coef[500], p]
        for clip in (False, True):
            got = denoise.fused_denoise_step(*args, clip_denoised=clip)
            want = denoise.denoise_step_plain(*args, clip_denoised=clip)
            err = (got - want).abs().max().item()
            # timed as a sampler calls it: the weights bound once
            step = denoise.make_denoise_step(p, N, dev, clip)
            ms, host = _time_queued_ms(lambda: step(*args[:5]), STEP_REPS, dev)
            u2_ms = tiles_ms = float("nan")  # the launches exist on the card only
            cluster = None
            if dev.type == "cuda":
                u2, tiles, cluster = step_part_calls(p, args[:5], clip, dev)
                u2_ms = _time_queued_ms(u2, STEP_REPS, dev)[0]
                tiles_ms = _time_queued_ms(tiles, STEP_REPS, dev)[0]
            paced = _time_ms(lambda: step(*args[:5]), STEP_REPS, dev)
            line = (f"K9 denoise step B={B} N={N} D={D} clip={clip} cluster "
                    f"{cluster}: max error {err:.3g} (tolerance "
                    f"{STEP_ATOL}); u2 {u2_ms:.4f} ms, tiles {tiles_ms:.4f} ms; "
                    f"host-paced {paced:.4f} ms per launch, the host's own {host:.4f}")
            if not (torch.isfinite(got).all() and err <= STEP_ATOL):
                raise AssertionError(line)
            bound_ms = _nbytes(*args[:5], *p, got) / HBM_BYTES_PER_S * 1e3
            bound_ms = max(bound_ms, 2 * B * (2 * D * up + N * rows) / FP32_OPS_PER_S * 1e3)
            if not clip:
                parts[f"b{B}"] = {"ms": ms, "u2_ms": u2_ms, "tiles_ms": tiles_ms,
                                  "bound_ms": bound_ms,
                                  "cluster": cluster}
            if B != 1 or clip:  # not the path's case: its error counts
                print(f"{line}; kernel {ms:.4f} ms per launch")
                rec["denoise_step"]["max_abs_err"] = max(
                    rec["denoise_step"]["max_abs_err"], err)
                continue
            _record(rec, "denoise_step", err, ms,
                    _time_ms(lambda: denoise.denoise_step_plain(*args), 20, dev),
                    line, _nbytes(*args[:5], *p, got), 2 * B * (2 * D * up + N * rows))
    rec["denoise_step"].update(parts)
    return rec


def step_path(dev, cfg, model, T: int = T_STEPS):
    """Phase 8: one batch-1 sample on the step path (``model`` with the
    fused encode, ``fused_step="step"``) through the kernels, through the
    plain versions and on the chain path, same draws.  On the card the
    step path's T K9 calls are one CUDA graph: the first sample captures
    it, the timed one must replay it (no K9 call from the host, T launches
    by the replay, T u2 and T tile nodes in the captured graph).  Returns
    (launch counts of the kernel run, max |kernel - plain| per output, max
    |step - chain| per output, seconds of the kernel run, peak GiB of it,
    the graph's record)."""
    import torch

    from lsdm_tpu_torch import kernels
    from lsdm_tpu_torch.diffusion.schedule import make_schedule
    from lsdm_tpu_torch.models.sampling import sample_sdm, step_loop
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

    run("step")  # warm-up: captures the graph
    graph = step_loop(model, B, N, T, dev, False)  # the one it keeps
    replays = getattr(graph, "replays", 0)
    peak = _reset_peak(dev)
    kernels.reset_launches()
    (s_k, o_k), sec_k = run("step")
    launches = _launches()
    direct = kernels.LAUNCHES["denoise_step"]
    peak = peak()
    info = {}
    if dev.type == "cuda":
        info = {"calls": graph.calls, "kernel_nodes": list(graph.kernel_nodes),
                "capture_s": graph.capture_s, "instantiate_s": graph.instantiate_s}
        print(f"step path graph: {graph.calls} K9 calls captured in "
              f"{graph.capture_s:.3f} s, instantiated in {graph.instantiate_s:.3f} s; "
              f"kernel nodes (all, K9 u2, K9 tiles) {graph.kernel_nodes}")
        if direct or graph.replays != replays + 1:
            raise AssertionError(f"the step path did not replay its graph: {direct} "
                                 f"K9 calls from the host, {graph.replays - replays} "
                                 "replays")
        if graph.calls != T or tuple(graph.kernel_nodes[1:]) != (T, T):
            raise AssertionError(f"the step graph holds {graph.calls} K9 calls and "
                                 f"kernel nodes {graph.kernel_nodes}, not {T}")
    with plain_versions():
        kernels.reset_launches()
        (s_p, o_p), _ = run("step")
        if any(_launches().values()):
            raise AssertionError(f"the plain run launched kernels: {_launches()}")
    (s_c, o_c), _ = run("chain")
    if s_k.shape != (B, N, 3) or not torch.isfinite(s_k).all():
        raise AssertionError(f"step-path sample is not a finite {(B, N, 3)} cloud")

    def errs(s, o):
        return {"sample": (s_k - s).abs().max().item(),
                "x0": (o_k.x0 - o.x0).abs().max().item(),
                "guiding": (o_k.guiding - o.guiding).abs().max().item(),
                "cat": (o_k.cat - o.cat).abs().max().item()}

    return launches, errs(s_p, o_p), errs(s_c, o_c), sec_k, peak, info


def _bf16_gate(got, want, want32, line: str) -> dict:
    """The BF16 gate of ``got`` (a bf16 mode's output) against ``want``
    (its plain bf16 version's), ``want32`` (the plain version's float32
    result on the same inputs) measuring the bf16 gap.  Raises with
    ``line`` if it fails; returns the readings: max and mean |got - want|,
    the bound on the max, the gap, and the share of entries that differ."""
    import torch

    from lsdm_tpu_torch.profile_encode import bf16_readings

    r = {**bf16_readings(got, want, want32),
         "bound": BF16_RTOL * max(1.0, want.float().abs().max().item())}
    if not (torch.isfinite(got).all() and r["max_abs_err"] <= r["bound"]
            and r["gap"] > 0 and r["mean_abs_err"] <= BF16_GAP_SHARE * r["gap"]):
        raise AssertionError(f"{line}: {r}")
    return r


def _bf16_text(r: dict) -> str:
    return (f"max error {r['max_abs_err']:.3g} (bound {r['bound']:.3g}), mean "
            f"{r['mean_abs_err']:.3g} against the bf16 gap {r['gap']:.3g} (at most "
            f"{BF16_GAP_SHARE} of it), {r['differ']:.2%} of entries differ")


def bf16_kernel_checks_fused(dev, model, T: int = T_STEPS) -> dict:
    """Phase 8b, kernels: the bf16 modes of K7 (sa1-sa4) and K8 (fp4-fp1,
    fp1 with the head) at each of ENCODE_BF16_CLOUDS (9 the path's call,
    recorded; the rest as ``stages_b8``), their features bf16 as the bf16
    stages hand them on, each stage's TFLOP/s and bound beside its time;
    of K6 at b1 and CHAIN_BATCH (clip on), pass 1 timed apart
    beside its bf16 ``baddbmm`` yardstick and the bytes its tables move,
    pass 2 (the rest) with its TFLOP/s and its plan (warps a tile, tiles a
    block), and pass 1's tables alone (emb, g) at b1; of K9 at b1 and b8,
    clip off and on.  Each against its plain bf16 version by the BF16 gate,
    each kernel timed (K7, K8 and K9 queued behind a sleep), its bound its bytes over
    HBM_BYTES_PER_S or its products over BF16_TC_OPS_PER_S.  The kernels get
    the weights rounded once (K7, K8: each stage's ``rowmlp.bf16_operands``;
    K6, K9: ``bf16_step_params``), as the sampler hands them over.  Returns
    {kernel: record}."""
    import torch

    from lsdm_tpu_torch.diffusion.schedule import make_schedule
    from lsdm_tpu_torch.models.sampling import chain_coefficients
    from lsdm_tpu_torch.ops import denoise, fp_fused, rowmlp, sa_fused
    from lsdm_tpu_torch.profile_encode import bf16_args, encode_levels, stage_cases

    bf = torch.bfloat16
    bb = model.pcd_backbone
    N, D = model.cfg.pcd_points, model.cfg.latent_dim
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    rec: dict = {}
    for clouds in ENCODE_BF16_CLOUDS:
        for case in stage_cases(bb, encode_levels(bb, clouds, g, dev), g, bf):
            # the stage's bf16 weights made once, as the sampler keeps them
            args = bf16_args(rowmlp, case)
            sa = case["kind"] == "sa"
            name = "sa_fused_bf16" if sa else "fp_fused_bf16"
            wrapper = sa_fused.sa_stage_fused_kernel if sa else fp_fused.fp_stage_fused_kernel
            plain = sa_fused.sa_stage_fused_plain if sa else fp_fused.fp_stage_fused_plain
            got = wrapper(*args, bf)
            plan = (rowmlp.plan_sa_bf16(clouds, args[2].shape[1], args[3].shape[1],
                                        args[1], tuple(w.shape[1] for w, _ in args[5]))
                    if sa else rowmlp.plan_fp_bf16(
                        clouds, args[0].shape[1], args[1].shape[1],
                        (args[4][0][0].shape[0], *(w.shape[1] for w, _ in args[4]))))
            line = (f"{'K7 fused SA' if sa else 'K8 fused FP'} bf16 {case['name']} "
                    f"{clouds} clouds {case['desc']} ({plan.blocks} blocks of "
                    f"{plan.rows} {'centres' if sa else 'targets'}, {plan.smem} B)")
            r = _bf16_gate(got, plain(*args, bf), plain(*args), line)
            if got.dtype != bf:
                raise AssertionError(f"{line}: output {got.dtype}")
            ms = _time_queued_ms(lambda: wrapper(*args, bf), ENCODE_REPS, dev)[0]
            bound = max(case["nbytes"] / HBM_BYTES_PER_S,
                        case["products"] / BF16_TC_OPS_PER_S) * 1e3
            st = {"stage": case["name"], "ms": ms, **r, "bound_ms": bound,
                  "tflop_s": case["products"] / ms / 1e9, "rows": plan.rows,
                  "blocks": plan.blocks, "smem": plan.smem}
            if clouds != ENCODE_BF16_CLOUDS[0]:  # not the path's call: its error counts
                print(f"{line}: {_bf16_text(r)}; wrapper {ms:.4f} ms queued, "
                      f"{st['tflop_s']:.2f} TFLOP/s, bound {bound:.4f} ms")
                rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], r["max_abs_err"])
                rec[name].setdefault(f"stages_b{clouds // 9}", []).append(st)
                continue
            _record(rec, name, r["max_abs_err"], ms,
                    _time_ms(lambda: plain(*args, bf), 5, dev),
                    f"{line}: {_bf16_text(r)}; {st['tflop_s']:.2f} TFLOP/s; wrapper "
                    f"queued", case["nbytes"], case["products"], bf16=True)
            rec[name].setdefault("stages_b1", []).append(st)

    p = denoise.extract_step_params(model)
    pb = denoise.bf16_step_params(p)  # rounded once, as the sampler's are
    coef = chain_coefficients(make_schedule("cosine", T, device=dev), False)
    up = sum(w.numel() for w in (p.w_up0, p.w_up2, p.w_up4))  # on 2D rows
    tail = (p.wp0_t.numel() + p.wp2_t.numel() + D * p.wx0_t.shape[1]
            + p.wx2_t.numel() + p.wo0_t.numel() + p.wo2_t.numel())
    table = p.wc_t.numel() + D * p.wx0_t.shape[1]
    for B, clip in ((1, False), (CHAIN_BATCH, True)):
        data = (torch.randn(B, N, 3, generator=g, device=dev),
                torch.randn(B, T, N, 3, generator=g, device=dev),
                torch.randn(B, N, 3, generator=g, device=dev),
                torch.randn(B, T, 2 * D, generator=g, device=dev), coef)
        got = denoise.fused_denoise_chain(*data, pb, clip_denoised=clip,
                                          compute_dtype=bf)
        want = denoise.denoise_chain_plain(*data, p, clip, bf)
        want32 = denoise.denoise_chain_plain(*data, p, clip)
        line = f"K6 denoise chain bf16 B={B} N={N} D={D} T={T} clip={clip}"
        reads = [_bf16_gate(a, w, w32, f"{line} {n}")
                 for a, w, w32, n in zip(got, want, want32, ("final", "last_in"))]
        del want, want32
        r = max(reads, key=lambda x: x["max_abs_err"])
        ms = _time_ms(lambda: denoise.fused_denoise_chain(
            *data, pb, clip_denoised=clip, compute_dtype=bf), 3, dev)
        pass1 = _chain_pass1_ms(data[3], pb, dev, bf)
        ops1 = 2 * B * T * (2 * D * up + N * table)
        ops2 = 2 * B * T * N * tail
        moved = _chain_pass1_bytes(B, T, pb)
        pass1_rec = {"source": "lsdm_tpu_torch/csrc/denoise_tables.cu", "ms": pass1,
                     "bound_ms": ops1 / BF16_TC_OPS_PER_S * 1e3,
                     "library_ms": _chain_pass1_library_ms(data[3], p, dev, bf),
                     "tflop_s": ops1 / pass1 * 1e-9, "table_bytes": moved,
                     "table_bytes_ms": moved / HBM_BYTES_PER_S * 1e3,
                     "gb_s": moved / pass1 * 1e-6}
        plan = denoise.chain_bf16_plan(B, N)
        pass2_rec = {"source": "lsdm_tpu_torch/csrc/denoise_chain_bf16.cu",
                     "ms": ms - pass1, "bound_ms": ops2 / BF16_TC_OPS_PER_S * 1e3,
                     "tflop_s": ops2 / (ms - pass1) * 1e-9, "warps_a_tile": plan[0],
                     "tiles_a_block": plan[1]}
        line = (f"{line}: {_bf16_text(r)}; pass 1 {pass1:.3f} ms (bound "
                f"{pass1_rec['bound_ms']:.3f} on the bf16 tensor cores; "
                f"{pass1_rec['tflop_s']:.2f} TFLOP/s; its tables move "
                f"{moved / 1e9:.3f} GB, {pass1_rec['table_bytes_ms']:.3f} ms at the HBM "
                f"rate, {pass1_rec['gb_s']:.0f} GB/s; bf16 baddbmm floor, no GELU "
                f"or u0: {pass1_rec['library_ms']:.3f}), pass 2 {ms - pass1:.3f} ms "
                f"(bound {pass2_rec['bound_ms']:.3f}; {pass2_rec['tflop_s']:.2f} "
                f"TFLOP/s; {plan[0]} warps a tile, {plan[1]} tiles a block)")
        if B != 1:
            print(f"{line}; kernel {ms:.4f} ms")
            rec["denoise_chain_bf16"]["max_abs_err"] = max(
                rec["denoise_chain_bf16"]["max_abs_err"], r["max_abs_err"])
            rec["denoise_chain_bf16"][f"pass1_b{B}"] = pass1_rec
            rec["denoise_chain_bf16"][f"pass2_b{B}"] = pass2_rec
            rec["denoise_chain_bf16"][f"ms_b{B}"] = ms
            rec["denoise_chain_bf16"][f"gate_b{B}"] = r
            continue
        _record(rec, "denoise_chain_bf16", r["max_abs_err"], ms,
                _time_ms(lambda: denoise.denoise_chain_plain(*data, p, False, bf), 2,
                         dev),
                line, _nbytes(*data, *p, *got), ops1 + ops2,
                pass1_rec["library_ms"], bf16=True)
        rec["denoise_chain_bf16"].update(pass1_b1=pass1_rec, pass2_ms=ms - pass1,
                                         pass2_b1=pass2_rec, gate_b1=r)
        # pass 1 alone, its tables emb and g (emb stored as bf16)
        e2 = data[3][:, -TABLE_STEPS:].contiguous()
        got = denoise.denoise_chain_tables(e2, pb, bf)
        if not torch.equal(got[0], got[0].to(bf).float()):
            raise AssertionError("K6 bf16 pass 1: emb is not bf16")
        reads = [_bf16_gate(a, w, w32, f"K6 bf16 pass 1 tables {n}") for a, w, w32, n in
                 zip(got, denoise.denoise_chain_tables_plain(e2, p, bf),
                     denoise.denoise_chain_tables_plain(e2, p), ("emb", "g"))]
        print(f"K6 bf16 pass 1 tables (emb, g) of {e2.shape[1]} steps: "
              + "; ".join(_bf16_text(x) for x in reads))
        rec["denoise_chain_bf16"]["tables_gate"] = reads
        del got

    rows = sum(w.numel() for w in (p.wc_t, p.wp0_t, p.wp2_t, p.wx0_t, p.wx2_t,
                                   p.wo0_t, p.wo2_t))  # on N rows
    # K9 bf16's bound moves its weights as it reads them: the product
    # weights bf16 (2 bytes an element), w_up0 and the biases float32;
    # beside it the float32 basis of earlier records, every weight 4 bytes
    weight_bytes = sum(w.numel() * (2 if f in denoise.PRODUCT_WEIGHTS else 4)
                       for f, w in zip(p._fields, p))
    parts = {}
    for B in (1, 8):
        x, noise, cpcd = (torch.randn(B, N, 3, generator=g, device=dev) for _ in range(3))
        e2 = torch.randn(B, 2 * D, generator=g, device=dev)
        # the loop's last step (t = 0: c1 = 1, c2 = c3 = 0), whose output is
        # x0 itself, so the bf16 gap is that of the whole tail; and a
        # mid-loop step, which weighs x0 by c1 ~ 0.004
        for row in (T - 1, T // 2):
            args = [x, noise, cpcd, e2, coef[row]]
            for clip in (False, True):
                step = denoise.make_denoise_step(p, N, dev, clip, bf)  # bound once
                got = step(*args)
                line = f"K9 denoise step bf16 B={B} N={N} D={D} step {row + 1}/{T} clip={clip}"
                r = _bf16_gate(got, denoise.denoise_step_plain(*args, p, clip, bf),
                               denoise.denoise_step_plain(*args, p, clip), line)
                ms = _time_queued_ms(lambda: step(*args), STEP_REPS, dev)[0]
                u2_ms = tiles_ms = float("nan")  # the launches exist on the card only
                plan = None
                if dev.type == "cuda":
                    u2, tiles, plan = step_part_calls(p, args, clip, dev, bf)
                    u2_ms = _time_queued_ms(u2, STEP_REPS, dev)[0]
                    tiles_ms = _time_queued_ms(tiles, STEP_REPS, dev)[0]
                ops = 2 * B * (2 * D * up + N * rows)
                nbytes = _nbytes(*args, got) + weight_bytes
                bound, bound_f32 = (max(n / HBM_BYTES_PER_S, ops / BF16_TC_OPS_PER_S) * 1e3
                                    for n in (nbytes, _nbytes(*args, *p, got)))
                case = {"ms": ms, "u2_ms": u2_ms, "tiles_ms": tiles_ms, "plan_mt": plan,
                        "bound_ms": bound, "bound_ms_f32_weights": bound_f32,
                        "tflop_s": ops / ms / 1e9, **r}
                parts.setdefault(f"b{B}", {})[f"step{row + 1}_clip{int(clip)}"] = case
                line = (f"{line} ({plan} m16 tiles a block): {_bf16_text(r)}; u2 "
                        f"{u2_ms:.4f} ms, tiles {tiles_ms:.4f} ms; bound {bound:.5f} ms "
                        f"(float32 weights {bound_f32:.5f})")
                if B != 1 or clip or row != T - 1:  # not the path's case: its error counts
                    print(f"{line}; kernel {ms:.4f} ms per launch")
                    rec["denoise_step_bf16"]["max_abs_err"] = max(
                        rec["denoise_step_bf16"]["max_abs_err"], r["max_abs_err"])
                    continue
                _record(rec, "denoise_step_bf16", r["max_abs_err"], ms,
                        _time_ms(lambda: denoise.denoise_step_plain(*args, p, False, bf),
                                 20, dev),
                        f"{line}; per launch queued", nbytes, ops, bf16=True)
                rec["denoise_step_bf16"]["bound_ms_f32_weights"] = bound_f32
    rec["denoise_step_bf16"].update(parts)
    return rec


def bf16_path(dev, cfg, fused, T: int = T_STEPS):
    """Phase 8b, paths: ``fused``'s weights as a bf16 model
    (``dtype="bfloat16"``, the JAX bench's ``--dtype bfloat16``) sampled at
    batch 1 on the chain path and on the step path (the K9 graph replayed),
    each through the kernels and through the plain versions of the same
    configuration, same draws, by the BF16 gate (the gap from the float32
    model's plain run); the step path's timed sample must replay its graph
    (T K9 calls, none from the host).  Returns {path: (launches, gates,
    ms/scene, peak GiB)}."""
    import torch

    from lsdm_tpu_torch import kernels
    from lsdm_tpu_torch.diffusion.schedule import make_schedule
    from lsdm_tpu_torch.models.sampling import sample_sdm, step_loop
    from lsdm_tpu_torch.models.sdm import SceneDiffusionModel
    from lsdm_tpu_torch.profile_sampling import seeded_inputs

    model = SceneDiffusionModel(dataclasses.replace(cfg, ball_impl="fused",
                                                    dtype="bfloat16"))
    model.load_state_dict(fused.state_dict())
    model = model.to(dev).eval()
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

    out = {}
    for path, step in (("fused_bf16", "chain"), ("step_bf16", "step")):
        run(model, step)  # warm-up (the step path captures its graph)
        graph = (step_loop(model, B, N, T, dev, False)
                 if step == "step" and dev.type == "cuda" else None)
        replays = graph.replays if graph is not None else 0
        peak = _reset_peak(dev)
        kernels.reset_launches()
        (s_k, o_k), sec = run(model, step)
        launches = _launches()
        direct = kernels.LAUNCHES["denoise_step_bf16"]
        peak = peak()
        with plain_versions():
            kernels.reset_launches()
            (s_p, o_p), _ = run(model, step)
            (s_32, o_32), _ = run(fused, step)
            if any(_launches().values()):
                raise AssertionError(f"the plain run launched kernels: {_launches()}")
        if s_k.shape != (B, N, 3) or s_k.dtype != torch.float32:
            raise AssertionError(f"{path}: the sample is not a float32 {(B, N, 3)} cloud")
        gates = {n: _bf16_gate(a, w, w32, f"{path} sdm_proxd B=1 T={T} {n}")
                 for n, a, w, w32 in (("sample", s_k, s_p, s_32),
                                      ("x0", o_k.x0, o_p.x0, o_32.x0),
                                      ("guiding", o_k.guiding, o_p.guiding,
                                       o_32.guiding),
                                      ("cat", o_k.cat, o_p.cat, o_32.cat))}
        if graph is not None:
            if direct or graph.replays != replays + 1:
                raise AssertionError(f"the bf16 step path did not replay its graph: "
                                     f"{direct} K9 calls from the host, "
                                     f"{graph.replays - replays} replays")
            if graph.calls != T or tuple(graph.kernel_nodes[1:]) != (T, T):
                raise AssertionError(f"the bf16 step graph holds {graph.calls} K9 "
                                     f"calls and kernel nodes {graph.kernel_nodes}")
            if launches["denoise_step_bf16"] != T:
                raise AssertionError(f"K9 bf16 launched {launches['denoise_step_bf16']} "
                                     f"times, not {T}")
        print(f"{path} path sdm_proxd bf16 B=1 9x{N} T={T}: launches {launches}; "
              + "; ".join(f"{n}: {_bf16_text(r)}" for n, r in gates.items()))
        _check_launches(path, launches)
        out[path] = (launches, gates, sec * 1e3, peak)
    return out


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
        launches = _launches()
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
            _time_queued_ms(lambda: chamfer.directed_nn_kernel(src, tgt),
                            QUEUED_REPS, dev)[0],
            _time_ms(lambda: chamfer.directed_nn_plain(src, tgt), 5, dev),
            f"K11 nearest neighbour, ICP ({tries},{points},3) plan "
            f"{chamfer.chamfer_nn_plan(tries, points, points)}: equal indices, "
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
              fused_step: str = "auto", text_args=()) -> dict:
    """Phase 6 (and 9 with ``fused_step="step"``): the port's test_sdm on
    a synthetic proxd test split of 4 sequences of ``points`` points,
    batch 2.  Returns the launch counts of the run.  On the step path the
    T K9 calls of a sample must come from replays of the CUDA graph (at
    least T), and from the host only the one call before its capture."""
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
                               "--fused_step", fused_step, *text_args])
        sec = time.perf_counter() - t0
        launches = _launches()
        direct = kernels.LAUNCHES["denoise_step"]
        replayed = kernels.GRAPH_LAUNCHES["denoise_step"]
        if fused_step == "step" and (replayed < T or direct > 1):
            raise AssertionError(f"test_sdm --fused_step step made {replayed} K9 "
                                 f"calls by graph replays (at least {T}) and {direct} "
                                 "from the host (at most the one before the capture)")
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
    print(f"CLI test_sdm {' '.join(['--fused_step', fused_step, *text_args[:2]])}, "
          "4 synthetic sequences, batch 2, "
          f"T={T}: {final}; {sec:.1f} s; launches {launches}")
    return launches


_WORDS = ("place", "put", "add", "a", "the", "chair", "table", "sofa", "bed",
          "lamp", "desk", "shelf", "cabinet", "tv", "monitor", "next", "to",
          "in", "front", "of", "behind", "person", "near", "beside", "on",
          "left", "right", "side")


def _prompts(n: int = TEXT_PROMPTS):
    """``n`` seeded prompts of 5 to 12 words from _WORDS."""
    import numpy as np

    rng = np.random.RandomState(SEED)
    return [" ".join(rng.choice(_WORDS, rng.randint(5, 13))) for _ in range(n)]


def _write_merges(path: str) -> str:
    """A small CLIP-scheme BPE merges file (as tests/test_clip_parity.py
    writes one) that merges a few of _WORDS."""
    pairs = ["p l", "pl a", "pla c", "plac e</w>", "t h", "th e</w>", "c h", "ch a",
             "i r</w>", "cha ir</w>", "t a", "b l", "ta bl", "tabl e</w>", "s o",
             "so f", "sof a</w>", "p e", "pe r", "per s", "pers o", "perso n</w>",
             "n e", "ne x", "nex t</w>", "t o</w>", "o n</w>", "d e", "de s", "des k</w>"]
    with open(path, "w") as f:
        f.write("#version: synthetic\n" + "\n".join(pairs) + "\n")
    return path


def _bert_snapshot(root: str, prompts) -> None:
    """A local ``bert-base-uncased`` snapshot under ``root`` (the HF cache
    layout): seeded BERT-base weights, a vocabulary of the prompts' words,
    the config."""
    import torch

    from lsdm_tpu_torch.models.bert import BertConfig, BertModel, init_bert_weights

    snap = os.path.join(root, "hub", "models--bert-base-uncased", "snapshots", "seeded")
    os.makedirs(snap)
    torch.save(init_bert_weights(BertModel(), SEED).state_dict(),
               os.path.join(snap, "pytorch_model.bin"))
    words = sorted({w for p in prompts for w in p.split()})
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words
    with open(os.path.join(snap, "vocab.txt"), "w") as f:
        f.write("\n".join(vocab + [f"[unused{i}]" for i in range(BertConfig().vocab_size
                                                                  - len(vocab))]) + "\n")
    with open(os.path.join(snap, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(BertConfig()), f)


def text_phase(dev, prompts=None) -> dict:
    """Phase 13: the CLIP and BERT towers through ``TextEncoder`` on the
    card and on the CPU, same seeded weights and prompts.  Returns
    {tower: (max |card - CPU|, bound, ms per batch)}."""
    import torch

    from lsdm_tpu_torch.models.bert import WordPieceTokenizer
    from lsdm_tpu_torch.models.text import (CLIPTextTransformer, SimpleTokenizer,
                                            TextEncoder, init_clip_weights)

    prompts = prompts or _prompts()
    out = {}
    with tempfile.TemporaryDirectory() as root:
        merges = _write_merges(os.path.join(root, "merges.txt"))
        sd = init_clip_weights(CLIPTextTransformer(), SEED).state_dict()
        _bert_snapshot(root, prompts)
        hf_home = os.environ.get("HF_HOME")
        os.environ["HF_HOME"] = root
        try:
            for tower, kw in (("CLIP", {"state_dict": sd, "bpe_path": merges}),
                              ("BERT", {"require_parity": True})):
                card = TextEncoder(tower, dim=512, device=dev, **kw)
                host = TextEncoder(tower, dim=512, device="cpu", **kw)
                want_tok = SimpleTokenizer if tower == "CLIP" else WordPieceTokenizer
                if not isinstance(card.tokenizer, want_tok):
                    raise AssertionError(f"{tower}: tokenizer {type(card.tokenizer)}")
                got, want = card.encode(prompts), host.encode(prompts)
                if got.shape != (len(prompts), 512) or not torch.isfinite(
                        torch.from_numpy(got)).all():
                    raise AssertionError(f"{tower}: not a finite ({len(prompts)}, 512) batch")
                err = float(abs(got - want).max())
                bound = TEXT_RTOL * max(1.0, float(abs(want).max()))

                def encode_uncached():
                    card.cache.clear()
                    return card.encode(prompts)

                ms = _time_ms(encode_uncached, TEXT_REPS, dev)
                out[tower] = (err, bound, ms)
                print(f"text tower {tower} ({type(card.model).__name__}, seeded), "
                      f"{len(prompts)} prompts: max |card - CPU| {err:.3g} (bound "
                      f"{bound:.3g}); {ms:.3f} ms per batch on the card (CUDA events, "
                      "TextEncoder.encode with an empty cache: tokens to embeddings "
                      "on the host)")
                if err > bound:
                    raise AssertionError(f"text tower {tower} disagrees with the CPU")
        finally:
            if hf_home is None:
                os.environ.pop("HF_HOME", None)
            else:
                os.environ["HF_HOME"] = hf_home
    return out


def clip_cli_phase(dev, points: int = 1024, T: int = T_STEPS) -> dict:
    """Phase 13, the CLI: ``cli_phase`` with ``--text_encoder CLIP
    --bpe_path --clip_weights`` (a seeded OpenAI-named state dict); the
    CLIP tower must have encoded the prompts on the card."""
    import torch

    from lsdm_tpu_torch.models import text as text_lib

    used = []

    class Recording(text_lib.TextEncoder):
        def encode(self, texts):
            used.append(self)
            return super().encode(texts)

    with tempfile.TemporaryDirectory() as root:
        merges = _write_merges(os.path.join(root, "merges.txt"))
        weights = os.path.join(root, "clip.pt")
        torch.save(text_lib.init_clip_weights(text_lib.CLIPTextTransformer(), SEED
                                              ).state_dict(), weights)
        real, text_lib.TextEncoder = text_lib.TextEncoder, Recording
        try:
            launches = cli_phase(dev, points, T, text_args=[
                "--text_encoder", "CLIP", "--bpe_path", merges, "--clip_weights", weights])
        finally:
            text_lib.TextEncoder = real
    enc = used[0]
    if (enc.encoder_type != "CLIP" or not isinstance(enc.tokenizer, text_lib.SimpleTokenizer)
            or next(enc.model.parameters()).device.type != dev.type or len(enc.cache) < 1):
        raise AssertionError(f"test_sdm --text_encoder CLIP did not run the CLIP tower "
                             f"on {dev}")
    return launches


def plms_phase(dev, cfg, model) -> tuple:
    """Phase 14: ``plms_sample_loop`` (order 2) over ``model`` at b1 on a
    PLMS_STEPS-step respacing, through the kernels and through the plain
    versions, same initial image.  Returns (launch counts of the kernel
    run, max |kernel - plain| of the sample, seconds of the kernel run)."""
    import torch

    from lsdm_tpu_torch import kernels
    from lsdm_tpu_torch.diffusion.sampler import plms_sample_loop
    from lsdm_tpu_torch.diffusion.schedule import spaced_schedule
    from lsdm_tpu_torch.profile_sampling import seeded_inputs

    B, N = 1, cfg.pcd_points
    mask, objs, cats, text, x_init, _ = seeded_inputs(cfg, B, 1, SEED, dev)
    schedule = spaced_schedule("cosine", T_STEPS, f"ddim{PLMS_STEPS}", device=dev)

    @torch.no_grad()
    def run():
        _sync(dev)
        t0 = time.perf_counter()
        cond = model.encode_conditioning(mask, objs, cats, text)

        def model_fn(x, t):
            return model.denoise_from_cond(cond, x, schedule.timestep_map[t])

        out = plms_sample_loop(schedule, model_fn, (B, N, 3), x_init=x_init,
                               clip_denoised=False, order=2)
        _sync(dev)
        return out, time.perf_counter() - t0

    run()  # warm-up
    kernels.reset_launches()
    (s_k, o_k), sec = run()
    launches = _launches()
    with plain_versions():
        kernels.reset_launches()
        (s_p, o_p), _ = run()
        if any(_launches().values()):
            raise AssertionError(f"the plain run launched kernels: {_launches()}")
    if s_k.shape != (B, N, 3) or not torch.isfinite(s_k).all():
        raise AssertionError(f"PLMS sample is not a finite {(B, N, 3)} cloud")
    err = max((s_k - s_p).abs().max().item(), (o_k.x0 - o_p.x0).abs().max().item())
    print(f"PLMS order 2, sdm_proxd B=1 9x{N}, {PLMS_STEPS} of {T_STEPS} steps: "
          f"max |kernel - plain| {err:.3g} (tolerance {PLMS_ATOL}); {sec * 1e3:.1f} ms "
          f"a sample; launches {launches}")
    if err > PLMS_ATOL:
        raise AssertionError("PLMS through the kernels disagrees with the plain versions")
    return launches


def backbones_phase(dev, T: int = T_STEPS, cfg=None,
                    batch: int = TRAIN_BATCH) -> dict:
    """Phase 15: a DGCNN + P2R ``sdm_proxd()`` (or ``cfg``) on the fused
    chain path, the step path and one train step at ``batch``, each against
    its plain versions.  Returns {path: launch counts}."""
    from lsdm_tpu_torch.config import sdm_proxd
    from lsdm_tpu_torch.models.sdm import SceneDiffusionModel
    from lsdm_tpu_torch.weights import init_weights

    cfg = dataclasses.replace(cfg or sdm_proxd(), **ALT_BACKBONES)
    fused = init_weights(SceneDiffusionModel(dataclasses.replace(
        cfg, ball_impl="fused")), SEED).to(dev).eval()
    composed = SceneDiffusionModel(dataclasses.replace(cfg, ball_impl="pallas"))
    composed.load_state_dict(fused.state_dict())
    composed = composed.to(dev).eval()
    label = f"DGCNN + P2R sdm_proxd B=1 9x{cfg.pcd_points} T={T}"
    launches = {}

    path_launches, errs, cond, (sec_k, sec_p), peak = fused_path(dev, cfg, fused,
                                                                 composed, T)
    print(f"backbones fused path {label}: launches {path_launches}; max |kernel - "
          f"plain| {errs} (tolerance {FUSED_ATOL}); fused vs composed cond_pcd: "
          f"worst |a - b| / ({COND_ATOL} + {COND_RTOL} |b|) = {cond:.3g} "
          f"(must be <= 1); kernels {sec_k * 1e3:.1f} ms/scene, plain "
          f"{sec_p * 1e3:.1f} ms/scene, peak memory {peak:.2f} GiB")
    _check_launches("backbones_fused", path_launches)
    if max(errs.values()) > FUSED_ATOL or cond > 1.0:
        raise AssertionError("the DGCNN + P2R fused path disagrees with its plain "
                             "versions or with the composed encode")
    launches["backbones_fused"] = path_launches
    del composed

    path_launches, errs, vs_chain, sec_k, peak, _ = step_path(dev, cfg, fused, T)
    print(f"backbones step path {label}: launches {path_launches}; max |kernel - "
          f"plain| {errs} (tolerance {FUSED_ATOL}); max |step - chain| {vs_chain} "
          f"(tolerance {CHAIN_ATOL}); kernels {sec_k * 1e3:.1f} ms/scene (the graph "
          f"replayed), peak memory {peak:.2f} GiB")
    _check_launches("backbones_step", path_launches)
    if dev.type == "cuda" and path_launches["denoise_step"] != T:
        raise AssertionError(f"K9 launched {path_launches['denoise_step']} times, "
                             f"not {T}")
    if max(errs.values()) > FUSED_ATOL or max(vs_chain.values()) > CHAIN_ATOL:
        raise AssertionError("the DGCNN + P2R step path disagrees")
    launches["backbones_step"] = path_launches
    del fused

    # one frame: the positional branch's BatchNorm sees equal rows, which
    # it normalises to zero, so the gradient of the bias before it and of
    # its scale is rounding noise
    step_launches, errs, step_ms, peak = train_step_check(
        dev, dataclasses.replace(cfg, attn_impl="pallas"), "DGCNN + P2R",
        batch=batch, T=T, noise_leaves=("human_backbone.pos_embed_0.conv.bias",
                                        "human_backbone.pos_embed_0.bn.weight"))
    _check_launches("backbones_train", step_launches)
    print(f"backbones train step DGCNN + P2R at B={batch}: {min(step_ms):.1f} "
          f"ms/step, {batch * 1e3 / min(step_ms):.1f} scenes/s, peak memory "
          f"{peak:.2f} GiB")
    launches["backbones_train"] = step_launches
    return launches


def _fitting_inputs(root: str) -> dict:
    """A library of two table meshes (boxes, 12 triangles each), a 64-frame
    human sequence of 655 vertices standing on the floor beside a table
    top, and a 1024-point predicted cloud of that top."""
    import numpy as np

    from lsdm_tpu_torch.fitting.meshio import write_obj

    rs = np.random.RandomState(SEED)
    faces = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5],
                      [0, 5, 4], [1, 2, 6], [1, 6, 5], [2, 3, 7], [2, 7, 6],
                      [3, 0, 4], [3, 4, 7]], np.int32)
    lib = os.path.join(root, "lib", "table")
    os.makedirs(lib)
    for name, (sx, sy, sz) in (("small", (0.8, 0.5, 0.72)), ("large", (1.6, 0.9, 0.74))):
        verts = np.array([[x, y, z] for z in (0.0, sz) for x, y in
                          ((-sx / 2, -sy / 2), (sx / 2, -sy / 2), (sx / 2, sy / 2),
                           (-sx / 2, sy / 2))], np.float32)
        write_obj(os.path.join(lib, f"{name}.obj"), verts, faces)
    body = np.concatenate([
        (rs.rand(455, 3) - 0.5) * [0.35, 0.25, 0.0] + [0.0, 0.0, 0.1]
        + rs.rand(455, 1) * [0.0, 0.0, 1.6],                            # body
        (rs.rand(150, 3) - 0.5) * [0.25, 0.25, 0.02] + [0.0, 0.0, 0.01],  # feet
        (rs.rand(50, 3) - 0.5) * [0.3, 0.3, 0.02] + [0.7, 0.1, 0.75]])    # hands
    verts = body[None] + rs.randn(64, 1, 3) * [0.01, 0.01, 0.0]
    pred = (rs.rand(1024, 3) - 0.5) * [1.0, 0.6, 0.02] + [0.9, 0.1, 0.73]
    paths = {"lib": os.path.join(root, "lib")}
    for name, arr in (("verts", verts), ("pred", pred)):
        paths[name] = os.path.join(root, f"{name}.npy")
        np.save(paths[name], arr.astype(np.float32))
    return paths


def fitting_phase(dev, sdf_dim: int = FIT_SDF_DIM) -> dict:
    """Phase 16: ``fit_custom_obj`` on the card, each of its grid searches
    and refinements replayed on the CPU.  Returns the card's times."""
    import tempfile

    import torch

    from lsdm_tpu_torch.fitting import fit_objects
    from lsdm_tpu_torch.run import fit_custom_obj

    calls = []

    def timed(kind, fn):
        def run(*args, **kw):
            _sync(dev)
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            _sync(dev)
            calls.append((kind, (time.perf_counter() - t0) * 1e3, args, kw, out))
            return out
        return run

    saved = fit_objects.grid_search, fit_objects.refine_pose
    fit_objects.grid_search = timed("grid", saved[0])
    fit_objects.refine_pose = timed("refine", saved[1])
    try:
        with tempfile.TemporaryDirectory() as root:
            d = _fitting_inputs(root)
            results = fit_custom_obj.main([
                "--file_name", d["pred"], "--label", "table", "--vertices_path",
                d["verts"], "--obj_lib", d["lib"], "--sdf_dim", str(sdf_dim),
                "--output_dir", os.path.join(root, "out")]
                + ([] if dev.type == "cuda" else ["--device", dev.type]))
    finally:
        fit_objects.grid_search, fit_objects.refine_pose = saved
    if not results or not all(math.isfinite(r["loss"]) for r in results):
        raise AssertionError(f"fit_custom_obj fitted nothing finite: {results}")
    cpu = torch.device("cpu")
    worst = {"grid_loss": 0.0, "refine_loss": 0.0, "refine_pose": 0.0}
    for kind, _, args, kw, out in calls:
        if out.points.device.type != dev.type:
            raise AssertionError(f"{kind} ran on {out.points.device}, not {dev}")
        args = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
        want = saved[kind == "refine"](*args, **dict(kw, device=cpu))
        rel = abs(float(out.loss) - float(want.loss)) / abs(float(want.loss))
        if kind == "grid":
            pose = [float(out.rot_deg), float(out.transl_x), float(out.transl_y)]
            if pose != [float(want.rot_deg), float(want.transl_x),
                        float(want.transl_y)]:
                print(f"grid search: the card picked {pose}, the CPU "
                      f"{[float(want.rot_deg), float(want.transl_x), float(want.transl_y)]}"
                      f" (losses {float(out.loss)!r}, {float(want.loss)!r})")
            worst["grid_loss"] = max(worst["grid_loss"], rel)
        else:
            worst["refine_loss"] = max(worst["refine_loss"], rel)
            worst["refine_pose"] = max(worst["refine_pose"], max(
                abs(float(getattr(out, n)) - float(getattr(want, n)))
                for n in ("rot", "transl_x", "transl_y")))
    ms = {k: [round(c[1], 3) for c in calls if c[0] == k] for k in ("grid", "refine")}
    contact, obj = calls[0][2][2], calls[0][2][0]
    print(f"fitting fit_custom_obj sdf {sdf_dim}^3, {len(results)} cluster(s) of "
          f"{len(contact)} contact points, {len(ms['grid'])} candidate fit(s) "
          f"(object {len(obj)} points first), 4356 poses, 200 Adam steps: card ms "
          f"per grid search {ms['grid']}, per refinement {ms['refine']}; worst "
          f"against the CPU {worst} (tolerances grid loss {FIT_GRID_RTOL}, refine "
          f"loss {FIT_REFINE_RTOL}, refine pose {FIT_REFINE_ATOL}); best "
          f"{[(r['obj_id'], round(r['loss'], 6)) for r in results]}")
    if (worst["grid_loss"] > FIT_GRID_RTOL or worst["refine_loss"] > FIT_REFINE_RTOL
            or worst["refine_pose"] > FIT_REFINE_ATOL):
        raise AssertionError("the fitting on the card disagrees with the CPU")
    return ms


def contactformer_step_check(dev, frames: int = CF_TRAIN_FRAMES,
                             dtype: str = "float32", mode: int = 1,
                             cpu_dtype: str = "") -> dict:
    """One Adam step of decoder ``mode`` (1, the trainer's default) at
    ``frames`` frames in ``dtype`` on ``dev`` and in ``cpu_dtype`` (else
    ``dtype``) on the CPU from the same weights and noise.  Returns the {loss, grad, param} errors and the
    worst leaves: the loss relative to the CPU's, each gradient leaf's
    2-norm distance over its 2-norm (no less than 1e-3 of the largest leaf
    norm), the parameters where the gradient exceeds CF_PARAM_CUT of its
    leaf's max (float32) or CF_F64_RTOL (float64): an attention's key bias
    has a gradient that is zero in exact arithmetic, and Adam's first step
    moves an entry by about lr whatever its size, as ``train_step_check``
    has it."""
    import torch

    from lsdm_tpu_torch.profile_contact import contact_inputs
    from lsdm_tpu_torch.train.contact import contact_train_step

    runs = []
    for d, dt in ((torch.device("cpu"), getattr(torch, cpu_dtype or dtype)),
                  (dev, getattr(torch, dtype))):
        model, inputs, eps = contact_inputs(mode, frames, SEED)
        model.to(d, dt).train()
        opt = torch.optim.Adam(model.parameters(), lr=1e-4)
        loss, _, _ = contact_train_step(model, opt, *(t.to(d, dt) for t in inputs),
                                        1e-3, eps=eps.to(d, dt))
        runs.append((float(loss), {n: (p.grad.cpu(), p.detach().cpu())
                                   for n, p in model.named_parameters()
                                   if p.grad is not None}))
    return _step_errors(runs, dtype)


def _step_errors(runs, dtype: str, param_cut=None) -> dict:
    """The {loss, grad, param} errors of a train step on the card against
    the CPU (``runs``: [(loss, {name: (grad, param)})] for the CPU, then the
    card), as ``contactformer_step_check`` documents them; ``param_cut``,
    where given, in place of its cut."""
    (loss_c, want), (loss_d, got) = runs
    cut = param_cut or (CF_PARAM_CUT if dtype == "float32" else CF_F64_RTOL)
    errs = {"loss": abs(loss_d - loss_c) / abs(loss_c), "grad": 0.0, "param": 0.0,
            "worst": {}}
    floor = 1e-3 * max(float(g.norm()) for g, _ in want.values())
    for n, (g, p) in want.items():
        e = float((got[n][0] - g).norm()) / max(float(g.norm()), floor)
        if e > errs["grad"]:
            errs["grad"], errs["worst"]["grad"] = e, n
        real = g.abs() > cut * g.abs().max()
        if real.any():
            e = float((got[n][1] - p)[real].abs().max())
            if e > errs["param"]:
                errs["param"], errs["worst"]["param"] = e, n
    return errs


def _step_gates(dtype: str) -> tuple:
    """(loss, grad, param) bounds of ``contactformer_step_check``."""
    return ((TRAIN_LOSS_RTOL, CF_GRAD_RTOL, TRAIN_PARAM_ATOL) if dtype == "float32"
            else (CF_F64_RTOL, CF_F64_RTOL, CF_F64_RTOL))


def contactformer_phase(dev, frames: int = CF_FRAMES,
                        train_frames: int = CF_TRAIN_FRAMES) -> dict:
    """Phase 16b: ContactFormer at full width.  Each decoder mode 0-4 forward
    at ``frames`` frames on the card against the CPU (CF_RTOL), timed; one
    Adam step of mode 1 against the CPU at ``train_frames`` frames in
    float32 and in float64 (``_step_gates``); CF_STEPS timed steps at ``frames`` with their peak memory; then
    ``train_contactformer`` for 2 epochs of 2 steps on ``dev`` over a
    synthetic contact split.  No port kernel may launch.  Returns the
    card's figures."""
    import numpy as np
    import torch

    from lsdm_tpu_torch.profile_contact import contact_inputs
    from lsdm_tpu_torch.run import train_contactformer
    from lsdm_tpu_torch.train.contact import contact_train_step

    before = _launches()
    out = {"forward_ms": {}, "forward_err": {}}
    for mode in range(5):
        model, inputs, eps = contact_inputs(mode, frames, SEED)
        with torch.no_grad():
            want = model.eval()(*inputs, eps=eps)
            args = [t.to(dev) for t in (*inputs, eps)]
            model.to(dev)
            got = model(*args)
            err = max(float(((g.cpu() - w).abs() / w.abs().clamp(min=1.0)).max())
                      for g, w in zip(got, want))
            ms = _time_ms(lambda: model(*args), CF_REPS, dev)
        out["forward_ms"][mode], out["forward_err"][mode] = ms, err
        print(f"ContactFormer mode {mode} forward, {frames} frames x 655 vertices: "
              f"{ms:.3f} ms; max |card - CPU| / max(1, |CPU|) {err:.3g} "
              f"(tolerance {CF_RTOL})")
        if not all(torch.isfinite(g).all() for g in got) or err > CF_RTOL:
            raise AssertionError(f"ContactFormer mode {mode} on the card disagrees "
                                 "with the CPU")
        del model, got
    for dtype in ("float32", "float64"):
        errs = contactformer_step_check(dev, train_frames, dtype)
        gates = _step_gates(dtype)
        print(f"ContactFormer mode 1 train step in {dtype}, {train_frames} frames: "
              f"card against the CPU {errs} (tolerances loss, grad, param {gates})")
        if any(errs[k] > gate for k, gate in zip(("loss", "grad", "param"), gates)):
            raise AssertionError(f"the ContactFormer train step in {dtype} on the card "
                                 "disagrees with the CPU")
    model, inputs, _ = contact_inputs(1, frames, SEED)
    model.to(dev).train()
    opt = torch.optim.Adam(model.parameters(), lr=1e-4)
    args = [t.to(dev) for t in inputs]
    g = torch.Generator(device=dev).manual_seed(SEED)
    ms = []
    for i in range(CF_STEPS + 1):
        if i == 1:
            peak = _reset_peak(dev)
        _sync(dev)
        t0 = time.perf_counter()
        loss, _, _ = contact_train_step(model, opt, *args, 1e-3, generator=g)
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    out["step_ms"], out["peak_gib"] = ms[1:], peak()
    print(f"ContactFormer mode 1 train step, {frames} frames x 655 vertices: ms/step "
          f"{[round(x, 3) for x in ms[1:]]} (warm-up {ms[0]:.1f}), peak memory "
          f"{out['peak_gib']:.2f} GiB, loss {float(loss):.5f}")
    del model, opt, args
    with tempfile.TemporaryDirectory() as root:
        data = contact_split(os.path.join(root, "data"), n_seqs=2,
                             frames=frames * 8 + 52, seed=SEED)
        save = os.path.join(root, "out")
        t0 = time.perf_counter()
        res = train_contactformer.main([
            "--train_data_dir", data, "--mesh_ds_dir", os.path.join(root, "none"),
            "--save_dir", save, "--epochs", "2", "--steps_per_epoch", "2",
            "--max_frame", str(frames), "--device", str(dev)])
        sec = time.perf_counter() - t0
        with open(os.path.join(save, "logs", "events.jsonl")) as f:
            logged = [json.loads(line) for line in f]
        losses = [e["train/loss"] for e in logged if "train/loss" in e]
        if (not os.path.exists(os.path.join(save, "best_model_recon_acc.pt"))
                or len(losses) != 2 or not np.isfinite(losses).all()):
            raise AssertionError(f"train_contactformer wrote no checkpoint or "
                                 f"non-finite logs: {res}, {losses}")
    print(f"CLI train_contactformer, 2 epochs of 2 steps at --max_frame {frames}: "
          f"{res}; {sec:.1f} s")
    if _launches() != before:
        raise AssertionError(f"the ContactFormer phase launched a port kernel: "
                             f"{before} -> {_launches()}")
    return out


def predict_contact_phase(dev, T: int = T_STEPS) -> tuple:
    """Phase 16c: ``predict_contact`` on a synthetic proxd test split of 4
    sequences at 1024 points, batch 2, T steps, on ``dev``: 4 finite
    (1024, 3) float32 files under ``predictions/``.  Returns (the launch
    counts of the run, the sampling's ms per scene by batch)."""
    import numpy as np

    from lsdm_tpu_torch import kernels
    from lsdm_tpu_torch.data.synthetic import generate
    from lsdm_tpu_torch.run import predict_contact, test_sdm

    sampled = []
    sample_batch = test_sdm.sample_batch

    def timed(s, batch, *args, **kw):
        _sync(dev)
        t0 = time.perf_counter()
        out = sample_batch(s, batch, *args, **kw)
        _sync(dev)
        sampled.append((time.perf_counter() - t0) * 1e3 / len(batch.seq_names))
        return out

    test_sdm.sample_batch = timed
    try:
        with tempfile.TemporaryDirectory() as root:
            data = generate(root, "proxd", n_scenes=1, n_seqs=4, pnt_size=1024,
                            seed=SEED, split="test")
            kernels.reset_launches()
            t0 = time.perf_counter()
            written = predict_contact.main([
                data, "--objs_data_dir", os.path.join(root, "objs"), "--output_dir",
                os.path.join(root, "out"), "--batch_size", "2", "--diffusion_steps",
                str(T), "--device", str(dev)])
            sec = time.perf_counter() - t0
            launches = _launches()
            names = sorted(os.listdir(os.path.join(root, "out", "predictions")))
            if len(written) != 4 or len(names) != 4:
                raise AssertionError(f"predict_contact wrote {names}, not 4 files")
            for path in written:
                a = np.load(path)
                if a.shape != (1024, 3) or a.dtype != np.float32 or not np.isfinite(a).all():
                    raise AssertionError(f"{path}: not a finite (1024, 3) float32 array")
    finally:
        test_sdm.sample_batch = sample_batch
    print(f"CLI predict_contact, 4 synthetic sequences, batch 2, T={T}: {sec:.1f} s "
          f"in all; sampling ms/scene by batch {[round(x, 1) for x in sampled]}; "
          f"launches {launches}")
    return launches, sampled


def atiss_step_check(dev, dtype: str = "float32", kind: str = "atiss",
                     cpu_dtype: str = "") -> dict:
    """One ``train_baseline`` step (AdamW, lr 1e-3, weight decay 0.01) of
    ``kind`` at the reference widths, ATISS_BATCH scenes, in ``dtype`` on
    ``dev`` and in ``cpu_dtype`` (else ``dtype``) on the CPU from the same
    weights and batch: the errors of ``_step_errors``, the parameters
    compared where the gradient exceeds CF_PARAM_CUT of its leaf's max in
    both dtypes.  Adam's first step moves an entry by lr * g / (|g| + 1e-8),
    which turns a float64 gradient's last-bit difference at |g| ~ 1e-9 into
    ~1e-12 (the attention's key projections hold such entries: 8.9e-13 with
    the float64 cut of 1e-12 of the leaf's max, H100 reading)."""
    import torch

    from lsdm_tpu_torch.profile_atiss import atiss_inputs
    from lsdm_tpu_torch.run._baseline_common import baseline_step
    from lsdm_tpu_torch.train.state import create_train_state

    runs = []
    for d, dt in ((torch.device("cpu"), getattr(torch, cpu_dtype or dtype)),
                  (dev, getattr(torch, dtype))):
        model, boxes, targets = atiss_inputs(kind, ATISS_BATCH, SEED)
        state = create_train_state(model.to(d, dt), lr=1e-3, weight_decay=0.01)
        loss = baseline_step(state, {k: v.to(d, dt) for k, v in boxes.items()},
                             *(t.to(d, dt) for t in targets))
        runs.append((float(loss), {n: (p.grad.cpu(), p.detach().cpu())
                                   for n, p in model.named_parameters()}))
    return _step_errors(runs, dtype, CF_PARAM_CUT)


def threed_front_step_check(dev, dtype: str = "float32") -> dict:
    """One ``train_atiss_3dfront`` step (``run/train_atiss_3dfront.py:
    train_step``: the default ResNet18 ATISS with DMLL heads, AdamW, lr 1e-3,
    weight decay 0) on a batch of 4 rooms of :func:`threed_front_cache`
    through the CLI's ``make_boxes``, in ``dtype`` on ``dev`` and on the CPU
    from the same weights: the errors of ``_step_errors`` (the parameters
    where the gradient exceeds CF_PARAM_CUT of its leaf's max)."""
    import numpy as np
    import torch

    from lsdm_tpu_torch.data.threed_front_dataset import get_dataset_raw_and_encoded
    from lsdm_tpu_torch.models.atiss import AutoregressiveTransformer
    from lsdm_tpu_torch.run.train_atiss_3dfront import make_boxes, train_step
    from lsdm_tpu_torch.train.state import create_train_state
    from lsdm_tpu_torch.weights import init_weights

    with tempfile.TemporaryDirectory() as root:
        base, split = threed_front_cache(root)
        np.random.seed(SEED)
        raw, enc = get_dataset_raw_and_encoded(
            {"dataset_type": "cached_threedfront",
             "encoding_type": "cached_autoregressive_wocm",
             "dataset_directory": base, "annotation_file": split,
             "train_stats": "stats.json", "room_layout_size": "64,64"},
            split=["train", "val"])
        C = len(raw.class_labels)
        boxes = make_boxes(enc, [enc[i] for i in range(4)], C, 12, "cpu")
    runs = []
    for d, dt in ((torch.device("cpu"), torch.float32), (dev, getattr(torch, dtype))):
        model = init_weights(AutoregressiveTransformer(
            n_classes=C, n_mixtures=4, scalar_head=False,
            feature_extractor_name="resnet18"), SEED).to(d, dt).eval()
        state = create_train_state(model, lr=1e-3, weight_decay=0.0)
        loss = train_step(state, {k: v.to(d, dt) for k, v in boxes.items()}, False)
        runs.append((float(loss), {
            n: (p.grad.cpu() if p.grad is not None else torch.zeros_like(p).cpu(),
                p.detach().cpu()) for n, p in model.named_parameters()}))
    return _step_errors(runs, dtype, CF_PARAM_CUT)


def _gen_errors(got, want, count_got, count_want) -> float:
    """max |got - want| / max(1, |want|) over a generated scene's boxes;
    raises unless the counts and the classes are equal."""
    if count_got != count_want:
        raise AssertionError(f"{count_got} boxes generated, {count_want} on the CPU")
    if not bool((got["class_labels"].cpu() == want["class_labels"]).all()):
        raise AssertionError("generated classes differ from the CPU's")
    return max(float(((got[k].cpu().double() - want[k].double()).abs()
                      / want[k].double().abs().clamp(min=1.0)).max())
               for k in ("translations", "sizes", "angles", "valid_mask"))


def atiss_phase(dev) -> dict:
    """Phase 16d: the ATISS / MIME baselines at the reference widths
    (``profile_atiss.atiss_inputs``: ResNet18 features, 4 layers of 512,
    MIME 528, ATISS_BATCH scenes of 9 slots), cuDNN's TF32 setting left on.
    The forward of ATISS, its batch-axis quirk, the PE variant and MIME on
    the card against the CPU (ATISS_RTOL), timed (``profile_atiss``'s
    timings); one AdamW step of ATISS and of MIME against the CPU in float32
    and in float64 (``_step_gates``); ATISS_STEPS timed steps with their
    peak memory; ``generate_boxes`` and ``complete_scene`` on the
    card replaying the CPU's draws (float64: ATISS_GEN_RTOL, equal classes
    and counts; float32 printed), and the ms a box of a float32 scene on the
    card; then ``train_atiss``, ``test_atiss``, ``test_mime``,
    ``test_cf_atiss``, ``generate_scenes`` and ``get_next_obj_class`` on a
    synthetic split on ``dev``.  Returns the launch counts of the phase
    (``_check_launches("atiss")``: none)."""
    import numpy as np
    import torch

    from lsdm_tpu_torch import kernels
    from lsdm_tpu_torch.data.synthetic import generate
    from lsdm_tpu_torch.models import atiss as A
    from lsdm_tpu_torch.profile_atiss import (ATISS_KINDS, atiss_inputs, time_forward,
                                              time_generation, time_steps)
    from lsdm_tpu_torch.run import (generate_scenes, get_next_obj_class, test_atiss,
                                    test_cf_atiss, test_mime, train_atiss)
    from lsdm_tpu_torch.train.state import create_train_state

    card = _card()
    kernels.reset_launches()
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    parts = [time.perf_counter()]
    try:
        for kind in ATISS_KINDS:
            model, boxes, _ = atiss_inputs(kind, ATISS_BATCH, SEED)
            with torch.no_grad():
                want = model(boxes)
                db = {k: v.to(dev) for k, v in boxes.items()}
                model.to(dev)
                got = model(db)
                err = max(float(((g.cpu() - w).abs() / w.abs().clamp(min=1.0)).max())
                          for g, w in zip(got, want))
            ms = time_forward(model, db, ATISS_REPS)
            n = sum(p.numel() for p in model.parameters())
            print(f"ATISS {kind} forward, {ATISS_BATCH} scenes x 9 slots, {n} parameters: "
                  f"{ms:.3f} ms; max |card - CPU| / max(1, |CPU|) {err:.3g} (tolerance "
                  f"{ATISS_RTOL}); {card}")
            if not all(torch.isfinite(g).all() for g in got) or err > ATISS_RTOL:
                raise AssertionError(f"ATISS {kind} on the card disagrees with the CPU")
        parts.append(time.perf_counter())
        for kind in ("atiss", "mime"):
            for dtype in ("float32", "float64"):
                errs = atiss_step_check(dev, dtype, kind)
                gates = _step_gates(dtype)
                print(f"ATISS {kind} train step in {dtype}, {ATISS_BATCH} scenes: card "
                      f"against the CPU {errs} (tolerances loss, grad, param {gates})")
                if any(errs[k] > gate for k, gate in zip(("loss", "grad", "param"),
                                                         gates)):
                    raise AssertionError(f"the ATISS {kind} train step in {dtype} on the "
                                         "card disagrees with the CPU")
        model, boxes, targets = atiss_inputs("atiss", ATISS_BATCH, SEED)
        state = create_train_state(model.to(dev), lr=1e-3, weight_decay=0.01)
        ms, peak, loss = time_steps(state, {k: v.to(dev) for k, v in boxes.items()},
                                    [t.to(dev) for t in targets], ATISS_STEPS)
        print(f"ATISS train step, {ATISS_BATCH} scenes x 9 slots: ms/step "
              f"{[round(x, 3) for x in ms]} (after a warm-up step), peak memory "
              f"{peak:.3f} GiB, loss {loss:.5f}; {card}")
        parts.append(time.perf_counter())
        for dtype in (torch.float64, torch.float32):
            model, boxes, _ = atiss_inputs("atiss", 1, SEED)
            model.to(dtype=dtype)
            room = boxes["room_layout"].to(dtype)
            rec = A.Draws(torch.Generator().manual_seed(SEED), record=True)
            want, n_want = A.generate_boxes(model, room, rec, ATISS_GEN_BOXES)
            given = {k: want[k][:, :2] for k in ("class_labels", "translations",
                                                  "sizes", "angles")}
            rec2 = A.Draws(torch.Generator().manual_seed(SEED + 1), record=True)
            want2, n2_want = A.complete_scene(model, given, room, rec2, 6)
            model.to(dev)
            got, n_got = A.generate_boxes(model, room.to(dev), A.Draws(given=rec.taken),
                                          ATISS_GEN_BOXES)
            got2, n2_got = A.complete_scene(model, {k: v.to(dev) for k, v in given.items()},
                                            room.to(dev), A.Draws(given=rec2.taken), 6)
            err = max(_gen_errors(got, want, n_got, n_want),
                      _gen_errors(got2, want2, n2_got, n2_want))
            print(f"ATISS generate_boxes ({n_got} of {ATISS_GEN_BOXES} slots) and "
                  f"complete_scene (2 + {n2_got - 2}) in {str(dtype)[6:]} on the card, "
                  f"the CPU's draws: equal classes and counts; max |card - CPU| / "
                  f"max(1, |CPU|) {err:.3g}"
                  + (f" (tolerance {ATISS_GEN_RTOL})" if dtype == torch.float64
                     else " (float32, printed only)"))
            if dtype == torch.float64 and err > ATISS_GEN_RTOL:
                raise AssertionError("ATISS generation on the card disagrees with the CPU")
        ms_box, count = time_generation(model, room.to(dev),
                                        torch.Generator(device=dev).manual_seed(SEED),
                                        ATISS_GEN_BOXES)
        print(f"ATISS generate_boxes in float32 on the card: {count} boxes, "
              f"{ms_box:.3f} ms a box; {card}")
        del model, state
        parts.append(time.perf_counter())
        with tempfile.TemporaryDirectory() as root:
            train = generate(root, "proxd", n_scenes=1, n_seqs=4, pnt_size=1024,
                             seed=SEED, split="train")
            test = generate(root, "proxd", n_scenes=1, n_seqs=2, pnt_size=1024,
                            seed=SEED + 1, split="test")
            common = ["--objs_data_dir", os.path.join(root, "objs"), "--batch_size", "2",
                      "--device", str(dev)]
            save = os.path.join(root, "atiss")
            state = train_atiss.main(["--train_data_dir", train, "--save_dir", save,
                                      "--epochs", "1"] + common)
            pt = os.path.join(save, "final_atiss.pt")
            finals = {"atiss": test_atiss.main([test, "--load_model", pt, "--output_dir",
                                                os.path.join(root, "e1")] + common),
                      "mime": test_mime.main([test, "--output_dir",
                                              os.path.join(root, "e2")] + common),
                      "cf_atiss": test_cf_atiss.main([test, "--output_dir",
                                                      os.path.join(root, "e3")] + common)}
            written = generate_scenes.main(["--load_model", pt, "--n_scenes", "1",
                                            "--max_boxes", str(ATISS_GEN_BOXES),
                                            "--output_dir", os.path.join(root, "gen"),
                                            "--device", str(dev)])
            nxt = get_next_obj_class.main(["--device", str(dev)])
            counts = [int(np.load(w)["count"]) for w in written]
            if (state.step != 2 or len(written) != 1
                    or not all(np.isfinite(list(f.values())).all() for f in finals.values())
                    or not all(os.path.exists(os.path.join(root, f"e{i}", "results.txt"))
                               for i in (1, 2, 3))):
                raise AssertionError(f"the ATISS CLIs: {state.step} steps, {finals}, "
                                     f"{written}")
        parts.append(time.perf_counter())
        secs = [round(b - a, 1) for a, b in zip(parts, parts[1:])]
        print(f"CLI train_atiss (1 epoch of 2 steps), test_atiss, test_mime, "
              f"test_cf_atiss (2 sequences), generate_scenes (count {counts}), "
              f"get_next_obj_class ({nxt}) on the card: {secs[-1]} s; the phase's "
              f"forwards, train steps, generation and CLIs took {secs} s")
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    return _launches()


def parallel_phase(dev, cfg_kw=None, batch: int = TRAIN_BATCH,
                   T: int = T_STEPS) -> dict:
    """Phase 18: the (data, model) mesh at the flagship width
    (``sdm_proxd()``, TRAIN_BATCH scenes of 9 clouds of 1024 points, masks
    that differ from scene to scene).  Two ranks (``parallel/mesh.py:spawn``),
    one a card with NCCL where there are two cards, else both on the one
    card over gloo (its CUDA all-reduce and all-gather stage through the
    host); no rank runs on the CPU.  Each rank
    (``parallel/dryrun.py:train_and_sample_check``) runs the single-rank
    train step, then the sharded step at each of MESH_SHAPES from the same
    weights and draws (MESH_LOSS_RTOL, MESH_PARAM_ATOL, MESH_GRAD_RTOL), with
    its own launch counts (K1-K5 on every rank) and a digest of its
    parameters and statistics (equal on every rank); TRAIN_STEPS more steps
    of each are timed (the single-rank step on the first rank alone).  The
    step with each of MESH_FAULTS planted must fail the gradient gate.  Then sharded
    sampling at 2x1, MESH_SAMPLE_BATCH scenes, T=1000, on the fused path,
    against the single-rank sample at CHAIN_ATOL.  Returns the launch
    records {path: {mesh: [rank 0's, rank 1's]}}.  Rehearse on the CPU with
    ``cfg_kw=parallel.dryrun.TINY``, ``batch=8``, ``T=8`` and
    ``_check_launches`` stubbed (nothing launches there)."""
    import torch

    from lsdm_tpu_torch.config import sdm_proxd
    from lsdm_tpu_torch.parallel import dryrun
    from lsdm_tpu_torch.parallel.mesh import backend_for, spawn

    world = 2
    backend = backend_for(dev.type, world)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    print(f"parallel phase: {world} ranks on {dev.type} ({min(cards, world)} card(s)) "
          f"over {backend}" + ("" if cards >= world or dev.type != "cuda" else
                               " (the ranks share the card; gloo stages through "
                               "the host)"))
    if cfg_kw is None:  # the train CLI resolves attn_impl on CUDA to K4/K5
        cfg_kw = {k: v for k, v in dataclasses.asdict(sdm_proxd()).items()
                  if k != "attn_impl"}
    t0 = time.perf_counter()
    res = spawn(dryrun.train_and_sample_check, world, (
        dict(cfg_kw=cfg_kw, meshes=MESH_SHAPES + MESH_FAULTS, dtype="float32",
             device=dev.type,
             seed=SEED, batch=batch, T=T, reps=TRAIN_STEPS),
        dict(cfg_kw=cfg_kw, shape=(2, 1), device=dev.type, seed=SEED,
             batch=MESH_SAMPLE_BATCH, T=T)), backend=backend, timeout=600)
    sec = time.perf_counter() - t0
    records = {"train_mesh": {}, "sample_mesh": {}}
    single = res[0]["train"]["single"]
    for d, m in MESH_SHAPES:
        label = f"{d}x{m}"
        runs = [r["train"][label] for r in res]
        launches = [run["launches"] for run in runs]
        for rank_launches in launches:
            _check_launches("train_mesh", rank_launches)
        records["train_mesh"][label] = launches
        if len({run["digest"] for run in runs}) != 1:
            raise AssertionError(f"mesh {label}: the ranks' parameters differ")
        for rank, (r, run) in enumerate(zip(res, runs)):
            ref = r["train"]["single"]["metrics"]["loss"]
            err = abs(run["metrics"]["loss"] - ref) / abs(ref)
            if (err > MESH_LOSS_RTOL or run["param_err"] > MESH_PARAM_ATOL
                    or run["grad_err"] > MESH_GRAD_RTOL):
                raise AssertionError(
                    f"mesh {label} rank {rank}: loss error {err:.3g} (tolerance "
                    f"{MESH_LOSS_RTOL}), parameter error {run['param_err']:.3g} "
                    f"(tolerance {MESH_PARAM_ATOL}), gradient error "
                    f"{run['grad_err']:.3g} (tolerance {MESH_GRAD_RTOL})")
        print(f"train step mesh {label}, B={batch} ({batch * 9} clouds), {backend}: loss {runs[0]['metrics']['loss']:.6f} (single rank "
              f"{single['metrics']['loss']:.6f}); parameters within "
              f"{max(run['param_err'] for run in runs):.3g} where well conditioned "
              f"({runs[0]['ill_conditioned']} entries left out), all entries "
              f"{max(run['param_err_all'] for run in runs):.3g}; gradients "
              f"{max(run['grad_err'] for run in runs):.3g} of a leaf "
              f"({runs[0]['grad_worst']}; tolerance {MESH_GRAD_RTOL}); ranks bitwise "
              f"equal; {runs[0]['ms']:.1f} "
              f"ms/step (single rank in this call {single['ms']:.1f} ms/step); "
              f"launches {[_nonzero(x) for x in launches]}")
    for d, m, fault in MESH_FAULTS:  # the gradient gate must see each
        label = f"{d}x{m} {fault}"
        grad_err = min(r["train"][label]["grad_err"] for r in res)
        loss_err = max(abs(r["train"][label]["metrics"]["loss"]
                           - r["train"]["single"]["metrics"]["loss"]) for r in res)
        param_err = max(r["train"][label]["param_err"] for r in res)
        print(f"train step mesh {label} (a planted fault): gradients "
              f"{grad_err:.3g} of a leaf (must exceed {MESH_GRAD_RTOL}), loss "
              f"{loss_err:.3g} off, parameters within {param_err:.3g} where well "
              f"conditioned")
        if not grad_err > MESH_GRAD_RTOL:
            raise AssertionError(f"the gradient gate does not see the fault {fault}")
    sample_err = 0.0
    for rank, r in enumerate(res):
        got = r["sample"]
        _check_launches("sample_mesh", got["launches"])
        records["sample_mesh"].setdefault("2x1", []).append(got["launches"])
        err = float((got["sharded"] - got["single"]).abs().max())
        cat = float((got["cat"] - got["single_cat"]).abs().max())
        if not torch.isfinite(got["sharded"]).all() or max(err, cat) > CHAIN_ATOL:
            raise AssertionError(f"sharded sampling rank {rank}: max |sharded - single| "
                                 f"{err:.3g}, category {cat:.3g} (tolerance {CHAIN_ATOL})")
        sample_err = max(sample_err, err, cat)
    print(f"sharded sampling 2x1, B={MESH_SAMPLE_BATCH}, T={T}, path "
          f"{res[0]['sample']['path']}: max |sharded - single| {sample_err:.3g} "
          f"(sample and category; tolerance {CHAIN_ATOL}); "
          f"{res[0]['sample']['ms']:.1f} ms; launches "
          f"{[_nonzero(x) for x in records['sample_mesh']['2x1']]}; phase {sec:.1f} s")
    return records


def _nonzero(launches: dict) -> dict:
    return {k: v for k, v in launches.items() if v}


def threed_front_cache(root: str, rooms: int = 6, classes: int = 5,
                       splits=None, seed: int = SEED):
    """A cached 3D-FRONT split under ``root``, the layout of
    ``tests/test_threed_front_stack.py::test_cached_rooms_path``: ``rooms``
    bedrooms (``cache/Bedroom_NNN/boxes.npz``) of 3-5 boxes of ``classes``
    classes (start and end included), 64 x 64 layouts, ``stats.json``, and
    a split csv with each room's split from ``splits`` (default: the last
    room ``val``, the rest ``train``); the data from ``seed``.  The tests
    build theirs with it too.  Returns (cache directory, split csv)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    C = classes
    if splits is None:
        splits = ["train"] * (rooms - 1) + ["val"]
    base = os.path.join(root, "cache")
    for i in range(rooms):
        tag = f"Bedroom_{i:03d}"
        os.makedirs(os.path.join(base, tag))
        L = 3 + i % 3
        np.savez(os.path.join(base, tag, "boxes.npz"), scene_id=tag,
                 room_layout=(rng.rand(64, 64, 1) * 255).astype(np.uint8),
                 floor_plan_vertices=rng.rand(4, 3),
                 floor_plan_faces=np.array([[0, 1, 2], [0, 2, 3]]),
                 floor_plan_centroid=np.zeros(3),
                 class_labels=np.eye(C)[rng.randint(0, C - 2, L)].astype(np.float32),
                 translations=rng.randn(L, 3).astype(np.float32),
                 sizes=rng.rand(L, 3).astype(np.float32),
                 angles=rng.randn(L, 1).astype(np.float32))
    labels = [f"c{i}" for i in range(C - 2)]
    with open(os.path.join(base, "stats.json"), "w") as f:
        json.dump({"bounds_translations": [-2, -1, -2, 2, 1, 2],
                   "bounds_sizes": [0.01, 0.01, 0.01, 2, 2, 2],
                   "bounds_angles": [-math.pi, math.pi],
                   "class_labels": labels + ["start", "end"], "object_types": labels,
                   "class_frequencies": {k: 1 / len(labels) for k in labels},
                   "class_order": {k: i for i, k in enumerate(labels)},
                   "count_furniture": {k: 10 for k in labels}}, f)
    split = os.path.join(root, "splits.csv")
    with open(split, "w") as f:
        f.writelines(f"{i:03d},{name}\n" for i, name in enumerate(splits))
    return base, split


def threed_front_phase(dev) -> dict:
    """Phase 19: ``train_atiss_3dfront`` with ``--device cuda`` at its
    default widths (ResNet18 features, 4 layers of 512, DMLL heads) for
    THREED_FRONT_STEPS steps of batch 4 on a synthetic cache
    (:func:`threed_front_cache`), cuDNN's TF32 setting left on (the trainer
    turns it off for its step), against the same run on the CPU: per-epoch
    losses within THREED_FRONT_RTOL, both checkpoints written.  Returns the
    launch counts (``_check_launches("atiss")``: none)."""
    import torch

    from lsdm_tpu_torch import kernels
    from lsdm_tpu_torch.run import train_atiss_3dfront

    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    losses = {}
    try:
        with tempfile.TemporaryDirectory() as root:
            base, split = threed_front_cache(root)
            common = ["--dataset_directory", base, "--annotation_file", split,
                      "--train_stats", "stats.json", "--batch_size", "4", "--epochs",
                      "1", "--steps_per_epoch", str(THREED_FRONT_STEPS), "--seed",
                      str(SEED)]
            for label, d in (("card", str(dev)), ("cpu", "cpu")):
                out = os.path.join(root, label)
                kernels.reset_launches()
                _sync(dev)
                t0 = time.perf_counter()
                state = train_atiss_3dfront.main(common + ["--save_dir", out,
                                                           "--device", d])
                _sync(dev)
                sec = time.perf_counter() - t0
                if label == "card":
                    launches, card_sec = _launches(), sec
                if state.step != THREED_FRONT_STEPS or not {
                        "best_model_3dfront.pt", "final_3dfront.pt"} <= set(os.listdir(out)):
                    raise AssertionError(f"train_atiss_3dfront on {d}: {state.step} "
                                         f"steps, wrote {sorted(os.listdir(out))}")
                with open(os.path.join(out, "logs", "events.jsonl")) as f:
                    losses[label] = [json.loads(line)["train/loss"] for line in f]
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    card, cpu = losses["card"], losses["cpu"]
    err = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    print(f"train_atiss_3dfront on {dev} (ResNet18, 4 x 512, batch 4, "
          f"{THREED_FRONT_STEPS} steps, cuDNN TF32 setting on): losses {card}, CPU "
          f"{cpu}, relative error {err:.3g} (tolerance {THREED_FRONT_RTOL}); "
          f"{card_sec:.1f} s for the run; launches {_nonzero(launches)}")
    if not all(math.isfinite(x) for x in card) or err > THREED_FRONT_RTOL:
        raise AssertionError("train_atiss_3dfront on the card disagrees with the CPU")
    return launches


def contact_split(root: str, n_seqs: int = 2, frames: int = 96, nv: int = 655,
                  seed: int = SEED) -> str:
    """A synthetic contact split under ``root`` (the layout of
    ``data/contact_dataset.py``: ``vertices_can/<seq>verts_can.npy``,
    ``vertices/<seq>verts.npy``, ``semantics/<seq>cfs.npy``): ``n_seqs``
    sequences of ``frames`` frames of ``nv`` vertices, a body-sized cloud
    swaying in its canonical frame and walking in the world frame, each
    vertex's contact class (0-7) from its height and side.  Returns
    ``root``."""
    import numpy as np

    rs = np.random.RandomState(seed)
    for sub in ("vertices_can", "vertices", "semantics"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for s in range(n_seqs):
        body = (rs.rand(nv, 3) - 0.5) * [0.4, 0.3, 1.7] + [0.0, 0.0, 0.85]
        t = np.arange(frames)[:, None, None] / frames
        can = body[None] + 0.03 * np.sin(2 * np.pi * t + body[None, :, :1])
        world = can + t * [2.0, 1.0, 0.0] + rs.randn(1, 1, 3) * [1.0, 1.0, 0.0]
        cls = np.clip((can[..., 2] * 4).astype(np.int64), 0, 3) + 4 * (can[..., 0] > 0)
        name = f"seq{s}_"
        np.save(os.path.join(root, "vertices_can", name + "verts_can.npy"),
                can.astype(np.float32))
        np.save(os.path.join(root, "vertices", name + "verts.npy"),
                world.astype(np.float32))
        np.save(os.path.join(root, "semantics", name + "cfs.npy"), cls.astype(np.int64))
    return root


def _check_launches(path: str, launches: dict) -> None:
    for name in PATH_KERNELS[path]:
        if launches[name] < 1:
            raise AssertionError(f"kernel {name} was not launched on the {path} path")
    if (path in ("fused", "fused_encode", "step", "fused_bf16", "step_bf16")
            and launches["ball_query"] + launches["three_nn"]):
        raise AssertionError(f"the {path} path ran K1/K2: {launches}")
    if path.startswith("backbones") and any(launches[k] for k in POINTNET2_KERNELS):
        raise AssertionError(f"the {path} path ran a PointNet++ kernel: {launches}")
    if path in ("fused", "backbones_fused") and launches["denoise_step"]:
        raise AssertionError(f"the fused path ran K9: {launches}")
    if path in ("step", "backbones_step") and launches["denoise_chain"]:
        raise AssertionError(f"the step path ran K6: {launches}")
    if path == "fused_bf16" and launches["denoise_step_bf16"]:
        raise AssertionError(f"the bf16 fused path ran K9: {launches}")
    if path == "step_bf16" and launches["denoise_chain_bf16"]:
        raise AssertionError(f"the bf16 step path ran K6: {launches}")
    if path in ("train_sg", "train_bf16_sg") and launches["ball_query"]:
        raise AssertionError(f"the sg train step ran K1: {launches}")
    if path == "sample_mesh" and launches["ball_query"] + launches["three_nn"]:
        raise AssertionError(f"sharded sampling ran K1/K2: {launches}")
    if path == "atiss" and any(launches.values()):
        raise AssertionError(f"the ATISS path launched a port kernel: {launches}")
    if "bf16" in path and any(launches[k] for k in NOT_ON_BF16_PATHS):
        raise AssertionError(f"the {path} path ran a float32 or fused kernel: "
                             f"{launches}")


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
    # bf16 products summed in float32, as JAX sums them (no bf16 split-K)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
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

    _check_launches("fused_encode", encode_large_phase(dev))
    _check_launches("fused", cli_phase(dev))
    text_phase(dev)
    _check_launches("fused", clip_cli_phase(dev))
    _check_launches("fused_encode", plms_phase(dev, cfg, fused))

    records.update(step_kernel_checks(dev, fused))
    path_launches, errs, vs_chain, sec_k, peak, graph = step_path(dev, cfg, fused)
    records["denoise_step"]["graph"] = graph
    print(f"step path sdm_proxd B=1 9x{cfg.pcd_points} T={T_STEPS}: launches "
          f"{path_launches}; max |kernel - plain| {errs} (tolerance {FUSED_ATOL}); "
          f"max |step - chain| {vs_chain} (tolerance {CHAIN_ATOL})")
    _check_launches("step", path_launches)
    launches["step"] = path_launches
    if path_launches["denoise_step"] != T_STEPS:  # by the graph's replay
        raise AssertionError(f"K9 launched {path_launches['denoise_step']} times, "
                             f"not {T_STEPS}")
    if max(errs.values()) > FUSED_ATOL:
        raise AssertionError("step path disagrees with its plain versions")
    if max(vs_chain.values()) > CHAIN_ATOL:
        raise AssertionError("step path disagrees with the chain path")
    print(f"kernel path step at b1 (the graph replayed): {sec_k * 1e3:.1f} ms/scene, "
          f"{T_STEPS / sec_k:.1f} steps/s, peak memory {peak:.2f} GiB")
    ms["step"], peaks["step"] = sec_k * 1e3, peak

    # phase 8b: a bf16 model on the fused paths, its kernels' bf16 modes
    records.update(bf16_kernel_checks_fused(dev, fused))
    for path, (path_launches, gates, ms_b, peak_b) in bf16_path(dev, cfg, fused).items():
        launches[path] = path_launches
        f32 = "fused" if path == "fused_bf16" else "step"
        name = "denoise_chain_bf16" if f32 == "fused" else "denoise_step_bf16"
        records[name]["path_b1"] = {"ms_scene": ms_b, "peak_gib": peak_b,
                                    "float32_ms_scene": ms[f32], "gates": gates}
        print(f"kernel path {path} at b1: {ms_b:.1f} ms/scene, {T_STEPS * 1e3 / ms_b:.1f} "
              f"steps/s, peak memory {peak_b:.2f} GiB; the float32 {f32} path in this "
              f"call {ms[f32]:.1f} ms/scene, {peaks[f32]:.2f} GiB")
    _check_launches("step", cli_phase(dev, fused_step="step"))
    _check_launches("scene_edit", scene_edit_phase(dev))
    icp_rec, icp_launches = icp_check(dev)
    if icp_launches != ICP_ITERS + 1:  # once per iteration, once for the result
        raise AssertionError(f"the ICP launched K11 {icp_launches} times, not "
                             f"{ICP_ITERS + 1}")

    from lsdm_tpu_torch.models.sampling import resolve_train_attn_impl

    records.update(train_kernel_checks(dev, model))
    records.update(bf16_kernel_checks(dev, model))
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
    steps = {}  # label: (best ms/step, peak GiB)
    for path, label, chamfer_impl, impls in (
            ("train", "default", "xla", {}),
            ("train_sg", "ball_impl=sg", "xla", {"ball_impl": "sg"}),
            ("train_chamfer", "chamfer_impl=pallas", "pallas", {})):
        step_launches, errs, step_ms, peak = train_step_check(
            dev, train_cfg, label, chamfer_impl, **impls)
        _check_launches(path, step_launches)
        launches[path] = step_launches
        steps[label] = (min(step_ms), peak)
        print(f"train step {label} at B={TRAIN_BATCH}: {min(step_ms):.1f} ms/step, "
              f"{TRAIN_BATCH * 1e3 / min(step_ms):.1f} scenes/s, peak memory "
              f"{peak:.2f} GiB")
    # the bf16 train steps, beside the float32 ones of this call
    for path, label, impls in (
            ("train_bf16", "bf16 bn_dtype=float32", {"bn_dtype": "float32"}),
            ("train_bf16", "bf16 bn_dtype=bfloat16", {"bn_dtype": "bfloat16"}),
            ("train_bf16_sg", "bf16 bn_dtype=float32 ball_impl=sg",
             {"bn_dtype": "float32", "ball_impl": "sg"}),
            ("train_bf16_sg", "bf16 bn_dtype=bfloat16 ball_impl=sg",
             {"bn_dtype": "bfloat16", "ball_impl": "sg"})):
        step_launches, errs, step_ms, peak = train_step_check(
            dev, train_cfg, label, dtype="bfloat16", **impls)
        _check_launches(path, step_launches)
        launches[path] = {k: launches.get(path, {}).get(k, 0) + n
                          for k, n in step_launches.items()}
        f32 = steps["ball_impl=sg" if "sg" in label else "default"]
        print(f"train step {label} at B={TRAIN_BATCH}: {min(step_ms):.1f} ms/step "
              f"({TRAIN_BATCH * 1e3 / min(step_ms):.1f} scenes/s), peak memory "
              f"{peak:.2f} GiB; float32 in this call {f32[0]:.1f} ms/step, "
              f"{f32[1]:.2f} GiB")
    launches.update(backbones_phase(dev))
    fitting_phase(dev)
    contactformer_phase(dev)
    path_launches, _ = predict_contact_phase(dev)
    _check_launches("fused", path_launches)
    _check_launches("atiss", atiss_phase(dev))
    _check_launches("train_cli", train_cli_phase(dev))
    _check_launches("train_cli_bf16", train_cli_phase(
        dev, T=BF16_CLI_STEPS, dtype_args=("--dtype", "bfloat16", "--bn_dtype",
                                           "bfloat16")))
    mesh_launches = parallel_phase(dev)
    for name in PATH_KERNELS["train_mesh"]:
        records[name]["train_mesh"] = {
            label: [rank[name] for rank in ranks]
            for label, ranks in mesh_launches["train_mesh"].items()}
    for name in PATH_KERNELS["sample_mesh"]:
        records[name]["sample_mesh"] = {
            label: [rank[name] for rank in ranks]
            for label, ranks in mesh_launches["sample_mesh"].items()}
    _check_launches("atiss", threed_front_phase(dev))

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

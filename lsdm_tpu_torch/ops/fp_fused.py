"""The fused eval FeaturePropagation stage (K8): CUDA kernel and plain
version.

Replaces ``lsdm_tpu/ops/fp_fused_pallas.py:fp_stage_fused``; the kernel
lives in ``csrc/fp_fused.cu``.

One stage of the eval backbone without the gathered (B, N, k, C) tensor:
the k = min(3, S) nearest sources of every target (K2's selection, on the
same distance bits, ties to the lowest index), inverse-distance weights
``r_i = 1 / (d_i + 1e-8)``, ``w_i = r_i / ((r_0 + r_1) + r_2)``, the
interpolation ``sum_i w_i * points2[idx_i]``, concatenated after the
target's own features ``points1`` when there are any, then the stage's
layers (BatchNorm folded by ``ops/sa_fused.py:fold_conv_bn``), each with
its activation, ``"relu"`` or ``"none"``: the backbone hands fp1 its head
and its last Linear as two more layers, so one launch ends the backbone.

A wrapper runs the kernel for CUDA tensors and the plain version for CPU
tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from lsdm_tpu_torch import kernels
from lsdm_tpu_torch.ops import rowmlp
from lsdm_tpu_torch.ops.ballquery import three_nn_plain
from lsdm_tpu_torch.ops.pointcloud import index_points
from lsdm_tpu_torch.ops.sa_fused import Folded, _check_layers

EPS = 1e-8
MAX_LAYERS = rowmlp.MAX_LAYERS
ACTS = ("relu", "none")


def fp_stage_fused_plain(xyz1: torch.Tensor, xyz2: torch.Tensor,
                         points1: Optional[torch.Tensor],
                         points2: torch.Tensor, folded: Folded,
                         acts: Optional[Sequence[str]] = None) -> torch.Tensor:
    """Plain version of K8 -> (B, N, F_last): the kernel's folded math,
    with gathers where the TPU kernel multiplies weighted one-hot masks."""
    acts = _acts(folded, acts)
    k = min(3, xyz2.shape[1])
    dists, idx = three_nn_plain(xyz1, xyz2, k)               # (B, N, k)
    recips = [1.0 / (dists[..., i] + EPS) for i in range(k)]
    norm = recips[0]
    for r in recips[1:]:
        norm = norm + r
    g = index_points(points2, idx)                           # (B, N, k, D2)
    h = (recips[0] / norm)[..., None] * g[:, :, 0]
    for i in range(1, k):
        h = h + (recips[i] / norm)[..., None] * g[:, :, i]
    if points1 is not None:
        h = torch.cat([points1, h], dim=-1)
    for (w, b), act in zip(folded, acts):
        h = h @ w + b
        if act == "relu":
            h = F.relu(h)
    return h


def fp_stage_fused_kernel(xyz1: torch.Tensor, xyz2: torch.Tensor,
                          points1: Optional[torch.Tensor],
                          points2: torch.Tensor, folded: Folded,
                          acts: Optional[Sequence[str]] = None
                          ) -> torch.Tensor:
    """K8: the eval FeaturePropagation stage.  xyz1 (B, N, 3) targets,
    xyz2 (B, S, 3) sources, points1 (B, N, D1) or None, points2 (B, S, D2),
    ``folded`` the layers' (W' (F_{l-1}, F_l), b' (F_l,)) with F_0 =
    D1 + D2, ``acts`` one of "relu"/"none" per layer (default all "relu"),
    all float32 -> (B, N, F_last).  CUDA kernel for CUDA tensors, plain
    version for CPU tensors."""
    acts = _acts(folded, acts)
    flat = [t for wb in folded for t in wb]
    given = [t for t in (points1,) if t is not None]
    if kernels.on_cpu(xyz1, xyz2, points2, *given, *flat):
        return fp_stage_fused_plain(xyz1, xyz2, points1, points2, folded, acts)
    B, N, _ = xyz1.shape
    S, D2 = xyz2.shape[1], points2.shape[-1]
    dev = xyz1.device
    kernels.require("xyz1", xyz1, torch.float32, (None, None, 3), dev)
    kernels.require("xyz2", xyz2, torch.float32, (B, None, 3), dev)
    kernels.require("points2", points2, torch.float32, (B, S, None), dev)
    D1 = 0
    if points1 is not None:
        kernels.require("points1", points1, torch.float32, (B, N, None), dev)
        D1 = points1.shape[2]
    widths = _check_layers(folded, D1 + D2, dev)
    if len(folded) > MAX_LAYERS:
        raise ValueError(f"fused FP kernel takes at most {MAX_LAYERS} layers")
    cap = rowmlp.fp_max_sources((D1 + D2, *widths))
    if S > cap:  # the sources are staged beside the layers' buffers
        raise ValueError(f"fused FP kernel takes at most {cap} sources at these "
                         f"widths (the sources beside its smallest plan within "
                         f"{rowmlp.SMEM_MAX} B of shared memory), got {S}")
    out = torch.empty((B, N, widths[-1]), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    L = len(folded)
    plan = rowmlp.plan_fp(B, N, S, (D1 + D2, *widths)).ints()
    lib = kernels.load()
    with torch.cuda.device(dev):
        rc = lib.lsdm_fp_fused(
            xyz1.data_ptr(), xyz2.data_ptr(),
            None if points1 is None else points1.data_ptr(),
            points2.data_ptr(),
            (ctypes.c_void_p * (2 * L))(*[t.data_ptr() for t in flat]),
            (ctypes.c_int * L)(*widths),
            (ctypes.c_int * L)(*[int(a == "relu") for a in acts]),
            L, B, N, S, D1, D2, (ctypes.c_int * len(plan))(*plan),
            out.data_ptr(), kernels.stream(dev))
    kernels.check(rc, "fp_fused")
    kernels.LAUNCHES["fp_fused"] += 1
    return out


def _acts(folded: Folded, acts: Optional[Sequence[str]]):
    acts = tuple(acts) if acts is not None else ("relu",) * len(folded)
    if len(acts) != len(folded) or any(a not in ACTS for a in acts):
        raise ValueError(f"acts {acts} must give one of {ACTS} per layer")
    return acts

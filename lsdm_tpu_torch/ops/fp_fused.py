"""The fused eval FeaturePropagation stage (K8): CUDA kernel and plain
version.

Replaces ``lsdm_tpu/ops/fp_fused_pallas.py:fp_stage_fused``; the kernel
lives in ``csrc/fp_fused.cu``, its bf16 mode in ``csrc/fp_fused_bf16.cu``.

One stage of the eval backbone without the gathered (B, N, k, C) tensor:
the k = min(3, S) nearest sources of every target (K2's selection, on the
same distance bits, ties to the lowest index), inverse-distance weights
``r_i = 1 / (d_i + 1e-8)``, ``w_i = r_i / ((r_0 + r_1) + r_2)``, the
interpolation ``sum_i w_i * points2[idx_i]``, concatenated after the
target's own features ``points1`` when there are any, then the stage's
layers (BatchNorm folded by ``ops/sa_fused.py:fold_conv_bn``), each with
its activation, ``"relu"`` or ``"none"``: the backbone hands fp1 its head
and its last Linear as two more layers, so one launch ends the backbone.

``compute_dtype=torch.bfloat16`` is the TPU kernel's bf16 mode
(``fp_fused_pallas.py:32-89``, ``:146``): the weights ``w_i`` are rounded to
bf16 (they no longer sum to 1), the interpolation sums their exact products
with ``points2`` rounded to bf16 in float32 and is rounded to bf16,
``points1`` is rounded, each layer's output (the product of bf16 operands
summed in float32, the bias unrounded, then its activation) is rounded to
bf16, and the output is bf16; the distances and the 3-NN are float32 and
unchanged.  The kernel's bf16 mode runs its layers on the bf16 tensor
cores from bf16 weight copies (those an ``ops/rowmlp.py:Bf16Operands``
``folded`` carries, made once per model, else made here at every call),
reads ``points1`` and ``points2`` as bf16 (it takes them float32 or bf16 and
rounds them here) and counts its launches as ``fp_fused_bf16``.

A wrapper runs the kernel for CUDA tensors and the plain version for CPU
tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from lsdm_tpu_torch import kernels
from lsdm_tpu_torch.kernels import mode_matmul
from lsdm_tpu_torch.ops import rowmlp
from lsdm_tpu_torch.ops.ballquery import three_nn_plain
from lsdm_tpu_torch.ops.pointcloud import index_points
from lsdm_tpu_torch.ops.sa_fused import Folded, _check_layers, _with_bf16_copies

EPS = 1e-8
MAX_LAYERS = rowmlp.MAX_LAYERS
ACTS = ("relu", "none")


def fp_stage_fused_plain(xyz1: torch.Tensor, xyz2: torch.Tensor,
                         points1: Optional[torch.Tensor],
                         points2: torch.Tensor, folded: Folded,
                         acts: Optional[Sequence[str]] = None,
                         compute_dtype: Optional[torch.dtype] = None
                         ) -> torch.Tensor:
    """Plain version of K8 -> (B, N, F_last): the kernel's folded math,
    with gathers where the TPU kernel multiplies weighted one-hot masks; in
    ``compute_dtype`` bf16 the TPU kernel's bf16 roundings and a bf16
    output."""
    acts = _acts(folded, acts)
    bf16 = kernels.bf16_mode(compute_dtype)
    rnd = kernels.bf16_exact if bf16 else (lambda t: t)
    k = min(3, xyz2.shape[1])
    dists, idx = three_nn_plain(xyz1, xyz2, k)               # (B, N, k)
    recips = [1.0 / (dists[..., i] + EPS) for i in range(k)]
    norm = recips[0]
    for r in recips[1:]:
        norm = norm + r
    g = index_points(rnd(points2), idx)                      # (B, N, k, D2)
    h = rnd(recips[0] / norm)[..., None] * g[:, :, 0]
    for i in range(1, k):
        h = h + rnd(recips[i] / norm)[..., None] * g[:, :, i]
    h = rnd(h)
    if points1 is not None:
        h = torch.cat([rnd(points1), h], dim=-1)
    for (w, b), act in zip(folded, acts):
        h = mode_matmul(h, w, bf16) + b
        if act == "relu":
            h = F.relu(h)
        h = rnd(h)
    return h.to(torch.bfloat16) if bf16 else h


def fp_stage_fused_kernel(xyz1: torch.Tensor, xyz2: torch.Tensor,
                          points1: Optional[torch.Tensor],
                          points2: torch.Tensor, folded: Folded,
                          acts: Optional[Sequence[str]] = None,
                          compute_dtype: Optional[torch.dtype] = None
                          ) -> torch.Tensor:
    """K8: the eval FeaturePropagation stage.  xyz1 (B, N, 3) targets,
    xyz2 (B, S, 3) sources, points1 (B, N, D1) or None, points2 (B, S, D2),
    ``folded`` the layers' (W' (F_{l-1}, F_l), b' (F_l,)) with F_0 =
    D1 + D2, ``acts`` one of "relu"/"none" per layer (default all "relu"),
    all float32 -> (B, N, F_last) float32; in ``compute_dtype`` bf16
    (points1 and points2 float32 or bf16) the bf16 mode, a bf16 output, its
    weights the bf16 copies ``folded`` carries where it is a
    :class:`rowmlp.Bf16Operands` (else made here).  CUDA kernel for CUDA
    tensors, plain version for CPU tensors."""
    acts = _acts(folded, acts)
    flat = [t for wb in folded for t in wb]
    given = [t for t in (points1,) if t is not None]
    if kernels.on_cpu(xyz1, xyz2, points2, *given, *flat):
        return fp_stage_fused_plain(xyz1, xyz2, points1, points2, folded, acts,
                                    compute_dtype)
    bf16 = kernels.bf16_mode(compute_dtype)
    B, N, _ = xyz1.shape
    S, D2 = xyz2.shape[1], points2.shape[-1]
    dev = xyz1.device
    kernels.require("xyz1", xyz1, torch.float32, (None, None, 3), dev)
    kernels.require("xyz2", xyz2, torch.float32, (B, None, 3), dev)

    def feats(t):  # the bf16 mode reads bf16 features, rounded here
        if bf16 and t.dtype in (torch.float32, torch.bfloat16):
            return t.to(torch.bfloat16)
        return t

    fdt = torch.bfloat16 if bf16 else torch.float32
    points2 = feats(points2)
    kernels.require("points2", points2, fdt, (B, S, None), dev)
    D1 = 0
    if points1 is not None:
        points1 = feats(points1)
        kernels.require("points1", points1, fdt, (B, N, None), dev)
        D1 = points1.shape[2]
    widths = _check_layers(folded, D1 + D2, dev)
    if len(folded) > MAX_LAYERS:
        raise ValueError(f"fused FP kernel takes at most {MAX_LAYERS} layers")
    if bf16:
        folded = _with_bf16_copies(folded, False, dev)
        cap = rowmlp.fp_max_sources_bf16((D1 + D2, *widths))
    else:
        cap = rowmlp.fp_max_sources((D1 + D2, *widths))
    if S > cap:  # the sources are staged beside the layers' buffers
        raise ValueError(f"fused FP kernel takes at most {cap} sources at these "
                         f"widths (the sources beside its smallest plan within "
                         f"{rowmlp.SMEM_MAX} B of shared memory), got {S}")
    out = torch.empty((B, N, widths[-1]), dtype=fdt, device=dev)
    if out.numel() == 0:
        return out
    if bf16:  # the bf16 rows of W'^T, the float32 biases
        flat = [t for wb in zip(folded.weights, folded.biases) for t in wb]
    L = len(folded)
    plan = (rowmlp.plan_fp_bf16 if bf16 else rowmlp.plan_fp)(
        B, N, S, (D1 + D2, *widths)).ints()
    lib = kernels.load()
    entry = lib.lsdm_fp_fused_bf16 if bf16 else lib.lsdm_fp_fused
    name = "fp_fused_bf16" if bf16 else "fp_fused"
    with torch.cuda.device(dev):
        rc = entry(
            xyz1.data_ptr(), xyz2.data_ptr(),
            None if points1 is None else points1.data_ptr(),
            points2.data_ptr(),
            (ctypes.c_void_p * (2 * L))(*[t.data_ptr() for t in flat]),
            (ctypes.c_int * L)(*widths),
            (ctypes.c_int * L)(*[int(a == "relu") for a in acts]),
            L, B, N, S, D1, D2, (ctypes.c_int * len(plan))(*plan),
            out.data_ptr(), kernels.stream(dev))
    kernels.check(rc, name)
    kernels.LAUNCHES[name] += 1
    return out


def _acts(folded: Folded, acts: Optional[Sequence[str]]):
    acts = tuple(acts) if acts is not None else ("relu",) * len(folded)
    if len(acts) != len(folded) or any(a not in ACTS for a in acts):
        raise ValueError(f"acts {acts} must give one of {ACTS} per layer")
    return acts

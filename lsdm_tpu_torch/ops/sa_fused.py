"""The fused eval SetAbstraction stage (K7): CUDA kernel and plain version.

Replaces ``lsdm_tpu/ops/sa_fused_pallas.py`` (``fold_conv_bn`` and
``sa_stage_fused``); the kernel lives in ``csrc/sa_fused.cu``, its bf16 mode
in ``csrc/sa_fused_bf16.cu``.

One stage of the eval backbone without the grouped (B, S, K, C) tensor:
ball query around each center, then, per selected point, the stage's MLP
with its BatchNorms folded into the weights and a max over the K points.
Layer 1 is hoisted to the N points, as in the TPU kernel: with
``Z1 = base @ W1' + b1'`` (computed outside the kernel, a plain matrix
product in full float32), ``layer1(grouped - center)`` is
``relu(Z1[idx] - center @ W1'[:3])``.

Selection is K1's, on the same distance bits, with one difference that the
TPU kernel has: a center with no point in its radius gathers point 0 in
every slot (K1's index rule gives ``N - 1``).  In the model every center is
one of the points, so the case arises only in tests.

``compute_dtype=torch.bfloat16`` is the TPU kernel's bf16 mode
(``sa_fused_pallas.py:61-129``, ``:158-162``, ``:187``): every product takes
operands rounded to bf16 and sums in float32, ``Z1 = bf16(base) @
bf16(W1') + b1'`` is rounded to bf16 after its bias, the center term is
``bf16(center) @ bf16(W1'[:3])`` (the ball query keeps the float32
centers), each layer's ReLU output is rounded to bf16 (its bias added
unrounded), and the output is bf16.  The kernel's bf16 mode runs its
layers on the bf16 tensor cores from bf16 weight copies: where ``folded``
is an ``ops/rowmlp.py:Bf16Operands`` (the folded layers with their copies,
made once per model: ``models/pointnet2.py`` keeps them per stage), those,
else made here at every call.  It takes ``Z1`` in bf16 and counts its
launches as ``sa_fused_bf16``.

A wrapper runs the kernel for CUDA tensors and the plain version for CPU
tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lsdm_tpu_torch import kernels
from lsdm_tpu_torch.kernels import mode_matmul
from lsdm_tpu_torch.ops import rowmlp
from lsdm_tpu_torch.ops.ballquery import _radius2, query_ball_point_plain
from lsdm_tpu_torch.ops.pointcloud import index_points

Folded = Sequence[Tuple[torch.Tensor, torch.Tensor]]

MAX_LAYERS = rowmlp.MAX_LAYERS + 1  # layer 1 plus the kernel's


def fold_conv_bn(conv: nn.Module, bn: nn.BatchNorm1d
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold a 1x1 conv and its eval BatchNorm into one dense layer.

    ``relu(BN(x @ W + b))`` with running statistics is
    ``relu(x @ (W * s) + ((b - mean) * s + beta))`` with
    ``s = gamma * rsqrt(var + eps)``.  Returns float32 (W' (Cin, F),
    b' (F,)), contiguous."""
    w = conv.weight.reshape(conv.weight.shape[0], -1).t()  # (Cin, F)
    s = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    return ((w * s).contiguous(),
            ((conv.bias - bn.running_mean) * s + bn.bias).contiguous())


def sa_stage_fused_plain(radius: float, nsample: int, xyz: torch.Tensor,
                         new_xyz: torch.Tensor, base: torch.Tensor,
                         folded: Folded,
                         compute_dtype: Optional[torch.dtype] = None
                         ) -> torch.Tensor:
    """Plain version of K7 -> (B, S, F_last): the kernel's folded,
    hoisted math, with gathers where the TPU kernel multiplies one-hot
    masks; in ``compute_dtype`` bf16 the TPU kernel's bf16 roundings and a
    bf16 output."""
    bf16 = kernels.bf16_mode(compute_dtype)
    rnd = kernels.bf16_exact if bf16 else (lambda t: t)
    w1, b1 = folded[0]
    z1 = rnd(mode_matmul(base, w1, bf16) + b1)               # (B, N, F1)
    # K1's selection on the same distance bits; an empty ball gathers point 0
    idx = query_ball_point_plain(radius, nsample, xyz, new_xyz, empty=0)
    h = rnd(F.relu(index_points(z1, idx)
                   - mode_matmul(new_xyz, w1[:3], bf16)[:, :, None, :]))
    for w, b in folded[1:]:
        h = rnd(F.relu(mode_matmul(h, w, bf16) + b))
    out = h.max(dim=2).values
    return out.to(torch.bfloat16) if bf16 else out


def sa_stage_fused_kernel(radius: float, nsample: int, xyz: torch.Tensor,
                          new_xyz: torch.Tensor, base: torch.Tensor,
                          folded: Folded,
                          compute_dtype: Optional[torch.dtype] = None
                          ) -> torch.Tensor:
    """K7: the eval SetAbstraction stage.  xyz (B, N, 3) points, new_xyz
    (B, S, 3) centers, base (B, N, Cin) = [xyz, features], ``folded`` the
    stage's (W' (F_{l-1}, F_l), b' (F_l,)) from :func:`fold_conv_bn`, all
    float32 -> (B, S, F_last) float32; in ``compute_dtype`` bf16 the bf16
    mode, a bf16 output, its weights the bf16 copies ``folded`` carries
    where it is a :class:`rowmlp.Bf16Operands` (else made here).  CUDA
    kernel for CUDA tensors, plain version for CPU tensors."""
    flat = [t for wb in folded for t in wb]
    if kernels.on_cpu(xyz, new_xyz, base, *flat):
        return sa_stage_fused_plain(radius, nsample, xyz, new_xyz, base, folded,
                                    compute_dtype)
    bf16 = kernels.bf16_mode(compute_dtype)
    B, N, _ = xyz.shape
    S = new_xyz.shape[1]
    dev = xyz.device
    kernels.require("xyz", xyz, torch.float32, (None, None, 3), dev)
    kernels.require("new_xyz", new_xyz, torch.float32, (B, None, 3), dev)
    kernels.require("base", base, torch.float32, (B, N, None), dev)
    widths = _check_layers(folded, base.shape[2], dev)
    if not 0 < nsample <= N:
        raise ValueError(f"nsample {nsample} must lie in [1, {N}]")
    if len(folded) > MAX_LAYERS:
        raise ValueError(f"fused SA kernel takes at most {MAX_LAYERS} layers")
    if bf16:
        folded = _with_bf16_copies(folded, True, dev)
        cap = rowmlp.sa_max_points_bf16(nsample, tuple(widths))
    else:
        cap = rowmlp.sa_max_points(nsample, tuple(widths))
    if N > cap:  # the cloud is staged beside the layers' buffers
        raise ValueError(f"fused SA kernel takes at most {cap} points at these "
                         f"widths (the cloud beside its smallest plan within "
                         f"{rowmlp.SMEM_MAX} B of shared memory), got {N}")
    z1, w1x, rest = sa_operands(base, folded, compute_dtype)
    return sa_stage_launch(radius, nsample, xyz, new_xyz, z1, w1x, rest, widths,
                           compute_dtype)


def sa_operands(base: torch.Tensor, folded: Folded,
                compute_dtype: Optional[torch.dtype] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, Folded]:
    """What K7's launch reads besides the points: layer 1 at the N points,
    ``Z1 = base @ W1' + b1'`` (a plain product, as on the TPU), W1'[:3], and
    the stage's ``folded`` layers.  In the bf16 mode, from the bf16 copies
    ``folded`` carries (:class:`rowmlp.Bf16Operands`; made here when it is
    plain layers): Z1 from bf16-rounded operands, rounded to bf16 after its
    bias, W1'[:3] rounded, and the kernel's layers as (bf16 rows of W'^T,
    float32 b') after layer 1's (W1', b1')."""
    w1, b1 = folded[0]
    if not kernels.bf16_mode(compute_dtype):
        return base @ w1 + b1, w1[:3].contiguous(), folded
    ops = folded if isinstance(folded, rowmlp.Bf16Operands) else \
        rowmlp.bf16_operands(folded, sa=True)
    z1 = (kernels.bf16_exact(base) @ ops.w1 + b1).to(torch.bfloat16)
    return z1, ops.w1x, [folded[0], *zip(ops.weights, ops.biases)]


def sa_stage_launch(radius: float, nsample: int, xyz: torch.Tensor,
                    new_xyz: torch.Tensor, z1: torch.Tensor,
                    w1x: torch.Tensor, folded: Folded,
                    widths: Sequence[int],
                    compute_dtype: Optional[torch.dtype] = None
                    ) -> torch.Tensor:
    """The launch of K7 alone, after :func:`sa_stage_fused_kernel` has
    checked its inputs and :func:`sa_operands` made ``z1`` (B, N, F1),
    ``w1x`` = W1'[:3] (3, F1) and the layers ``folded``, CUDA, contiguous:
    float32, or in the bf16 mode a bf16 ``z1``, a rounded ``w1x`` and the
    layers 2..L as bf16 rows of W'^T (:class:`rowmlp.Bf16Operands`)."""
    bf16 = kernels.bf16_mode(compute_dtype)
    B, N, _ = xyz.shape
    S = new_xyz.shape[1]
    out = torch.empty((B, S, widths[-1]),
                      dtype=torch.bfloat16 if bf16 else torch.float32,
                      device=xyz.device)
    if out.numel() == 0:
        return out
    if z1.dtype != out.dtype:
        raise ValueError(f"z1: expected {out.dtype}, got {z1.dtype}")
    plan = (rowmlp.plan_sa_bf16 if bf16 else rowmlp.plan_sa)(
        B, N, S, nsample, tuple(widths)).ints()
    flat = [t for wb in folded[1:] for t in wb]
    params = (ctypes.c_void_p * max(1, len(flat)))(
        *[t.data_ptr() for t in flat])
    lib = kernels.load()
    entry = lib.lsdm_sa_fused_bf16 if bf16 else lib.lsdm_sa_fused
    name = "sa_fused_bf16" if bf16 else "sa_fused"
    with torch.cuda.device(xyz.device):
        rc = entry(
            xyz.data_ptr(), new_xyz.data_ptr(), z1.data_ptr(), w1x.data_ptr(),
            params, (ctypes.c_int * len(widths))(*widths), len(widths), B, N,
            S, _radius2(radius), nsample, (ctypes.c_int * len(plan))(*plan),
            out.data_ptr(), kernels.stream(xyz.device))
    kernels.check(rc, name)
    kernels.LAUNCHES[name] += 1
    return out


def _with_bf16_copies(folded: Folded, sa: bool, dev: torch.device
                  ) -> rowmlp.Bf16Operands:
    """``folded`` with its bf16 copies on ``dev``: checked against the
    layers' widths where it carries them, made here where it does not."""
    if not isinstance(folded, rowmlp.Bf16Operands):
        return rowmlp.bf16_operands(folded, sa)
    operands, layers = folded, folded[1:] if sa else folded
    if len(operands.weights) != len(layers):
        raise ValueError(f"bf16 operands of {len(operands.weights)} layers for "
                         f"{len(layers)}")
    for i, (w, (wf, _)) in enumerate(zip(operands.weights, layers)):
        kernels.require(f"bf16 W{i + 1 + sa}", w, torch.bfloat16,
                        (-(-wf.shape[1] // 16) * 16, -(-wf.shape[0] // 16) * 16), dev)
    if sa:
        kernels.require("bf16 W1", operands.w1, torch.float32,
                        tuple(folded[0][0].shape), dev)
    return operands


def _check_layers(folded: Folded, c_in: int, dev: torch.device):
    """Check a chain of (W (F_{l-1}, F_l), b (F_l,)) starting at ``c_in``
    channels; return the widths [F_1, ..., F_L]."""
    if not folded:
        raise ValueError("the stage needs at least one layer")
    widths = []
    for i, (w, b) in enumerate(folded):
        kernels.require(f"W{i + 1}", w, torch.float32, (c_in, None), dev)
        c_in = w.shape[1]
        kernels.require(f"b{i + 1}", b, torch.float32, (c_in,), dev)
        widths.append(c_in)
    return widths

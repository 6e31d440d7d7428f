"""Ball query + neighbourhood gather (K10): CUDA kernel, plain version and
the differentiable select-gather of a SetAbstraction stage.

Replaces ``lsdm_tpu/ops/sg_fused_pallas.py`` (``_sg_call`` behind
``select_gather_grouped``, ``ball_impl="sg"``); the kernel lives in
``csrc/sg_fused.cu``.  For centers new_xyz (B, S, 3) over a cloud xyz
(B, N, 3) and its stage columns base (B, N, C) = [xyz, features]:

    idx     = ball query (K1's rule: first nsample in radius, empty
              slots repeat the first, an empty ball is all N - 1)
    grouped = base[idx] with new_xyz subtracted from columns 0-2

The backward is the JAX custom VJP's (``_sg_bwd``) in plain torch, which
the JAX package also leaves to XLA: ``grad_base`` sums the cotangent rows
into the selected points (``index_add_``), ``grad_new_xyz = -sum_K
grad[..., :3]``, and the distance operand ``xyz`` gets zero.  On CUDA the
``index_add_`` sums with atomics, so its order, and the last bits of
``grad_base``, change from run to run.

A bf16 ``base`` is the bf16 mode (the JAX kernel's
``compute_dtype=bfloat16``, ``sg_fused_pallas.py:67-73,106-112``): the
grouped output is bf16, the gather exact, each xyz column ``g - qc`` with
the center ``qc`` rounded to bf16, computed in float32 and rounded once to
bf16; the backward sums the bf16 cotangent into ``grad_base`` in float32
and rounds once to bf16, as ``onehot_segment_sum`` does (its
``:190-201``).  Its kernel is its own source (``csrc/sg_fused_bf16.cu``:
the same scan, then slabs of C >= 8 columns copied a source row at a time)
with its own plan (:func:`select_gather_bf16_plan`), and counts its
launches as ``select_gather_bf16``.

A wrapper runs the kernel for CUDA tensors and the plain version for CPU
tensors; it never falls back from one to the other.
"""

from __future__ import annotations

from typing import Tuple

import torch

from lsdm_tpu_torch import kernels
from lsdm_tpu_torch.ops.ballquery import (
    _radius2, ball_query_plan, query_ball_point_plain)
from lsdm_tpu_torch.ops.pointcloud import index_points

# csrc/ballscan.cuh: warps a block, points a scan round
SG_WARPS, SG_ROUND_POINTS = 4, 128


# the largest slab (nsample x C floats) for which K10 takes K1's plan
SG_SELECT_SLAB = 512


def select_gather_plan(clouds: int, s: int, slab: int) -> int:
    """Centers a warp (1, 2 or 4) of K10 for ``clouds`` clouds of ``s``
    centers whose output slabs are ``slab`` = nsample x C floats.  Where a
    slab is small (sa1's 32 x 6), the scan holds the kernel and K1's plan
    (``ops/ballquery.py:ball_query_plan``) serves it; where a slab is
    large (sa2-sa4's 2,144 to 8,288 floats), a warp's gather of its
    centers' slabs holds it, and one center a warp, the most warps, is
    fastest.  From the sweep of the three plans at sa1-sa4 at 9, 54 and 72
    clouds (``profile_kernels.py --sg_sweep``; PERF.md §6 gives the call
    and the card): the fastest plan, or one within 1%, in each of the 12
    cells."""
    if slab <= SG_SELECT_SLAB:
        return ball_query_plan(clouds, s)
    return 1


# warps of the card the bf16 plan fills before it shares slabs between warps:
# 4 blocks of 4 warps an SM
SG_BF16_FILL = kernels.SMS * 16
# the most warps a bf16 slab is shared by (csrc/sg_fused_bf16.cu)
SG_BF16_MAX_SPLIT = 8


def select_gather_bf16_plan(clouds: int, s: int, slab: int) -> Tuple[int, int]:
    """(centers a warp, warps a slab) of K10's bf16 mode for ``clouds``
    clouds of ``s`` centers whose slabs are ``slab`` = nsample x C values.
    Small slabs (sa1's) take the float32 mode's plan, one warp a slab.
    Larger ones take one center a warp, and where the centers are too few
    to fill the card (sa4's 864 at 54 clouds, sa3's 576 and sa4's 144 at
    9) the fewest warps a slab (2, 4 or 8) that give SG_BF16_FILL warps,
    each warp at least one 16-byte chunk a lane.  From the sweep of every
    plan at sa1-sa4 at 9, 54 and 72 clouds (``profile_kernels.py
    --sg_sweep``; PERF.md §6): at sa2-sa4 the fastest plan, or one within
    2%, in each of the 9 cells; at sa1 the float32 mode's plan, within 4%
    of the fastest."""
    if slab <= SG_SELECT_SLAB:
        return select_gather_plan(clouds, s, slab), 1
    split = 1
    while (split < SG_BF16_MAX_SPLIT and clouds * s * split < SG_BF16_FILL
           and slab // 8 >= 2 * 32 * split):
        split *= 2
    return 1, split


def select_gather_smem(n: int, nsample: int, queries: int) -> int:
    """Bytes of shared memory a K10 block takes: its cloud, padded to the
    scan's rounds, as float4s, and the index slots of its warps' centers
    (``csrc/sg_fused.cu:launch_select_gather``)."""
    padded = -(-n // SG_ROUND_POINTS) * SG_ROUND_POINTS
    return 16 * padded + 4 * SG_WARPS * queries * nsample


def select_gather_max_points(nsample: int, queries: int) -> int:
    """The largest cloud K10 stages beside ``queries`` centers a warp of
    ``nsample`` slots within a block's ``kernels.SMEM_MAX`` bytes: 14,336
    points at nsample 32 and 4 centers a warp."""
    room = kernels.SMEM_MAX - 4 * SG_WARPS * queries * nsample
    return room // (16 * SG_ROUND_POINTS) * SG_ROUND_POINTS


def select_gather_plain(radius: float, nsample: int, xyz: torch.Tensor,
                        new_xyz: torch.Tensor, base: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K10: (grouped (B, S, nsample, C) in base's dtype,
    idx (B, S, nsample) int32)."""
    idx = query_ball_point_plain(radius, nsample, xyz, new_xyz)
    grouped = index_points(base, idx)
    center = new_xyz[:, :, None, :].to(base.dtype)
    return torch.cat([grouped[..., :3] - center, grouped[..., 3:]], -1), idx


def select_gather_kernel(radius: float, nsample: int, xyz: torch.Tensor,
                         new_xyz: torch.Tensor, base: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10: xyz (B, N, 3), new_xyz (B, S, 3) float32, base (B, N, C)
    float32 or bf16 (the bf16 mode) -> (grouped (B, S, nsample, C) in
    base's dtype, idx (B, S, nsample) int32).  CUDA kernel for CUDA
    tensors, plain version for CPU tensors."""
    if kernels.on_cpu(xyz, new_xyz, base):
        return select_gather_plain(radius, nsample, xyz, new_xyz, base)
    B, N, _ = xyz.shape
    S, C = new_xyz.shape[1], base.shape[2]
    dev = xyz.device
    dt = torch.bfloat16 if base.dtype == torch.bfloat16 else torch.float32
    kernels.require("xyz", xyz, torch.float32, (None, None, 3), dev)
    kernels.require("new_xyz", new_xyz, torch.float32, (B, None, 3), dev)
    kernels.require("base", base, dt, (B, N, None), dev)
    if not 0 < nsample <= min(N, 128):
        raise ValueError(f"nsample {nsample} must lie in [1, min({N}, 128)]")
    if C < 3:
        raise ValueError(f"base must lead with the 3 xyz columns, has {C}")
    bf16 = dt == torch.bfloat16
    if S == 0:
        queries, split = 1, 1
    elif bf16:
        queries, split = select_gather_bf16_plan(B, S, nsample * C)
    else:
        queries, split = select_gather_plan(B, S, nsample * C), 1
    cap = select_gather_max_points(nsample, queries)
    if N > cap:  # the cloud is staged in shared memory
        raise ValueError(f"select-gather kernel takes at most {cap} points at "
                         f"nsample {nsample} (its cloud within "
                         f"{kernels.SMEM_MAX} B of shared memory), got {N}")
    if B > 65535:
        raise ValueError(f"select-gather kernel grids at most 65535 clouds, got {B}")
    out = torch.empty((B, S, nsample, C), dtype=dt, device=dev)
    idx = torch.empty((B, S, nsample), dtype=torch.int32, device=dev)
    if idx.numel() == 0:
        return out, idx
    lib = kernels.load()
    name = "select_gather_bf16" if bf16 else "select_gather"
    plan = (queries, split) if bf16 else (queries,)
    with torch.cuda.device(dev):
        rc = getattr(lib, "lsdm_" + name)(
            xyz.data_ptr(), new_xyz.data_ptr(), base.data_ptr(), B, N, S, C,
            _radius2(radius), nsample, *plan, out.data_ptr(), idx.data_ptr(),
            kernels.stream(dev))
    kernels.check(rc, name)
    kernels.LAUNCHES[name] += 1
    return out, idx


class _SelectGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, radius, nsample, xyz, new_xyz, base):
        grouped, idx = select_gather_kernel(radius, nsample, xyz.contiguous(),
                                            new_xyz.contiguous(),
                                            base.contiguous())
        ctx.save_for_backward(idx)
        ctx.shapes = (xyz.shape, base.shape[1], xyz.dtype, new_xyz.dtype,
                      base.dtype)
        return grouped

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        xyz_shape, N, xyz_dt, center_dt, base_dt = ctx.shapes
        B, S, K, C = grad.shape
        # a bf16 cotangent is summed in float32, then rounded once
        grad = grad.to(torch.promote_types(grad.dtype, torch.float32))
        flat = (idx.long() + N * torch.arange(B, device=idx.device)[:, None, None])
        grad_base = torch.zeros(B * N, C, dtype=grad.dtype, device=grad.device)
        grad_base.index_add_(0, flat.reshape(-1), grad.reshape(-1, C))
        grad_center = -grad[..., :3].sum(dim=2)
        grad_xyz = torch.zeros(xyz_shape, dtype=xyz_dt, device=grad.device)
        return (None, None, grad_xyz, grad_center.to(center_dt),
                grad_base.reshape(B, N, C).to(base_dt))


def select_gather_grouped(radius: float, nsample: int, xyz: torch.Tensor,
                          new_xyz: torch.Tensor, base: torch.Tensor
                          ) -> torch.Tensor:
    """Differentiable select-gather (the JAX ``select_gather_grouped``):
    the SetAbstraction stage's grouped input (B, S, nsample, C), in
    base's dtype."""
    return _SelectGather.apply(radius, nsample, xyz, new_xyz, base)

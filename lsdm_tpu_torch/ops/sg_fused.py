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

A wrapper runs the kernel for CUDA tensors and the plain version for CPU
tensors; it never falls back from one to the other.
"""

from __future__ import annotations

from typing import Tuple

import torch

from lsdm_tpu_torch import kernels
from lsdm_tpu_torch.ops.ballquery import _radius2, query_ball_point_plain
from lsdm_tpu_torch.ops.pointcloud import index_points


def select_gather_plain(radius: float, nsample: int, xyz: torch.Tensor,
                        new_xyz: torch.Tensor, base: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K10: (grouped (B, S, nsample, C) float32,
    idx (B, S, nsample) int32)."""
    idx = query_ball_point_plain(radius, nsample, xyz, new_xyz)
    grouped = index_points(base, idx)
    center = new_xyz[:, :, None, :]
    return torch.cat([grouped[..., :3] - center, grouped[..., 3:]], -1), idx


def select_gather_kernel(radius: float, nsample: int, xyz: torch.Tensor,
                         new_xyz: torch.Tensor, base: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10: xyz (B, N, 3), new_xyz (B, S, 3), base (B, N, C) float32 ->
    (grouped (B, S, nsample, C), idx (B, S, nsample) int32).  CUDA kernel
    for CUDA tensors, plain version for CPU tensors."""
    if kernels.on_cpu(xyz, new_xyz, base):
        return select_gather_plain(radius, nsample, xyz, new_xyz, base)
    B, N, _ = xyz.shape
    S, C = new_xyz.shape[1], base.shape[2]
    dev = xyz.device
    kernels.require("xyz", xyz, torch.float32, (None, None, 3), dev)
    kernels.require("new_xyz", new_xyz, torch.float32, (B, None, 3), dev)
    kernels.require("base", base, torch.float32, (B, N, None), dev)
    if not 0 < nsample <= min(N, 128):
        raise ValueError(f"nsample {nsample} must lie in [1, min({N}, 128)]")
    if C < 3:
        raise ValueError(f"base must lead with the 3 xyz columns, has {C}")
    if N > 8192:  # the cloud is staged in shared memory
        raise ValueError(f"select-gather kernel takes at most 8192 points, got {N}")
    if B > 65535:
        raise ValueError(f"select-gather kernel grids at most 65535 clouds, got {B}")
    out = torch.empty((B, S, nsample, C), dtype=torch.float32, device=dev)
    idx = torch.empty((B, S, nsample), dtype=torch.int32, device=dev)
    if idx.numel() == 0:
        return out, idx
    lib = kernels.load()
    with torch.cuda.device(dev):
        rc = lib.lsdm_select_gather(
            xyz.data_ptr(), new_xyz.data_ptr(), base.data_ptr(), B, N, S, C,
            _radius2(radius), nsample, out.data_ptr(), idx.data_ptr(),
            kernels.stream(dev))
    kernels.check(rc, "select_gather")
    kernels.LAUNCHES["select_gather"] += 1
    return out, idx


class _SelectGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, radius, nsample, xyz, new_xyz, base):
        grouped, idx = select_gather_kernel(radius, nsample, xyz.contiguous(),
                                            new_xyz.contiguous(),
                                            base.contiguous())
        ctx.save_for_backward(idx)
        ctx.shapes = (xyz.shape, base.shape[1])
        return grouped

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        xyz_shape, N = ctx.shapes
        B, S, K, C = grad.shape
        flat = (idx.long() + N * torch.arange(B, device=idx.device)[:, None, None])
        grad_base = torch.zeros(B * N, C, dtype=grad.dtype, device=grad.device)
        grad_base.index_add_(0, flat.reshape(-1), grad.reshape(-1, C))
        grad_center = -grad[..., :3].sum(dim=2)
        grad_xyz = torch.zeros(xyz_shape, dtype=grad.dtype, device=grad.device)
        return None, None, grad_xyz, grad_center, grad_base.reshape(B, N, C)


def select_gather_grouped(radius: float, nsample: int, xyz: torch.Tensor,
                          new_xyz: torch.Tensor, base: torch.Tensor
                          ) -> torch.Tensor:
    """Differentiable select-gather (the JAX ``select_gather_grouped``):
    the SetAbstraction stage's grouped input (B, S, nsample, C)."""
    return _SelectGather.apply(radius, nsample, xyz, new_xyz, base)

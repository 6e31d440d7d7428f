"""Chamfer loss through the directed nearest-neighbour kernel (K11): CUDA
kernel, plain version and the differentiable loss.

Replaces ``lsdm_tpu/ops/chamfer_pallas.py`` (``_directed_min_sqdist``
behind ``chamfer_distance_pallas``, the training loss's
``chamfer_impl="pallas"``); the kernel lives in ``csrc/chamfer.cu``.  Per
point of x (B, N, 3) against y (B, M, 3): the smallest
``(|x|^2 + |y|^2) - 2 x.y``, clamped at 0 after the min, and its lowest
index.  Kernel and plain version compute that expression elementwise with
the same float32 operations in the same order (no matrix product, so no
TF32), so their distances and indices are equal.  The kernel is the
lane-split nearest-k scan of ``csrc/nearest.cuh`` that K2 shares, with
one nearest point; :func:`chamfer_nn_plan` picks its lanes a point and
points a lane.

The loss has the pytorch3d reductions of ``ops/pointcloud.py:
chamfer_distance`` (point mean, batch mean, both directions summed).  Its
backward is the JAX custom VJP's (``_chamfer_bwd``) in plain torch, which
the JAX package also leaves to XLA: the gradient flows only through the
nearest pairs, gathered at the saved indices and summed back into y (and
x) with ``scatter_add_``, whose atomics on CUDA change the order of the
sums from run to run.

A wrapper runs the kernel for CUDA tensors and the plain version for CPU
tensors; it never falls back from one to the other.
"""

from __future__ import annotations

from typing import Tuple

import torch

from lsdm_tpu_torch import kernels
from lsdm_tpu_torch.ops.ballquery import NEAREST_GROUPS, nearest_plan
from lsdm_tpu_torch.ops.pointcloud import index_points


def _sq_norm(p: torch.Tensor) -> torch.Tensor:
    return (p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1]) + p[..., 2] * p[..., 2]


def directed_nn_plain(x: torch.Tensor, y: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K11: (min (B, N) float32, argmin (B, N) int32)."""
    dot = ((x[:, :, None, 0] * y[:, None, :, 0]
            + x[:, :, None, 1] * y[:, None, :, 1])
           + x[:, :, None, 2] * y[:, None, :, 2])
    d = (_sq_norm(x)[:, :, None] + _sq_norm(y)[:, None, :]) - 2.0 * dot
    m = d.min(dim=-1, keepdim=True).values
    iota = torch.arange(y.shape[1], device=x.device)
    arg = torch.where(d == m, iota, y.shape[1]).min(dim=-1).values
    return m[..., 0].clamp_min(0.0), arg.to(torch.int32)


CHAMFER_NN_WARPS = 20  # warps an SM K11's plan asks for


def chamfer_nn_plan(clouds: int, n: int, m: int) -> Tuple[int, int]:
    """K11's (lanes a point of x, points a lane) for ``clouds`` clouds of
    ``n`` points of x against ``m`` of y: :func:`nearest_plan`, four points
    a lane where the fewest lanes then give CHAMFER_NN_WARPS warps an SM,
    else two, else one.  K11 keeps one nearest point, a select and no
    branch, so more points a lane only share each source's load.  From the
    sweep of every plan (``profile_kernels.py --nn_sweep``; PERF.md §6):
    the fastest plan at the ICP's (64, 1024) against 1024, 8 lanes of 4
    points, and at the chamfer step's (6, 1024), 32 lanes of 2."""
    return nearest_plan(clouds, n, m, NEAREST_GROUPS, CHAMFER_NN_WARPS)


def directed_nn_kernel(x: torch.Tensor, y: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K11: x (B, N, 3), y (B, M, 3) float32 -> (min (B, N), argmin (B, N)
    int32).  CUDA kernel for CUDA tensors, plain version for CPU tensors.
    y streams through the kernel's shared tiles: M is not capped."""
    if kernels.on_cpu(x, y):
        return directed_nn_plain(x, y)
    B, N, _ = x.shape
    M = y.shape[1]
    dev = x.device
    kernels.require("x", x, torch.float32, (None, None, 3), dev)
    kernels.require("y", y, torch.float32, (B, None, 3), dev)
    if M < 1:
        raise ValueError("the nearest neighbour needs at least one point of y")
    if B > 65535:
        raise ValueError(f"chamfer kernel grids at most 65535 clouds, got {B}")
    mins = torch.empty((B, N), dtype=torch.float32, device=dev)
    args = torch.empty((B, N), dtype=torch.int32, device=dev)
    if mins.numel() == 0:
        return mins, args
    lanes, group = chamfer_nn_plan(B, N, M)
    lib = kernels.load()
    with torch.cuda.device(dev):
        rc = lib.lsdm_chamfer_nn(x.data_ptr(), y.data_ptr(), B, N, M, lanes,
                                 group, mins.data_ptr(), args.data_ptr(),
                                 kernels.stream(dev))
    kernels.check(rc, "chamfer_nn")
    kernels.LAUNCHES["chamfer_nn"] += 1
    return mins, args


class _Chamfer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y):
        x, y = x.contiguous(), y.contiguous()
        min_xy, arg_xy = directed_nn_kernel(x, y)
        min_yx, arg_yx = directed_nn_kernel(y, x)
        ctx.save_for_backward(x, y, arg_xy, arg_yx)
        return (min_xy.mean(dim=1) + min_yx.mean(dim=1)).mean()

    @staticmethod
    def backward(ctx, g):
        x, y, arg_xy, arg_yx = ctx.saved_tensors
        B, N, _ = x.shape
        M = y.shape[1]
        # d/dx mean_b mean_n |x_n - y_{m*}|^2 = 2 (x_n - y_near) / (B N)
        gx = 2.0 * (x - index_points(y, arg_xy)) / (B * N)
        gy = 2.0 * (y - index_points(x, arg_yx)) / (B * M)
        gy_from_xy = torch.zeros_like(y).scatter_add_(
            1, arg_xy.long()[..., None].expand(-1, -1, 3), -gx)
        gx_from_yx = torch.zeros_like(x).scatter_add_(
            1, arg_yx.long()[..., None].expand(-1, -1, 3), -gy)
        return g * (gx + gx_from_yx), g * (gy + gy_from_xy)


def chamfer_distance_kernel(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bidirectional chamfer loss (the JAX ``chamfer_distance_pallas``):
    x (B, N, 3), y (B, M, 3) float32 -> scalar, differentiable in both."""
    return _Chamfer.apply(x, y)

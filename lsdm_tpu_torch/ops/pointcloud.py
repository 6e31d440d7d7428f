"""Point-cloud ops of the PointNet++ backbone.

Counterpart of ``lsdm_tpu/ops/pointcloud.py``, reference-semantics subset
(``pointnet2_utils.py``).  The selection ops take an ``impl``:

* ``"pallas"``: this repo's hand-written selection kernels (the name is
  the JAX package's, so one ``SDMConfig.ball_impl`` names one program in
  both packages) — the CUDA kernel for CUDA tensors, its plain version
  for CPU tensors;
* ``"topk"``: the plain version on any device.

The JAX package's other formulations (``topk_p``, ``topk2``, ``topk2c``,
``scatter``, ``binsearch``) work around TPU sorting and partitioning and
are not ported.
"""

from __future__ import annotations

from typing import Optional

import torch

from lsdm_tpu_torch.ops.ballquery import (
    query_ball_point_kernel, query_ball_point_plain, square_distance,
    three_nn_kernel, three_nn_plain)
from lsdm_tpu_torch.ops.fps import (
    farthest_point_sample_kernel, farthest_point_sample_plain)

__all__ = ["square_distance", "index_points", "farthest_point_sample",
           "query_ball_point", "three_nn_interpolate", "chamfer_distance",
           "knn"]

IMPLS = ("pallas", "topk")


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise NotImplementedError(
            f"selection impl {impl!r} is not ported (ported: {IMPLS})")


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched gather (reference ``pointnet2_utils.py:41-57``):
    points (B, N, C), idx (B, ...) int -> (B, ..., C).  The gradient of a
    bf16 ``points`` is summed in float32 and rounded once to bf16
    (:class:`_GatherF32Sum`)."""
    B, N, C = points.shape
    flat = idx.reshape(B, -1).long()[..., None].expand(-1, -1, C)
    if points.dtype == torch.bfloat16 and points.requires_grad:
        out = _GatherF32Sum.apply(points, flat)
    else:
        out = torch.gather(points, 1, flat)
    return out.reshape(*idx.shape, C)


class _GatherF32Sum(torch.autograd.Function):
    """``torch.gather(points, 1, index)`` whose backward sums the
    cotangent rows into their points in float32 and rounds the sums once
    to ``points``' dtype: the backward of the JAX package's train gathers
    (``gather_bwd="matmul_fwd"``, ``ops/pointcloud.py:onehot_segment_sum``,
    a bf16 x bf16 product accumulated in float32).  torch's own backward
    of a bf16 gather would accumulate in bf16."""

    @staticmethod
    def forward(ctx, points, index):
        ctx.save_for_backward(index)
        ctx.shape, ctx.dtype = points.shape, points.dtype
        return torch.gather(points, 1, index)

    @staticmethod
    def backward(ctx, grad):
        (index,) = ctx.saved_tensors
        acc = torch.zeros(ctx.shape, dtype=torch.float32, device=grad.device)
        acc.scatter_add_(1, index, grad.float())
        return acc.to(ctx.dtype), None


def farthest_point_sample(xyz: torch.Tensor, npoint: int,
                          start: Optional[torch.Tensor] = None,
                          impl: str = "pallas") -> torch.Tensor:
    """FPS indices (B, npoint) int32.  ``start`` (B,) defaults to index 0
    for every cloud, as the JAX function does without a key; then no start
    tensor is made and the kernel's call reads nothing back."""
    _check_impl(impl)
    if impl == "topk":
        return farthest_point_sample_plain(xyz, npoint, start)
    return farthest_point_sample_kernel(xyz, npoint, start)


def query_ball_point(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor, impl: str = "pallas"
                     ) -> torch.Tensor:
    """Fixed-size ball query (B, S, nsample) int32 indices, reference
    semantics (``pointnet2_utils.py:84-104``): the first ``nsample``
    in-radius indices in index order, empty slots repeat the first."""
    _check_impl(impl)
    if impl == "topk":
        return query_ball_point_plain(radius, nsample, xyz, new_xyz)
    return query_ball_point_kernel(radius, nsample, xyz, new_xyz)


def three_nn_interpolate(xyz1: torch.Tensor, xyz2: torch.Tensor,
                         points2: torch.Tensor, eps: float = 1e-8,
                         impl: str = "pallas", diff_weights: bool = False
                         ) -> torch.Tensor:
    """Inverse-distance-weighted 3-NN interpolation of features
    points2 (B, S, C) living on xyz2 (B, S, 3) onto xyz1 (B, N, 3)
    (reference ``pointnet2_utils.py:290-300``) -> (B, N, C).

    The JAX function's gate (its ``ops/pointcloud.py:671``): ``"pallas"``
    with N % 8 == 0 takes the indices from the K2 kernel (no gradient), and
    ``diff_weights`` (training) then recomputes the k distances at those
    indices as ``sum((x1 - x2[idx]) ** 2)``, so the weights carry the
    reference graph's gradients.  Every other case is the composed
    formulation, whose selected expansion-form distances carry them."""
    _check_impl(impl)
    k = min(3, xyz2.shape[1])  # the reference always has S >= 16; tiny configs don't
    if impl == "pallas" and xyz1.shape[1] % 8 == 0:
        dists, idx = three_nn_kernel(xyz1.detach(), xyz2.detach(), k)
        if diff_weights:
            dists = ((xyz1[:, :, None, :] - index_points(xyz2, idx)) ** 2).sum(-1)
    else:
        dists, idx = three_nn_plain(xyz1, xyz2, k)
    dist_recip = 1.0 / (dists + eps)
    weight = dist_recip / dist_recip.sum(dim=2, keepdim=True)
    gathered = index_points(points2, idx)  # (B, N, k, C)
    return (gathered * weight[..., None]).sum(dim=2)


def knn(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices (B, N, k) int64 of each row's k nearest rows of x (B, N, C)
    by squared distance, self included (reference
    ``model/pcd_backbone/dgcnn.py:21-27``; JAX ``ops/pointcloud.py:knn``,
    ``lax.top_k`` of the negated distances).  The distances are the JAX
    function's expansion ``-2 x.y + |x|^2 + |y|^2`` (``Precision.HIGHEST``):
    three channels through :func:`square_distance`, elementwise and
    bit-stable, wider features through one batched product with TF32 off
    (its 10-bit mantissa would reorder near neighbours).  Ties go to the
    lowest index, as ``lax.top_k``'s do: a stable sort of each row
    (``torch.topk`` does not promise an order among ties, and a cloud of
    equal points, an empty object slot, ties every distance).  Not
    differentiable."""
    with torch.no_grad():
        if x.shape[-1] == 3:
            d = square_distance(x, x)
        else:
            tf32 = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = False
            try:
                d = -2.0 * torch.bmm(x, x.transpose(1, 2))
            finally:
                torch.backends.cuda.matmul.allow_tf32 = tf32
            sq = (x * x).sum(-1)
            d = (d + sq[:, :, None]) + sq[:, None, :]
        return torch.sort(d, dim=-1, stable=True).indices[..., :k]


def chamfer_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bidirectional chamfer distance with ``pytorch3d.loss.chamfer_distance``
    reductions (point "mean", batch "mean", both directions summed): the
    reference's eval metric (``run/test_sdm.py:186``).  x (B, N, 3),
    y (B, M, 3) -> scalar.  The JAX function's optional point masks are not
    ported: evaluation passes none."""
    d = square_distance(x.float(), y.float())  # (B, N, M)
    # amin shares a tie's gradient evenly among the tied points, as JAX's
    # min does (points of a bf16 model's output can coincide)
    return (d.amin(dim=2).mean(dim=1) + d.amin(dim=1).mean(dim=1)).mean()

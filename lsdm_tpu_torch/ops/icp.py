"""Point-to-point ICP with random restarts, batched over the restarts.

Counterpart of ``lsdm_tpu/ops/icp.py`` (the reference's open3d
``registration_icp`` in ``run/scene_edit.py:100-136``).  Each ICP is a
fixed number of (nearest-neighbour correspondences -> thresholded Kabsch
update) iterations; the restarts run as one batch, as JAX's ``vmap`` runs
them.  The nearest neighbours come from the K11 entry
(``ops/chamfer.py:directed_nn_kernel``: its CUDA kernel for CUDA tensors,
its plain version on the CPU; minimum and lowest-index argmin), which JAX
computes from ``square_distance`` outside any Pallas kernel.

Returns the registration statistics open3d exposes: ``fitness`` (inlier
fraction of source points), ``inlier_rmse`` and the correspondence count.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from lsdm_tpu_torch.ops.chamfer import directed_nn_kernel
from lsdm_tpu_torch.ops.rotations import quaternion_to_matrix


class ICPResult(NamedTuple):
    transformation: torch.Tensor  # (4, 4), or (K, 4, 4) batched
    fitness: torch.Tensor         # inlier fraction
    inlier_rmse: torch.Tensor
    n_correspondences: torch.Tensor


def _kabsch(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor):
    """Weighted rigid alignment src -> dst (Kabsch/Umeyama), batched: src,
    dst (K, N, 3), w (K, N) -> R (K, 3, 3), t (K, 3).  Where w is all zero
    the SVD of a zero matrix picks an arbitrary basis, in torch as in JAX."""
    wsum = torch.clamp(w.sum(-1, keepdim=True), min=1e-8)       # (K, 1)
    mu_s = (src * w[..., None]).sum(1) / wsum
    mu_d = (dst * w[..., None]).sum(1) / wsum
    H = ((src - mu_s[:, None]) * w[..., None]).transpose(1, 2) @ (dst - mu_d[:, None])
    U, _, Vt = torch.linalg.svd(H)
    V = Vt.transpose(1, 2)
    d = torch.sign(torch.linalg.det(V @ U.transpose(1, 2)))
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1))
    R = V @ D @ U.transpose(1, 2)
    t = mu_d - (R @ mu_s[..., None])[..., 0]
    return R, t


def _icp_batched(source: torch.Tensor, target: torch.Tensor,
                 inits: torch.Tensor, threshold: float, iters: int) -> ICPResult:
    """ICP from each of K initial poses inits (K, 4, 4): source (N, 3),
    target (M, 3).  Returns an ICPResult of K entries."""
    K, N = inits.shape[0], source.shape[0]
    tgt = target.expand(K, -1, -1).contiguous()
    R_acc, t_acc = inits[:, :3, :3], inits[:, :3, 3]
    src = source @ R_acc.transpose(1, 2) + t_acc[:, None]      # (K, N, 3)
    for _ in range(iters):
        nn_d2, nn = directed_nn_kernel(src.contiguous(), tgt)
        w = (nn_d2 <= threshold ** 2).to(src.dtype)
        matched = torch.gather(tgt, 1, nn.long()[..., None].expand(-1, -1, 3))
        R, t = _kabsch(src, matched, w)
        src = src @ R.transpose(1, 2) + t[:, None]
        R_acc, t_acc = R @ R_acc, (R @ t_acc[..., None])[..., 0] + t
    nn_d2, _ = directed_nn_kernel(src.contiguous(), tgt)  # clamped at 0
    inlier = nn_d2 <= threshold ** 2
    n_corr = inlier.sum(-1)
    fitness = n_corr / N
    rmse = torch.sqrt(torch.where(
        n_corr > 0, (nn_d2 * inlier).sum(-1) / torch.clamp(n_corr, min=1), 0.0))
    T = torch.eye(4, dtype=source.dtype, device=source.device).repeat(K, 1, 1)
    T[:, :3, :3] = R_acc
    T[:, :3, 3] = t_acc
    return ICPResult(T, fitness, rmse, n_corr)


@torch.no_grad()
def icp(source: torch.Tensor, target: torch.Tensor, init: torch.Tensor,
        threshold: float = 0.2, iters: int = 30) -> ICPResult:
    """Fixed-iteration point-to-point ICP from one initial pose init (4, 4):
    source (N, 3), target (M, 3)."""
    res = _icp_batched(source, target, init[None], threshold, iters)
    return ICPResult(*(a[0] for a in res))


@torch.no_grad()
def random_restart_icp(source: torch.Tensor, target: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       n_tries: int = 64, threshold: float = 0.2,
                       iters: int = 30,
                       quats: Optional[torch.Tensor] = None) -> ICPResult:
    """Multi-start ICP, all tries as one batch; keeps the try with the most
    correspondences (the first of equals; reference criterion,
    ``scene_edit.py:127-130``).

    Initial poses: the translation that aligns the centroids and the
    rotations of ``quats`` (n_tries, 4) wxyz, by default drawn as standard
    normals from ``generator`` on the source's device (uniform rotations);
    the first try keeps the identity rotation, like the mean shift the
    reference applies."""
    dev, dtype = source.device, source.dtype
    if quats is None:
        quats = torch.randn((n_tries, 4), generator=generator, device=dev,
                            dtype=dtype)
    inits = torch.eye(4, dtype=dtype, device=dev).repeat(quats.shape[0], 1, 1)
    inits[:, :3, :3] = quaternion_to_matrix(quats.to(device=dev, dtype=dtype))
    inits[:, :3, 3] = target.mean(0) - source.mean(0)
    inits[0, :3, :3] = torch.eye(3, dtype=dtype, device=dev)
    res = _icp_batched(source, target, inits, threshold, iters)
    best = int(torch.argmax(res.n_correspondences))
    return ICPResult(*(a[best] for a in res))


def transform_points(points: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """points (..., 3) under the rigid transform T (4, 4)."""
    return points @ T[:3, :3].T + T[:3, 3]

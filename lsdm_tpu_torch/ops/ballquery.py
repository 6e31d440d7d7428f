"""Ball query (K1) and 3-NN selection (K2): CUDA kernels and plain versions.

Replace ``lsdm_tpu/ops/ballquery_pallas.py`` (``query_ball_point_pallas``
and ``three_nn_pallas``); the kernels live in ``csrc/ballquery.cu``.

Both select integer indices from one squared-distance expression,
``(-2 (q.x) + |q|^2) + |x|^2`` in float32, the expansion the Pallas kernels
use.  The kernels and the plain versions here compute it with the same
separately rounded products and sums (no fused multiply-add), so their
distances are bit-identical and their indices equal.  That matters beyond
tidiness: at fp1 the 3-NN sources are the targets themselves, each
target's nearest distance is rounding noise around 0, and the FP weight
``1 / (d + 1e-8)`` amplifies that noise.

* Ball query: for each query, the first ``nsample`` in-radius point
  indices in ascending index order; empty slots repeat the first index;
  a row with no point in radius is all ``N - 1`` (the JAX kernel's
  ``clip(N, 0, N - 1)``).
* 3-NN: the ``k`` smallest distances per target with their source
  indices, ties to the lowest index (``lax.top_k(-d)`` semantics).

A wrapper runs the kernel for CUDA tensors and the plain version for CPU
tensors; it never falls back from one to the other.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from lsdm_tpu_torch import kernels


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distance (B, N, M) between src (B, N, 3) and
    dst (B, M, 3), as ``(-2 src.dst + |src|^2) + |dst|^2``.

    Each product and sum is its own float32 op in the order the CUDA
    kernels use (``csrc/ballquery.cu:sq_dist``), so both give the same bits.
    The dot product is taken elementwise: no matrix product, hence no TF32.
    """
    s = [src[..., c] for c in range(3)]
    d = [dst[..., c] for c in range(3)]
    dot = ((s[0][:, :, None] * d[0][:, None, :]
            + s[1][:, :, None] * d[1][:, None, :])
           + s[2][:, :, None] * d[2][:, None, :])
    ss = (s[0] * s[0] + s[1] * s[1]) + s[2] * s[2]
    dd = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]
    return (-2.0 * dot + ss[:, :, None]) + dd[:, None, :]


def _radius2(radius: float) -> float:
    # the float32 value both versions compare against (the JAX kernel's
    # Python-float radius**2, taken to float32 by the comparison)
    return float(np.float32(float(radius) ** 2))


def query_ball_point_plain(radius: float, nsample: int, xyz: torch.Tensor,
                           new_xyz: torch.Tensor,
                           empty: Optional[int] = None) -> torch.Tensor:
    """Plain version of K1: (B, S, nsample) int32 indices.  A row with no
    point in radius is all ``N - 1`` (K1's rule) or, given ``empty``, all
    ``empty`` (K7 gathers point 0)."""
    B, N, _ = xyz.shape
    if nsample > N:
        raise ValueError(f"nsample {nsample} exceeds the {N} points")
    d = square_distance(new_xyz, xyz)  # (B, S, N)
    iota = torch.arange(N, device=xyz.device, dtype=torch.int32)
    cand = torch.where(d <= _radius2(radius), iota, N)
    idx = torch.sort(cand, dim=-1).values[..., :nsample]
    first = idx[..., :1]
    if empty is not None:
        first = torch.where(first == N, empty, first)
    idx = torch.where(idx == N, first, idx)
    return idx.clamp(0, N - 1).to(torch.int32)


def query_ball_point_kernel(radius: float, nsample: int, xyz: torch.Tensor,
                            new_xyz: torch.Tensor) -> torch.Tensor:
    """K1: ball query, xyz (B, N, 3), new_xyz (B, S, 3) float32 ->
    (B, S, nsample) int32.  CUDA kernel for CUDA tensors, plain version
    for CPU tensors."""
    if kernels.on_cpu(xyz, new_xyz):
        return query_ball_point_plain(radius, nsample, xyz, new_xyz)
    B, N, _ = xyz.shape
    S = new_xyz.shape[1]
    dev = xyz.device
    kernels.require("xyz", xyz, torch.float32, (None, None, 3), dev)
    kernels.require("new_xyz", new_xyz, torch.float32, (B, None, 3), dev)
    if not 0 < nsample <= N:
        raise ValueError(f"nsample {nsample} must lie in [1, {N}]")
    if N > 3072:  # the cloud is staged in 48 KB of shared memory
        raise ValueError(f"ball query kernel takes at most 3072 points, got {N}")
    out = torch.empty((B, S, nsample), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    lib = kernels.load()
    with torch.cuda.device(dev):
        rc = lib.lsdm_ball_query(xyz.data_ptr(), new_xyz.data_ptr(), B, N, S,
                                 _radius2(radius), nsample, out.data_ptr(),
                                 kernels.stream(dev))
    kernels.check(rc, "ball_query")
    kernels.LAUNCHES["ball_query"] += 1
    return out


def three_nn_plain(xyz1: torch.Tensor, xyz2: torch.Tensor, k: int = 3
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2: ``k`` iterated (min, lowest index, mask-out)
    passes, as the Pallas kernel runs them.  Returns (dists f32, idx
    int32), both (B, N, k)."""
    S = xyz2.shape[1]
    if not 0 < k <= S:
        raise ValueError(f"k {k} must lie in [1, {S}]")
    cur = square_distance(xyz1, xyz2)  # (B, N, S)
    iota = torch.arange(S, device=xyz1.device)
    dists, idxs = [], []
    for _ in range(k):
        m = cur.min(dim=-1, keepdim=True).values
        sel = torch.where(cur == m, iota, S).min(dim=-1, keepdim=True).values
        dists.append(m)
        idxs.append(sel)
        cur = torch.where(iota == sel, torch.inf, cur)  # mask by position
    return torch.cat(dists, -1), torch.cat(idxs, -1).to(torch.int32)


def three_nn_kernel(xyz1: torch.Tensor, xyz2: torch.Tensor, k: int = 3
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: k nearest sources xyz2 (B, S, 3) of every target xyz1 (B, N, 3)
    -> (dists (B, N, k) f32, idx (B, N, k) int32), k <= 3.  CUDA kernel
    for CUDA tensors, plain version for CPU tensors."""
    if kernels.on_cpu(xyz1, xyz2):
        return three_nn_plain(xyz1, xyz2, k)
    B, N, _ = xyz1.shape
    S = xyz2.shape[1]
    dev = xyz1.device
    kernels.require("xyz1", xyz1, torch.float32, (None, None, 3), dev)
    kernels.require("xyz2", xyz2, torch.float32, (B, None, 3), dev)
    if not 0 < k <= min(3, S):
        raise ValueError(f"k {k} must lie in [1, min(3, {S})]")
    if S > 3072:  # the sources are staged in 48 KB of shared memory
        raise ValueError(f"3-NN kernel takes at most 3072 sources, got {S}")
    dist = torch.empty((B, N, k), dtype=torch.float32, device=dev)
    idx = torch.empty((B, N, k), dtype=torch.int32, device=dev)
    if dist.numel() == 0:
        return dist, idx
    lib = kernels.load()
    with torch.cuda.device(dev):
        rc = lib.lsdm_three_nn(xyz1.data_ptr(), xyz2.data_ptr(), B, N, S, k,
                               dist.data_ptr(), idx.data_ptr(),
                               kernels.stream(dev))
    kernels.check(rc, "three_nn")
    kernels.LAUNCHES["three_nn"] += 1
    return dist, idx

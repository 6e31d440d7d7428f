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
  indices, ties to the lowest index (``lax.top_k(-d)`` semantics).  The
  kernel is the lane-split nearest-k scan of ``csrc/nearest.cuh``, which
  K11 (``ops/chamfer.py``) shares; :func:`three_nn_plan` picks its lanes a
  target.

A wrapper runs the kernel for CUDA tensors and the plain version for CPU
tensors; it never falls back from one to the other.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

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


# K1 stages its cloud as float4s padded to its 128-point rounds
# (csrc/ballquery.cu: kRoundPoints), within kernels.SMEM_MAX: 14,464 points
BALL_MAX_POINTS = kernels.SMEM_MAX // 16 // 128 * 128


def ball_query_plan(clouds: int, s: int) -> int:
    """Queries a warp (1, 2 or 4) of K1 for ``clouds`` clouds of ``s``
    queries each.  A warp serves its queries from every point it reads, so
    more queries a warp issue fewer loads and votes, but a round's latency
    is hidden only by other warps: four queries a warp where they still
    leave 24 warps an SM, two where those leave 16, else one.  Chosen from
    the sweep of the three at sa1-sa4 and 9, 54 and 72 clouds
    (``profile_kernels.py --bq_sweep``; PERF.md §6 gives the call and the
    card), where it picks the fastest plan or one within 3% of it in
    every cell.  Flagship stages (1024, 256, 64, 16 queries): 2, 1, 1, 1
    queries a warp at 9 clouds; 4, 4, 1, 1 at 54.

    The warps an SM that the rule counts assume the staged clouds fit:
    a block's cloud takes 16 bytes a point (and the SM 1 KB a block), so
    at 1024 points (16 KB) 13 blocks, 52 warps, fit an SM's 228 KB, but
    at 4096 points (64 KB, the largest ``--pcd_points`` the port is tested
    at) only 3 blocks, 12 warps, and past 7,168 points one block of 4
    warps.  There the card runs fewer warps than the rule counts on."""
    if clouds < 1 or s < 1:
        raise ValueError(f"ball query plan needs clouds and queries, got "
                         f"{clouds} and {s}")
    if clouds * -(-s // 4) >= 24 * kernels.SMS:
        return 4
    return 2 if clouds * -(-s // 2) >= 16 * kernels.SMS else 1


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
    if N > BALL_MAX_POINTS:
        raise ValueError(f"ball query kernel takes at most {BALL_MAX_POINTS} "
                         f"points (its cloud within {kernels.SMEM_MAX} B of shared "
                         f"memory), got {N}")
    if B > 65535:
        raise ValueError(f"ball query kernel grids at most 65535 clouds, got {B}")
    out = torch.empty((B, S, nsample), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    lib = kernels.load()
    with torch.cuda.device(dev):
        rc = lib.lsdm_ball_query(xyz.data_ptr(), new_xyz.data_ptr(), B, N, S,
                                 _radius2(radius), nsample,
                                 ball_query_plan(B, S), out.data_ptr(),
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


NEAREST_WARPS = 8        # warps a block (csrc/nearest.cuh: kWarps)
NEAREST_LANES = (1, 2, 4, 8, 16, 32)  # lanes a target the kernel takes
NEAREST_GROUPS = (4, 2, 1)            # targets a lane the kernel takes
NEAREST_MIN_SOURCES = 4  # sources a lane reads at least, where L > 1
# K2's plan: 12 warps an SM, at most 8 lanes a target, at most 512
# sources a lane, one target a lane (the sweep in the docstring below)
THREE_NN_WARPS, THREE_NN_MAX_LANES, THREE_NN_MAX_SOURCES = 12, 8, 512


def nearest_plan(clouds: int, n: int, s: int, groups: Sequence[int],
                 min_warps: int, max_lanes: int = 32,
                 max_sources: Optional[int] = None) -> Tuple[int, int]:
    """(lanes a target L, targets a lane G) of the nearest-k scan
    (``csrc/nearest.cuh``, K2 and K11) for ``clouds`` clouds of ``n``
    targets and ``s`` sources: for each G of ``groups`` in turn, the fewest
    lanes (at most ``max_lanes``, each reading at least
    NEAREST_MIN_SOURCES sources and at most ``max_sources``) that launch
    ``min_warps`` warps an SM; else the last plan tried.  More targets a
    lane share each source's shared-memory load, more lanes a target fill
    a small grid, and each lane's list is merged in log2(L) levels."""
    if clouds < 1 or n < 1 or s < 1:
        raise ValueError(f"nearest-k plan needs clouds, targets and sources, "
                         f"got {clouds}, {n} and {s}")
    plan = (1, groups[-1])
    for group in groups:
        for lanes in NEAREST_LANES:
            if lanes > max_lanes or (lanes > 1 and lanes * NEAREST_MIN_SOURCES > s):
                break
            plan = (lanes, group)
            if (nearest_warps(clouds, n, lanes, group) >= min_warps * kernels.SMS
                    and (max_sources is None or s <= lanes * max_sources)):
                return plan
    return plan


def nearest_warps(clouds: int, n: int, lanes: int, group: int) -> int:
    """Warps the nearest-k scan launches for ``clouds`` clouds of ``n``
    targets, ``lanes`` lanes a target and ``group`` targets a lane."""
    per_block = NEAREST_WARPS * 32 // lanes * group
    return clouds * -(-n // per_block) * NEAREST_WARPS


def three_nn_plan(clouds: int, n: int, s: int) -> int:
    """K2's lanes a target: :func:`nearest_plan` with one target a lane and
    the fewest lanes, at most THREE_NN_MAX_LANES, that give THREE_NN_WARPS
    warps an SM with no lane reading more than THREE_NN_MAX_SOURCES
    sources.  From the sweep of every plan at fp4-fp1 at 9, 54 and 72
    clouds (``profile_kernels.py --nn_sweep``; PERF.md §6 gives the calls
    and the card): it takes the fastest plan, or one within 4% of it, in
    each of the 12 cells.  More targets a lane were slower in every cell: a
    lane inserts into each target's top 3 in turn, and a warp waits out
    every lane's insert.  Flagship FP stages (fp4, fp3, fp2, fp1): 4, 8,
    8, 8 lanes at 9 clouds; 4, 4, 1, 2 at 54."""
    return nearest_plan(clouds, n, s, (1,), THREE_NN_WARPS, THREE_NN_MAX_LANES,
                        THREE_NN_MAX_SOURCES)[0]


def three_nn_kernel(xyz1: torch.Tensor, xyz2: torch.Tensor, k: int = 3
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: k nearest sources xyz2 (B, S, 3) of every target xyz1 (B, N, 3)
    -> (dists (B, N, k) f32, idx (B, N, k) int32), k <= 3.  CUDA kernel
    for CUDA tensors, plain version for CPU tensors.  The sources stream
    through the kernel's shared tiles: S is not capped."""
    if kernels.on_cpu(xyz1, xyz2):
        return three_nn_plain(xyz1, xyz2, k)
    B, N, _ = xyz1.shape
    S = xyz2.shape[1]
    dev = xyz1.device
    kernels.require("xyz1", xyz1, torch.float32, (None, None, 3), dev)
    kernels.require("xyz2", xyz2, torch.float32, (B, None, 3), dev)
    if not 0 < k <= min(3, S):
        raise ValueError(f"k {k} must lie in [1, min(3, {S})]")
    if B > 65535:
        raise ValueError(f"3-NN kernel grids at most 65535 clouds, got {B}")
    dist = torch.empty((B, N, k), dtype=torch.float32, device=dev)
    idx = torch.empty((B, N, k), dtype=torch.int32, device=dev)
    if dist.numel() == 0:
        return dist, idx
    lanes = three_nn_plan(B, N, S)
    lib = kernels.load()
    with torch.cuda.device(dev):
        rc = lib.lsdm_three_nn(xyz1.data_ptr(), xyz2.data_ptr(), B, N, S, k,
                               lanes, dist.data_ptr(), idx.data_ptr(),
                               kernels.stream(dev))
    kernels.check(rc, "three_nn")
    kernels.LAUNCHES["three_nn"] += 1
    return dist, idx

"""Farthest-point sampling (K3): CUDA kernel and plain version.

Replaces ``lsdm_tpu/ops/fps_pallas.py:farthest_point_sample_pallas`` and
serves the contract of ``lsdm_tpu/ops/fps_batched_pallas.py:
farthest_point_sample_batched`` too: both give the same indices for the
same inputs, so one kernel (``csrc/fps.cu``, one block per cloud) stands
for both names.

Reference algorithm (``pointnet2_utils.py:60-81``): from the start index,
repeatedly select the point farthest from the selected set.  The running
minimum distance starts at 1e10, the distance is ``sum((x - c)^2)`` summed
over (x, y, z) in that order (not the |x|^2 - 2xc expansion), and the
argmax takes the first maximum.  Kernel and plain version round the same
float32 ops, so their indices are equal.

Without a ``start`` every cloud starts at index 0, and the kernel's call
reads nothing back from the card: the SDM never passes a start, so its
FPS calls queue behind the work before them (and can be captured in a
CUDA graph).  A ``start`` that is passed is range-checked, which reads it
back.
"""

from __future__ import annotations

from typing import Optional

import torch

from lsdm_tpu_torch import kernels

PPTS = (1, 2, 4, 8)  # points a lane the kernel takes (csrc/fps.cu)
# 32 warps of 8 points a lane; the cloud, 16 bytes a point (128 KB at this
# cap), fits the 227 KB of shared memory a block may take on Hopper
MAX_POINTS = 32 * 32 * PPTS[-1]


def fps_plan(n: int):
    """(warps, points a lane) of the kernel's block for a cloud of ``n``
    points: one warp up to 64 points (no block barrier), else a warp for
    every 32 points up to 32 warps; each lane owns the smallest of 1, 2, 4
    or 8 contiguous points that covers the cloud (8 above 4096 points).
    From the sweep of every plan at sa2-sa4 (``profile_kernels.py
    --fps_sweep``, H100): one point a lane beat 2 and 4 at 1024 and 256
    points (8 warps at 256 beat one), two points in one warp beat two warps
    at 64."""
    if not 1 <= n <= MAX_POINTS:
        raise ValueError(f"FPS kernel takes 1 to {MAX_POINTS} points (32 warps "
                         f"of {PPTS[-1]} points a lane), got {n}")
    warps = 1 if n <= 64 else min(32, -(-n // 32))
    need = -(-n // (32 * warps))
    return warps, next(p for p in PPTS if p >= need)


def farthest_point_sample_plain(xyz: torch.Tensor, npoint: int,
                                start: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """Plain version of K3: xyz (B, N, 3), start (B,) or None (index 0)
    -> (B, npoint) int32."""
    B, N, _ = xyz.shape
    dist = torch.full((B, N), 1e10, dtype=torch.float32, device=xyz.device)
    far = (torch.zeros(B, dtype=torch.long, device=xyz.device) if start is None
           else start.to(torch.long))
    rows = torch.arange(B, device=xyz.device)
    out = []
    for _ in range(npoint):
        out.append(far)
        diff = xyz - xyz[rows, far][:, None, :]
        sq = diff * diff
        dist = torch.minimum(dist, (sq[..., 0] + sq[..., 1]) + sq[..., 2])
        far = torch.argmax(dist, dim=-1)  # first maximum
    return torch.stack(out, dim=1).to(torch.int32)


def farthest_point_sample_kernel(xyz: torch.Tensor, npoint: int,
                                 start: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """K3: FPS indices (B, npoint) int32 from xyz (B, N, 3) float32 and
    start (B,) int32, or None for index 0 in every cloud (no read-back).
    CUDA kernel for CUDA tensors, plain version for CPU tensors."""
    if kernels.on_cpu(xyz, *(() if start is None else (start,))):
        return farthest_point_sample_plain(xyz, npoint, start)
    B, N, _ = xyz.shape
    dev = xyz.device
    kernels.require("xyz", xyz, torch.float32, (None, None, 3), dev)
    warps, ppt = fps_plan(N)
    if start is not None:
        kernels.require("start", start, torch.int32, (B,), dev)
        if bool(((start < 0) | (start >= N)).any()):  # reads back: a sync
            raise ValueError(f"FPS start indices must lie in [0, {N})")
    out = torch.empty((B, npoint), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    lib = kernels.load()
    with torch.cuda.device(dev):
        rc = lib.lsdm_fps(xyz.data_ptr(), None if start is None else start.data_ptr(),
                          B, N, npoint, warps, ppt, out.data_ptr(),
                          kernels.stream(dev))
    kernels.check(rc, "fps")
    kernels.LAUNCHES["fps"] += 1
    return out

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
"""

from __future__ import annotations

import torch

from lsdm_tpu_torch import kernels


def farthest_point_sample_plain(xyz: torch.Tensor, npoint: int,
                                start: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: xyz (B, N, 3), start (B,) -> (B, npoint) int32."""
    B, N, _ = xyz.shape
    dist = torch.full((B, N), 1e10, dtype=torch.float32, device=xyz.device)
    far = start.to(torch.long)
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
                                 start: torch.Tensor) -> torch.Tensor:
    """K3: FPS indices (B, npoint) int32 from xyz (B, N, 3) float32 and
    start (B,) int32.  CUDA kernel for CUDA tensors, plain version for CPU
    tensors."""
    if kernels.on_cpu(xyz, start):
        return farthest_point_sample_plain(xyz, npoint, start)
    B, N, _ = xyz.shape
    dev = xyz.device
    kernels.require("xyz", xyz, torch.float32, (None, None, 3), dev)
    kernels.require("start", start, torch.int32, (B,), dev)
    if N > 3072:  # the cloud and its distance row sit in 48 KB of shared memory
        raise ValueError(f"FPS kernel takes at most 3072 points, got {N}")
    if bool(((start < 0) | (start >= N)).any()):
        raise ValueError(f"FPS start indices must lie in [0, {N})")
    out = torch.empty((B, npoint), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    lib = kernels.load()
    with torch.cuda.device(dev):
        rc = lib.lsdm_fps(xyz.data_ptr(), start.data_ptr(), B, N, npoint,
                          out.data_ptr(), kernels.stream(dev))
    kernels.check(rc, "fps")
    kernels.LAUNCHES["fps"] += 1
    return out

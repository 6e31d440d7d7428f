"""The SDM's human backbone: the POSA spiral decoder.

Counterpart of ``lsdm_tpu/models/posa.py:POSADecoderBackbone`` (reference
``Decoder``, ``posa/posa_models.py:292-326``, instantiated at
``model/sdm.py:104``).  With the default seq_length=1 the spirals are
identity spirals, so the pipeline is: per-point linears 3 -> z/2 -> 64
(GroupNorm + ReLU each), an identity-spiral block 64 -> 64, a spiral
linear 64 -> 3 over the first ``vert_dims`` points, then x2 nearest
upsampling truncated to ``pcd_points``.  Module nesting (``de_spiral.N.
conv.layer``, ``de_spiral.N.norm``) follows the reference state_dict.

With a compute ``dtype`` (bf16) the linears cast to it as flax's do, and
each GroupNorm, which sets no dtype in the JAX module, normalises the
widened input in float32 against its float32 scale and returns float32,
as flax's promotion has it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from lsdm_tpu_torch.ops.attention import Linear, wide


def identity_spirals(num_vertices: int) -> np.ndarray:
    """Length-1 spirals, each vertex its own neighbourhood.  Copied from
    ``lsdm_tpu/ops/spiral.py:identity_spirals``."""
    return np.arange(num_vertices, dtype=np.int32)[:, None]


def _group_norm(channels: int, num_groups: int) -> nn.GroupNorm:
    if channels % num_groups != 0:
        num_groups = channels  # reference fallback (posa_models.py:144-145)
    return nn.GroupNorm(num_groups, channels, eps=1e-5)


def _norm_relu(norm: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    # x (B, V, C): GroupNorm over (V, C/G) per group, as flax's on NVC, in
    # at least float32
    x = wide(x)
    return F.relu(norm(x.transpose(1, 2)).transpose(1, 2))


class SpiralConv(nn.Module):
    """Gather each vertex's spiral window and apply one linear layer
    (reference ``posa_models.py:70-111``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 indices: np.ndarray, dtype: Optional[torch.dtype] = None):
        super().__init__()
        # a plain constant like the reference's attribute: not in state_dict
        self.register_buffer("indices", torch.as_tensor(indices, dtype=torch.long),
                             persistent=False)
        self.layer = Linear(in_channels * indices.shape[1], out_channels,
                            dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n_nodes = self.indices.shape[0]
        g = x.index_select(-2, self.indices.reshape(-1))
        return self.layer(g.reshape(x.shape[0], n_nodes, -1))


class _Lin(nn.Module):
    """Per-vertex linear nested as ``conv.layer`` (reference GraphLin)."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.layer = Linear(in_channels, out_channels, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer(x)


class GraphLinBlock(nn.Module):
    """Per-vertex linear + GroupNorm + ReLU (``posa_models.py:132-160``)."""

    def __init__(self, in_channels: int, out_channels: int, num_groups: int = 8,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = _Lin(in_channels, out_channels, dtype)
        self.norm = _group_norm(out_channels, num_groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _norm_relu(self.norm, self.conv(x))


class SpiralBlock(nn.Module):
    """SpiralConv + GroupNorm + ReLU (``posa_models.py:163-187``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 indices: np.ndarray, num_groups: int = 8,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = SpiralConv(in_channels, out_channels, indices, dtype)
        self.norm = _group_norm(out_channels, num_groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _norm_relu(self.norm, self.conv(x))


class POSADecoderBackbone(nn.Module):
    """Human vertices (B, P >= vert_dims, 3) -> (B, pcd_points, f_dim)."""

    def __init__(self, vert_dims: int = 655, pcd_points: int = 1024,
                 z_dim: int = 128, channels: int = 64, f_dim: int = 3,
                 num_groups: int = 8, dtype: Optional[torch.dtype] = None):
        super().__init__()
        idx = identity_spirals(vert_dims)
        self.pcd_points = pcd_points
        self.de_spiral = nn.Sequential(
            GraphLinBlock(3, z_dim // 2, num_groups, dtype),
            GraphLinBlock(z_dim // 2, channels, num_groups, dtype),
            SpiralBlock(channels, channels, idx, num_groups, dtype),
            SpiralConv(channels, f_dim, idx, dtype),
        )

    def forward(self, vertices: torch.Tensor) -> torch.Tensor:
        x = self.de_spiral(vertices)
        x = torch.repeat_interleave(x, 2, dim=-2)  # nearest x2 upsampling
        return x[..., :self.pcd_points, :]

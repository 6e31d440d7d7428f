"""POSA spiral-convolution models (reference ``posa/posa_models.py``).

Counterpart of ``lsdm_tpu/models/posa.py``.  Spiral convolution gathers
each vertex's precomputed spiral neighbourhood (N, L) and applies one
linear layer to the flattened window.  Three consumers:

* :class:`POSADecoderBackbone`, the SDM's human backbone, below;
* :class:`POSAEncoder` / :class:`POSADecoder`, the contact-semantics VAE
  of ContactFormer (655 -> 164 -> 41 mesh levels, spirals of length 9);
* :class:`POSA`, encoder + reparameterisation + decoder.

The VAE's module names are the JAX modules' (``en_spiral_0.conv.layer``,
``en_fc_0.lin``, ``de_spiral_1.norm``), so the weight bridge
(``weights.py:contactformer_state_dict_from_jax``) renames only the
norms' ``scale``.  flax's GroupNorm and LayerNorm take the variance as
E[x^2] - E[x]^2, torch's in two passes: the float64 tests compare the
formulas, the float32 ones hold the difference within 1e-5.

The SDM's human backbone is ``lsdm_tpu/models/posa.py:POSADecoderBackbone`` (reference
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

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from lsdm_tpu_torch.ops.attention import Linear, wide
from lsdm_tpu_torch.ops.mesh import ds_us
from lsdm_tpu_torch.ops.spiral import identity_spirals


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
        return self.layer(g.reshape(*x.shape[:-2], n_nodes, -1))


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


class FcBlock(nn.Module):
    """Linear + LayerNorm + ReLU (``posa_models.py:190-215``)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.lin = Linear(in_features, out_features)
        self.norm = nn.LayerNorm(out_features, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.norm(self.lin(x)))


class POSAEncoder(nn.Module):
    """Contact VAE encoder (reference ``Encoder``, ``posa_models.py:247-289``):
    cat(verts, contact features) -> spiral blocks with mesh downsampling
    655 -> 164 -> 41 -> fc -> (mu, logvar).  The down matrices are
    non-persistent buffers, constants of the mesh like the spirals."""

    def __init__(self, spiral_indices: Sequence[np.ndarray],
                 down_mats: Sequence[torch.Tensor], in_channels: int = 3 + 8,
                 h_dim: int = 512, z_dim: int = 256, channels: int = 64,
                 num_groups: int = 8):
        super().__init__()
        sp = spiral_indices
        self.en_spiral_0 = SpiralBlock(in_channels, channels, sp[0], num_groups)
        self.en_spiral_1 = SpiralBlock(channels, channels, sp[0], num_groups)
        self.en_spiral_2 = SpiralBlock(channels, channels, sp[1], num_groups)
        self.en_spiral_3 = SpiralBlock(channels, channels, sp[2], num_groups)
        for i, m in enumerate(down_mats):
            self.register_buffer(f"down_{i}", torch.as_tensor(m, dtype=torch.float32),
                                 persistent=False)
        self.en_fc_0 = FcBlock(down_mats[1].shape[0] * channels, h_dim)
        self.en_mu = Linear(h_dim, z_dim)
        self.en_log_var = Linear(h_dim, z_dim)

    def forward(self, x: torch.Tensor, vertices: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = torch.cat([vertices, x], dim=-1)
        x = self.en_spiral_1(self.en_spiral_0(x))
        x = self.en_spiral_2(ds_us(self.down_0, x))
        x = self.en_spiral_3(ds_us(self.down_1, x))
        x = self.en_fc_0(x.reshape(x.shape[0], -1))
        return self.en_mu(x), self.en_log_var(x)


class POSADecoder(nn.Module):
    """Contact VAE decoder (the original POSA decoder that takes (z, verts),
    reference ``contact_former/posa_models.py:288-336``): z broadcast onto
    each vertex beside its position, spiral blocks at full resolution ->
    per-vertex contact-class logits."""

    def __init__(self, spiral_indices: np.ndarray, no_obj_classes: int = 8,
                 z_dim: int = 256, channels: int = 64,
                 num_hidden_layers: int = 1, num_groups: int = 8):
        super().__init__()
        self.de_spiral_0 = GraphLinBlock(3 + z_dim, channels, num_groups)
        for i in range(num_hidden_layers):
            setattr(self, f"de_spiral_{1 + i}",
                    SpiralBlock(channels, channels, spiral_indices, num_groups))
        setattr(self, f"de_spiral_{1 + num_hidden_layers}",
                SpiralConv(channels, no_obj_classes, spiral_indices))
        self.num_layers = num_hidden_layers + 2

    def forward(self, z: torch.Tensor, vertices: torch.Tensor) -> torch.Tensor:
        # z (B, z_dim); vertices (B, V, 3)
        zb = z[:, None, :].expand(-1, vertices.shape[-2], -1)
        x = torch.cat([vertices, zb], dim=-1)
        for i in range(self.num_layers):
            x = getattr(self, f"de_spiral_{i}")(x)
        return x


class POSA(nn.Module):
    """VAE wrapper (reference ``posa_models.py:329-344``).  The
    reparameterisation noise is ``eps`` when given (the tests take JAX's
    draw), else a standard normal from ``generator`` on the device."""

    def __init__(self, spiral_indices: Sequence[np.ndarray],
                 down_mats: Sequence[torch.Tensor], no_obj_classes: int = 8,
                 h_dim: int = 512, z_dim: int = 256):
        super().__init__()
        self.encoder = POSAEncoder(spiral_indices, down_mats,
                                   3 + no_obj_classes, h_dim, z_dim)
        self.decoder = POSADecoder(np.asarray(spiral_indices[0]),
                                   no_obj_classes, z_dim)

    def forward(self, x: torch.Tensor, vertices: torch.Tensor,
                eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        mu, logvar = self.encoder(x, vertices)
        std = torch.exp(0.5 * logvar)
        if eps is None:
            eps = torch.randn(std.shape, generator=generator, dtype=std.dtype,
                              device=std.device)
        z = mu + eps * std
        return self.decoder(z, vertices), mu, logvar

    def decode(self, z: torch.Tensor, vertices: torch.Tensor) -> torch.Tensor:
        return self.decoder(z, vertices)

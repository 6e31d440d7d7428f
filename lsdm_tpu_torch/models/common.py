"""Shared denoiser blocks (reference ``model/diffusion_utils.py``).

Counterpart of ``lsdm_tpu/models/common.py``.  MLPs are ``nn.Sequential``
stacks whose Linear layers sit at indices "0", "2", "4" with the
activation modules between them, exactly as in the reference, so the
``state_dict`` keys match it.  GELU is the exact erf form (torch
``nn.GELU()``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from lsdm_tpu_torch.ops.embeddings import positional_encoding_table

_ACTS = {"gelu": nn.GELU, "silu": nn.SiLU, "sigmoid": nn.Sigmoid,
         "relu": nn.ReLU}


def mlp(in_features: int, features: Sequence[int], act: str) -> nn.Sequential:
    """Linear + activation after every layer, Sequential indices 0, 2, 4..."""
    layers = []
    for f in features:
        layers += [nn.Linear(in_features, f), _ACTS[act]()]
        in_features = f
    return nn.Sequential(*layers)


class PositionalEncoding(nn.Module):
    """Holds the sinusoidal table as the reference's
    ``sequence_pos_encoder.pe`` buffer, shape (max_len, 1, D)."""

    def __init__(self, d_model: int, max_len: int = 5000):
        super().__init__()
        pe = torch.from_numpy(positional_encoding_table(d_model, max_len))
        self.register_buffer("pe", pe[:, None, :])


class TimestepEmbedder(nn.Module):
    """PE table row of the integer timestep, then Linear-SiLU-Linear
    (reference ``model/diffusion_utils.py:7-21``) -> (B, 1, D)."""

    def __init__(self, latent_dim: int):
        super().__init__()
        self.time_embed = nn.Sequential(
            nn.Linear(latent_dim, latent_dim), nn.SiLU(),
            nn.Linear(latent_dim, latent_dim))

    def forward(self, timesteps: torch.Tensor, pe: torch.Tensor
                ) -> torch.Tensor:
        return self.time_embed(pe[timesteps.long()])  # (B, 1, D)


class InputProcess(nn.Module):
    """Point-wise input MLP (reference ``model/diffusion_utils.py:45-88``):
    pose embedding 3 -> D/2 -> D (sigmoid), concat the conditioning
    embedding, then 2D -> 1.5D -> D (sigmoid)."""

    def __init__(self, input_feats: int, latent_dim: int):
        super().__init__()
        d = latent_dim
        self.pose_embedding = mlp(input_feats, (d // 2, d), "sigmoid")
        self.combination_extraction = mlp(2 * d, (int(d * 1.5), d), "sigmoid")

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        # float32 points, as JAX casts them, in the weights' dtype
        x = self.pose_embedding(x.float().to(self.pose_embedding[0].weight.dtype))
        return self.combination_extraction(torch.cat([x, emb], dim=-1))


class OutputProcess(nn.Module):
    """Point-wise output MLP (reference ``model/diffusion_utils.py:91-122``):
    D -> D/2 -> input_feats with GELU after BOTH layers (a reference quirk
    that bounds outputs below at ~-0.17, kept for checkpoint parity)."""

    def __init__(self, input_feats: int, latent_dim: int, pcd_points: int):
        super().__init__()
        self.pcd_points = pcd_points
        self.pose_final = mlp(latent_dim, (latent_dim // 2, input_feats),
                              "gelu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.pose_final(x)
        return x.reshape(x.shape[0], self.pcd_points, -1)

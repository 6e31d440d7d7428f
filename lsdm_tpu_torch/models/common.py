"""Shared denoiser blocks (reference ``model/diffusion_utils.py``).

Counterpart of ``lsdm_tpu/models/common.py``.  MLPs are ``nn.Sequential``
stacks whose Linear layers sit at indices "0", "2", "4" with the
activation modules between them, exactly as in the reference, so the
``state_dict`` keys match it.  GELU is the exact erf form (torch
``nn.GELU()``).

A compute dtype (``SDMConfig.dtype``, :func:`compute_dtype`) is flax's:
each Linear casts its input, weight and bias to it and returns it
(``ops/attention.py:Linear``), the parameters stay float32.  On a bf16
tensor the activations compute what the JAX functions' bf16 programs
compute, op by op, each op rounded to bf16: GELU is flax's
``0.5 x erfc(-x / sqrt(2))`` with the constant rounded to bf16, the
sigmoid is ``1 / (1 + exp(-x))``, as XLA expands ``jax.nn.sigmoid``'s
logistic, and SiLU is ``x * sigmoid(x)``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from lsdm_tpu_torch.ops.attention import Linear
from lsdm_tpu_torch.ops.embeddings import positional_encoding_table

# 1 / sqrt(2) as flax's bf16 GELU multiplies by it: rounded to bf16
_BF16_RSQRT2 = 0.70703125


def compute_dtype(name: str) -> Optional[torch.dtype]:
    """The torch dtype of an ``SDMConfig.dtype`` / ``bn_dtype`` name:
    None for "float32" (the parameters' own dtype, so a model made
    ``.double()`` computes in float64), ``torch.bfloat16`` for
    "bfloat16"."""
    if name == "float32":
        return None
    if name == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"compute dtype {name!r}: 'float32' or 'bfloat16'")


class GELU(nn.GELU):
    """Exact GELU; on bf16, flax's bf16 program (``jax.nn.gelu(x,
    approximate=False)``): ``(0.5 x) * erfc(-x * 0.70703125)``, each
    product and the erfc rounded to bf16."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype != torch.bfloat16:
            return super().forward(x)
        return (x * 0.5) * torch.special.erfc(x * -_BF16_RSQRT2)


def _sigmoid_bf16(x: torch.Tensor) -> torch.Tensor:
    # XLA's expansion of the logistic: exp, the add and the quotient each
    # rounded to bf16
    return 1.0 / (1.0 + torch.exp(-x))


class Sigmoid(nn.Sigmoid):
    """Sigmoid; on bf16, ``1 / (1 + exp(-x))`` op by op, as XLA computes
    ``jax.nn.sigmoid`` in bf16."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype != torch.bfloat16:
            return super().forward(x)
        return _sigmoid_bf16(x)


class SiLU(nn.SiLU):
    """SiLU; on bf16, ``jax.nn.silu``'s ``x * sigmoid(x)`` with the
    sigmoid of :class:`Sigmoid`, rounded before the product."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype != torch.bfloat16:
            return super().forward(x)
        return x * _sigmoid_bf16(x)


_ACTS = {"gelu": GELU, "silu": SiLU, "sigmoid": Sigmoid, "relu": nn.ReLU}


def mlp(in_features: int, features: Sequence[int], act: str,
        dtype: Optional[torch.dtype] = None) -> nn.Sequential:
    """Linear + activation after every layer, Sequential indices 0, 2, 4...;
    the Linears compute in ``dtype`` (None: the parameters')."""
    layers = []
    for f in features:
        layers += [Linear(in_features, f, dtype=dtype), _ACTS[act]()]
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

    def __init__(self, latent_dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.time_embed = nn.Sequential(
            Linear(latent_dim, latent_dim, dtype=dtype), SiLU(),
            Linear(latent_dim, latent_dim, dtype=dtype))

    def forward(self, timesteps: torch.Tensor, pe: torch.Tensor
                ) -> torch.Tensor:
        return self.time_embed(pe[timesteps.long()])  # (B, 1, D)


class InputProcess(nn.Module):
    """Point-wise input MLP (reference ``model/diffusion_utils.py:45-88``):
    pose embedding 3 -> D/2 -> D (sigmoid), concat the conditioning
    embedding, then 2D -> 1.5D -> D (sigmoid)."""

    def __init__(self, input_feats: int, latent_dim: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        d = latent_dim
        self.pose_embedding = mlp(input_feats, (d // 2, d), "sigmoid", dtype)
        self.combination_extraction = mlp(2 * d, (int(d * 1.5), d), "sigmoid",
                                          dtype)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        # float32 points, as JAX casts them, in the weights' dtype
        x = self.pose_embedding(x.float().to(self.pose_embedding[0].weight.dtype))
        return self.combination_extraction(torch.cat([x, emb], dim=-1))


class OutputProcess(nn.Module):
    """Point-wise output MLP (reference ``model/diffusion_utils.py:91-122``):
    D -> D/2 -> input_feats with GELU after BOTH layers (a reference quirk
    that bounds outputs below at ~-0.17, kept for checkpoint parity)."""

    def __init__(self, input_feats: int, latent_dim: int, pcd_points: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.pcd_points = pcd_points
        self.pose_final = mlp(latent_dim, (latent_dim // 2, input_feats),
                              "gelu", dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.pose_final(x)
        return x.reshape(x.shape[0], self.pcd_points, -1)

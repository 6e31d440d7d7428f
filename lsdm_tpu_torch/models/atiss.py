"""The ATISS package's transformer encoder layer.

Counterpart of ``lsdm_tpu/models/atiss.py:TorchTransformerEncoderLayer``;
ContactFormer's encoder stacks it.  The rest of the JAX module (the ATISS
and MIME scene transformers) is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from lsdm_tpu_torch.ops.attention import Linear, multihead_attention


class TorchTransformerEncoderLayer(nn.Module):
    """``torch.nn.TransformerEncoderLayer`` parity (post-LN, exact GELU),
    with the JAX module's parameter names (``in_proj_weight``,
    ``attn_out_proj``, ``linear1``/``linear2``, ``norm1``/``norm2``).

    The JAX layer's dropout runs only under ``train=True``, which no port
    caller passes (ContactFormer calls it without), so there is none here.
    """

    def __init__(self, d_model: int, n_heads: int, dim_ff: int):
        super().__init__()
        self.n_heads = n_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        nn.init.xavier_uniform_(self.in_proj_weight)
        self.attn_out_proj = Linear(d_model, d_model)
        self.linear1 = Linear(d_model, dim_ff)
        self.linear2 = Linear(dim_ff, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x: torch.Tensor,
                attn_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        # attn_bias: additive (L, S) or (B*H, L, S) mask (key padding etc.)
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, -1)
        attn, _ = multihead_attention(q, k, v, self.n_heads, attn_mask=attn_bias,
                                      need_weights=False)
        x = self.norm1(x + self.attn_out_proj(attn))
        h = self.linear2(F.gelu(self.linear1(x)))
        return self.norm2(x + h)

"""Multi-head attention with torch.nn.MultiheadAttention semantics.

Counterpart of ``lsdm_tpu/ops/attention.py``.  The SDM uses two
nonstandard attentions (reference ``model/sdm.py:79,95``):

  * ``attn_layer``:    embed_dim=D, heads=8, kdim=cat_emb, vdim=N*pcd_dim;
  * ``pcd_attention``: embed_dim=12, heads=12, kdim=vdim=3 (head_dim=1).

Reproduced on purpose: separate q/k/v input projections (the "unmerged"
torch path), a float ``attn_mask`` ADDED to the logits (the reference passes
the 0/1 object mask as float, ``model/sdm.py:180-182``), and attention
weights averaged over heads.  Plain torch ops only: the head_dim=1 rank-1
path keeps its own einsum formulation, so the port's numerics follow the
JAX function and not a fused library attention.  With ``fused=True`` and
the JAX package's gate (head_dim 1, no mask, L % 8 == 0) the head_dim=1
eval path is the K4 kernel instead (``ops/attn.py``), which returns no
weights.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from lsdm_tpu_torch.ops.attn import rank1_mha_kernel


def multihead_attention(
    q: torch.Tensor,  # (B, L, E), already projected
    k: torch.Tensor,  # (B, S, E)
    v: torch.Tensor,  # (B, S, E)
    num_heads: int,
    attn_mask: Optional[torch.Tensor] = None,  # additive, (B*H, L, S) or (L, S)
    need_weights: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Scaled dot-product attention over merged heads.

    Returns (output (B, L, E), weights averaged over heads (B, L, S) or
    None when ``need_weights`` is false).
    """
    B, L, E = q.shape
    S = k.shape[1]
    H = num_heads
    Dh = E // H
    if H * Dh != E:
        raise ValueError(f"embed_dim {E} is not a multiple of num_heads {H}")
    # float32 1/sqrt(Dh), as the JAX function computes it
    scale = 1.0 / torch.sqrt(torch.tensor(float(Dh), dtype=torch.float32,
                                          device=q.device))

    if Dh == 1:
        # rank-1 logits: logits[b,h,l,s] = q[b,l,h] * k[b,s,h]
        # (ops/attention.py:50-70 of the JAX package)
        logits = torch.einsum("blh,bsh->bhls", q * scale, k)
    else:
        qh = q.reshape(B, L, H, Dh).transpose(1, 2)  # (B, H, L, Dh)
        kh = k.reshape(B, S, H, Dh).transpose(1, 2)
        logits = (qh * scale) @ kh.transpose(-1, -2)
    if attn_mask is not None:
        if attn_mask.dim() == 3:  # torch convention: (B*H, L, S)
            logits = logits + attn_mask.reshape(B, H, L, S).to(logits.dtype)
        else:  # (L, S)
            logits = logits + attn_mask.to(logits.dtype)[None, None]
    weights = torch.softmax(logits, dim=-1)
    if Dh == 1:
        out = torch.einsum("bhls,bsh->blh", weights, v)
    else:
        vh = v.reshape(B, S, H, Dh).transpose(1, 2)
        out = (weights @ vh).transpose(1, 2).reshape(B, L, E)
    return out, (weights.mean(dim=1) if need_weights else None)


class TorchMultiheadAttention(nn.Module):
    """``torch.nn.MultiheadAttention(batch_first=True)`` with kdim != vdim.

    Parameter names are torch's (``q_proj_weight``/``k_proj_weight``/
    ``v_proj_weight``/``in_proj_bias``/``out_proj``), so a reference
    checkpoint loads key for key.
    """

    def __init__(self, embed_dim: int, num_heads: int, kdim: int, vdim: int):
        super().__init__()
        E = embed_dim
        self.num_heads = num_heads
        self.q_proj_weight = nn.Parameter(torch.empty(E, E))
        self.k_proj_weight = nn.Parameter(torch.empty(E, kdim))
        self.v_proj_weight = nn.Parameter(torch.empty(E, vdim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * E))
        self.out_proj = nn.Linear(E, E)
        for w in (self.q_proj_weight, self.k_proj_weight, self.v_proj_weight):
            nn.init.xavier_uniform_(w)

    def forward(
        self,
        query: torch.Tensor,  # (B, L, E)
        key: torch.Tensor,  # (B, S, kdim)
        value: torch.Tensor,  # (B, S, vdim)
        attn_mask: Optional[torch.Tensor] = None,
        need_weights: bool = True,
        fused: bool = False,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        E = self.q_proj_weight.shape[0]
        b = self.in_proj_bias
        q = F.linear(query, self.q_proj_weight, b[:E])
        k = F.linear(key, self.k_proj_weight, b[E:2 * E])
        v = F.linear(value, self.v_proj_weight, b[2 * E:])
        if (fused and self.num_heads == E and attn_mask is None
                and q.shape[1] % 8 == 0):
            # head_dim 1 eval path, the JAX module's gate
            # (lsdm_tpu/ops/attention.py:168-185): the (B, H, L, S) planes
            # never exist, and no weights are returned
            return self.out_proj(rank1_mha_kernel(q, k, v)), None
        out, weights = multihead_attention(q, k, v, self.num_heads,
                                           attn_mask=attn_mask,
                                           need_weights=need_weights)
        return self.out_proj(out), weights

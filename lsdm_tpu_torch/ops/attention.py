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
weights; with ``fused_train=True`` and the same gate it is
``rank1_mha_train``, K4 forward and K5 backward.

A compute dtype (``dtype``, bf16) takes flax's casts, not autocast's: the
projections are :class:`Linear` layers in that dtype (parameters stay
float32), the logits and the softmax are float32, the weights are rounded
to the dtype before the value product, which accumulates in float32 and
returns float32, and ``out_proj`` casts that back.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from lsdm_tpu_torch.ops.attn import rank1_mha_kernel, rank1_mha_train


def wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in at least float32 (float64 stays float64), as flax's
    promotions widen a bf16 operand."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


class Linear(nn.Linear):
    """``nn.Linear`` with a compute dtype: the JAX ``TorchLinear`` (and
    flax's ``Dense``), whose parameters stay float32 while it casts its
    input, weight and bias to ``dtype`` and returns ``dtype``: the product
    is rounded to ``dtype``, then the bias added in it
    (``lsdm_tpu/ops/attention.py:112-117``).  ``dtype=None`` computes in
    the parameters' own dtype, as ``nn.Linear`` does.  The parameter names
    are ``nn.Linear``'s."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias, self.compute_dtype)


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ weight.T + bias`` in ``dtype`` with flax's two roundings (the
    product, then the sum with the bias); ``F.linear`` when ``dtype`` is
    None."""
    if dtype is None:
        return F.linear(x, weight, bias)
    y = x.to(dtype) @ weight.to(dtype).t()
    return y if bias is None else y + bias.to(dtype)


def multihead_attention(
    q: torch.Tensor,  # (B, L, E), already projected
    k: torch.Tensor,  # (B, S, E)
    v: torch.Tensor,  # (B, S, E)
    num_heads: int,
    attn_mask: Optional[torch.Tensor] = None,  # additive, (B*H, L, S) or (L, S)
    need_weights: bool = True,
    dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Scaled dot-product attention over merged heads.

    Returns (output (B, L, E), weights averaged over heads (B, L, S) or
    None when ``need_weights`` is false).  The logits and the softmax are
    at least float32; with a compute ``dtype`` the weights are rounded to
    it before the value product, whose float32 sums are the output, as
    the JAX function's ``preferred_element_type`` has it.
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

    q, k, v = wide(q), wide(k), wide(v)  # a bf16 operand's exact widening
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
    w = weights if dtype is None else weights.to(dtype).to(weights.dtype)
    if Dh == 1:
        out = torch.einsum("bhls,bsh->blh", w, v)
    else:
        vh = v.reshape(B, S, H, Dh).transpose(1, 2)
        out = (w @ vh).transpose(1, 2).reshape(B, L, E)
    return out, (weights.mean(dim=1) if need_weights else None)


class TorchMultiheadAttention(nn.Module):
    """``torch.nn.MultiheadAttention(batch_first=True)`` with kdim != vdim.

    Parameter names are torch's (``q_proj_weight``/``k_proj_weight``/
    ``v_proj_weight``/``in_proj_bias``/``out_proj``), so a reference
    checkpoint loads key for key.  ``dtype``: the compute dtype of the
    projections and the value product (None: the parameters').
    """

    def __init__(self, embed_dim: int, num_heads: int, kdim: int, vdim: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        E = embed_dim
        self.num_heads = num_heads
        self.compute_dtype = dtype
        self.q_proj_weight = nn.Parameter(torch.empty(E, E))
        self.k_proj_weight = nn.Parameter(torch.empty(E, kdim))
        self.v_proj_weight = nn.Parameter(torch.empty(E, vdim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * E))
        self.out_proj = Linear(E, E, dtype=dtype)
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
        fused_train: bool = False,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        E = self.q_proj_weight.shape[0]
        b = self.in_proj_bias
        q = linear(query, self.q_proj_weight, b[:E], self.compute_dtype)
        k = linear(key, self.k_proj_weight, b[E:2 * E], self.compute_dtype)
        v = linear(value, self.v_proj_weight, b[2 * E:], self.compute_dtype)
        if ((fused or fused_train) and self.num_heads == E
                and attn_mask is None and q.shape[1] % 8 == 0):
            # head_dim 1 eval or train path, the JAX module's gates
            # (lsdm_tpu/ops/attention.py:168-206): the (B, H, L, S) planes
            # never exist, and no weights are returned.  K4's output is
            # float32 (its bf16 mode too) and out_proj casts it.
            attend = rank1_mha_train if fused_train else rank1_mha_kernel
            return self.out_proj(attend(q, k, v)), None
        out, weights = multihead_attention(q, k, v, self.num_heads,
                                           attn_mask=attn_mask,
                                           need_weights=need_weights,
                                           dtype=self.compute_dtype)
        return self.out_proj(out), weights

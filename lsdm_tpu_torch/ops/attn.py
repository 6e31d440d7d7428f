"""Rank-1-head multi-head attention, forward (K4): CUDA kernel and plain
version.

Replaces ``lsdm_tpu/ops/attn_pallas.py:rank1_mha_pallas``; the kernel
lives in ``csrc/rank1_attn.cu``.  The SDM's ``pcd_attention`` has
embed_dim == num_heads == 12, so each head is one scalar and its logits
are the outer product ``q_h (L) x k_h (S)``, scale 1.  The kernel never
writes the (B, H, L, S) logits or weights; the plain version does, as the
composed path does.  Float32 only: the port has no bf16 compute mode.

A wrapper runs the kernel for CUDA tensors and the plain version for CPU
tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import torch

from lsdm_tpu_torch import kernels


def rank1_mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                    ) -> torch.Tensor:
    """Plain version of K4, the JAX kernel's formula: per head
    ``w = e / sum(e)`` with ``e = exp(q k - max)``, then ``sum(w v)``.
    q (B, L, H), k and v (B, S, H) -> (B, L, H)."""
    logits = torch.einsum("blh,bsh->bhls", q, k)             # rank 1
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    w = e / e.sum(dim=-1, keepdim=True)
    return torch.einsum("bhls,bsh->blh", w, v)


def rank1_mha_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                     ) -> torch.Tensor:
    """K4: ``softmax_s(q_h * k_h[s]) @ v_h`` for every head h.  q (B, L, H),
    k and v (B, S, H), float32 -> (B, L, H).  CUDA kernel for CUDA tensors,
    plain version for CPU tensors."""
    if kernels.on_cpu(q, k, v):
        return rank1_mha_plain(q, k, v)
    B, L, H = q.shape
    S = k.shape[1]
    dev = q.device
    kernels.require("q", q, torch.float32, (None, None, None), dev)
    kernels.require("k", k, torch.float32, (B, None, H), dev)
    kernels.require("v", v, torch.float32, (B, S, H), dev)
    if S < 1:
        raise ValueError("attention needs at least one key")
    if S > 16384:  # a head's k and v columns are staged in shared memory
        raise ValueError(f"rank-1 attention kernel takes at most 16384 keys, got {S}")
    if B > 65535 or H > 65535:
        raise ValueError(f"rank-1 attention kernel grids at most 65535 clouds "
                         f"and heads, got {B} and {H}")
    out = torch.empty((B, L, H), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = kernels.load()
    with torch.cuda.device(dev):
        rc = lib.lsdm_rank1_attn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 B, L, S, H, out.data_ptr(), kernels.stream(dev))
    kernels.check(rc, "rank1_attn")
    kernels.LAUNCHES["rank1_attn"] += 1
    return out

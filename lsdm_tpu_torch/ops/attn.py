"""Rank-1-head multi-head attention, forward (K4) and backward (K5): CUDA
kernels and plain versions.

Replaces ``lsdm_tpu/ops/attn_pallas.py``: ``rank1_mha_pallas`` (K4,
``csrc/rank1_attn.cu``), ``_rank1_mha_bwd_pallas`` (K5,
``csrc/rank1_attn_bwd.cu``) and the custom VJP ``rank1_mha_train`` that
pairs them (:func:`rank1_mha_train`, a ``torch.autograd.Function``).  The SDM's ``pcd_attention`` has
embed_dim == num_heads == 12, so each head is one scalar and its logits
are the outer product ``q_h (L) x k_h (S)``, scale 1.  The kernel never
writes the (B, H, L, S) logits or weights; the plain version does, as the
composed path does; so does the backward's plain version, which the
kernel replaces by one pass that recomputes each weight from the row
denominator the training forward saved.  Float32 only: the port has no
bf16 compute mode.

A wrapper runs the kernel for CUDA tensors and the plain version for CPU
tensors; it never falls back from one to the other.
"""

from __future__ import annotations

from typing import Optional

import torch

from lsdm_tpu_torch import kernels


def rank1_mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    denominator: bool = False):
    """Plain version of K4, the JAX kernel's formula: per head
    ``w = e / sum(e)`` with ``e = exp(q k - max)``, then ``sum(w v)``.
    q (B, L, H), k and v (B, S, H) -> (B, L, H); with ``denominator``,
    also each row's ``sum(e)``, (B, H, L)."""
    logits = torch.einsum("blh,bsh->bhls", q, k)             # rank 1
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    den = e.sum(dim=-1)
    out = torch.einsum("bhls,bsh->blh", e / den[..., None], v)
    return (out, den) if denominator else out


def rank1_mha_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     denominator: bool = False):
    """K4: ``softmax_s(q_h * k_h[s]) @ v_h`` for every head h.  q (B, L, H),
    k and v (B, S, H), float32 -> (B, L, H); with ``denominator``, also
    each row's softmax denominator ``sum_s exp(q k - max)`` (B, H, L),
    which the backward (K5) takes.  CUDA kernel for CUDA tensors, plain
    version for CPU tensors."""
    if kernels.on_cpu(q, k, v):
        return rank1_mha_plain(q, k, v, denominator)
    B, L, H = q.shape
    S = k.shape[1]
    dev = q.device
    kernels.require("q", q, torch.float32, (None, None, None), dev)
    kernels.require("k", k, torch.float32, (B, None, H), dev)
    kernels.require("v", v, torch.float32, (B, S, H), dev)
    if S < 1:
        raise ValueError("attention needs at least one key")
    if S > 16384:  # K4's contract (its keys pass through in 1024-key chunks)
        raise ValueError(f"rank-1 attention kernel takes at most 16384 keys, got {S}")
    if B > 65535 or H > 65535:
        raise ValueError(f"rank-1 attention kernel grids at most 65535 clouds "
                         f"and heads, got {B} and {H}")
    out = torch.empty((B, L, H), dtype=torch.float32, device=dev)
    den = (torch.empty((B, H, L), dtype=torch.float32, device=dev)
           if denominator else None)
    if out.numel() > 0:
        lib = kernels.load()
        with torch.cuda.device(dev):
            rc = lib.lsdm_rank1_attn(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), B, L, S, H,
                out.data_ptr(), None if den is None else den.data_ptr(),
                kernels.stream(dev))
        kernels.check(rc, "rank1_attn")
        kernels.LAUNCHES["rank1_attn"] += 1
    return (out, den) if denominator else out


def rank1_mha_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, g: torch.Tensor,
                        denom: Optional[torch.Tensor] = None):
    """Plain version of K5, the JAX backward kernel's formula: the softmax
    recomputed, ``D = g * out`` and ``dlog = w (g v - D)``; then
    ``dq = sum_s dlog k``, ``dk = sum_l dlog q``, ``dv = sum_l w g``.
    q, out, g (B, L, H), k and v (B, S, H) -> (dq, dk, dv).  It recomputes
    the row denominators, so ``denom`` (the kernel's input) is not read."""
    logits = torch.einsum("blh,bsh->bhls", q, k)
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    w = e / e.sum(dim=-1, keepdim=True)                       # (B, H, L, S)
    gh = g.transpose(1, 2)[..., None]                         # (B, H, L, 1)
    d = (g * out).transpose(1, 2)[..., None]
    dlog = w * (gh * v.transpose(1, 2)[:, :, None, :] - d)
    dq = torch.einsum("bhls,bsh->blh", dlog, k)
    dk = torch.einsum("bhls,blh->bsh", dlog, q)
    dv = torch.einsum("bhls,blh->bsh", w, g)
    return dq, dk, dv


def rank1_mha_bwd_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         out: torch.Tensor, g: torch.Tensor, denom: torch.Tensor):
    """K5: the gradients (dq, dk, dv) of K4 at the cotangent ``g``.  q, out
    and g (B, L, H), k and v (B, S, H), float32; ``denom`` (B, H, L) the
    forward's row denominators (``rank1_mha_kernel(..., denominator=True)``),
    which the kernel needs and the plain version does not.  CUDA kernel
    (one pass over every (row, key) pair) for CUDA tensors, plain version
    for CPU tensors."""
    if kernels.on_cpu(q, k, v, out, g, denom):
        return rank1_mha_bwd_plain(q, k, v, out, g)
    B, L, H = q.shape
    S = k.shape[1]
    dev = q.device
    kernels.require("q", q, torch.float32, (None, None, None), dev)
    kernels.require("k", k, torch.float32, (B, None, H), dev)
    kernels.require("v", v, torch.float32, (B, S, H), dev)
    kernels.require("out", out, torch.float32, (B, L, H), dev)
    kernels.require("g", g, torch.float32, (B, L, H), dev)
    kernels.require("denom", denom, torch.float32, (B, H, L), dev)
    if S < 1:
        raise ValueError("attention needs at least one key")
    if L > 4096:  # the rows' statistics and dq partials in shared memory
        raise ValueError(f"rank-1 attention backward takes at most 4096 "
                         f"queries, got {L}")
    if B > 65535 or H > 65535:
        raise ValueError(f"rank-1 attention backward grids at most 65535 "
                         f"clouds and heads, got {B} and {H}")
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if dq.numel() == 0:
        return dq, dk, dv
    lib = kernels.load()
    tiles = lib.lsdm_rank1_attn_bwd_tiles(S)
    scratch = (torch.empty((tiles, B, H, L), dtype=torch.float32, device=dev)
               if tiles > 1 else None)
    with torch.cuda.device(dev):
        rc = lib.lsdm_rank1_attn_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            g.data_ptr(), denom.data_ptr(), B, L, S, H, dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(),
            None if scratch is None else scratch.data_ptr(), kernels.stream(dev))
    kernels.check(rc, "rank1_attn_bwd")
    kernels.LAUNCHES["rank1_attn_bwd"] += 1
    return dq, dk, dv


class _Rank1MHATrain(torch.autograd.Function):
    """K4 forward, K5 backward; saves (q, k, v, out), as the JAX custom VJP
    does, and K4's row denominators (B, H, L), as flash attention saves its
    log-sum-exp: K5 then takes one exponential a (row, key) pair.  On the
    CPU both directions are the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v):
        q, k, v = (t.contiguous() for t in (q, k, v))
        out, den = rank1_mha_kernel(q, k, v, denominator=True)
        ctx.save_for_backward(q, k, v, out, den)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, den = ctx.saved_tensors
        return rank1_mha_bwd_kernel(q, k, v, out, g.contiguous(), den)


def rank1_mha_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                    ) -> torch.Tensor:
    """Differentiable rank-1 attention (the JAX ``rank1_mha_train``): K4
    forward, K5 backward, no (L, S) plane in device memory either way.
    q (B, L, H), k and v (B, S, H) -> (B, L, H)."""
    return _Rank1MHATrain.apply(q, k, v)

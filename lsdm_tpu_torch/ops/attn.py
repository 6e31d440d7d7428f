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
denominator the training forward saved.

Two compute modes, chosen by the dtype of q, k and v (all float32 or all
bf16; the plain versions also take float64).  bf16 is the JAX kernels'
``compute_dtype=bfloat16`` (``attn_pallas.py:43-56``, ``:86-134``): q and k
read as float32, each weight ``w = e / sum(e)`` rounded to bf16 before
every product, the sums float32; K4's output and row denominators stay
float32, K5's dq, dk and dv come back bf16, as the JAX custom VJP casts
them.  K5's bf16 mode is its own design on the tensor cores
(``csrc/rank1_attn_bwd_bf16.cu``: the sums split by linearity into
products of the bf16 weight plane with exact bf16 parts of a few vectors,
on ``mma.sync``), so it sums in another order than the plain version.
The kernels count their bf16 launches apart (``rank1_attn_bf16``,
``rank1_attn_bwd_bf16``).

A wrapper runs the kernel for CUDA tensors and the plain version for CPU
tensors; it never falls back from one to the other.
"""

from __future__ import annotations

from typing import Optional

import torch

from lsdm_tpu_torch import kernels


def _mode(q, k, v) -> bool:
    """True for the bf16 mode (q, k, v all bf16); raises on a mix."""
    bf16 = {t.dtype == torch.bfloat16 for t in (q, k, v)}
    if len(bf16) > 1:
        raise ValueError(f"q, k and v must share one dtype, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    return bf16.pop()


def _weights(q, k):
    """(softmax weights (B, H, L, S), row denominators (B, H, L)) of the
    rank-1 logits, in at least float32."""
    dt = torch.promote_types(q.dtype, torch.float32)
    logits = torch.einsum("blh,bsh->bhls", q.to(dt), k.to(dt))  # rank 1
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    den = e.sum(dim=-1)
    return e / den[..., None], den


def rank1_mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    denominator: bool = False):
    """Plain version of K4, the JAX kernel's formula: per head
    ``w = e / sum(e)`` with ``e = exp(q k - max)``, then ``sum(w v)``; in
    the bf16 mode each ``w`` rounded to bf16 (to nearest even) first.
    q (B, L, H), k and v (B, S, H) -> (B, L, H), float32 for bf16 inputs;
    with ``denominator``, also each row's ``sum(e)``, (B, H, L)."""
    w, den = _weights(q, k)
    if _mode(q, k, v):
        w = w.to(torch.bfloat16).to(w.dtype)
    out = torch.einsum("bhls,bsh->blh", w, v.to(w.dtype))
    return (out, den) if denominator else out


def rank1_mha_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     denominator: bool = False):
    """K4: ``softmax_s(q_h * k_h[s]) @ v_h`` for every head h.  q (B, L, H),
    k and v (B, S, H), float32 -> (B, L, H); with ``denominator``, also
    each row's softmax denominator ``sum_s exp(q k - max)`` (B, H, L),
    which the backward (K5) takes.  bf16 q, k, v: the bf16 mode, whose
    output and denominators are float32.  CUDA kernel for CUDA tensors,
    plain version for CPU tensors."""
    if kernels.on_cpu(q, k, v):
        return rank1_mha_plain(q, k, v, denominator)
    B, L, H = q.shape
    S = k.shape[1]
    dev = q.device
    dt = torch.bfloat16 if q.dtype == torch.bfloat16 else torch.float32
    kernels.require("q", q, dt, (None, None, None), dev)
    kernels.require("k", k, dt, (B, None, H), dev)
    kernels.require("v", v, dt, (B, S, H), dev)
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
        name = "rank1_attn_bf16" if dt == torch.bfloat16 else "rank1_attn"
        with torch.cuda.device(dev):
            rc = getattr(lib, "lsdm_" + name)(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), B, L, S, H,
                out.data_ptr(), None if den is None else den.data_ptr(),
                kernels.stream(dev))
        kernels.check(rc, name)
        kernels.LAUNCHES[name] += 1
    return (out, den) if denominator else out


def rank1_mha_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, g: torch.Tensor,
                        denom: Optional[torch.Tensor] = None):
    """Plain version of K5, the JAX backward kernel's formula: the softmax
    recomputed, ``D = g * out`` and ``dlog = w (g v - D)``; then
    ``dq = sum_s dlog k``, ``dk = sum_l dlog q``, ``dv = sum_l w g``; in
    the bf16 mode each ``w`` rounded to bf16 first, and dq, dk, dv
    returned in bf16.  q, out, g (B, L, H), k and v (B, S, H) -> (dq, dk,
    dv).  It recomputes the row denominators, so ``denom`` (the kernel's
    input) is not read."""
    w, _ = _weights(q, k)                                     # (B, H, L, S)
    bf16 = _mode(q, k, v)
    if bf16:
        w = w.to(torch.bfloat16).to(w.dtype)
    q, k, v = q.to(w.dtype), k.to(w.dtype), v.to(w.dtype)
    gh = g.transpose(1, 2)[..., None]                         # (B, H, L, 1)
    d = (g * out).transpose(1, 2)[..., None]
    dlog = w * (gh * v.transpose(1, 2)[:, :, None, :] - d)
    dq = torch.einsum("bhls,bsh->blh", dlog, k)
    dk = torch.einsum("bhls,blh->bsh", dlog, q)
    dv = torch.einsum("bhls,blh->bsh", w, g)
    if bf16:
        return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))
    return dq, dk, dv


def rank1_mha_bwd_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         out: torch.Tensor, g: torch.Tensor, denom: torch.Tensor):
    """K5: the gradients (dq, dk, dv) of K4 at the cotangent ``g``.  q, out
    and g (B, L, H), k and v (B, S, H), float32, or q, k, v bf16 (the bf16
    mode: out, g float32, dq, dk, dv bf16); ``denom`` (B, H, L) the
    forward's row denominators (``rank1_mha_kernel(..., denominator=True)``),
    which the kernel needs and the plain version does not.  CUDA kernel
    (one pass over every (row, key) pair) for CUDA tensors, plain version
    for CPU tensors."""
    if kernels.on_cpu(q, k, v, out, g, denom):
        return rank1_mha_bwd_plain(q, k, v, out, g)
    B, L, H = q.shape
    S = k.shape[1]
    dev = q.device
    dt = torch.bfloat16 if q.dtype == torch.bfloat16 else torch.float32
    kernels.require("q", q, dt, (None, None, None), dev)
    kernels.require("k", k, dt, (B, None, H), dev)
    kernels.require("v", v, dt, (B, S, H), dev)
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
    name = "rank1_attn_bwd_bf16" if dt == torch.bfloat16 else "rank1_attn_bwd"
    with torch.cuda.device(dev):
        rc = getattr(lib, "lsdm_" + name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            g.data_ptr(), denom.data_ptr(), B, L, S, H, dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(),
            None if scratch is None else scratch.data_ptr(), kernels.stream(dev))
    kernels.check(rc, name)
    kernels.LAUNCHES[name] += 1
    return dq, dk, dv


class _Rank1MHATrain(torch.autograd.Function):
    """K4 forward, K5 backward; saves (q, k, v, out), as the JAX custom VJP
    does, and K4's row denominators (B, H, L), as flash attention saves its
    log-sum-exp: K5 then takes one exponential a (row, key) pair.  On the
    CPU both directions are the plain versions.  bf16 q, k, v give a
    float32 output and bf16 gradients."""

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
    q (B, L, H), k and v (B, S, H), float32 or bf16 -> (B, L, H) float32."""
    return _Rank1MHATrain.apply(q, k, v)

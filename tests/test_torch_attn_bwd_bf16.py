"""K5's bf16 mode (``csrc/rank1_attn_bwd_bf16.cu``) as its tensor-core
design computes it, on the CPU.

The kernel splits the backward's sums by linearity,

    dq = g sum_s w (v k) - D sum_s w k
    dk = v sum_l w (g q) - sum_l w (D q)
    dv = sum_l w g,

and runs each as a product of the bf16 weight plane W with bf16 columns
that hold the vectors exactly: v k (a product of two bf16 values) in two
bf16 parts, g, g q and D q (float32) in three.  Here the splits are held
exact, and a plain-torch model of the kernel's contractions (each part's
product summed in float32, the parts and the 64-key groups of a warp
combined in the kernel's order, the 1024-key tiles in sequence) is held
to the plain version's float32 sums and to JAX's backward kernel
(``_rank1_mha_bwd_pallas(..., compute_dtype=bfloat16)`` in interpret mode,
whose output is float32 before the custom VJP's cast) within a quarter of
the card's gate, ``ATTN_BWD_BF16_ATOL`` x max(1, max |grad|), on small
ragged shapes, a shape of two key tiles and inputs offset by +8, where
the split form cancels two sums of ~8 |g|.  The model takes each
reference's own bf16 weights, so what it checks is the design's
arithmetic, not where two exponentials round a weight apart.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsdm_tpu.ops.attn_pallas import _rank1_mha_bwd_pallas
from lsdm_tpu_torch.ops import attn

# chip_smoke.ATTN_BWD_BF16_ATOL: K5 bf16 against its plain version on the card
ATTN_BWD_BF16_ATOL = 2e-3
KEYS_A_WARP, KEYS_A_BLOCK = 64, 1024  # csrc/rank1_attn_bwd_bf16.cu
# (B, L, S, H, offset): ragged L and S, two key tiles, +8 offsets
CASES = [(2, 40, 77, 3, 0.0), (1, 37, 1100, 2, 0.0), (2, 24, 100, 2, 8.0),
         (1, 19, 1030, 2, 8.0)]


def _bf16(t):
    return t.to(torch.bfloat16).float()


def split(x, parts):
    """x (float32) as ``parts`` bf16-valued float32 tensors, the kernel's
    split: each part the bf16 rounding of what the earlier ones left."""
    out, r = [], x
    for _ in range(parts):
        p = _bf16(r)
        out.append(p)
        r = r - p
    return out


def _exact(parts, x):
    """The parts are bf16 values and sum to x exactly (in float64)."""
    return (all(torch.equal(p, _bf16(p)) for p in parts)
            and torch.equal(sum(p.double() for p in parts), x.double()))


@functools.lru_cache(maxsize=None)
def _inputs(b, l, s, h, offset):
    """Seeded bf16-valued q, k, v, float32 g and the plain forward's out
    (float32 tensors)."""
    rs = np.random.RandomState(b * 1000 + l + s + h)
    q = _bf16(torch.from_numpy(rs.randn(b, l, h).astype(np.float32) * 2))
    k = _bf16(torch.from_numpy(rs.randn(b, s, h).astype(np.float32) * 2 + offset))
    v = _bf16(torch.from_numpy(rs.randn(b, s, h).astype(np.float32) + offset))
    g = torch.from_numpy(rs.randn(b, l, h).astype(np.float32))
    out = attn.rank1_mha_plain(*(t.bfloat16() for t in (q, k, v)))
    return q, k, v, g, out


def plain_weights(q, k):
    """The plain version's bf16 weights, (B, H, L, S) float32."""
    return _bf16(attn._weights(q, k)[0])


def jax_weights(q, k):
    """JAX's backward kernel's bf16 weights (its formula, eager), (B, H, L,
    S) float32."""
    qj, kj = jnp.asarray(q.numpy()), jnp.asarray(k.numpy())
    logits = qj.transpose(0, 2, 1)[..., :, None] * kj.transpose(0, 2, 1)[..., None, :]
    e = jnp.exp(logits - jnp.max(logits, axis=-1, keepdims=True))
    w = e / jnp.sum(e, axis=-1, keepdims=True)
    return torch.from_numpy(np.array(w.astype(jnp.bfloat16).astype(jnp.float32)))


def plain_f32(q, k, v, out, g, w):
    """rank1_mha_bwd_plain's arithmetic before its final rounding to bf16,
    on the weights w (B, H, L, S)."""
    gh = g.transpose(1, 2)[..., None]
    d = (g * out).transpose(1, 2)[..., None]
    dlog = w * (gh * v.transpose(1, 2)[:, :, None, :] - d)
    return (torch.einsum("bhls,bsh->blh", dlog, k), torch.einsum("bhls,blh->bsh", dlog, q),
            torch.einsum("bhls,blh->bsh", w, g))


def kernel_model(q, k, v, out, g, w):
    """The kernel's contractions in float32 on the weights w (B, H, L, S):
    dq's columns (v k hi, v k lo, k) summed a 64-key warp group at a time,
    combined per warp as g (hi + lo) - D k, the warps and the 1024-key
    tiles added in order; dk's and dv's three-part columns summed over all
    rows, the parts added as p1 + (p2 + p3), dk = v X - Y."""
    B, L, H = q.shape
    S = k.shape[1]
    vk = v * k
    vk_parts = split(vk, 2)
    D = g * out
    g_parts, x_parts, y_parts = split(g, 3), split(g * q, 3), split(D * q, 3)
    assert _exact(vk_parts, vk) and _exact(g_parts, g)
    assert _exact(x_parts, g * q) and _exact(y_parts, D * q)
    # dq: per 64-key group, then groups in order
    pad = -S % KEYS_A_WARP
    wp = torch.nn.functional.pad(w, (0, pad))
    cols = [torch.nn.functional.pad(c.transpose(1, 2), (0, pad))
            for c in (*vk_parts, k)]                                  # (B, H, Sp)
    groups = wp.shape[-1] // KEYS_A_WARP
    wg = wp.reshape(B, H, L, groups, KEYS_A_WARP)
    hi, lo, kk = (torch.einsum("bhlgs,bhgs->bhlg", wg,
                               c.reshape(B, H, groups, KEYS_A_WARP)) for c in cols)
    gt, dt = g.transpose(1, 2)[..., None], D.transpose(1, 2)[..., None]
    part = gt * (hi + lo) - dt * kk                                   # (B, H, L, groups)
    dq = torch.zeros(B, H, L)
    per_tile = KEYS_A_BLOCK // KEYS_A_WARP
    for t0 in range(0, groups, per_tile):  # a tile's warps in order, then the tiles
        acc = part[..., t0]
        for gi in range(t0 + 1, min(t0 + per_tile, groups)):
            acc = acc + part[..., gi]
        dq = acc if t0 == 0 else dq + acc
    rsum = [[torch.einsum("bhls,blh->bsh", w, p) for p in parts]
            for parts in (g_parts, x_parts, y_parts)]
    dv, x, y = (p[0] + (p[1] + p[2]) for p in rsum)
    return dq.transpose(1, 2), v * x - y, dv


def _tol(ref):
    return ATTN_BWD_BF16_ATOL * max(1.0, ref.abs().max().item())


@pytest.mark.parametrize("case", CASES)
def test_k5_bf16_model_stays_near_the_plain_sums(case):
    """Against the plain version's float32 sums on its own weights: within a
    quarter of the gate; and those sums rounded to bf16 are the plain
    version's output."""
    q, k, v, g, out = _inputs(*case)
    w = plain_weights(q, k)
    want = plain_f32(q, k, v, out, g, w)
    plain = attn.rank1_mha_bwd_plain(q.bfloat16(), k.bfloat16(), v.bfloat16(), out, g)
    assert all(torch.equal(p, t.bfloat16()) for p, t in zip(plain, want))
    got = kernel_model(q, k, v, out, g, w)
    for a, b in zip(got, want):
        err = (a - b).abs().max().item()
        assert err <= _tol(b) / 4, (case, err, _tol(b))


@pytest.mark.parametrize("case", CASES)
def test_k5_bf16_model_stays_near_jax(case):
    """Against JAX's backward kernel at compute_dtype=bfloat16 (interpret
    mode, float32 output) on its own weights: within a quarter of the gate."""
    q, k, v, g, out = _inputs(*case)
    with jax.default_matmul_precision("highest"):
        want = _rank1_mha_bwd_pallas(*(jnp.asarray(t.numpy()) for t in (q, k, v, out, g)),
                                     compute_dtype=jnp.bfloat16, interpret=True)
    got = kernel_model(q, k, v, out, g, jax_weights(q, k))
    for a, b in zip(got, want):
        b = torch.from_numpy(np.array(b))
        err = (a - b).abs().max().item()
        assert err <= _tol(b) / 4, (case, err, _tol(b))


def test_bf16_splits_are_exact_at_the_edges():
    """v k for bf16 v and k is exactly two bf16 parts, and a float32 number
    three, at scales from 2^-90 to 2^100 (a float32 whose third part
    falls below 2^-126 is split to within that part's subnormal spacing)
    and at the largest significands (the carries of the parts' rounding)."""
    rs = np.random.RandomState(3)
    a = _bf16(torch.from_numpy(rs.randn(4096).astype(np.float32)))
    b = _bf16(torch.from_numpy(rs.randn(4096).astype(np.float32)))
    edge = _bf16(torch.tensor([1.9921875, -1.9921875, 1.0, 1.5]))
    a, b = torch.cat([a, edge, edge]), torch.cat([b, edge, -edge])
    for scale in (2.0 ** -50, 1.0, 2.0 ** 50):
        vk = (a * scale) * b
        assert torch.equal(vk.double(), (a * scale).double() * b.double())  # exact
        assert _exact(split(vk, 2), vk)
    sign = np.where(rs.rand(4096) < 0.5, -1.0, 1.0)
    x = torch.from_numpy((sign * (0.5 + 3.5 * rs.rand(4096))).astype(np.float32))
    x = torch.cat([x, torch.tensor([np.float32(1) - np.float32(2.0 ** -24),
                                    np.float32(1.9999999), np.float32(-3.3333333)])])
    for scale in (2.0 ** -90, 1.0, 2.0 ** 100):
        assert _exact(split(x * scale, 3), x * scale)

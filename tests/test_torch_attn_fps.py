"""K4 and K5 (rank-1 attention forward and backward) and K3 (FPS) as the
Hopper kernels compute them, on the CPU.

The CUDA kernels cannot run here, so their arithmetic is transcribed into
torch and held against the JAX package: K4's one pass over the keys
(``csrc/rank1_attn.cu``: per thread 4 keys in sequence, K5's warp
reduce-scatter over the lanes, the warps in order, the exponential as
``ex2`` of the rounded argument) against ``rank1_mha_pallas`` in
interpret mode, and its row denominators; K5's one pass from the
forward's saved row denominator (``csrc/rank1_attn_bwd.cu``), in float64
against ``_rank1_mha_bwd_pallas`` in interpret mode, and in float32
against that exact algebra, on plain inputs and on k, v shifted by +8,
where a factored form of the same gradients loses digits to
cancellation; the warp reduction that sums K4's and K5's row partials;
K3's lane layout and argmax (``csrc/fps.cu``) against ``torch.argmax``;
the host's FPS launch plan; and the calls that must not read back from
the card (no ``start`` tensor on the SDM's FPS).  The transcriptions add
their terms in a fixed order, as the kernels' lanes do, so their float32
results are the same bits in every process.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsdm_tpu.ops.attn_pallas import (
    _rank1_mha_bwd_pallas, rank1_mha_pallas, rank1_mha_train)
from lsdm_tpu_torch.models.pointnet2 import PointNet2Backbone
from lsdm_tpu_torch.ops import attn, fps, pointcloud

# chip_smoke.ATTN_ATOL, ATTN_DEN_RTOL: K4 against its plain version on the
# card; chip_smoke.ATTN_BWD_ATOL: K5 against its plain version
ATTN_ATOL = 1e-6
ATTN_DEN_RTOL = 1e-6
ATTN_BWD_ATOL = 1e-5
# float32 against the exact (float64) algebra, here and in JAX's kernel:
# with k and v offset by +8 a dq term w (g v - D) k reaches ~10 and cancels
# to a dq of order 1, so sums of 48 such terms keep ~1e-5 (JAX's kernel
# reads 9.9e-06 from the float64 algebra on these inputs).
F32_ATOL = 3e-5
LOG2E = 1.4426950408889634
SHAPE = (2, 64, 48, 12)  # B, L, S, H


def _row_max(q, k):
    """K4's and K5's row max of q k, from max(k) and min(k)."""
    kmax, kmin = k.amax(1, keepdim=True), k.amin(1, keepdim=True)
    return torch.where(q >= 0, q * kmax, q * kmin)


def _sum(x, dim):
    """A sum in sequence along ``dim``, as a kernel's lane adds its terms:
    the same order, so the same bits, in every process."""
    x = x.movedim(dim, 0)
    acc = x[0]
    for term in x[1:]:
        acc = acc + term
    return acc


def k4_denominator(q, k):
    """K4's saved row sums Z = sum_s exp(q k - m), (B, H, L)."""
    d = q[:, :, None, :] * k[:, None, :, :] - _row_max(q, k)[:, :, None, :]
    return _sum(torch.exp(d), 2).transpose(1, 2)


def k5_one_pass(q, k, v, out, g, z):
    """K5's algebra as the kernel computes it: e = 2^((q k - m) log2 e), q k
    - m and g v - D rounded as the plain version rounds them, p = e (g v -
    D); dq = sum_s p k / Z, dk = sum_l p (q / Z), dv = sum_l e (g / Z)."""
    d = q[:, :, None, :] * k[:, None, :, :] - _row_max(q, k)[:, :, None, :]
    e = torch.exp2(d * LOG2E)                                    # (B, L, S, H)
    p = e * (g[:, :, None, :] * v[:, None, :, :] - (g * out)[:, :, None, :])
    zl = z.transpose(1, 2)                                       # (B, L, H)
    return (_sum(p * k[:, None], 2) / zl, _sum(p * (q / zl)[:, :, None], 1),
            _sum(e * (g / zl)[:, :, None], 1))


def k5_factored(q, k, v, out, g, z):
    """The same gradients factored to save work a pair:
    dq = g (sum_s w v k - out sum_s w k), dk = v sum_l w g q - sum_l w D q."""
    d = q[:, :, None, :] * k[:, None, :, :] - _row_max(q, k)[:, :, None, :]
    w = torch.exp2(d * LOG2E) / z.transpose(1, 2)[:, :, None, :]
    dq = g * _sum(w * (v * k)[:, None], 2) - g * out * _sum(w * k[:, None], 2)
    dk = v * _sum(w * (g * q)[:, :, None], 1) - _sum(w * (g * out * q)[:, :, None], 1)
    return dq, dk, _sum(w * g[:, :, None], 1)


# csrc/rank1_attn.cu: threads a block, keys a thread, warps a block
K4_THREADS, K4_KEYS = 256, 4
K4_WARPS = K4_THREADS // 32


def _fma(a, b, c):
    """fmaf in float32: the float64 product of two float32 values is exact."""
    return (a.double() * b.double() + c.double()).float()


def _lane_tree(x, dim):
    """The sum over 32 lanes along ``dim`` as the reduce-scatter of
    ``rank1::reduce_rows`` adds them: pairs by lane bit 4, then 3, 2, 1, 0
    (each add commutes, so who adds to whom does not matter)."""
    while x.shape[dim] > 1:
        x = x.narrow(dim, 0, x.shape[dim] // 2) + x.narrow(dim, x.shape[dim] // 2,
                                                           x.shape[dim] // 2)
    return x.squeeze(dim)


def k4_kernel_order(q, k, v):
    """K4 as the kernel computes it, float32: e = 2^((q k - m) log2 e) of the
    argument rounded as the kernel rounds it; key c 1024 + j 256 + t on
    thread t of chunk c; each thread's 4 keys in sequence (the first one
    starts the sums, e v then FMAs), the lanes by the reduce-scatter's tree,
    each warp's totals over the chunks in sequence, then the 8 warps in
    order.  q (B, L, H), k and v (B, S, H) -> out (B, L, H), den (B, H, L)."""
    B, L, H = q.shape
    S = k.shape[1]
    chunk = K4_THREADS * K4_KEYS
    nch = -(-S // chunk)
    kp = torch.zeros(B, nch * chunk, H)
    vp = torch.zeros(B, nch * chunk, H)
    kp[:, :S], vp[:, :S] = k, v
    arg = (q[:, :, None, :] * kp[:, None] - _row_max(q, k)[:, :, None, :]) * LOG2E
    e = torch.exp2(arg)
    e[:, :, S:] = 0.0  # a missing key's argument is -inf
    e = e.reshape(B, L, nch, K4_KEYS, K4_THREADS, H)
    vv = vp.reshape(B, 1, nch, K4_KEYS, K4_THREADS, H).expand_as(e)
    se, sv = e[:, :, :, 0], e[:, :, :, 0] * vv[:, :, :, 0]
    for j in range(1, K4_KEYS):
        se, sv = se + e[:, :, :, j], _fma(e[:, :, :, j], vv[:, :, :, j], sv)
    warps = [_lane_tree(t.reshape(B, L, nch, K4_WARPS, 32, H), 4) for t in (se, sv)]
    se, sv = (_sum(t, 2) for t in warps)   # chunks in sequence: (B, L, W, H)
    se, sv = _sum(se, 2), _sum(sv, 2)      # warps in order: (B, L, H)
    return sv / se, se.transpose(1, 2)


def _softmax64(q, k, v):
    """The softmax of the logits as every version rounds them (q k, then
    - m, in float32), evaluated in float64: (out (B, L, H), den (B, H, L))."""
    x = (q[:, :, None, :] * k[:, None] - _row_max(q, k)[:, :, None, :]).double()
    e = torch.exp(x)
    den = e.sum(2)
    return (e * v[:, None].double()).sum(2) / den, den.transpose(1, 2)


@functools.lru_cache(maxsize=None)
def _attn_inputs(offset):
    """Seeded (q, k, v, out, g), k and v offset by ``offset``, with JAX's
    forward ``out`` and its backward kernel's (dq, dk, dv), interpret mode;
    computed once a process."""
    B, L, S, H = SHAPE
    rs = np.random.RandomState(9)
    q, g = (rs.randn(B, L, H).astype(np.float32) for _ in range(2))
    k, v = ((rs.randn(B, S, H) + offset).astype(np.float32) for _ in range(2))
    with jax.default_matmul_precision("highest"):
        out = rank1_mha_pallas(*map(jnp.asarray, (q, k, v)), interpret=True)
        want = _rank1_mha_bwd_pallas(*map(jnp.asarray, (q, k, v)), out,
                                     jnp.asarray(g), interpret=True)
    return (q, k, v, np.array(out), g), tuple(np.array(w) for w in want)


def _errors(fn, offset, dtype=torch.float32, want=None):
    """Largest |fn - want| of (dq, dk, dv) on the inputs of ``offset``;
    ``want`` defaults to JAX's kernel."""
    data, jax_want = _attn_inputs(offset)
    q, k, v, out, g = (torch.from_numpy(a.copy()).to(dtype) for a in data)
    got = fn(q, k, v, out, g, k4_denominator(q, k))
    return [float(np.abs(a.double().numpy() - np.asarray(w, dtype=np.float64)).max())
            for a, w in zip(got, jax_want if want is None else want)]


def _exact(offset):
    """The one-pass algebra in float64: the exact gradients to float32's eye."""
    data, _ = _attn_inputs(offset)
    q, k, v, out, g = (torch.from_numpy(a.copy()).double() for a in data)
    return [t.numpy() for t in k5_one_pass(q, k, v, out, g, k4_denominator(q, k))]


K4_SHAPES = [(2, 64, 1024, 12),  # one chunk of 1024 keys, as at the flagship
             (1, 37, 2500, 12)]  # three chunks, the last one masked; ragged rows


@functools.lru_cache(maxsize=None)
def _k4_case(shape, offset):
    """Seeded (q, k, v), k and v offset by ``offset``, and JAX's forward
    kernel's output on them (interpret mode); computed once a process."""
    B, L, S, H = shape
    rs = np.random.RandomState(10)
    q = rs.randn(B, L, H).astype(np.float32)
    k, v = ((rs.randn(B, S, H) + offset).astype(np.float32) for _ in range(2))
    with jax.default_matmul_precision("highest"):
        want = rank1_mha_pallas(*map(jnp.asarray, (q, k, v)), interpret=True)
    return (q, k, v), np.array(want)


@pytest.mark.parametrize("offset", [0.0, 8.0])
@pytest.mark.parametrize("shape", K4_SHAPES)
def test_k4_kernel_order_matches_jax(shape, offset):
    """K4's float32 arithmetic and summation order against JAX's forward
    kernel (interpret mode) and against the float64 softmax of the logits
    as both round them, in units of the output's size (with v offset by +8
    the outputs are ~8, whose float32 spacing is 9.5e-7): within
    ATTN_ATOL of JAX's kernel and of the float64 result, and no further
    from the latter than JAX's kernel itself; the row denominators within
    ATTN_DEN_RTOL."""
    data, jax_out = _k4_case(shape, offset)
    q, k, v = map(torch.from_numpy, data)
    out, den = k4_kernel_order(q, k, v)
    exact, exact_den = _softmax64(q, k, v)
    scale = max(1.0, float(exact.abs().max()))
    err = float((out.double() - exact).abs().max())
    jax_err = float(np.abs(jax_out - exact.numpy()).max())
    assert err <= ATTN_ATOL * scale and err <= jax_err, (err, jax_err, scale)
    assert np.abs(out.numpy() - jax_out).max() <= ATTN_ATOL * scale
    den_err = float(((den.double() - exact_den) / exact_den).abs().max())
    assert den_err <= ATTN_DEN_RTOL, den_err


def test_k4_lane_tree_is_the_reduce_scatter_order():
    """``_lane_tree`` adds the lanes as ``rank1::reduce_rows`` does, to the
    bit, in float32: the reduce-scatter run lane by lane on 8 rows."""
    rs = np.random.RandomState(1)
    acc = torch.from_numpy(rs.randn(32, 8).astype(np.float32) * 10.0 ** rs.randint(-3, 3, (32, 8)))
    lanes = torch.arange(32)
    vals = [acc[:, i].clone() for i in range(8)]
    for off, n in ((16, 4), (8, 2), (4, 1)):
        up = (lanes & off) != 0
        vals = [torch.where(up, vals[i + n], vals[i])
                + torch.where(up, vals[i], vals[i + n])[lanes ^ off] for i in range(n)]
    r = vals[0]
    for off in (2, 1):
        r = r + r[lanes ^ off]
    rsel = ((lanes >> 4) & 1) * 4 + ((lanes >> 3) & 1) * 2 + ((lanes >> 2) & 1)
    writers = lanes[(lanes & 3) == 0]
    assert torch.equal(r[writers], _lane_tree(acc, 0)[rsel[writers]])


@pytest.mark.parametrize("offset", [0.0, 8.0])
def test_k5_one_pass_algebra_matches_jax(offset):
    """K5's one pass from the saved denominators, in float64, against JAX's
    backward kernel (float32, interpret mode), on plain and +8-offset
    inputs: the algebra is the JAX kernel's, to its own float32 rounding."""
    errs = _errors(k5_one_pass, offset, torch.float64)
    assert max(errs) <= F32_ATOL, errs


@pytest.mark.parametrize("offset", [0.0, 8.0])
def test_k5_one_pass_float32_stays_near_the_exact_algebra(offset):
    """The kernel's float32 arithmetic against the float64 algebra: it loses
    no more than float32 sums of these terms must (JAX's kernel loses as
    much, the test above), with k and v offset by +8 too."""
    errs = _errors(k5_one_pass, offset, want=_exact(offset))
    assert max(errs) <= F32_ATOL, errs


def test_k5_factored_form_loses_the_offset_case():
    """Why K5 keeps the per-pair (g v - D) k form: factored, dq cancels two
    sums of magnitude ~8 |g| each, and on the +8-offset inputs its float32
    error from the exact algebra is several times the per-pair form's and
    beyond F32_ATOL, where the per-pair form's is within it."""
    exact = _exact(8.0)
    one_pass = max(_errors(k5_one_pass, 8.0, want=exact))
    factored = max(_errors(k5_factored, 8.0, want=exact))
    assert one_pass <= F32_ATOL < factored and factored > 4 * one_pass, (one_pass, factored)


def test_k5_dq_warp_reduction_sums_every_row_once():
    """``reduce_rows`` in csrc/rank1_attn_bwd.cu, lane by lane: after the
    reduce-scatter over offsets 16, 8, 4 and the butterflies over 2, 1,
    lanes with (lane & 3) == 0 hold row 4 b4 + 2 b3 + b2 of their bits."""
    rs = np.random.RandomState(0)
    acc = rs.randint(-1000, 1000, size=(32, 8)).astype(np.int64)  # exact sums
    lanes = np.arange(32)
    vals = [acc[:, i].copy() for i in range(8)]
    for off, n in ((16, 4), (8, 2), (4, 1)):
        up = (lanes & off) != 0
        nxt = []
        for i in range(n):
            send = np.where(up, vals[i], vals[i + n])
            keep = np.where(up, vals[i + n], vals[i])
            nxt.append(keep + send[lanes ^ off])
        vals = nxt
    r = vals[0]
    for off in (2, 1):
        r = r + r[lanes ^ off]
    rsel = ((lanes >> 4) & 1) * 4 + ((lanes >> 3) & 1) * 2 + ((lanes >> 2) & 1)
    writers = lanes[(lanes & 3) == 0]
    assert sorted(rsel[writers]) == list(range(8))
    np.testing.assert_array_equal(r[writers], acc.sum(0)[rsel[writers]])


def test_k4_plain_denominator_is_the_row_sum():
    q, k, v = (torch.from_numpy(a.copy()) for a in _attn_inputs(0.0)[0][:3])
    out, den = attn.rank1_mha_plain(q, k, v, denominator=True)
    assert torch.equal(out, attn.rank1_mha_plain(q, k, v))
    torch.testing.assert_close(den, k4_denominator(q, k), atol=0, rtol=1e-6)
    assert den.shape == (q.shape[0], q.shape[2], q.shape[1])
    got = attn.rank1_mha_kernel(q, k, v, denominator=True)  # CPU: the plain version
    assert all(torch.equal(a, b) for a, b in zip(got, (out, den)))


def test_rank1_train_saves_the_denominator_and_matches_jax_vjp():
    """The training forward keeps K4's row denominators for K5; on the CPU
    both directions are the plain versions, and the gradients equal JAX's
    ``rank1_mha_train`` VJP.  (Not on the offset inputs: there dq moves by
    ~1e-5 with out's last bits, D = g out, so two forwards that round out
    differently give gradients that differ by more than K5's tolerance.)"""
    (q, k, v, _, g), _ = _attn_inputs(0.0)
    with jax.default_matmul_precision("highest"):
        out_j, vjp = jax.vjp(lambda *a: rank1_mha_train(*a, jnp.float32, True),
                             *map(jnp.asarray, (q, k, v)))
        want = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = attn.rank1_mha_train(tq, tk, tv)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 5 and saved[4].shape == (SHAPE[0], SHAPE[3], SHAPE[1])
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), atol=2e-6)
    for name, a, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=ATTN_BWD_ATOL,
                                   rtol=0, err_msg=f"d{name}")


def test_k5_wrapper_on_cpu_takes_the_plain_version_with_or_without_denom():
    (q, k, v, out, g), _ = _attn_inputs(0.0)
    q, k, v, out, g = map(torch.from_numpy, (q, k, v, out, g))
    den = k4_denominator(q, k)
    got = attn.rank1_mha_bwd_kernel(q, k, v, out, g, den)
    # the plain version recomputes the denominators: it reads none it is given
    for want in (attn.rank1_mha_bwd_plain(q, k, v, out, g),
                 attn.rank1_mha_bwd_plain(q, k, v, out, g, den)):
        assert all(torch.equal(a, b) for a, b in zip(got, want))


# --- K3 -------------------------------------------------------------------

def test_fps_plan_covers_every_cloud_size():
    for n in range(1, fps.MAX_POINTS + 1):
        warps, ppt = fps.fps_plan(n)
        assert ppt in (1, 2, 4) and 1 <= warps <= 32
        assert warps * 32 * ppt >= n, n
        assert warps * 32 * ppt < 2 * n + 32, n  # at most ~half the lanes idle
        if n <= 64:
            assert warps == 1  # no block barrier
    # the measured plans at sa2..sa4
    assert [fps.fps_plan(n) for n in (1024, 256, 64)] == [(32, 1), (8, 1), (1, 2)]
    for bad in (0, fps.MAX_POINTS + 1):
        with pytest.raises(ValueError):
            fps.fps_plan(bad)


def _kernel_argmax(dist: np.ndarray, n: int) -> int:
    """One round's argmax as csrc/fps.cu takes it: lane t of warp w owns
    points [t ppt, (t + 1) ppt), padding holds 0; each lane's first
    maximum, the warp's max bits and lowest lane holding them, then the
    warps' winners the same way."""
    warps, ppt = fps.fps_plan(n)
    lanes = np.zeros(warps * 32 * ppt, dtype=np.float32)
    lanes[:n] = dist
    bits = lanes.view(np.uint32).reshape(warps, 32, ppt)
    first = bits.argmax(-1)                              # per lane, first max
    best = np.take_along_axis(bits, first[..., None], -1)[..., 0]
    idx = (np.arange(warps * 32).reshape(warps, 32)) * ppt + first
    wmax = best.max(1)
    who = (best == wmax[:, None]).argmax(1)              # lowest lane: __ffs
    widx = idx[np.arange(warps), who]
    return int(widx[(wmax == wmax.max()).argmax()])


@pytest.mark.parametrize("n", [1, 5, 64, 256, 257, 1000, 1024, 3072])
def test_fps_lane_layout_takes_the_first_maximum(n):
    rs = np.random.RandomState(n)
    for case in range(4):
        dist = rs.choice([0.0, 1.5, 2.25, 1e10], size=n).astype(np.float32)  # ties
        if case == 0:
            dist[:] = 0.0  # every point already selected
        assert _kernel_argmax(dist, n) == int(torch.argmax(torch.from_numpy(dist)))


@pytest.mark.parametrize("n,npoint", [(32, 8), (100, 25)])
def test_fps_without_start_equals_fps_from_zeros(n, npoint):
    xyz = torch.from_numpy(np.random.RandomState(n).randn(3, n, 3).astype(np.float32))
    zeros = torch.zeros(3, dtype=torch.int32)
    want = fps.farthest_point_sample_plain(xyz, npoint, zeros)
    for got in (fps.farthest_point_sample_plain(xyz, npoint),
                fps.farthest_point_sample_kernel(xyz, npoint),
                pointcloud.farthest_point_sample(xyz, npoint),
                pointcloud.farthest_point_sample(xyz, npoint, impl="topk")):
        assert torch.equal(got, want)


def test_pointnet2_fps_passes_no_start(monkeypatch):
    """The SDM's FPS calls pass no start tensor, so on the card they read
    nothing back (a start that is passed is range-checked on the host)."""
    starts = []
    real = pointcloud.farthest_point_sample_kernel

    def spy(xyz, npoint, start=None):
        starts.append(start)
        return real(xyz, npoint, start)

    monkeypatch.setattr(pointcloud, "farthest_point_sample_kernel", spy)
    backbone = PointNet2Backbone(sa_npoints=(32, 8, 4, 2), sa_nsample=8,
                                 ball_impl="pallas").eval()
    with torch.no_grad():
        backbone(torch.from_numpy(np.random.RandomState(1).randn(2, 32, 3)
                                  .astype(np.float32)))
    assert starts == [None, None, None]  # sa2..sa4; sa1 keeps all 32 points

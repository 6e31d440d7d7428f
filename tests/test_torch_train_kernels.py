"""The training slice's kernels (K5, K10, K11) against the JAX package.

The port's autograd functions run their plain versions on the CPU; the
JAX side runs its Pallas kernels in interpret mode, under
``jax.default_matmul_precision("highest")``, at the shapes of the JAX
package's own tests (``tests/test_pallas_kernels.py``,
``tests/test_sg_fused.py``).  Inputs come from numpy seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsdm_tpu.ops.attn_pallas import _rank1_mha_bwd_pallas, rank1_mha_train
from lsdm_tpu.ops.chamfer_pallas import _directed_min_sqdist, chamfer_distance_pallas
from lsdm_tpu.ops.sg_fused_pallas import _sg_call, select_gather_grouped
from lsdm_tpu_torch.ops import attn, chamfer, sg_fused


def _a(rs, *shape, scale=1.0):
    return (rs.randn(*shape) * scale).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(a).requires_grad_(grad)


# --- K5 -------------------------------------------------------------------

@pytest.mark.parametrize("B,L,fwd_tol,grad_tol", [
    (3, 64, 2e-6, 5e-6),    # tests/test_pallas_kernels.py:179-205
    (2, 512, 2e-5, 2e-5),   # the multi-tile case, :296-319
])
def test_rank1_train_matches_jax(B, L, fwd_tol, grad_tol):
    rs = np.random.RandomState(L)
    H = 12
    q, k, v, g = (_a(rs, B, L, H) for _ in range(4))
    with jax.default_matmul_precision("highest"):
        out_j, vjp = jax.vjp(lambda *a: rank1_mha_train(*a, jnp.float32, True),
                             *map(jnp.asarray, (q, k, v)))
        grads_j = vjp(jnp.asarray(g))
        direct_j = _rank1_mha_bwd_pallas(*map(jnp.asarray, (q, k, v)), out_j,
                                         jnp.asarray(g), interpret=True)
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    out = attn.rank1_mha_train(tq, tk, tv)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), atol=fwd_tol)
    for name, got, vjp_want, direct_want in zip("qkv", (tq.grad, tk.grad, tv.grad),
                                                grads_j, direct_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(vjp_want), atol=grad_tol,
                                   err_msg=f"d{name} vs jax.vjp")
        np.testing.assert_allclose(got.numpy(), np.asarray(direct_want), atol=grad_tol,
                                   err_msg=f"d{name} vs the backward kernel")


def test_rank1_train_module_gate():
    """``fused_train`` takes the K4/K5 pair only where the JAX module does:
    heads == embed, no mask, L % 8 == 0; and then equals the composed
    module in value and gradient."""
    from lsdm_tpu_torch.ops.attention import TorchMultiheadAttention

    rs = np.random.RandomState(5)
    mha = TorchMultiheadAttention(12, 12, kdim=3, vdim=3)
    x, xyz = _t(_a(rs, 2, 32, 12)), _t(_a(rs, 2, 32, 3))
    calls = []
    real = attn._Rank1MHATrain.apply
    attn._Rank1MHATrain.apply = lambda *a: calls.append(1) or real(*a)
    try:
        out_f, w_f = mha(x, xyz, xyz, fused_train=True)
        mha(x[:, :30], xyz[:, :30], xyz[:, :30], fused_train=True)  # L % 8 != 0
    finally:
        attn._Rank1MHATrain.apply = real
    assert calls == [1] and w_f is None
    g_f = torch.autograd.grad(out_f.square().sum(), list(mha.parameters()))
    out_c, _ = mha(x, xyz, xyz)
    g_c = torch.autograd.grad(out_c.square().sum(), list(mha.parameters()))
    torch.testing.assert_close(out_f, out_c, atol=2e-6, rtol=0)
    for a, b in zip(g_f, g_c):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)


def _bf16(a):
    return np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


# --- K10 ------------------------------------------------------------------

def _sg_inputs(seed, B=2, N=64, S=16, C=9):
    rs = np.random.RandomState(seed)
    xyz = rs.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    base = np.concatenate([xyz, _a(rs, B, N, C - 3)], -1)
    return xyz, xyz[:, :S].copy(), base


@pytest.mark.parametrize("case", ["jax_test", "empty_slots", "empty_ball"])
def test_select_gather_matches_jax(case):
    """Forward equal (grouped and idx), including rows with fewer in-radius
    points than nsample and a center with no point in its ball (all N - 1);
    gradients of base and new_xyz within 1e-6, the distance operand's zero
    (``_sg_bwd``)."""
    xyz, new_xyz, base = _sg_inputs({"jax_test": 1, "empty_slots": 3,
                                     "empty_ball": 4}[case])
    radius = 0.05 if case == "empty_slots" else 0.4
    if case == "empty_ball":
        new_xyz[1, 5] += 10.0
    N = xyz.shape[1]
    grouped_j, idx_j = _sg_call(radius, 8, *map(jnp.asarray, (xyz, new_xyz, base)),
                                jnp.float32, True)
    got, idx = sg_fused.select_gather_plain(radius, 8, *map(_t, (xyz, new_xyz, base)))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(got.numpy(), np.asarray(grouped_j))
    if case == "empty_ball":
        assert (idx[1, 5] == N - 1).all()
    if case == "empty_slots":
        assert (idx[..., -1] == idx[..., 0]).any()

    # the JAX backward (onehot_segment_sum) rounds the cotangent to bf16
    # before its f32 sums; a cotangent of bf16 values makes that exact, so
    # the two backwards differ only in the order of their f32 sums
    cot = _bf16(_a(np.random.RandomState(9), *got.shape))
    with jax.default_matmul_precision("highest"):
        want = jax.grad(lambda x, q, b: jnp.sum(select_gather_grouped(
            radius, 8, jnp.float32, True, x, q, b) * cot), (0, 1, 2))(
                *map(jnp.asarray, (xyz, new_xyz, base)))
    args = [_t(a, True) for a in (xyz, new_xyz, base)]
    (sg_fused.select_gather_grouped(radius, 8, *args) * torch.from_numpy(cot)).sum().backward()
    for name, a, w in zip(("xyz", "new_xyz", "base"), args, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), atol=1e-6, rtol=0,
                                   err_msg=name)
    assert not args[0].grad.any()


# --- K11 ------------------------------------------------------------------

def _no_near_ties(x, y):
    """No two candidates of any row lie within a few ulp of each other, so
    the argmin cannot depend on rounding."""
    d = ((x[:, :, None, :].astype(np.float64) - y[:, None, :, :]) ** 2).sum(-1)
    two = np.sort(d, axis=-1)[..., :2]
    return (two[..., 1] - two[..., 0] > 8 * np.spacing(two[..., 1].astype(np.float32))).all()


@pytest.mark.parametrize("n", [128, 256])
def test_chamfer_kernel_loss_matches_jax(n):
    rs = np.random.RandomState(n)
    x, y = _a(rs, 2, n, 3), _a(rs, 2, n, 3)
    assert _no_near_ties(x, y) and _no_near_ties(y, x)
    for a, b in ((x, y), (y, x)):
        m_j, arg_j = _directed_min_sqdist(jnp.asarray(a), jnp.asarray(b), True)
        m, arg = chamfer.directed_nn_plain(_t(a), _t(b))
        np.testing.assert_array_equal(arg.numpy(), np.asarray(arg_j))
        np.testing.assert_allclose(m.numpy(), np.asarray(m_j), rtol=1e-5, atol=1e-6)
    with jax.default_matmul_precision("highest"):
        loss_j, grads_j = jax.value_and_grad(
            lambda a, b: chamfer_distance_pallas(a, b, True), (0, 1))(
                jnp.asarray(x), jnp.asarray(y))
    tx, ty = _t(x, True), _t(y, True)
    loss = chamfer.chamfer_distance_kernel(tx, ty)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-6)
    for got, want in zip((tx.grad, ty.grad), grads_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_chamfer_kernel_ties_and_clamp():
    """Ties go to the lowest index, and a distance that rounds below zero
    is clamped after the min."""
    y = torch.tensor([[[1.0, 0, 0], [0, 1.0, 0], [-1.0, 0, 0]]])
    x = torch.tensor([[[0.0, 0, 0], [0.1, 0.2, 0.3]]])
    m, arg = chamfer.directed_nn_plain(x, y)
    assert arg[0, 0] == 0
    m, _ = chamfer.directed_nn_plain(x, x)
    assert (m >= 0).all()

"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and skips without one.  The shapes are
small and deliberately awkward (rows that are not multiples of a warp or a
tile, k < 3, empty balls, distance ties, several chunks of the denoise
chain), the edge cases ``chip_smoke.py`` does not reach at the flagship
shapes.  On a
machine with a GPU and no JAX, run them without the JAX test conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from lsdm_tpu_torch import kernels
from lsdm_tpu_torch.ops import (
    attn, ballquery, chamfer, denoise, fp_fused, fps, sa_fused, sg_fused)
from lsdm_tpu_torch.ops.denoise import DenoiseStepParams

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


def _cloud(seed, *shape, scale=1.0):
    return torch.from_numpy(
        (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32))


@pytest.mark.parametrize("n,s,radius,nsample", [
    (64, 64, 0.3, 32), (100, 13, 0.5, 16), (37, 5, 0.05, 8), (1024, 256, 0.2, 32)])
def test_ball_query_kernel_equals_plain(dev, n, s, radius, nsample):
    xyz = _cloud(n, 3, n, 3).to(dev)
    new_xyz = _cloud(s, 3, s, 3).to(dev)
    new_xyz[0, 0] = 50.0  # a ball with no point in it
    before = kernels.LAUNCHES["ball_query"]
    got = ballquery.query_ball_point_kernel(radius, nsample, xyz, new_xyz)
    assert kernels.LAUNCHES["ball_query"] == before + 1
    want = ballquery.query_ball_point_plain(radius, nsample, xyz, new_xyz)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert (got[0, 0] == n - 1).all()


@pytest.mark.parametrize("n,s,k", [(64, 16, 3), (50, 50, 3), (33, 2, 2), (7, 1, 1)])
def test_three_nn_kernel_equals_plain(dev, n, s, k):
    xyz1 = _cloud(n, 2, n, 3).to(dev)
    xyz2 = xyz1[:, :s].contiguous() if s == n else _cloud(s + 1, 2, s, 3).to(dev)
    gd, gi = ballquery.three_nn_kernel(xyz1, xyz2, k)
    wd, wi = ballquery.three_nn_plain(xyz1, xyz2, k)
    torch.cuda.synchronize()
    assert torch.equal(gi, wi)
    assert torch.equal(gd, wd)  # same float32 ops: same bits


def test_three_nn_ties_go_to_the_lowest_index(dev):
    xyz2 = torch.tensor([[[1.0, 0, 0], [0, 1.0, 0], [-1.0, 0, 0], [0, -1.0, 0]]],
                        device=dev)
    xyz1 = torch.zeros(1, 1, 3, device=dev)
    _, idx = ballquery.three_nn_kernel(xyz1, xyz2, 3)
    assert idx.tolist() == [[[0, 1, 2]]]


@pytest.mark.parametrize("n,npoint", [(64, 16), (1000, 250), (1024, 256), (3, 3)])
def test_fps_kernel_equals_plain(dev, n, npoint):
    xyz = _cloud(n + 7, 5, n, 3).to(dev)
    start = torch.tensor([0, 1, 2, n - 1, n // 2], dtype=torch.int32, device=dev)
    got = fps.farthest_point_sample_kernel(xyz, npoint, start)
    want = fps.farthest_point_sample_plain(xyz, npoint, start)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _chain_inputs(dev, B, T, N, D, seed=0):
    rs = np.random.RandomState(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rs.randn(*shape) * scale).astype(np.float32)).to(dev)

    dh, d15 = D // 2, int(D * 1.5)
    p = DenoiseStepParams(
        w_up0=t(128, 1), b_up0=t(128, 1, scale=0.1),
        w_up2=t(512, 128, scale=128 ** -0.5), b_up2=t(512, 1, scale=0.1),
        w_up4=t(N, 512, scale=512 ** -0.5), b_up4=t(N, 1, scale=0.1),
        wc_t=t(2 * D, D, scale=(2 * D) ** -0.5), bc=t(1, D, scale=0.1),
        wp0_t=t(3, dh, scale=0.5), bp0=t(1, dh, scale=0.1),
        wp2_t=t(dh, D, scale=dh ** -0.5), bp2=t(1, D, scale=0.1),
        wx0_t=t(2 * D, d15, scale=(2 * D) ** -0.5), bx0=t(1, d15, scale=0.1),
        wx2_t=t(d15, D, scale=d15 ** -0.5), bx2=t(1, D, scale=0.1),
        wo0_t=t(D, dh, scale=D ** -0.5), bo0=t(1, dh, scale=0.1),
        wo2_t=t(dh, 3, scale=dh ** -0.5), bo2=t(1, 3, scale=0.1))
    coef = torch.from_numpy(np.stack(
        [np.linspace(0.2, 0.9, T), np.linspace(0.9, 0.5, T),
         np.linspace(0.3, 0.0, T)], -1).astype(np.float32)).to(dev)
    return (t(B, N, 3), t(B, T, N, 3), t(B, N, 3), t(B, T, 2 * D), coef, p)


@pytest.mark.parametrize("clip", [False, True])
def test_denoise_chain_kernel_matches_plain(dev, clip, monkeypatch):
    # a small scratch budget forces several chunks of steps
    monkeypatch.setattr(denoise, "CHAIN_SCRATCH_FLOATS", 1 << 16)
    args = _chain_inputs(dev, B=2, T=7, N=37, D=16)
    got = denoise.fused_denoise_chain(*args, clip_denoised=clip)
    want = denoise.denoise_chain_plain(*args, clip_denoised=clip)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        # float32 sums in another order, through 7 recurrent steps
        torch.testing.assert_close(a, b, atol=2e-5, rtol=0)


def test_denoise_chain_tables_kernel_matches_plain(dev):
    *_, e2, _, p = _chain_inputs(dev, B=2, T=5, N=37, D=16)
    got = denoise.denoise_chain_tables(e2, p)
    want = denoise.denoise_chain_tables_plain(e2, p)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.shape == b.shape
        # float32 sums in another order, no recurrence
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def _layers(dev, widths, seed=0):
    """Random folded (W (F_{l-1}, F_l), b (F_l,)) layers of ``widths``."""
    rs = np.random.RandomState(seed)
    return [(torch.from_numpy((rs.randn(a, b) / np.sqrt(a)).astype(np.float32)).to(dev),
             torch.from_numpy((rs.randn(b) * 0.1).astype(np.float32)).to(dev))
            for a, b in zip(widths[:-1], widths[1:])]


@pytest.mark.parametrize("n,s,radius,nsample,mlp", [
    (64, 13, 0.8, 16, (8, 16)),        # 13 centers: not a multiple of a tile
    (37, 5, 0.3, 8, (8,)),             # one layer; most balls hold < 8 points
    (100, 24, 0.05, 32, (16, 16, 24)),  # nsample far above the in-radius count
    (64, 16, 0.8, 32, (256, 256, 512)),  # sa4's widths: one center per block
])
def test_sa_fused_kernel_matches_plain(dev, n, s, radius, nsample, mlp):
    xyz = _cloud(n, 2, n, 3).to(dev)
    new_xyz = xyz[:, :s].clone()
    new_xyz[1, 2] = 50.0  # a center with no point in its radius
    base = torch.cat([xyz, _cloud(n + 1, 2, n, 5).to(dev)], -1).contiguous()
    folded = _layers(dev, (8,) + mlp)
    before = kernels.LAUNCHES["sa_fused"]
    got = sa_fused.sa_stage_fused_kernel(radius, nsample, xyz, new_xyz, base, folded)
    assert kernels.LAUNCHES["sa_fused"] == before + 1
    want = sa_fused.sa_stage_fused_plain(radius, nsample, xyz, new_xyz, base, folded)
    torch.cuda.synchronize()
    assert got.shape == (2, s, mlp[-1])
    # float32 sums in another order
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    # the plain version, which the kernel matched, gathered point 0 in every
    # slot of the empty ball
    assert (ballquery.query_ball_point_plain(radius, nsample, xyz, new_xyz,
                                             empty=0)[1, 2] == 0).all()


@pytest.mark.parametrize("n,s,d1,mlp,acts", [
    (64, 2, 6, (8, 16), None),                     # S = 2: k = 2
    (50, 50, 0, (16, 8, 3), ("relu", "relu", "none")),  # sources = targets (fp1)
    (40, 16, 256, (256, 256), None),               # fp4-like widths, 40 rows
    (33, 7, 0, (12,), ("none",)),
])
def test_fp_fused_kernel_matches_plain(dev, n, s, d1, mlp, acts):
    xyz1 = _cloud(n, 2, n, 3).to(dev)
    xyz2 = xyz1[:, :s].contiguous() if s == n else _cloud(s + 3, 2, s, 3).to(dev)
    d2 = 512 if d1 == 256 else 10
    p1 = _cloud(n + 5, 2, n, d1).to(dev) if d1 else None
    p2 = _cloud(s + 9, 2, s, d2).to(dev)
    folded = _layers(dev, (d1 + d2,) + mlp)
    before = kernels.LAUNCHES["fp_fused"]
    got = fp_fused.fp_stage_fused_kernel(xyz1, xyz2, p1, p2, folded, acts)
    assert kernels.LAUNCHES["fp_fused"] == before + 1
    want = fp_fused.fp_stage_fused_plain(xyz1, xyz2, p1, p2, folded, acts)
    torch.cuda.synchronize()
    assert got.shape == (2, n, mlp[-1])
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_fp_fused_ties_go_to_the_lowest_index(dev):
    # the target at the origin is equidistant from all four sources: the
    # three lowest indices weigh 1/3 each, the fourth source none
    xyz2 = torch.tensor([[[1.0, 0, 0], [0, 1.0, 0], [-1.0, 0, 0], [0, -1.0, 0]]],
                        device=dev)
    xyz1 = torch.zeros(1, 8, 3, device=dev)
    p2 = torch.tensor([[[1.0], [2.0], [4.0], [100.0]]], device=dev)
    eye = [(torch.ones(1, 1, device=dev), torch.zeros(1, device=dev))]
    got = fp_fused.fp_stage_fused_kernel(xyz1, xyz2, None, p2, eye, ("none",))
    torch.testing.assert_close(got, torch.full((1, 8, 1), 7.0 / 3, device=dev))


@pytest.mark.parametrize("b,l,s,h", [(2, 300, 77, 12), (1, 1024, 1024, 12), (3, 8, 5, 2)])
def test_rank1_attention_kernel_matches_plain(dev, b, l, s, h):
    q = _cloud(1, b, l, h, scale=2.0).to(dev)
    k = _cloud(2, b, s, h, scale=2.0).to(dev)
    v = _cloud(3, b, s, h).to(dev)
    before = kernels.LAUNCHES["rank1_attn"]
    got = attn.rank1_mha_kernel(q, k, v)
    assert kernels.LAUNCHES["rank1_attn"] == before + 1
    want = attn.rank1_mha_plain(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("b,l,s,h", [(2, 300, 77, 12), (1, 1024, 1024, 12), (3, 8, 5, 2)])
def test_rank1_attention_bwd_kernel_matches_plain(dev, b, l, s, h):
    q = _cloud(4, b, l, h, scale=2.0).to(dev)
    k = _cloud(5, b, s, h, scale=2.0).to(dev)
    v = _cloud(6, b, s, h).to(dev)
    g = _cloud(7, b, l, h).to(dev)
    out = attn.rank1_mha_plain(q, k, v).contiguous()
    before = kernels.LAUNCHES["rank1_attn_bwd"]
    got = attn.rank1_mha_bwd_kernel(q, k, v, out, g)
    assert kernels.LAUNCHES["rank1_attn_bwd"] == before + 1
    want = attn.rank1_mha_bwd_plain(q, k, v, out, g)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        # compensated sums of up to 1024 terms against the plain version's
        # rounded weights and its reductions in another order
        torch.testing.assert_close(a, w, atol=1e-5, rtol=1e-5)


def test_rank1_attention_train_autograd_runs_both_kernels(dev):
    q, k, v = (_cloud(i, 2, 64, 12).to(dev).requires_grad_() for i in (8, 9, 10))
    before = (kernels.LAUNCHES["rank1_attn"], kernels.LAUNCHES["rank1_attn_bwd"])
    attn.rank1_mha_train(q, k, v).square().sum().backward()
    assert (kernels.LAUNCHES["rank1_attn"], kernels.LAUNCHES["rank1_attn_bwd"]) == (
        before[0] + 1, before[1] + 1)
    ref = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    attn.rank1_mha_plain(*ref).square().sum().backward()
    for a, w in zip((q, k, v), ref):
        torch.testing.assert_close(a.grad, w.grad, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n,s,radius,nsample,c", [
    (64, 13, 0.8, 16, 6),      # 13 centers: not a multiple of a block
    (100, 24, 0.05, 32, 67),   # most balls hold fewer than nsample points
    (1024, 256, 0.2, 32, 67),  # sa2's shapes
    (37, 5, 0.3, 8, 3),        # xyz only
])
def test_select_gather_kernel_equals_plain(dev, n, s, radius, nsample, c):
    xyz = _cloud(n, 2, n, 3).to(dev)
    new_xyz = xyz[:, :s].clone()
    new_xyz[1, 2] = 50.0  # a center with no point in its radius
    base = torch.cat([xyz, _cloud(n + 1, 2, n, c - 3).to(dev)], -1).contiguous()
    before = kernels.LAUNCHES["select_gather"]
    got, gi = sg_fused.select_gather_kernel(radius, nsample, xyz, new_xyz, base)
    assert kernels.LAUNCHES["select_gather"] == before + 1
    want, wi = sg_fused.select_gather_plain(radius, nsample, xyz, new_xyz, base)
    torch.cuda.synchronize()
    assert torch.equal(gi, wi) and torch.equal(got, want)  # a copy and one subtraction
    assert (gi[1, 2] == n - 1).all()


@pytest.mark.parametrize("n,m", [(1024, 1024), (100, 37), (5000, 3000), (1, 1)])
def test_chamfer_nn_kernel_equals_plain(dev, n, m):
    x = _cloud(n, 3, n, 3).to(dev)  # M > 2048: more than one shared-memory tile
    y = _cloud(m + 1, 3, m, 3).to(dev)
    before = kernels.LAUNCHES["chamfer_nn"]
    gm, ga = chamfer.directed_nn_kernel(x, y)
    assert kernels.LAUNCHES["chamfer_nn"] == before + 1
    wm, wa = chamfer.directed_nn_plain(x, y)
    torch.cuda.synchronize()
    assert torch.equal(ga, wa) and torch.equal(gm, wm)  # same float32 ops: same bits


def test_chamfer_nn_ties_go_to_the_lowest_index(dev):
    y = torch.tensor([[[1.0, 0, 0], [0, 1.0, 0], [-1.0, 0, 0]]], device=dev)
    _, arg = chamfer.directed_nn_kernel(torch.zeros(1, 4, 3, device=dev), y)
    assert arg.tolist() == [[0, 0, 0, 0]]


def test_kernel_wrappers_reject_what_the_kernels_do_not_take(dev):
    xyz = _cloud(0, 2, 16, 3).to(dev)
    with pytest.raises(ValueError):
        ballquery.query_ball_point_kernel(0.2, 4, xyz.double(), xyz.double())
    with pytest.raises(ValueError):
        ballquery.query_ball_point_kernel(0.2, 4, xyz, xyz.cpu())
    with pytest.raises(ValueError):
        ballquery.three_nn_kernel(xyz.transpose(0, 1), xyz, 3)
    with pytest.raises(ValueError):
        fps.farthest_point_sample_kernel(
            xyz, 4, torch.tensor([0, 16], dtype=torch.int32, device=dev))
    x, noise, cpcd, e2, coef, p = _chain_inputs(dev, B=1, T=3, N=8, D=16)
    with pytest.raises(ValueError):  # one step row short
        denoise.fused_denoise_chain(x, noise, cpcd, e2[:, :2].contiguous(), coef, p)
    with pytest.raises(ValueError):  # bf16: the port computes in float32
        attn.rank1_mha_kernel(xyz.bfloat16(), xyz.bfloat16(), xyz.bfloat16())
    folded = _layers(dev, (6, 8))
    with pytest.raises(ValueError):  # layer 1 takes 6 channels, base has 3
        sa_fused.sa_stage_fused_kernel(0.2, 4, xyz, xyz, xyz, folded)
    with pytest.raises(ValueError):
        fp_fused.fp_stage_fused_kernel(xyz, xyz, None, xyz, _layers(dev, (3, 4)),
                                       ("gelu",))
    with pytest.raises(ValueError):  # base lacks the xyz columns
        sg_fused.select_gather_kernel(0.2, 4, xyz, xyz, xyz[..., :2].contiguous())
    with pytest.raises(ValueError):  # out and g disagree in length
        attn.rank1_mha_bwd_kernel(xyz, xyz, xyz, xyz, xyz[:, :8].contiguous())
    with pytest.raises(ValueError):
        chamfer.directed_nn_kernel(xyz, xyz[:, :0].contiguous())

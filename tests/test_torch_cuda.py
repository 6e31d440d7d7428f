"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and skips without one.  The shapes are
small and deliberately awkward (rows that are not multiples of a warp or a
tile, k < 3, empty balls, distance ties, several chunks of the denoise
chain, the denoise step reading rows of its tables), the edge cases ``chip_smoke.py`` does not reach at the flagship
shapes.  On a
machine with a GPU and no JAX, run them without the JAX test conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from lsdm_tpu_torch import kernels
from lsdm_tpu_torch.ops import (
    attn, ballquery, chamfer, denoise, fp_fused, fps, rowmlp, sa_fused, sg_fused)
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
    (64, 64, 0.3, 32), (100, 13, 0.5, 16), (37, 5, 0.05, 8), (1024, 256, 0.2, 32),
    (37, 6, 0.8, 37),        # nsample == N, N not a multiple of 32
    (3000, 700, 0.15, 32),   # 3000 points (24 rounds); 700 queries, ragged blocks
    (256, 64, 2.5, 8)])      # every ball full in the first round
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


@pytest.mark.parametrize("clouds", [9, 54])
def test_ball_query_kernel_at_the_flagship_stages(dev, clouds):
    """sa1-sa4 (1024 -> 1024, 256, 64, 16 centres, radii 0.1-0.8, 32
    samples) at a b1 sample's 9 clouds and a train step's 54: every block
    serves its share of queries (up to 16) from one staged cloud, the plan
    picks the queries a warp; plus a centre whose ball is empty."""
    g = torch.Generator(device=dev).manual_seed(clouds)
    levels = [torch.randn(clouds, 1024, 3, generator=g, device=dev)]
    levels.append(levels[0])
    for npoint in (256, 64, 16):
        idx = fps.farthest_point_sample_plain(levels[-1], npoint)
        levels.append(torch.gather(levels[-1], 1, idx.long()[..., None].expand(-1, -1, 3))
                      .contiguous())
    for r, xyz, new_xyz in zip((0.1, 0.2, 0.4, 0.8), levels[:4], levels[1:5]):
        far = new_xyz.clone()
        far[-1, -1] = 50.0
        for centres in (new_xyz, far):
            got = ballquery.query_ball_point_kernel(r, 32, xyz, centres)
            want = ballquery.query_ball_point_plain(r, 32, xyz, centres)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (r, xyz.shape[1], centres.shape[1])
        assert (got[-1, -1] == xyz.shape[1] - 1).all()


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


@pytest.mark.parametrize("n", [64, 256, 1000, 1024, 3072])
def test_fps_kernel_breaks_ties_as_plain(dev, n):
    """Duplicate points tie in distance, across lanes and warps of the
    kernel's plan (1 warp of 2 points a lane at 64 points, 8 warps at 256,
    32 at 1000 and 1024, 32 of 4 points a lane at 3072); with and without
    a start tensor."""
    base = _cloud(n, 3, n // 4, 3)
    xyz = base.repeat(1, 4, 1)[:, torch.randperm(n, generator=torch.Generator().manual_seed(n))]
    xyz = xyz.contiguous().to(dev)
    npoint = min(n, 300)
    want = fps.farthest_point_sample_plain(xyz, npoint)
    before = kernels.LAUNCHES["fps"]
    got = fps.farthest_point_sample_kernel(xyz, npoint)
    assert kernels.LAUNCHES["fps"] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    start = torch.tensor([n - 1, 0, n // 3], dtype=torch.int32, device=dev)
    assert torch.equal(fps.farthest_point_sample_kernel(xyz, npoint, start),
                       fps.farthest_point_sample_plain(xyz, npoint, start))


def test_fps_default_start_captures_into_a_cuda_graph(dev):
    """No start tensor: the call reads nothing back from the card (a host
    sync cannot be captured), so it records into a CUDA graph after one
    warm-up call, and the replay gives the plain version's indices."""
    xyz = _cloud(11, 9, 1024, 3).to(dev)
    fps.farthest_point_sample_kernel(xyz, 256)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = fps.farthest_point_sample_kernel(xyz, 256)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, fps.farthest_point_sample_plain(xyz, 256))


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


@pytest.mark.parametrize("b,n,d,t,chunked", [
    (2, 37, 16, 7, True),      # several chunks of steps, a partial tile pair
    (1, 1024, 128, 5, False),  # the flagship widths
    (8, 1024, 128, 3, False),  # taller tiles, the last pair part-filled
    (4, 1000, 128, 3, False),  # the last pair's second tile empty
    (3, 5, 16, 4, False),      # fewer rows than one tile pair
    (2, 100, 128, 4, True),
])
@pytest.mark.parametrize("clip", [False, True])
def test_denoise_chain_kernel_matches_plain(dev, b, n, d, t, chunked, clip, monkeypatch):
    if chunked:  # a small scratch budget forces one chunk per step
        monkeypatch.setattr(denoise, "CHAIN_SCRATCH_FLOATS", 1 << 16)
    args = _chain_inputs(dev, B=b, T=t, N=n, D=d)
    before = kernels.LAUNCHES["denoise_chain"]
    got = denoise.fused_denoise_chain(*args, clip_denoised=clip)
    assert kernels.LAUNCHES["denoise_chain"] == before + 1
    want = denoise.denoise_chain_plain(*args, clip_denoised=clip)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert a.shape == (b, n, 3)
        # float32 sums in another order, through t recurrent steps
        torch.testing.assert_close(a, w, atol=2e-5, rtol=0)


def test_denoise_chain_refuses_weights_beyond_shared_memory(dev):
    # D = 256: each half of the tail is ~525 KB, past what a block may hold
    args = _chain_inputs(dev, B=1, T=2, N=8, D=256)
    before = kernels.LAUNCHES["denoise_chain"]
    with pytest.raises(RuntimeError, match="denoise_chain"):
        denoise.fused_denoise_chain(*args)
    assert kernels.LAUNCHES["denoise_chain"] == before


@pytest.mark.parametrize("b,t,n,d", [
    (1, 8, 1024, 128),  # the flagship widths: 128 x 128 tiles, g on 96 columns
    (2, 5, 37, 16),     # ragged rows, columns and k (g's K = 16 < one k tile)
    (1, 6, 1000, 128),  # ragged points: partial float4s and masked columns
    (1, 4, 1024, 96),   # g 144 wide: a half-masked 96-column tile; u2 on them
])
def test_denoise_chain_tables_kernel_matches_plain(dev, b, t, n, d):
    *_, e2, _, p = _chain_inputs(dev, B=b, T=t, N=n, D=d)
    got = denoise.denoise_chain_tables(e2, p)
    want = denoise.denoise_chain_tables_plain(e2, p)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert a.shape == w.shape
        # float32 sums in another order, no recurrence
        torch.testing.assert_close(a, w, atol=1e-6, rtol=0)


def _step_args(dev, B, N, D, seed=0, T=3):
    """K9's arguments for step 1 of a T-step table: noise, e2 and coefs are
    rows of (T, B, N, 3), (T, B, 2D) and (T, 3) tables, as the sampler
    passes them."""
    x, noise, cpcd, e2, coef, p = _chain_inputs(dev, B, T, N, D, seed)
    noise_tab = noise.transpose(0, 1).contiguous()
    e2_tab = e2.transpose(0, 1).contiguous()
    return x, noise_tab[1], cpcd, e2_tab[1], coef[1], p


@pytest.mark.parametrize("b,n,d,clip", [
    (1, 1024, 128, False),  # the flagship widths
    (3, 37, 16, True),      # odd N: a partial tile of rows
    (2, 100, 128, True),
    (1, 5, 16, False),      # fewer rows than one tile
])
def test_denoise_step_kernel_matches_plain(dev, b, n, d, clip):
    args = _step_args(dev, b, n, d)
    before = kernels.LAUNCHES["denoise_step"]
    got = denoise.fused_denoise_step(*args, clip_denoised=clip)
    assert kernels.LAUNCHES["denoise_step"] == before + 1  # two launches, one call
    want = denoise.denoise_step_plain(*args, clip_denoised=clip)
    torch.cuda.synchronize()
    assert got.shape == (b, n, 3)
    # float32 sums in another order, one step
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_denoise_step_kernel_reads_table_rows_in_place(dev):
    # the sampler's layout: rows of contiguous tables at an offset, the
    # coefficients on the device; every step of a short loop equals the
    # chain kernel's carried sample
    x, noise, cpcd, e2, coef, p = _chain_inputs(dev, 2, 4, 37, 16)
    noise_tab, e2_tab = noise.transpose(0, 1).contiguous(), e2.transpose(0, 1).contiguous()
    y = x
    for t in range(4):
        y = denoise.fused_denoise_step(y, noise_tab[t], cpcd, e2_tab[t], coef[t], p)
    final, _ = denoise.fused_denoise_chain(x, noise, cpcd, e2, coef, p)
    torch.cuda.synchronize()
    # two kernels, each float32 in its own order, through 4 steps
    torch.testing.assert_close(y, final, atol=2e-5, rtol=0)
    with pytest.raises(ValueError, match="contiguous"):  # a strided row
        denoise.fused_denoise_step(x, noise_tab[0], cpcd, e2[:, 0], coef[0], p)


def test_bound_denoise_step_checks_its_weights_once_and_its_data_each_call(dev):
    x, noise, cpcd, e2, coef, p = _step_args(dev, 2, 37, 16)
    with pytest.raises(ValueError):  # the weights on the host
        denoise.make_denoise_step(denoise.DenoiseStepParams(*(w.cpu() for w in p)),
                                  37, dev)
    with pytest.raises(ValueError):  # weights for another N
        denoise.make_denoise_step(p, 36, dev)
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):  # bound on the stream current now
        step = denoise.make_denoise_step(p, 37, dev, clip_denoised=True)
    before = kernels.LAUNCHES["denoise_step"]
    got = step(x, noise, cpcd, e2, coef)
    assert kernels.LAUNCHES["denoise_step"] == before + 1
    side.synchronize()
    # the same kernels on the same inputs
    assert torch.equal(got, denoise.fused_denoise_step(x, noise, cpcd, e2, coef, p,
                                                       clip_denoised=True))
    with pytest.raises(ValueError):  # noise of another cloud size
        step(x, noise[:, :36].contiguous(), cpcd, e2, coef)
    with pytest.raises(ValueError):  # the data on the host, the step bound on the card
        step(x.cpu(), noise, cpcd, e2, coef)


def _layers(dev, widths, seed=0):
    """Random folded (W (F_{l-1}, F_l), b (F_l,)) layers of ``widths``."""
    rs = np.random.RandomState(seed)
    return [(torch.from_numpy((rs.randn(a, b) / np.sqrt(a)).astype(np.float32)).to(dev),
             torch.from_numpy((rs.randn(b) * 0.1).astype(np.float32)).to(dev))
            for a, b in zip(widths[:-1], widths[1:])]


def _forced_cluster(monkeypatch, module, cluster):
    """Make the row-MLP plans of ``module`` (plan_sa, plan_fp) take a
    cluster of ``cluster`` blocks (0: the plan's own choice) with the rows
    the plan chose (``layout_sa``, ``layout_fp``)."""
    if cluster:
        plan = getattr(rowmlp, module)
        layout = getattr(rowmlp, module.replace("plan", "layout"))
        monkeypatch.setattr(rowmlp, module,
                            lambda *a: layout(*a, plan(*a).rows, cluster))


@pytest.mark.parametrize("b,n,s,radius,nsample,mlp,cluster", [
    (2, 64, 13, 0.8, 16, (8, 16), 0),      # 13 centers: not a multiple of a tile
    (2, 37, 5, 0.3, 8, (8,), 0),           # one layer; most balls hold < 8 points
    (2, 100, 24, 0.05, 32, (16, 16, 24), 0),  # nsample far above the in-radius count
    (2, 64, 16, 0.8, 32, (256, 256, 512), 0),  # sa4's widths
    # the flagship stages at b1 (9 clouds): sa1-sa4
    (9, 1024, 1024, 0.1, 32, (32, 32, 64), 0),
    (9, 1024, 256, 0.2, 32, (64, 64, 128), 0),
    (9, 256, 64, 0.4, 32, (128, 128, 256), 0),
    (9, 64, 16, 0.8, 32, (256, 256, 512), 0),
    # ragged: 37 centres in clusters of 2 and 4, an input width (67) off the
    # k tile, outputs (20, 3) off the column tile
    (3, 100, 37, 0.5, 16, (64, 67, 20), 2),
    (3, 100, 37, 0.5, 16, (64, 67, 20), 4),
    (2, 50, 7, 0.6, 8, (12, 10, 3), 4),
    (2, 64, 16, 0.8, 32, (256, 256, 512), 4),
])
def test_sa_fused_kernel_matches_plain(dev, b, n, s, radius, nsample, mlp, cluster,
                                       monkeypatch):
    _forced_cluster(monkeypatch, "plan_sa", cluster)
    xyz = _cloud(n, b, n, 3).to(dev)
    new_xyz = xyz[:, :s].clone()
    new_xyz[1, 2] = 50.0  # a center with no point in its radius
    base = torch.cat([xyz, _cloud(n + 1, b, n, 5).to(dev)], -1).contiguous()
    folded = _layers(dev, (8,) + mlp)
    before = kernels.LAUNCHES["sa_fused"]
    got = sa_fused.sa_stage_fused_kernel(radius, nsample, xyz, new_xyz, base, folded)
    assert kernels.LAUNCHES["sa_fused"] == before + 1
    want = sa_fused.sa_stage_fused_plain(radius, nsample, xyz, new_xyz, base, folded)
    torch.cuda.synchronize()
    assert got.shape == (b, s, mlp[-1])
    # float32 sums in another order
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    # the plain version, which the kernel matched, gathered point 0 in every
    # slot of the empty ball
    assert (ballquery.query_ball_point_plain(radius, nsample, xyz, new_xyz,
                                             empty=0)[1, 2] == 0).all()


HEAD = ("relu",) * 4 + ("none",)


@pytest.mark.parametrize("b,n,s,d1,d2,mlp,acts,cluster", [
    (2, 64, 2, 6, 10, (8, 16), None, 0),              # S = 2: k = 2
    (2, 50, 50, 0, 10, (16, 8, 3), ("relu", "relu", "none"), 0),  # sources = targets (fp1)
    (2, 40, 16, 256, 512, (256, 256), None, 0),       # fp4-like widths, 40 rows
    (2, 33, 7, 0, 10, (12,), ("none",), 0),
    # the flagship stages at b1 (9 clouds): fp4-fp1, fp1 with the head and conv2
    (9, 64, 16, 256, 512, (256, 256), None, 0),
    (9, 256, 64, 128, 256, (256, 256), None, 0),
    (9, 1024, 256, 64, 256, (256, 128), None, 0),
    (9, 1024, 1024, 0, 128, (128, 128, 128, 128, 3), HEAD, 0),
    # ragged: 45 targets in clusters, an input of 67 channels (off the k
    # tile), outputs off the column tile; 384 and 320 inputs in clusters
    (2, 45, 11, 30, 37, (36, 5), ("relu", "none"), 2),
    (2, 45, 11, 30, 37, (36, 5), None, 4),
    (2, 70, 64, 128, 256, (256, 256), None, 2),
    (2, 70, 64, 64, 256, (256, 128), None, 4),
])
def test_fp_fused_kernel_matches_plain(dev, b, n, s, d1, d2, mlp, acts, cluster,
                                       monkeypatch):
    _forced_cluster(monkeypatch, "plan_fp", cluster)
    xyz1 = _cloud(n, b, n, 3).to(dev)
    xyz2 = xyz1[:, :s].contiguous() if s == n else _cloud(s + 3, b, s, 3).to(dev)
    p1 = _cloud(n + 5, b, n, d1).to(dev) if d1 else None
    p2 = _cloud(s + 9, b, s, d2).to(dev)
    folded = _layers(dev, (d1 + d2,) + mlp)
    before = kernels.LAUNCHES["fp_fused"]
    got = fp_fused.fp_stage_fused_kernel(xyz1, xyz2, p1, p2, folded, acts)
    assert kernels.LAUNCHES["fp_fused"] == before + 1
    want = fp_fused.fp_stage_fused_plain(xyz1, xyz2, p1, p2, folded, acts)
    torch.cuda.synchronize()
    assert got.shape == (b, n, mlp[-1])
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_row_mlp_kernels_raise_on_a_plan_they_cannot_run(dev, monkeypatch):
    xyz = _cloud(0, 2, 64, 3).to(dev)
    base = torch.cat([xyz, xyz], -1).contiguous()
    folded = _layers(dev, (6, 16, 32))
    plan = rowmlp.plan_sa(2, 64, 16, 8, (16, 32))
    # one byte of shared memory short of what the layout needs
    bad = dataclasses.replace(plan, smem=plan.smem - 4)
    monkeypatch.setattr(rowmlp, "plan_sa", lambda *a: bad)
    with pytest.raises(RuntimeError):
        sa_fused.sa_stage_fused_kernel(0.5, 8, xyz, xyz[:, :16].contiguous(), base,
                                       folded)
    fplan = rowmlp.plan_fp(2, 64, 16, (6, 8))
    monkeypatch.setattr(rowmlp, "plan_fp",
                        lambda *a: dataclasses.replace(fplan, tiles=(12,)))
    with pytest.raises(RuntimeError):  # a tile that does not exist
        fp_fused.fp_stage_fused_kernel(xyz, xyz[:, :16].contiguous(), None,
                                       base[:, :16].contiguous(),
                                       _layers(dev, (6, 8)))


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


K4_SHAPES = [(2, 300, 77, 12), (1, 1024, 1024, 12), (3, 8, 5, 2),
             (2, 1, 1024, 12),     # one query row
             (2, 129, 2048, 12),   # two key chunks; one row past a 128-row tile
             (1, 200, 2500, 12)]   # three key chunks, the last one masked


@pytest.mark.parametrize("b,l,s,h", K4_SHAPES)
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


@pytest.mark.parametrize("b,l,s,h", K4_SHAPES)
def test_rank1_attention_kernel_denominator_matches_plain(dev, b, l, s, h):
    q = _cloud(1, b, l, h, scale=2.0).to(dev)
    k = _cloud(2, b, s, h, scale=2.0).to(dev)
    v = _cloud(3, b, s, h).to(dev)
    out, den = attn.rank1_mha_kernel(q, k, v, denominator=True)
    want, wden = attn.rank1_mha_plain(q, k, v, denominator=True)
    torch.cuda.synchronize()
    assert torch.equal(out, attn.rank1_mha_kernel(q, k, v))
    torch.testing.assert_close(den, wden, atol=0, rtol=1e-6)


def _bwd_case(b, l, s, h, offset=0.0, scale=2.0):
    q = _cloud(4, b, l, h, scale=scale).cuda()
    k = (_cloud(5, b, s, h, scale=scale) + offset).cuda()
    v = (_cloud(6, b, s, h) + offset).cuda()
    g = _cloud(7, b, l, h).cuda()
    out, den = attn.rank1_mha_kernel(q, k, v, denominator=True)
    return q, k, v, out, g, den


@pytest.mark.parametrize("b,l,s,h", [(2, 300, 77, 12), (1, 1024, 1024, 12), (3, 8, 5, 2),
                                     (2, 100, 2500, 3)])  # three key tiles
def test_rank1_attention_bwd_kernel_matches_plain(dev, b, l, s, h):
    q, k, v, out, g, den = _bwd_case(b, l, s, h)
    before = kernels.LAUNCHES["rank1_attn_bwd"]
    got = attn.rank1_mha_bwd_kernel(q, k, v, out, g, den)
    assert kernels.LAUNCHES["rank1_attn_bwd"] == before + 1
    want = attn.rank1_mha_bwd_plain(q, k, v, out, g)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        # SFU exponentials and uncompensated sums of up to 1024 terms in
        # groups, against the plain version's rounded weights and its
        # reductions in another order
        torch.testing.assert_close(a, w, atol=1e-5, rtol=1e-5)
    again = attn.rank1_mha_bwd_kernel(q, k, v, out, g, den)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics


@pytest.mark.parametrize("b,l,s,h", [(4, 1024, 1024, 12), (2, 300, 77, 12)])
def test_rank1_attention_bwd_kernel_on_offset_inputs(dev, b, l, s, h):
    """k and v offset by +8 on unit-scale inputs, as chip_smoke.py holds
    K5: the (g v - D) k form of each pair, as the plain version rounds it,
    where a factored form would cancel."""
    q, k, v, out, g, den = _bwd_case(b, l, s, h, offset=8.0, scale=1.0)
    got = attn.rank1_mha_bwd_kernel(q, k, v, out, g, den)
    want = attn.rank1_mha_bwd_plain(q, k, v, out, g)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=1e-5, rtol=0)


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


def test_topk_accuracy_breaks_ties_by_the_lowest_index_on_the_card(dev):
    from lsdm_tpu_torch.ops.metrics import topk_accuracy

    scores = torch.zeros(64, 13, device=dev)
    scores[:, 5] = 1.0  # one class ahead, the other twelve tied
    labels = torch.arange(64, device=dev) % 13
    top1, top3 = topk_accuracy(scores, labels, (1, 3))
    # top-3 is {5, 0, 1}: rows whose label is 0, 1 or 5
    assert float(top1) == pytest.approx(100.0 * 5 / 64)
    assert float(top3) == pytest.approx(100.0 * 15 / 64)
    ties = torch.full((64, 1000), 0.5, device=dev)  # all tied: top-3 is {0, 1, 2}
    assert float(topk_accuracy(ties, labels, (3,))[0]) == pytest.approx(
        100.0 * 15 / 64)


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
    sx, snoise, scpcd, se2, scoef, sp = _step_args(dev, 1, 8, 16)
    with pytest.raises(ValueError):  # e2 one column short
        denoise.fused_denoise_step(sx, snoise, scpcd, se2[:, 1:].contiguous(), scoef, sp)
    with pytest.raises(ValueError):  # the coefficients on the host
        denoise.fused_denoise_step(sx, snoise, scpcd, se2, scoef.cpu(), sp)
    with pytest.raises(ValueError):  # float64
        denoise.fused_denoise_step(sx.double(), snoise, scpcd, se2, scoef, sp)
    with pytest.raises(ValueError):  # cond_pcd of another scene count
        denoise.fused_denoise_step(sx, snoise, scpcd.expand(2, -1, -1).contiguous(),
                                   se2, scoef, sp)
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
    den = torch.ones(2, 3, 16, device=dev)  # (B, H, L) row denominators
    with pytest.raises(ValueError):  # out and g disagree in length
        attn.rank1_mha_bwd_kernel(xyz, xyz, xyz, xyz, xyz[:, :8].contiguous(), den)
    with pytest.raises(ValueError):  # row denominators laid out (B, L, H)
        attn.rank1_mha_bwd_kernel(xyz, xyz, xyz, xyz, xyz, xyz)
    with pytest.raises(ValueError):  # no FPS kernel past 3072 points
        fps.farthest_point_sample_kernel(_cloud(1, 1, 3073, 3).to(dev), 4)
    with pytest.raises(ValueError):
        chamfer.directed_nn_kernel(xyz, xyz[:, :0].contiguous())

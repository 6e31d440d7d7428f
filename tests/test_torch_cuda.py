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


def _fp_levels(dev, clouds, n=1024, seed=0):
    """Seeded clouds of n points and the FPS levels of the SA stages (n,
    n / 4, n / 16, n / 64 points), from the plain FPS."""
    g = torch.Generator(device=dev).manual_seed(seed)
    levels = [torch.randn(clouds, n, 3, generator=g, device=dev)]
    for npoint in (n // 4, n // 16, n // 64):
        idx = fps.farthest_point_sample_plain(levels[-1], npoint)
        levels.append(torch.gather(levels[-1], 1, idx.long()[..., None].expand(-1, -1, 3))
                      .contiguous())
    return levels


@pytest.mark.parametrize("clouds", [9, 54])
def test_three_nn_kernel_at_the_flagship_fp_stages(dev, clouds):
    """fp4-fp1 (targets 64, 256, 1024, 1024 against 16, 64, 256, 1024
    sources; at fp1 the sources are the targets, whose nearest distance is
    rounding noise around 0) at a b1 sample's 9 clouds and a train step's
    54: indices equal and distances the same bits as the plain version."""
    levels = _fp_levels(dev, clouds, seed=clouds)
    for xyz1, xyz2 in zip(levels[3::-1], levels[:0:-1]):
        before = kernels.LAUNCHES["three_nn"]
        gd, gi = ballquery.three_nn_kernel(xyz1, xyz2, 3)
        assert kernels.LAUNCHES["three_nn"] == before + 1
        wd, wi = ballquery.three_nn_plain(xyz1, xyz2, 3)
        torch.cuda.synchronize()
        assert torch.equal(gi, wi), (xyz1.shape[1], xyz2.shape[1])
        assert torch.equal(gd.view(torch.int32), wd.view(torch.int32))
    gd, gi = ballquery.three_nn_kernel(levels[0], levels[0], 3)  # fp1: sources = targets
    wd, wi = ballquery.three_nn_plain(levels[0], levels[0], 3)
    assert torch.equal(gi, wi) and torch.equal(gd.view(torch.int32), wd.view(torch.int32))


def _tied_sources(dev, s, seed):
    """s seeded sources with duplicates 1 and 33 apart (other lanes at every
    L) and across the tiles of 1024 (csrc/nearest.cuh: kTile), and targets
    beside them."""
    x = _cloud(seed, 2, s, 3)
    pairs = [(a, b) for a, b in ((0, 1), (2, 35), (7, 8), (1023, 1024), (5, s - 1),
                                 (100, 1124), (40, 1064)) if b < s]
    for a, b in pairs:
        x[:, b] = x[:, a]
    q = torch.cat([x[:, [a for a, _ in pairs]] + 1e-3, _cloud(seed + 1, 2, 57, 3)], 1)
    return q.contiguous().to(dev), x.contiguous().to(dev)


@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_nearest_kernels_break_ties_across_lanes_and_tiles(dev, lanes, group, monkeypatch):
    """Every plan of the scan (lanes a target; K11 also targets a lane, K2
    takes one) on sources that tie between lanes and between tiles: K2 and
    K11 equal to their plain versions, ties to the lowest index."""
    monkeypatch.setattr(ballquery, "three_nn_plan", lambda *a: lanes)
    monkeypatch.setattr(chamfer, "chamfer_nn_plan", lambda *a: (lanes, group))
    for s in (45, 1100, 2100):
        q, x = _tied_sources(dev, s, s)
        for k in (1, 2, 3):
            gd, gi = ballquery.three_nn_kernel(q, x, k)
            wd, wi = ballquery.three_nn_plain(q, x, k)
            torch.cuda.synchronize()
            assert torch.equal(gi, wi), (s, k)
            assert torch.equal(gd.view(torch.int32), wd.view(torch.int32)), (s, k)
        gm, ga = chamfer.directed_nn_kernel(q, x)
        wm, wa = chamfer.directed_nn_plain(q, x)
        torch.cuda.synchronize()
        assert torch.equal(ga, wa) and torch.equal(gm, wm), s
    # S < L: lanes with no source keep empty slots, which never win
    q, x = _tied_sources(dev, 45, 3)
    gd, gi = ballquery.three_nn_kernel(q, x[:, :2].contiguous(), 2)
    wd, wi = ballquery.three_nn_plain(q, x[:, :2].contiguous(), 2)
    assert torch.equal(gi, wi) and torch.equal(gd, wd)


@pytest.mark.parametrize("clouds", [64, 6])
def test_chamfer_nn_kernel_at_the_icp_and_train_shapes(dev, clouds):
    """K11 at (64, 1024) against (64, 1024), an ICP iteration's, and at
    (6, 1024) each way, the chamfer train step's: argmin equal, clamped
    minimum the same bits."""
    g = torch.Generator(device=dev).manual_seed(clouds)
    x = torch.rand(clouds, 1024, 3, generator=g, device=dev)
    y = (x + 0.01 * torch.randn(clouds, 1024, 3, generator=g, device=dev)).contiguous()
    for a, b in ((x, y), (y, x), (x, x)):
        before = kernels.LAUNCHES["chamfer_nn"]
        gm, ga = chamfer.directed_nn_kernel(a, b)
        assert kernels.LAUNCHES["chamfer_nn"] == before + 1
        wm, wa = chamfer.directed_nn_plain(a, b)
        torch.cuda.synchronize()
        assert torch.equal(ga, wa) and torch.equal(gm, wm)


def test_selection_kernels_take_4096_points(dev):
    """--pcd_points 4096: K1 (its cloud, 64 KB, past the default 48 KB of
    shared memory), K2 (sources streamed through tiles) and K3 (32 warps of
    4 points a lane) at the SA and FP stages' shapes, and K3 at 8192 points
    (8 points a lane), against their plain versions."""
    levels = _fp_levels(dev, 9, n=4096, seed=4096)
    for r, xyz, new_xyz in zip((0.1, 0.2), (levels[0], levels[0]), (levels[0], levels[1])):
        got = ballquery.query_ball_point_kernel(r, 32, xyz, new_xyz)
        assert torch.equal(got, ballquery.query_ball_point_plain(r, 32, xyz, new_xyz))
    for xyz1, xyz2 in ((levels[0], levels[0]), (levels[0], levels[1])):
        gd, gi = ballquery.three_nn_kernel(xyz1, xyz2, 3)
        wd, wi = ballquery.three_nn_plain(xyz1, xyz2, 3)
        assert torch.equal(gi, wi) and torch.equal(gd, wd)
    assert torch.equal(fps.farthest_point_sample_kernel(levels[0], 1024),
                       fps.farthest_point_sample_plain(levels[0], 1024))
    big = _cloud(8192, 2, fps.MAX_POINTS, 3).to(dev)
    assert fps.fps_plan(fps.MAX_POINTS) == (32, 8)
    assert torch.equal(fps.farthest_point_sample_kernel(big, 64),
                       fps.farthest_point_sample_plain(big, 64))
    with pytest.raises(ValueError):  # past the cap, named in the message
        ballquery.query_ball_point_kernel(
            0.1, 4, _cloud(1, 1, ballquery.BALL_MAX_POINTS + 1, 3).to(dev),
            levels[0][:1, :4].contiguous())


@pytest.mark.parametrize("n,npoint", [(64, 16), (1000, 250), (1024, 256), (3, 3)])
def test_fps_kernel_equals_plain(dev, n, npoint):
    xyz = _cloud(n + 7, 5, n, 3).to(dev)
    start = torch.tensor([0, 1, 2, n - 1, n // 2], dtype=torch.int32, device=dev)
    got = fps.farthest_point_sample_kernel(xyz, npoint, start)
    want = fps.farthest_point_sample_plain(xyz, npoint, start)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", [64, 256, 1000, 1024, 3072, 4096, 6000])
def test_fps_kernel_breaks_ties_as_plain(dev, n):
    """Duplicate points tie in distance, across lanes and warps of the
    kernel's plan (1 warp of 2 points a lane at 64 points, 8 warps at 256,
    32 at 1000 and 1024, 32 of 4 points a lane at 3072 and 4096, of 8 at
    6000); with and without a start tensor."""
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


@pytest.mark.parametrize("b", [1, 2, 8])
@pytest.mark.parametrize("n", [1000, 1024])
@pytest.mark.parametrize("clip", [False, True])
def test_denoise_step_kernel_at_the_flagship_width(dev, b, n, clip):
    # D = 128: clusters of 3 at b1, 2 at b2, 1 at b8 on an H100 (step_plan);
    # N = 1000 leaves the last tile of each scene 8 rows
    args = _step_args(dev, b, n, 128)
    got = denoise.fused_denoise_step(*args, clip_denoised=clip)
    want = denoise.denoise_step_plain(*args, clip_denoised=clip)
    torch.cuda.synchronize()
    # chip_smoke.STEP_ATOL: float32 sums in another order, one step
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


def test_step_occupancy_at_the_flagship_width(dev):
    # the plan's input, asked of the card: one ~217 KB tile block an SM,
    # and no cluster size holds more blocks than the card has SMs
    p = _step_args(dev, 1, 1024, 128)[-1]
    bound = denoise.BoundStep(p, 1024, dev, False)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert bound.occupancy[1] == sms
    assert all(0 <= n * c <= sms for c, n in bound.occupancy.items())
    assert bound.occupancy[bound.plan(1)] > 0


@pytest.mark.parametrize("b,n,d,t,clip", [
    (1, 1024, 128, 6, False),  # the flagship width
    (2, 37, 16, 5, True),      # a partial tile, T odd
])
def test_step_graph_replays_the_host_loop_bit_for_bit(dev, b, n, d, t, clip):
    x, noise, cpcd, e2, coef, p = _chain_inputs(dev, b, t, n, d)
    noise_tab = noise.transpose(0, 1).contiguous()
    e2_tab = e2.transpose(0, 1).contiguous()
    before = kernels.LAUNCHES["denoise_step"]
    graph = denoise.DenoiseStepGraph(p, b, n, t, dev, clip)
    # one call before the capture, none counted in it; the graph holds t of
    # each launch
    assert kernels.LAUNCHES["denoise_step"] == before + 1
    assert graph.calls == t and tuple(graph.kernel_nodes) == (2 * t, t, t)
    replayed = kernels.GRAPH_LAUNCHES["denoise_step"]
    final, last_in = graph.run(x, noise_tab, cpcd, e2_tab, coef)
    assert kernels.GRAPH_LAUNCHES["denoise_step"] == replayed + t
    host = denoise.make_denoise_step(p, n, dev, clip)
    want_final, want_last = denoise._step_loop(host, x, noise_tab, cpcd, e2_tab, coef)
    torch.cuda.synchronize()
    # the same kernels on the same inputs in the same order
    assert torch.equal(final, want_final) and torch.equal(last_in, want_last)
    again, _ = graph.run(x, noise_tab, cpcd, e2_tab, coef)  # statics refilled
    assert torch.equal(again, final)


def test_second_step_sample_replays_without_recapture(dev):
    from lsdm_tpu_torch.config import SDMConfig
    from lsdm_tpu_torch.diffusion.schedule import make_schedule
    from lsdm_tpu_torch.models.sampling import sample_sdm, step_loop
    from lsdm_tpu_torch.models.sdm import SceneDiffusionModel
    from lsdm_tpu_torch.weights import init_weights

    cfg = SDMConfig(clip_dim=32, latent_dim=16, cat_emb=8, n_head=4,
                    vert_dims=32, pcd_points=64)  # the human branch: 2 x 32 points
    model = init_weights(SceneDiffusionModel(cfg), 0).to(dev).eval()
    g = torch.Generator(device=dev).manual_seed(0)
    mask = torch.zeros(2, 9, device=dev)
    mask[:, 1:4] = 1.0
    cats = torch.nn.functional.one_hot(
        torch.randint(0, 13, (2, 9), generator=g, device=dev), 13).float()
    args = (mask, torch.randn(2, 9, 64, 3, generator=g, device=dev), cats,
            torch.randn(2, 32, generator=g, device=dev))
    T = 7
    x_init = torch.randn(2, 64, 3, generator=g, device=dev)
    noise = torch.randn(T, 2, 64, 3, generator=g, device=dev)
    sched = make_schedule("cosine", T, device=dev)
    first = sample_sdm(model, sched, *args, fused_step="step", x_init=x_init, noise=noise)
    graph = step_loop(model, 2, 64, T, dev, False)
    kernels.reset_launches()
    second = sample_sdm(model, sched, *args, fused_step="step", x_init=x_init, noise=noise)
    assert step_loop(model, 2, 64, T, dev, False) is graph
    assert kernels.LAUNCHES["denoise_step"] == 0  # no K9 call from the host
    assert kernels.GRAPH_LAUNCHES["denoise_step"] == T and graph.replays == 2
    assert torch.equal(first[0], second[0])
    chain = sample_sdm(model, sched, *args, fused_step="chain", x_init=x_init,
                       noise=noise)
    torch.testing.assert_close(second[0], chain[0], atol=1e-6, rtol=0)


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


@pytest.mark.parametrize("stage", ["sa1", "sa2", "fp2", "fp1"])
def test_row_mlp_kernels_take_4096_points(dev, stage):
    """--pcd_points 4096 at the flagship widths: K7 at sa1 (4096 centres of
    4096 points) and sa2 (1024 of 4096), K8 at fp2 (4096 targets, 1024
    sources) and fp1 with the head (4096 targets and sources), 2 clouds,
    against their plain versions; their clouds (64 KB) sit beside the
    layers in the plans' shared memory."""
    levels = _fp_levels(dev, 2, n=4096, seed=7)
    if stage.startswith("sa"):
        n_c, radius, mlp = ((4096, 0.1, (32, 32, 64)) if stage == "sa1"
                            else (1024, 0.2, (64, 64, 128)))
        xyz = levels[0]
        new_xyz = xyz if n_c == 4096 else levels[1]
        base = torch.cat([xyz, _cloud(5, 2, 4096, 5).to(dev)], -1).contiguous()
        folded = _layers(dev, (8,) + mlp)
        got = sa_fused.sa_stage_fused_kernel(radius, 32, xyz, new_xyz, base, folded)
        want = sa_fused.sa_stage_fused_plain(radius, 32, xyz, new_xyz, base, folded)
    else:
        xyz2 = levels[0] if stage == "fp1" else levels[1]
        d1, d2, mlp, acts = ((0, 128, (128, 128, 128, 128, 3), HEAD) if stage == "fp1"
                             else (64, 256, (256, 128), None))
        p1 = _cloud(11, 2, 4096, d1).to(dev) if d1 else None
        p2 = _cloud(12, 2, xyz2.shape[1], d2).to(dev)
        folded = _layers(dev, (d1 + d2,) + mlp)
        got = fp_fused.fp_stage_fused_kernel(levels[0], xyz2, p1, p2, folded, acts)
        want = fp_fused.fp_stage_fused_plain(levels[0], xyz2, p1, p2, folded, acts)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_encode_at_4096_points_on_the_fused_and_pallas_paths(dev):
    """The conditioning encode of sdm_proxd() at --pcd_points 4096, b1 (9
    clouds of 4096 points): the fused path (K3, K7, K8, K4) within the JAX
    package's fused-vs-composed bound of the pallas path (K1, K2, K3 and
    the composed stages), which equals the plain selection's encode.  The
    human branch yields 2 x vert_dims points (POSA's x2 upsampling, 1310
    at the reference's 655 vertices), so 4096 points take vert_dims 2048."""
    from lsdm_tpu_torch.config import sdm_proxd
    from lsdm_tpu_torch.models.sdm import SceneDiffusionModel
    from lsdm_tpu_torch.profile_sampling import seeded_inputs
    from lsdm_tpu_torch.weights import init_weights

    cfg = dataclasses.replace(sdm_proxd(), pcd_points=4096, vert_dims=2048)
    state = init_weights(SceneDiffusionModel(cfg), 0).state_dict()
    models = {}
    for impl in ("fused", "pallas", "topk"):
        m = SceneDiffusionModel(dataclasses.replace(cfg, ball_impl=impl))
        m.load_state_dict(state)
        models[impl] = m.to(dev).eval()
    inputs = seeded_inputs(cfg, 1, 1, 0, dev)[:4]
    cond, launches = {}, {}
    with torch.no_grad():
        for impl, m in models.items():
            kernels.reset_launches()
            cond[impl] = m.encode_conditioning(*inputs).cond_pcd
            torch.cuda.synchronize()
            launches[impl] = dict(kernels.LAUNCHES)
    assert all(launches["fused"][k] for k in ("fps", "sa_fused", "fp_fused"))
    assert all(launches["pallas"][k] for k in ("fps", "ball_query", "three_nn"))
    assert not launches["topk"]["ball_query"] + launches["topk"]["three_nn"]
    assert torch.isfinite(cond["fused"]).all()
    torch.testing.assert_close(cond["pallas"], cond["topk"], atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(cond["fused"], cond["pallas"], atol=2e-5, rtol=2e-4)


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


# K4 and K5 in bf16 against their plain versions: a weight's bf16 rounding
# can flip between the SFU's exponential and torch's (2^-8 of the weight)
ATTN_BF16_ATOL = 2.0 ** -7


def _bf16_case(dev, b, l, s, h, seeds=(1, 2, 3)):
    """q (b, l, h), k and v (b, s, h) in bf16 on ``dev``."""
    return [_cloud(i, b, n, h, scale=sc).to(dev).bfloat16()
            for i, n, sc in zip(seeds, (l, s, s), (2.0, 2.0, 1.0))]


@pytest.mark.parametrize("b,l,s,h", K4_SHAPES)
def test_rank1_attention_bf16_kernel_matches_plain(dev, b, l, s, h):
    """K4's bf16 mode (bf16 q, k, v; the weights rounded to bf16): a float32
    output within ATTN_BF16_ATOL x max(1, max |v|) of the plain version's,
    the same row denominators as the float32 mode computes from the same
    values, and the same output with and without them."""
    q, k, v = _bf16_case(dev, b, l, s, h)
    before = kernels.LAUNCHES["rank1_attn_bf16"]
    got, den = attn.rank1_mha_kernel(q, k, v, denominator=True)
    assert kernels.LAUNCHES["rank1_attn_bf16"] == before + 1
    want, wden = attn.rank1_mha_plain(q, k, v, denominator=True)
    torch.cuda.synchronize()
    assert got.dtype == den.dtype == torch.float32
    atol = ATTN_BF16_ATOL * max(1.0, v.abs().max().item())
    torch.testing.assert_close(got, want, atol=atol, rtol=0)
    torch.testing.assert_close(den, wden, atol=0, rtol=1e-6)
    assert torch.equal(got, attn.rank1_mha_kernel(q, k, v))
    assert torch.equal(den, attn.rank1_mha_kernel(q.float(), k.float(), v.float(),
                                                  denominator=True)[1])


@pytest.mark.parametrize("b,l,s,h", [(2, 300, 77, 12), (1, 1024, 1024, 12), (3, 8, 5, 2),
                                     (2, 100, 2500, 3),   # three key tiles
                                     (1, 600, 1100, 5)])  # three row chunks, two key tiles
def test_rank1_attention_bwd_bf16_kernel_matches_plain(dev, b, l, s, h):
    """K5's bf16 mode from K4's bf16 output: bf16 dq, dk, dv within
    ATTN_BF16_ATOL of each one's largest entry of the plain version's, and
    the same bits from a second run.  L and S that are not multiples of the
    kernel's 16-row and 16-key tiles, more than one 256-row chunk and one
    1024-key tile."""
    q, k, v = _bf16_case(dev, b, l, s, h, seeds=(4, 5, 6))
    g = _cloud(7, b, l, h).to(dev)
    out, den = attn.rank1_mha_kernel(q, k, v, denominator=True)
    before = kernels.LAUNCHES["rank1_attn_bwd_bf16"]
    got = attn.rank1_mha_bwd_kernel(q, k, v, out, g, den)
    assert kernels.LAUNCHES["rank1_attn_bwd_bf16"] == before + 1
    want = attn.rank1_mha_bwd_plain(q, k, v, out, g)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), w.float(), rtol=0,
                                   atol=ATTN_BF16_ATOL * max(1.0, w.abs().max().item()))
    again = attn.rank1_mha_bwd_kernel(q, k, v, out, g, den)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics


@pytest.mark.parametrize("b,l,s,h", [(4, 1024, 1024, 12), (2, 300, 77, 12),
                                     (1, 100, 2500, 3)])
def test_rank1_attention_bwd_bf16_kernel_on_offset_inputs(dev, b, l, s, h):
    """k and v offset by +8 on unit-scale bf16 inputs: the split form's dq
    (g sum w v k - D sum w k) and dk (v sum w g q - sum w D q) cancel two
    sums of ~8 |g|, held within ATTN_BF16_ATOL of each gradient's largest
    entry of the plain version's."""
    q = _cloud(4, b, l, h).to(dev).bfloat16()
    k, v = ((_cloud(i, b, s, h) + 8.0).to(dev).bfloat16() for i in (5, 6))
    g = _cloud(7, b, l, h).to(dev)
    out, den = attn.rank1_mha_kernel(q, k, v, denominator=True)
    got = attn.rank1_mha_bwd_kernel(q, k, v, out, g, den)
    want = attn.rank1_mha_bwd_plain(q, k, v, out, g)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a.float(), w.float(), rtol=0,
                                   atol=ATTN_BF16_ATOL * max(1.0, w.abs().max().item()))


def test_rank1_attention_bf16_autograd_runs_both_kernels(dev):
    q, k, v = (_cloud(i, 2, 64, 12).to(dev).bfloat16().requires_grad_() for i in (8, 9, 10))
    before = (kernels.LAUNCHES["rank1_attn_bf16"], kernels.LAUNCHES["rank1_attn_bwd_bf16"])
    out = attn.rank1_mha_train(q, k, v)
    assert out.dtype == torch.float32
    out.square().sum().backward()
    assert (kernels.LAUNCHES["rank1_attn_bf16"],
            kernels.LAUNCHES["rank1_attn_bwd_bf16"]) == (before[0] + 1, before[1] + 1)
    assert all(t.grad.dtype == torch.bfloat16 and torch.isfinite(t.grad).all()
               for t in (q, k, v))


@pytest.mark.parametrize("m,k", [(6, 3072), (54 * 1024, 32), (256, 16384)])
def test_bf16_linear_sums_in_float32(dev, m, k, monkeypatch):
    """A bf16 ``Linear`` on the card, with
    ``allow_bf16_reduced_precision_reduction`` off as the entry points set
    it: within one bf16 rounding of the float32-summed product (JAX's bf16
    dot accumulates in float32), measured on the scale of the terms, sum
    |x| |w|, since sums near zero take any order's float32 rounding at the
    ulp of the terms, at the SDM's attn_layer value projection (K = 3072),
    the grouped SA rows and a long K where cuBLAS may split the sum.  The
    error with the flag on is printed beside it."""
    from lsdm_tpu_torch.ops.attention import linear

    x = _cloud(1, m, k).to(dev).bfloat16()
    w = (_cloud(2, 128, k) * k ** -0.5).to(dev).bfloat16()
    want = x.float() @ w.float().t()
    scale = x.float().abs() @ w.float().abs().t()
    step = torch.finfo(torch.bfloat16).eps  # 2^-7, two roundings' worth
    err = {}
    for flag in (False, True):
        monkeypatch.setattr(torch.backends.cuda.matmul,
                            "allow_bf16_reduced_precision_reduction", flag)
        got = linear(x, w, None, torch.bfloat16).float()
        err[flag] = ((got - want).abs() / (step * scale)).max().item()
    print(f"bf16 product ({m}, {k}) x ({k}, 128): worst error over 2^-7 sum |x||w|, "
          f"reduced-precision reduction off {err[False]:.3g}, on {err[True]:.3g}")
    assert err[False] <= 1.0


SG_CASES = [
    (64, 13, 0.8, 16, 6),      # 13 centers: not a multiple of a block
    (100, 24, 0.05, 32, 67),   # most balls hold fewer than nsample points
    (1024, 256, 0.2, 32, 67),  # sa2's shapes
    (37, 5, 0.3, 8, 3),        # xyz only
    (300, 40, 0.3, 31, 67),    # nsample C odd: slabs at every offset mod 4
    (300, 21, 0.5, 1, 6),      # one sample: slabs of 6 floats
    (200, 9, 0.9, 64, 259),    # 64 samples of sa4's width
    (4096, 1024, 0.1, 32, 6),  # 4096 points
]


@pytest.mark.parametrize("n,s,radius,nsample,c", SG_CASES)
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


@pytest.mark.parametrize("n,s,radius,nsample,c", SG_CASES)
def test_select_gather_bf16_kernel_equals_plain(dev, n, s, radius, nsample, c):
    """K10's bf16 mode: a bf16 base gives bf16 slabs equal to the plain
    version's (the gather exact, g - bf16(center) rounded once) and the
    float32 mode's indices; slabs of C < 8 values a slot put the unaligned
    head and tail across slots."""
    xyz = _cloud(n, 2, n, 3).to(dev)
    new_xyz = xyz[:, :s].clone()
    new_xyz[1, 2] = 50.0
    base = torch.cat([xyz, _cloud(n + 1, 2, n, c - 3).to(dev)], -1).bfloat16().contiguous()
    before = kernels.LAUNCHES["select_gather_bf16"]
    got, gi = sg_fused.select_gather_kernel(radius, nsample, xyz, new_xyz, base)
    assert kernels.LAUNCHES["select_gather_bf16"] == before + 1
    want, wi = sg_fused.select_gather_plain(radius, nsample, xyz, new_xyz, base)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert torch.equal(gi, wi) and torch.equal(got, want)
    assert torch.equal(gi, sg_fused.select_gather_kernel(radius, nsample, xyz, new_xyz,
                                                         base.float())[1])


# every plan of K10's bf16 mode: (centers a warp, warps a slab)
SG_BF16_PLANS = [(1, 1), (2, 1), (4, 1), (1, 2), (1, 4), (1, 8)]


@pytest.mark.parametrize("plan", SG_BF16_PLANS)
def test_select_gather_bf16_every_plan_at_the_flagship_stages(dev, plan, monkeypatch):
    """K10's bf16 mode at sa1-sa4 of 9 clouds (centres by FPS, the stages'
    widths 6, 67, 131, 259) under each plan, forced by standing in for
    ``select_gather_bf16_plan``: indices and values equal the plain
    version's bit for bit, and the indices K1's."""
    monkeypatch.setattr(sg_fused, "select_gather_bf16_plan", lambda *_: plan)
    xyz = _cloud(9, 9, 1024, 3).to(dev)
    levels = [xyz, xyz]
    for npoint in (256, 64, 16):
        idx = fps.farthest_point_sample_plain(levels[-1], npoint)
        levels.append(torch.gather(levels[-1], 1, idx.long()[..., None].expand(-1, -1, 3))
                      .contiguous())
    for i, (r, c) in enumerate(zip((0.1, 0.2, 0.4, 0.8), (6, 67, 131, 259))):
        pts, centres = levels[i], levels[i + 1]
        base = torch.cat([pts, _cloud(i, 9, pts.shape[1], c - 3).to(dev)],
                         -1).bfloat16().contiguous()
        got, gi = sg_fused.select_gather_kernel(r, 32, pts, centres, base)
        want, wi = sg_fused.select_gather_plain(r, 32, pts, centres, base)
        torch.cuda.synchronize()
        assert torch.equal(gi, wi) and torch.equal(got, want), (plan, i)
        assert torch.equal(gi, ballquery.query_ball_point_kernel(r, 32, pts, centres))


@pytest.mark.parametrize("plan", SG_BF16_PLANS)
@pytest.mark.parametrize("nsample,c", [(31, 6), (7, 3), (5, 7), (33, 67),
                                      (13, 10), (3, 8)])  # two rows' first values a chunk
def test_select_gather_bf16_unaligned_slabs_every_plan(dev, plan, nsample, c, monkeypatch):
    """Slabs of nsample x C values that are not a multiple of 8: each starts
    at another offset mod 8 from a 16-byte boundary, so its head and tail
    (one value a lane) span slots where C < 8, and the body's chunks hold
    up to four pieces of rows; equal to the plain version at every plan."""
    monkeypatch.setattr(sg_fused, "select_gather_bf16_plan", lambda *_: plan)
    xyz = _cloud(nsample, 3, 200, 3).to(dev)
    new_xyz = xyz[:, :37].clone()
    new_xyz[1, 2] = 50.0
    base = torch.cat([xyz, _cloud(c, 3, 200, c - 3).to(dev)], -1).bfloat16().contiguous()
    got, gi = sg_fused.select_gather_kernel(0.4, nsample, xyz, new_xyz, base)
    want, wi = sg_fused.select_gather_plain(0.4, nsample, xyz, new_xyz, base)
    torch.cuda.synchronize()
    assert torch.equal(gi, wi) and torch.equal(got, want)
    # a base that starts 2 bytes past a 16-byte boundary: every source row
    # at another offset
    wide = torch.zeros(3 * 200 * c + 1, dtype=torch.bfloat16, device=dev)
    shifted = wide[1:].view(3, 200, c)
    shifted.copy_(base)
    got2, _ = sg_fused.select_gather_kernel(0.4, nsample, xyz, new_xyz, shifted)
    torch.cuda.synchronize()
    assert torch.equal(got2, want)


@pytest.mark.parametrize("clouds", [9, 54])
def test_select_gather_kernel_at_the_flagship_stages(dev, clouds):
    # sa1-sa4 of the train step: centres by FPS, the stages' widths
    xyz = _cloud(clouds, clouds, 1024, 3).to(dev)
    levels = [xyz, xyz]
    for npoint in (256, 64, 16):
        idx = fps.farthest_point_sample_plain(levels[-1], npoint)
        levels.append(torch.gather(levels[-1], 1, idx.long()[..., None].expand(-1, -1, 3))
                      .contiguous())
    for i, (r, c) in enumerate(zip((0.1, 0.2, 0.4, 0.8), (6, 67, 131, 259))):
        pts, centres = levels[i], levels[i + 1]
        ns = min(32, pts.shape[1])
        base = torch.cat([pts, _cloud(i, clouds, pts.shape[1], c - 3).to(dev)],
                         -1).contiguous()
        got, gi = sg_fused.select_gather_kernel(r, ns, pts, centres, base)
        want, wi = sg_fused.select_gather_plain(r, ns, pts, centres, base)
        torch.cuda.synchronize()
        assert torch.equal(gi, wi) and torch.equal(got, want), i
        # K1 selects the same indices from the same code
        assert torch.equal(gi, ballquery.query_ball_point_kernel(r, ns, pts, centres))


def test_select_gather_kernel_at_its_cap(dev):
    # 5 centres of one cloud: one centre a warp, so the cap is 14,464 points
    queries = sg_fused.select_gather_plan(1, 5, 32 * 6)
    cap = sg_fused.select_gather_max_points(32, queries)
    xyz = _cloud(7, 1, cap, 3).to(dev)
    new_xyz = xyz[:, :5].clone()
    new_xyz[0, 4] = 50.0
    base = torch.cat([xyz, _cloud(8, 1, cap, 3).to(dev)], -1).contiguous()
    got, gi = sg_fused.select_gather_kernel(0.05, 32, xyz, new_xyz, base)
    want, wi = sg_fused.select_gather_plain(0.05, 32, xyz, new_xyz, base)
    torch.cuda.synchronize()
    assert torch.equal(gi, wi) and torch.equal(got, want)
    assert (gi[0, 4] == cap - 1).all()
    big = _cloud(9, 1, cap + 1, 3).to(dev)
    with pytest.raises(ValueError, match="at most"):
        sg_fused.select_gather_kernel(0.05, 32, big, new_xyz, big)


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
    with pytest.raises(ValueError):  # float64: the kernels take float32 or bf16
        attn.rank1_mha_kernel(xyz.double(), xyz.double(), xyz.double())
    with pytest.raises(ValueError):  # q, k, v of two dtypes
        attn.rank1_mha_kernel(xyz, xyz.bfloat16(), xyz.bfloat16())
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
    with pytest.raises(ValueError):  # no FPS kernel past 32 warps of 8 points a lane
        fps.farthest_point_sample_kernel(_cloud(1, 1, fps.MAX_POINTS + 1, 3).to(dev), 4)
    with pytest.raises(ValueError):
        chamfer.directed_nn_kernel(xyz, xyz[:, :0].contiguous())


# --- the bf16 modes of K6-K9 ------------------------------------------------------

# The bf16 modes against their plain bf16 versions, with the criterion of
# tests/test_torch_bf16.py:_check_bf16: every entry within BF16_RTOL x
# max(1, |plain|), and the mean absolute difference within half of the plain
# version's own mean gap between its bf16 and float32 modes on the same
# inputs.  The kernels and the plain versions round the same values; they
# sum in another order, so a rounding near a bf16 boundary can flip.
BF16_RTOL = 3e-2


def _bf16_gate(got, want, want32, what):
    got, want, want32 = got.float(), want.float(), want32.float()
    assert got.shape == want.shape and torch.isfinite(got).all(), what
    err = (got - want).abs()
    assert err.max().item() <= BF16_RTOL * max(1.0, want.abs().max().item()), (
        what, err.max().item())
    gap = (want - want32).abs().mean().item()
    assert gap > 0 and err.mean().item() <= 0.5 * gap, (what, err.mean().item(), gap)


@pytest.mark.parametrize("b,n,s,radius,nsample,mlp,cluster", [
    (9, 1024, 1024, 0.1, 32, (32, 32, 64), 0),   # sa1-sa4 at b1
    (9, 1024, 256, 0.2, 32, (64, 64, 128), 0),
    (9, 256, 64, 0.4, 32, (128, 128, 256), 0),
    (9, 64, 16, 0.8, 32, (256, 256, 512), 0),
    (2, 37, 5, 0.3, 8, (8,), 0),                 # one layer: the max of layer 1
    (3, 100, 37, 0.5, 16, (64, 67, 20), 4),      # ragged (the cluster forces only
                                                 # the float32 plan)
    # the bf16 design's max: in registers for nsample 8 and 4, by atomics for
    # 5 and 64; 300 rows a centre take two passes of 256
    (2, 50, 7, 0.6, 8, (12, 10, 3), 0),
    (2, 64, 16, 0.8, 4, (16, 32), 0),
    (2, 30, 3, 0.9, 5, (12, 10), 0),
    (2, 100, 24, 0.5, 64, (16, 16, 24), 0),
    (2, 600, 3, 2.0, 300, (8, 16, 24), 0),
])
def test_sa_fused_bf16_kernel_matches_plain(dev, b, n, s, radius, nsample, mlp, cluster,
                                            monkeypatch):
    _forced_cluster(monkeypatch, "plan_sa", cluster)
    xyz = _cloud(n, b, n, 3).to(dev)
    new_xyz = xyz[:, :s].clone()
    new_xyz[1, 2] = 50.0  # a center with no point in its radius
    base = torch.cat([xyz, _cloud(n + 1, b, n, 5).to(dev)], -1).contiguous()
    folded = _layers(dev, (8,) + mlp)
    args = (radius, nsample, xyz, new_xyz, base, folded)
    before = {k: kernels.LAUNCHES[k] for k in ("sa_fused", "sa_fused_bf16")}
    got = sa_fused.sa_stage_fused_kernel(*args, torch.bfloat16)
    assert (kernels.LAUNCHES["sa_fused_bf16"], kernels.LAUNCHES["sa_fused"]) == (
        before["sa_fused_bf16"] + 1, before["sa_fused"])
    want = sa_fused.sa_stage_fused_plain(*args, torch.bfloat16)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (b, s, mlp[-1])
    _bf16_gate(got, want, sa_fused.sa_stage_fused_plain(*args), "K7 bf16")


@pytest.mark.parametrize("b,n,s,d1,d2,mlp,acts,cluster", [
    (9, 64, 16, 256, 512, (256, 256), None, 0),  # fp4-fp1 at b1, fp1 with the head
    (9, 256, 64, 128, 256, (256, 256), None, 0),
    (9, 1024, 256, 64, 256, (256, 128), None, 0),
    (9, 1024, 1024, 0, 128, (128, 128, 128, 128, 3), HEAD, 0),
    (2, 64, 2, 6, 10, (8, 16), None, 0),         # S = 2: k = 2
    (2, 45, 11, 30, 37, (36, 5), ("relu", "none"), 2),  # ragged, odd widths
    (2, 100, 40, 0, 20, (24, 16, 3), ("relu", "relu", "none"), 0),  # 4 row tiles
])
def test_fp_fused_bf16_kernel_matches_plain(dev, b, n, s, d1, d2, mlp, acts, cluster,
                                            monkeypatch):
    _forced_cluster(monkeypatch, "plan_fp", cluster)
    xyz1 = _cloud(n, b, n, 3).to(dev)
    xyz2 = xyz1[:, :s].contiguous() if s == n else _cloud(s + 3, b, s, 3).to(dev)
    # the features as the stages hand them on: bf16
    p1 = _cloud(n + 5, b, n, d1).to(dev).bfloat16() if d1 else None
    p2 = _cloud(s + 9, b, s, d2).to(dev).bfloat16()
    folded = _layers(dev, (d1 + d2,) + mlp)
    args = (xyz1, xyz2, p1, p2, folded, acts)
    before = {k: kernels.LAUNCHES[k] for k in ("fp_fused", "fp_fused_bf16")}
    got = fp_fused.fp_stage_fused_kernel(*args, torch.bfloat16)
    assert (kernels.LAUNCHES["fp_fused_bf16"], kernels.LAUNCHES["fp_fused"]) == (
        before["fp_fused_bf16"] + 1, before["fp_fused"])
    want = fp_fused.fp_stage_fused_plain(*args, torch.bfloat16)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (b, n, mlp[-1])
    _bf16_gate(got, want, fp_fused.fp_stage_fused_plain(*args), "K8 bf16")
    with pytest.raises(ValueError):  # the float32 mode takes float32 features
        fp_fused.fp_stage_fused_kernel(*args)


# the flagship stages' widths: K7 (points, centres, widths F1..FL), K8
# (targets, sources, D1, layer widths, activations; fp1 with the head)
SA_FLAGSHIP = {"sa1": (1024, 1024, (32, 32, 64)), "sa2": (1024, 256, (64, 64, 128)),
               "sa3": (256, 64, (128, 128, 256)), "sa4": (64, 16, (256, 256, 512))}
FP_FLAGSHIP = {"fp4": (64, 16, 256, (768, 256, 256), None),
               "fp3": (256, 64, 128, (384, 256, 256), None),
               "fp2": (1024, 256, 64, (320, 256, 128), None),
               "fp1": (1024, 1024, 0, (128, 128, 128, 128, 128, 3), HEAD)}


def _sa_bf16_case(dev, b, n, s, widths, radius=0.2, seed=0):
    xyz = _cloud(seed + n, b, n, 3).to(dev)
    new_xyz = xyz[:, :s].contiguous()
    base = torch.cat([xyz, _cloud(seed + n + 1, b, n, 5).to(dev)], -1).contiguous()
    return (radius, 32, xyz, new_xyz, base, _layers(dev, (8,) + widths, seed))


def _fp_bf16_case(dev, b, n, s, d1, widths, acts, seed=0):
    xyz1 = _cloud(seed + n, b, n, 3).to(dev)
    xyz2 = _cloud(seed + s + 3, b, s, 3).to(dev)
    p1 = _cloud(seed + n + 5, b, n, d1).to(dev).bfloat16() if d1 else None
    p2 = _cloud(seed + s + 9, b, s, widths[0] - d1).to(dev).bfloat16()
    return xyz1, xyz2, p1, p2, _layers(dev, widths, seed), acts


def _check_bf16_stage(kind, args, what):
    mod = sa_fused if kind == "sa" else fp_fused
    wrapper = mod.sa_stage_fused_kernel if kind == "sa" else mod.fp_stage_fused_kernel
    plain = mod.sa_stage_fused_plain if kind == "sa" else mod.fp_stage_fused_plain
    name = "sa_fused" if kind == "sa" else "fp_fused"
    before = {k: kernels.LAUNCHES[k] for k in (name, name + "_bf16")}
    got = wrapper(*args, torch.bfloat16)
    assert (kernels.LAUNCHES[name + "_bf16"], kernels.LAUNCHES[name]) == (
        before[name + "_bf16"] + 1, before[name])
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    _bf16_gate(got, plain(*args, torch.bfloat16), plain(*args), what)


@pytest.mark.parametrize("stage,rows,kc", [
    *((st, r, None) for st in ("sa2", "sa3") for r in rowmlp.sa_rows_bf16(32)),
    *((st, r, None) for st in ("fp2", "fp1") for r in rowmlp.BF16_FP_ROWS),
    ("sa4", 1, 128), ("sa4", 4, 128), ("fp4", 32, 128), ("fp2", 64, 128)])
def test_row_mlp_bf16_kernels_under_every_plan(dev, stage, rows, kc, monkeypatch):
    """K7 / K8 bf16 at flagship widths (3 clouds) under each row count of
    their plans (m16 tiles a pass 2, 4, 8, 16: every warp layout) and with
    weight chunks of 128 k, by the BF16 gate against the plain bf16
    version."""
    if stage in SA_FLAGSHIP:
        n, s, widths = SA_FLAGSHIP[stage]
        args = _sa_bf16_case(dev, 3, n, s, widths, radius=0.2 if s > 64 else 0.8)
        monkeypatch.setattr(rowmlp, "plan_sa_bf16",
                            lambda *a: rowmlp.layout_sa_bf16(*a, rows, kc))
    else:
        n, s, d1, widths, acts = FP_FLAGSHIP[stage]
        args = _fp_bf16_case(dev, 3, n, s, d1, widths, acts)
        monkeypatch.setattr(rowmlp, "plan_fp_bf16",
                            lambda *a: rowmlp.layout_fp_bf16(*a, rows, kc))
    _check_bf16_stage(stage[:2], args, f"{stage} bf16, {rows} rows a block, k {kc}")


@pytest.mark.parametrize("stage", sorted(SA_FLAGSHIP) + sorted(FP_FLAGSHIP))
def test_row_mlp_bf16_kernels_at_their_caps(dev, stage):
    """K7 bf16 with as many points, K8 bf16 with as many sources, as the
    bf16 design stages beside its smallest plan at the flagship widths
    (``rowmlp.sa_max_points_bf16`` / ``fp_max_sources_bf16``), by the BF16
    gate; one more raises, naming the cap."""
    if stage in SA_FLAGSHIP:
        _, s, widths = SA_FLAGSHIP[stage]
        cap = rowmlp.sa_max_points_bf16(32, widths)
        case = lambda n: _sa_bf16_case(dev, 1, n, min(s, 64), widths, radius=0.1)
    else:
        n, _, d1, widths, acts = FP_FLAGSHIP[stage]
        cap = rowmlp.fp_max_sources_bf16(widths)
        case = lambda s: _fp_bf16_case(dev, 1, 64, s, d1, widths, acts)
    _check_bf16_stage(stage[:2], case(cap), f"{stage} bf16 at its cap {cap}")
    over = case(cap + 1)
    wrapper = (sa_fused.sa_stage_fused_kernel if stage in SA_FLAGSHIP
               else fp_fused.fp_stage_fused_kernel)
    with pytest.raises(ValueError, match=f"at most {cap} "):
        wrapper(*over, torch.bfloat16)


def test_bf16_model_hands_its_kept_operands_to_the_kernels(dev, monkeypatch):
    """A bf16 fused SA stage on the card makes its bf16 weight copies once
    across forwards (``rowmlp.kept_bf16_operands``) and the wrapper uses
    them: no copy is made at a call."""
    from lsdm_tpu_torch.models.pointnet2 import PointNetSetAbstraction

    stage = PointNetSetAbstraction(64, 0.4, 32, 3 + 5, (32, 48), impl="fused",
                                   dtype=torch.bfloat16).to(dev).eval()
    made = []
    real = rowmlp.bf16_operands
    monkeypatch.setattr(rowmlp, "bf16_operands",
                        lambda *a: made.append(1) or real(*a))
    xyz, feats = _cloud(1, 2, 256, 3).to(dev), _cloud(2, 2, 256, 5).to(dev)
    before = kernels.LAUNCHES["sa_fused_bf16"]
    with torch.no_grad():
        first = stage(xyz, feats)[1]
        again = stage(xyz, feats)[1]
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["sa_fused_bf16"] == before + 2 and made == [1]
    assert torch.equal(first, again)


@pytest.mark.parametrize("b,n,d,t,chunked,clip,plan", [
    # the flagship widths (D = 128, the largest the bf16 mode takes) at the
    # planner's choice, b1 (8 warps a tile) and b8 (4 tiles of 4 warps a
    # block); at T = 1000 with the clip chip_smoke.py's gates leave out (b1
    # on, b8 off: 4 and 25 chunks)
    (1, 1024, 128, 5, False, False, None),
    (8, 1024, 128, 3, False, True, None),
    (1, 1024, 128, 1000, False, True, None),
    (8, 1024, 128, 1000, False, False, None),
    (4, 1000, 128, 3, False, False, None),    # (4, 2), a last tile of 8 rows
    (2, 37, 16, 7, True, True, None),         # (8, 1), several chunks, masked rows
    # forced plans (warps a tile, tiles a block)
    (1, 1024, 128, 4, False, True, (4, 1)),   # 4 warps a tile alone in a block
    (8, 1024, 128, 2, False, False, (8, 2)),  # 16 warps a block, 8 a tile
    (8, 1024, 128, 2, False, True, (4, 3)),   # the last block holds 2 tiles
    (1, 1000, 128, 3, False, False, (8, 2)),  # 63 tiles: the last block holds 1
    (2, 1000, 16, 5, True, False, (4, 3)),    # chunks of ragged points
    (3, 37, 16, 4, False, True, (4, 2)),      # 5-row tiles
])
def test_denoise_chain_bf16_kernel_matches_plain(dev, b, n, d, t, chunked, clip, plan,
                                                 monkeypatch):
    if chunked:
        monkeypatch.setattr(denoise, "CHAIN_SCRATCH_FLOATS", 1 << 16)
    if plan:
        monkeypatch.setattr(denoise, "chain_bf16_plan", lambda *_: plan)
    args = _chain_inputs(dev, B=b, T=t, N=n, D=d)
    before = {k: kernels.LAUNCHES[k] for k in ("denoise_chain", "denoise_chain_bf16")}
    got = denoise.fused_denoise_chain(*args, clip_denoised=clip,
                                      compute_dtype=torch.bfloat16)
    assert (kernels.LAUNCHES["denoise_chain_bf16"], kernels.LAUNCHES["denoise_chain"]) == (
        before["denoise_chain_bf16"] + 1, before["denoise_chain"])
    want = denoise.denoise_chain_plain(*args, clip_denoised=clip,
                                       compute_dtype=torch.bfloat16)
    want32 = denoise.denoise_chain_plain(*args, clip_denoised=clip)
    torch.cuda.synchronize()
    for a, w, w32, name in zip(got, want, want32, ("final", "last_in")):
        assert a.dtype == torch.float32
        _bf16_gate(a, w, w32, f"K6 bf16 {name}")
    # the weights rounded once beforehand give the same launch
    p = denoise.bf16_step_params(args[-1])
    again = denoise.fused_denoise_chain(*args[:-1], p, clip_denoised=clip,
                                        compute_dtype=torch.bfloat16)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("plan", [(1, 1), (2, 4), (4, 5), (8, 3), (4, 0)])
def test_denoise_chain_bf16_refuses_plans_it_has_no_instance_for(dev, plan,
                                                                 monkeypatch):
    """Pass 2 takes 4 or 8 warps a tile and up to 16 warps a block: another
    plan raises and counts no launch."""
    monkeypatch.setattr(denoise, "chain_bf16_plan", lambda *_: plan)
    args = _chain_inputs(dev, B=1, T=2, N=40, D=16)
    before = kernels.LAUNCHES["denoise_chain_bf16"]
    with pytest.raises(RuntimeError, match="denoise_chain_bf16"):
        denoise.fused_denoise_chain(*args, compute_dtype=torch.bfloat16)
    assert kernels.LAUNCHES["denoise_chain_bf16"] == before


def test_denoise_chain_bf16_reciprocal_is_the_ieee_division(dev):
    """K6 bf16's pass 2 divides its sigmoids by a branch-free reciprocal
    (``csrc/denoise_chain_bf16.cu:recip``) where 1 + exp(-y) lies in [1,
    2^126): there it gives the bits of ``1.0f / y`` at every float32."""
    count = torch.zeros(1, dtype=torch.int64, device=dev)
    rc = kernels.load().lsdm_denoise_recip_check(0x3F800000, 0x7E800000, count.data_ptr(),
                                                 kernels.stream(dev))
    kernels.check(rc, "denoise_chain_bf16")
    torch.cuda.synchronize()
    assert count.item() == 0


def test_denoise_chain_bf16_refuses_what_pass_1_refused(dev):
    """D = 136, the float32 mode's largest model width: the bf16 mode
    refuses it (pass 1 did before pass 2 was redesigned; now its tail
    copies name the widths it takes) and launches nothing, while the float32
    mode runs it."""
    args = _chain_inputs(dev, B=1, T=2, N=40, D=136)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="D <= 128"):
        denoise.fused_denoise_chain(*args, compute_dtype=torch.bfloat16)
    assert kernels.LAUNCHES == before
    got = denoise.fused_denoise_chain(*args)
    want = denoise.denoise_chain_plain(*args)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=2e-5, rtol=0)


@pytest.mark.parametrize("b,t,n,d", [
    (1, 8, 1024, 128),  # the flagship widths
    (2, 5, 37, 16),     # ragged to the MMA tile: rows, columns and k (g's K = 16)
    (3, 4, 1000, 16),   # ragged points: a part-filled 16-byte chunk, 12 z
    (1, 6, 1000, 128),  # ragged points at the flagship width
])
def test_denoise_chain_tables_bf16_kernel_matches_plain(dev, b, t, n, d):
    *_, e2, _, p = _chain_inputs(dev, B=b, T=t, N=n, D=d)
    got = denoise.denoise_chain_tables(e2, p, torch.bfloat16)
    want = denoise.denoise_chain_tables_plain(e2, p, torch.bfloat16)
    want32 = denoise.denoise_chain_tables_plain(e2, p)
    torch.cuda.synchronize()
    assert torch.equal(got[0], got[0].bfloat16().float())  # emb rounded
    for a, w, w32, name in zip(got, want, want32, ("emb", "g")):
        _bf16_gate(a, w, w32, f"K6 bf16 tables {name}")


@pytest.mark.parametrize("b,t,n,d", [(1, 3, 1024, 128), (2, 3, 37, 16)])
def test_denoise_chain_tables_bf16_are_stored_as_bf16(dev, b, t, n, d):
    """Pass 1's bf16 scratch holds u0, u2 and u4^T as bf16 tables in the
    layout of csrc/denoise_tables.cuh: read back as bf16 they are the plain
    bf16 computation's, rounded (through the BF16 gate), and the scratch is
    the bf16 layout's size (emb^T kept, as pass 1 alone keeps it), below
    the float32 one's."""
    *_, e2, _, p = _chain_inputs(dev, B=b, T=t, N=n, D=d)
    bf = torch.bfloat16
    scratch, dims = denoise._tables_scratch(e2, p, bf)
    torch.cuda.synchronize()
    U0, U2, D2, z = p.w_up0.shape[0], p.w_up2.shape[0], 2 * d, b * t
    assert scratch.numel() == z * denoise._per_step(dims, True, emb=True)
    assert denoise._per_step(dims, True, emb=True) < denoise._per_step(dims)
    ldn = denoise._ldn(n, True)
    h = scratch.view(bf)
    u0 = h[:z * U0 * D2].view(b, t, U0, D2)
    u2 = h[z * U0 * D2:z * (U0 + U2) * D2].view(b, t, U2, D2)
    o = z * (U0 + U2) * D2
    u4t = h[o:o + z * D2 * ldn].view(b, t, D2, ldn)[..., :n]

    def plain(bf16):
        mm = (lambda a, c: a.to(bf).float() @ c.to(bf).float()) if bf16 else torch.matmul
        u0 = torch.nn.functional.gelu(p.w_up0 * e2[..., None, :] + p.b_up0)
        u2 = torch.nn.functional.gelu(mm(p.w_up2, u0) + p.b_up2)
        u4 = torch.nn.functional.gelu(mm(p.w_up4, u2) + p.b_up4)
        return u0, u2, u4.transpose(-1, -2)

    for a, w, w32, name in zip((u0, u2, u4t), plain(True), plain(False),
                               ("u0", "u2", "u4^T")):
        _bf16_gate(a, w.to(bf), w32, f"K6 bf16 table {name}")  # stored rounded


@pytest.mark.parametrize("b,n,d,clip", [
    (1, 1024, 128, False), (8, 1024, 128, True), (3, 37, 16, True), (1, 5, 16, False),
    (1, 1000, 128, False), (1, 1000, 128, True),   # N not a multiple of the row tile
    (8, 1000, 128, True),                          # 64-row tiles, the last of 40 rows
    (1, 4096, 128, True), (8, 4096, 128, False),   # 4096 points: 2 and 4 waves
    (2, 1024, 64, False), (2, 1024, 64, True),     # D = 64, b2
    (3, 1024, 128, False),                         # 32-row tiles
])
def test_denoise_step_bf16_kernel_matches_plain(dev, b, n, d, clip):
    args = _step_args(dev, b, n, d)
    before = {k: kernels.LAUNCHES[k] for k in ("denoise_step", "denoise_step_bf16")}
    got = denoise.fused_denoise_step(*args, clip_denoised=clip,
                                     compute_dtype=torch.bfloat16)
    assert (kernels.LAUNCHES["denoise_step_bf16"], kernels.LAUNCHES["denoise_step"]) == (
        before["denoise_step_bf16"] + 1, before["denoise_step"])
    want = denoise.denoise_step_plain(*args, clip_denoised=clip,
                                      compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    _bf16_gate(got, want, denoise.denoise_step_plain(*args, clip_denoised=clip),
               "K9 bf16")


@pytest.mark.parametrize("mt", [1, 2, 4])
@pytest.mark.parametrize("b,n,d", [(2, 1000, 128), (3, 37, 16)])
def test_denoise_step_bf16_kernel_at_every_plan(dev, mt, b, n, d, monkeypatch):
    """Each instance of the tile kernel (16, 32 or 64 rows a block), forced
    past the planner, on ragged last tiles."""
    monkeypatch.setattr(denoise, "step_bf16_plan", lambda B, N, _: mt)
    args = _step_args(dev, b, n, d)
    got = denoise.fused_denoise_step(*args, clip_denoised=True, compute_dtype=torch.bfloat16)
    want = denoise.denoise_step_plain(*args, clip_denoised=True, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    _bf16_gate(got, want, denoise.denoise_step_plain(*args, clip_denoised=True),
               f"K9 bf16 mt={mt}")


def test_denoise_step_bf16_refuses_a_model_past_its_caps(dev):
    """D = 144 (2D = 288, DH = 72, D15 = 216) exceeds the widths
    csrc/denoise_step_bf16.cu is compiled for: binding the weights raises,
    naming them, and launches nothing; the float32 mode runs it."""
    args = _step_args(dev, 1, 40, 144)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="K9 bf16 takes D <= 128"):
        denoise.make_denoise_step(args[-1], 40, dev, compute_dtype=torch.bfloat16)
    assert kernels.LAUNCHES == before
    got = denoise.fused_denoise_step(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, denoise.denoise_step_plain(*args), atol=1e-5, rtol=0)


def test_float32_step_keeps_its_bits_beside_a_bound_bf16_step(dev):
    """The float32 K9 gives the same bits before and after a bf16 step is
    bound and run in the same process (the two modes share no state)."""
    args = _step_args(dev, 2, 1000, 128)
    f32 = denoise.make_denoise_step(args[-1], 1000, dev, clip_denoised=True)
    before = f32(*args[:5])
    bf = denoise.make_denoise_step(args[-1], 1000, dev, True, torch.bfloat16)
    bf(*args[:5])
    graph = denoise.DenoiseStepGraph(args[-1], 2, 1000, 2, dev, True, torch.bfloat16)
    del graph
    after = f32(*args[:5])
    again = denoise.make_denoise_step(args[-1], 1000, dev, clip_denoised=True)(*args[:5])
    torch.cuda.synchronize()
    assert torch.equal(before, after) and torch.equal(before, again)


def test_bf16_step_graph_replays_the_host_loop_bit_for_bit(dev):
    b, n, d, t = 1, 1024, 128, 6
    x, noise, cpcd, e2, coef, p = _chain_inputs(dev, b, t, n, d)
    noise_tab = noise.transpose(0, 1).contiguous()
    e2_tab = e2.transpose(0, 1).contiguous()
    before = kernels.LAUNCHES["denoise_step_bf16"]
    graph = denoise.DenoiseStepGraph(p, b, n, t, dev, compute_dtype=torch.bfloat16)
    assert kernels.LAUNCHES["denoise_step_bf16"] == before + 1
    assert graph.calls == t and tuple(graph.kernel_nodes) == (2 * t, t, t)
    replayed = kernels.GRAPH_LAUNCHES["denoise_step_bf16"]
    final, last_in = graph.run(x, noise_tab, cpcd, e2_tab, coef)
    assert kernels.GRAPH_LAUNCHES["denoise_step_bf16"] == replayed + t
    host = denoise.make_denoise_step(p, n, dev, compute_dtype=torch.bfloat16)
    want_final, want_last = denoise._step_loop(host, x, noise_tab, cpcd, e2_tab, coef)
    torch.cuda.synchronize()
    assert torch.equal(final, want_final) and torch.equal(last_in, want_last)


@pytest.mark.parametrize("fused_step", ["chain", "step"])
def test_bf16_model_launches_the_bf16_modes_only(dev, fused_step):
    """A bf16 model on CUDA tensors with the fused encode: K7, K8, K4 and
    K6 (or K9) in their bf16 modes, and no float32 mode of any of them.  At
    512 points (stages of 512, 128, 32, 8) every stage passes its gate."""
    from lsdm_tpu_torch.config import SDMConfig
    from lsdm_tpu_torch.diffusion.schedule import make_schedule
    from lsdm_tpu_torch.models.sampling import sample_sdm
    from lsdm_tpu_torch.models.sdm import SceneDiffusionModel
    from lsdm_tpu_torch.weights import init_weights

    cfg = SDMConfig(clip_dim=32, latent_dim=16, cat_emb=8, n_head=4, vert_dims=256,
                    pcd_points=512, ball_impl="fused", dtype="bfloat16",
                    bn_dtype="bfloat16")
    model = init_weights(SceneDiffusionModel(cfg), 0).to(dev).eval()
    g = torch.Generator(device=dev).manual_seed(0)
    mask = torch.zeros(2, 9, device=dev)
    mask[:, 1:4] = 1.0
    cats = torch.nn.functional.one_hot(
        torch.randint(0, 13, (2, 9), generator=g, device=dev), 13).float()
    args = (mask, torch.randn(2, 9, 512, 3, generator=g, device=dev), cats,
            torch.randn(2, 32, generator=g, device=dev))
    kernels.reset_launches()
    sample, last = sample_sdm(model, make_schedule("cosine", 4, device=dev), *args,
                              generator=g, fused_step=fused_step)
    torch.cuda.synchronize()
    launched = {k: v + kernels.GRAPH_LAUNCHES[k] for k, v in kernels.LAUNCHES.items()}
    loop = "denoise_chain_bf16" if fused_step == "chain" else "denoise_step_bf16"
    assert all(launched[k] for k in ("sa_fused_bf16", "fp_fused_bf16",
                                     "rank1_attn_bf16", "fps", loop)), launched
    assert not any(launched[k] for k in (
        "sa_fused", "fp_fused", "rank1_attn", "denoise_chain", "denoise_step",
        "ball_query", "three_nn")), launched
    assert sample.dtype == torch.float32 and torch.isfinite(sample).all()
    assert torch.isfinite(last.x0).all()


def test_failed_bf16_build_raises_without_a_plain_fallback(dev, tmp_path, monkeypatch):
    """A kernel library whose bf16 source does not compile: the bf16 wrapper
    raises the build's error and never returns the plain version."""
    import shutil

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in kernels.CSRC.glob("*.cuh"):
        shutil.copy(f, csrc)
    broken = (kernels.CSRC / "sa_fused_bf16.cu").read_text().replace(
        "int lsdm_sa_fused_bf16(", "int lsdm_sa_fused_bf16(undeclared_type t, ")
    assert broken != (kernels.CSRC / "sa_fused_bf16.cu").read_text()
    (csrc / "sa_fused_bf16.cu").write_text(broken)
    monkeypatch.setattr(kernels, "CSRC", csrc)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "_lib", None)
    xyz = _cloud(0, 2, 64, 3).to(dev)
    base = torch.cat([xyz, xyz], -1).contiguous()
    before = dict(kernels.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        sa_fused.sa_stage_fused_kernel(0.5, 8, xyz, xyz[:, :16].contiguous(), base,
                                       _layers(dev, (6, 16, 32)), torch.bfloat16)
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("fused_step", ["chain", "step"])
def test_alternate_backbones_launch_no_pointnet2_kernel(dev, fused_step):
    """A DGCNN + P2R model on CUDA tensors with the fused configuration:
    K4 in ``pcd_attention`` and K6 (or K9) in the loop, and none of the
    PointNet++ kernels (K1, K2, K3, K7, K8)."""
    from lsdm_tpu_torch.config import SDMConfig
    from lsdm_tpu_torch.diffusion.schedule import make_schedule
    from lsdm_tpu_torch.models.sampling import sample_sdm
    from lsdm_tpu_torch.models.sdm import SceneDiffusionModel
    from lsdm_tpu_torch.weights import init_weights

    cfg = SDMConfig(clip_dim=32, latent_dim=16, cat_emb=8, n_head=4, vert_dims=64,
                    pcd_points=128, ball_impl="fused", pcd_backbone_type="DGCNN",
                    human_backbone_type="P2R")
    model = init_weights(SceneDiffusionModel(cfg), 0).to(dev).eval()
    g = torch.Generator(device=dev).manual_seed(0)
    mask = torch.zeros(2, 9, device=dev)
    mask[:, 1:4] = 1.0
    cats = torch.nn.functional.one_hot(
        torch.randint(0, 13, (2, 9), generator=g, device=dev), 13).float()
    args = (mask, torch.randn(2, 9, 128, 3, generator=g, device=dev), cats,
            torch.randn(2, 32, generator=g, device=dev))
    kernels.reset_launches()
    sample, _ = sample_sdm(model, make_schedule("cosine", 4, device=dev), *args,
                           generator=g, fused_step=fused_step)
    torch.cuda.synchronize()
    launched = {k: v + kernels.GRAPH_LAUNCHES[k] for k, v in kernels.LAUNCHES.items()}
    loop = "denoise_chain" if fused_step == "chain" else "denoise_step"
    assert launched["rank1_attn"] and launched[loop], launched
    assert not any(launched[k] for k in ("ball_query", "three_nn", "fps", "sa_fused",
                                         "fp_fused")), launched
    assert torch.isfinite(sample).all()


def test_knn_on_cuda_equals_the_cpu(dev):
    """``knn`` on the card: the CPU's indices, ties to the lowest index
    (an all-equal cloud, duplicated points, 64-channel features)."""
    from lsdm_tpu_torch.ops.pointcloud import knn

    x = _cloud(3, 4, 1024, 3)
    x[1] = 0.0
    x[2, 512:] = x[2, :512]
    f = torch.randn(2, 1024, 64, generator=torch.Generator().manual_seed(4))
    for t in (x, f):
        assert torch.equal(knn(t.to(dev), 10).cpu(), knn(t, 10))


def test_grid_search_and_refine_on_cuda_match_the_cpu(dev):
    """The pose grid (4356 poses, chunked) and 50 Adam steps on the card
    against the same calls on the CPU, on a 64^3 SDF."""
    import numpy as np

    from lsdm_tpu_torch.fitting import place_obj

    rs = np.random.RandomState(0)
    sdf = rs.rand(64, 64, 64).astype(np.float32) - 0.5
    cen, ext = np.array([0.1, 0.2, 0.5], np.float32), np.array([2, 2, 1.5], np.float32)
    obj = ((rs.rand(512, 3) - 0.5) * [0.6, 0.4, 0.8]).astype(np.float32)
    con = ((rs.rand(300, 3) - 0.5) * 0.5 + [0.3, 0.1, 0.4]).astype(np.float32)
    args = (obj, np.zeros(2, np.float32), con, sdf, cen, ext)
    got = place_obj.grid_search(*args, device=dev, chunk=500)
    want = place_obj.grid_search(*args)
    assert got.points.device.type == "cuda"
    assert abs(float(got.loss) - float(want.loss)) <= 1e-5 * abs(float(want.loss))
    start = (obj, np.array([float(want.transl_x), float(want.transl_y)], np.float32),
             float(want.rot_deg), con, sdf, cen, ext)
    got = place_obj.refine_pose(*start, opt_steps=50, device=dev)
    want = place_obj.refine_pose(*start, opt_steps=50)
    assert abs(float(got.loss) - float(want.loss)) <= 1e-4 * abs(float(want.loss))
    for name in ("rot", "transl_x", "transl_y"):
        assert abs(float(getattr(got, name)) - float(getattr(want, name))) <= 1e-4


def test_refine_pose_steps_never_wait_for_the_host(dev):
    """The refinement's Adam steps and its best-so-far pose stay on the
    card: no call in ``refine_pose`` synchronises with the host
    (``torch.cuda.set_sync_debug_mode("error")``), its inputs on the card."""
    import numpy as np

    from lsdm_tpu_torch.fitting import place_obj

    rs = np.random.RandomState(1)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    args = (t((rs.rand(256, 3) - 0.5) * 0.6), t([0.1, -0.2]), 30.0,
            t((rs.rand(100, 3) - 0.5) * 0.5), t(rs.rand(32, 32, 32) - 0.5),
            t([0.0, 0.0, 0.5]), t([2.0, 2.0, 1.5]))
    place_obj.refine_pose(*args, opt_steps=3)  # warm-up: lazy inits
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = place_obj.refine_pose(*args, opt_steps=20)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert out.loss.device.type == "cuda" and torch.isfinite(out.loss)


@pytest.mark.parametrize("mode", [1, 4])
def test_contactformer_forward_on_cuda_matches_the_cpu(dev, mode, monkeypatch):
    """ContactFormer's forward (64 frames at the trainer's widths; mode 1's
    transformers, mode 4's cuDNN LSTM) on the card against the CPU, within
    chip_smoke's CF_RTOL x max(1, |CPU|), TF32 off; no port kernel launches
    (the JAX model reaches no Pallas kernel)."""
    import chip_smoke
    from lsdm_tpu_torch.profile_contact import contact_inputs

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    model, inputs, eps = contact_inputs(mode, 64)
    with torch.no_grad():
        want = model.eval()(*inputs, eps=eps)
        before = dict(kernels.LAUNCHES)
        got = model.to(dev)(*(t.to(dev) for t in inputs), eps=eps.to(dev))
        torch.cuda.synchronize()
    assert kernels.LAUNCHES == before
    for g_, w, what in zip(got, want, ("logits", "mu", "logvar")):
        err = ((g_.cpu() - w).abs() / w.abs().clamp(min=1.0)).max()
        assert float(err) <= chip_smoke.CF_RTOL, (what, float(err))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_contactformer_train_step_on_cuda_matches_the_cpu(dev, monkeypatch, dtype):
    """One Adam step of mode 1 (32 frames) on the card against the CPU from
    the same weights and noise, by chip_smoke's gates for ``dtype``."""
    import chip_smoke

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    errs = chip_smoke.contactformer_step_check(dev, 32, dtype)
    for key, gate in zip(("loss", "grad", "param"), chip_smoke._step_gates(dtype)):
        assert errs[key] <= gate, errs


def test_contactformer_lstm_keeps_float32_with_cudnn_tf32_on(dev, monkeypatch):
    """Decoder mode 4 as a user runs it, cuDNN's TF32 setting at its
    default (on): the forward (64 frames) on the card against the CPU
    within chip_smoke's CF_RTOL, and one Adam step (32 frames) in float32
    on the card against the CPU's float64 step, each gradient leaf within
    TRAIN_GRAD_RTOL by its relative 2-norm (reading 1.3e-6; 2.4e-4 when the
    backward runs cuDNN in TF32, ``profile_contact.py --grad_check``); the
    setting is restored after."""
    import chip_smoke
    from lsdm_tpu_torch.profile_contact import contact_inputs

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    model, inputs, eps = contact_inputs(4, 64)
    with torch.no_grad():
        want = model.eval()(*inputs, eps=eps)
        got = model.to(dev)(*(t.to(dev) for t in inputs), eps=eps.to(dev))
        torch.cuda.synchronize()
    for g_, w, what in zip(got, want, ("logits", "mu", "logvar")):
        err = ((g_.cpu() - w).abs() / w.abs().clamp(min=1.0)).max()
        assert float(err) <= chip_smoke.CF_RTOL, (what, float(err))
    errs = chip_smoke.contactformer_step_check(dev, 32, "float32", mode=4,
                                               cpu_dtype="float64")
    print(f"mode 4 train step, cuDNN TF32 on, against float64: {errs}")
    gates = (chip_smoke.TRAIN_LOSS_RTOL, chip_smoke.TRAIN_GRAD_RTOL,
             chip_smoke.TRAIN_PARAM_ATOL)
    for key, gate in zip(("loss", "grad", "param"), gates):
        assert errs[key] <= gate, errs
    assert torch.backends.cudnn.allow_tf32


def test_contactformer_grad_gate_sees_tf32_products(dev, monkeypatch):
    """The float32 step's gradient gate (CF_GRAD_RTOL) rejects a mode-1
    train step whose products run in TF32 on the card."""
    import chip_smoke

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    errs = chip_smoke.contactformer_step_check(dev, 32, "float32")
    print(f"mode 1 train step, TF32 products: {errs}")
    assert errs["grad"] > chip_smoke.CF_GRAD_RTOL, errs

@pytest.mark.parametrize("kind", ["atiss", "quirk", "pe", "mime"])
def test_atiss_forward_on_cuda_matches_the_cpu(dev, kind):
    """Each ATISS kind at the reference widths (2 scenes of 9 slots) on the
    card against the CPU within chip_smoke's ATISS_RTOL, launching no port
    kernel."""
    import chip_smoke
    from lsdm_tpu_torch.profile_atiss import atiss_inputs

    model, boxes, _ = atiss_inputs(kind, 2)
    with torch.no_grad():
        want = model(boxes)
        before = dict(kernels.LAUNCHES)
        got = model.to(dev)({k: v.to(dev) for k, v in boxes.items()})
        torch.cuda.synchronize()
    assert kernels.LAUNCHES == before
    for name, g_, w in zip(want._fields, got, want):
        err = ((g_.cpu() - w).abs() / w.abs().clamp(min=1.0)).max()
        assert float(err) <= chip_smoke.ATISS_RTOL, (name, float(err))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kind", ["atiss", "quirk", "pe", "mime"])
def test_atiss_train_step_on_cuda_matches_the_cpu(dev, monkeypatch, kind, dtype):
    """One ``train_baseline`` step (AdamW) of each kind on the card against
    the CPU from the same weights and batch, by chip_smoke's gates for
    ``dtype``."""
    import chip_smoke

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    errs = chip_smoke.atiss_step_check(dev, dtype, kind)
    print(f"ATISS {kind} train step in {dtype}: {errs}")
    for key, gate in zip(("loss", "grad", "param"), chip_smoke._step_gates(dtype)):
        assert errs[key] <= gate, errs


def test_atiss_resnet_keeps_float32_with_cudnn_tf32_on(dev, monkeypatch):
    """ATISS over ResNet18 as a user runs it, cuDNN's TF32 setting at its
    default (on): the forward on the card against the CPU within
    ATISS_RTOL, and one AdamW step in float32 on the card against the CPU's
    float64 step within the train gates (TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL by
    each leaf's relative 2-norm, TRAIN_PARAM_ATOL); the setting is restored
    after."""
    import chip_smoke
    from lsdm_tpu_torch.profile_atiss import atiss_inputs

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    model, boxes, _ = atiss_inputs("atiss", 2)
    with torch.no_grad():
        want = model(boxes)
        got = model.to(dev)({k: v.to(dev) for k, v in boxes.items()})
        torch.cuda.synchronize()
    for name, g_, w in zip(want._fields, got, want):
        err = ((g_.cpu() - w).abs() / w.abs().clamp(min=1.0)).max()
        assert float(err) <= chip_smoke.ATISS_RTOL, (name, float(err))
    errs = chip_smoke.atiss_step_check(dev, "float32", cpu_dtype="float64")
    print(f"ATISS train step, cuDNN TF32 on, against float64: {errs}")
    gates = (chip_smoke.TRAIN_LOSS_RTOL, chip_smoke.TRAIN_GRAD_RTOL,
             chip_smoke.TRAIN_PARAM_ATOL)
    for key, gate in zip(("loss", "grad", "param"), gates):
        assert errs[key] <= gate, errs
    assert torch.backends.cudnn.allow_tf32


def test_atiss_rtol_sees_tf32_convolutions(dev, monkeypatch):
    """The ATISS_RTOL gate rejects the forward when the extractor's
    convolutions run in TF32 (``cudnn_full_fp32`` taken out, cuDNN's
    setting on)."""
    import contextlib

    import chip_smoke
    from lsdm_tpu_torch.models import atiss, feature_extractors
    from lsdm_tpu_torch.profile_atiss import atiss_inputs

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    for mod in (atiss, feature_extractors):
        monkeypatch.setattr(mod, "cudnn_full_fp32", contextlib.nullcontext)
    model, boxes, _ = atiss_inputs("atiss", 2)
    with torch.no_grad():
        want = model.feature_extractor(boxes["room_layout"])
        got = model.to(dev).feature_extractor(boxes["room_layout"].to(dev))
    err = float(((got.cpu() - want).abs() / want.abs().clamp(min=1.0)).max())
    print(f"ResNet18 features with TF32 convolutions: {err:.3g}")
    assert err > chip_smoke.ATISS_RTOL


def test_atiss_grad_gate_sees_tf32_convolutions(dev, monkeypatch):
    """The float32 step's gradient gate (CF_GRAD_RTOL, each leaf's relative
    2-norm) rejects an ATISS train step whose ResNet18 convolutions run in
    TF32 forward and backward (``cudnn_full_fp32`` taken out of the
    extractors and the trainer, cuDNN's setting on).  H100 readings: 3.97e-2
    with TF32, 1.63e-6 without."""
    import contextlib

    import chip_smoke
    from lsdm_tpu_torch.models import atiss, cudnn, feature_extractors

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    for mod in (cudnn, atiss, feature_extractors):
        monkeypatch.setattr(mod, "cudnn_full_fp32", contextlib.nullcontext)
    errs = chip_smoke.atiss_step_check(dev, "float32")
    print(f"ATISS train step, TF32 convolutions: {errs}")
    assert errs["grad"] > chip_smoke.CF_GRAD_RTOL, errs


def test_device_memory_stats_and_trace_on_the_card(dev, tmp_path):
    """``utils/profiling.py`` on the card: the allocator's statistics of
    every visible card, and a Chrome trace holding the card's kernels."""
    import json

    from lsdm_tpu_torch.utils.profiling import device_memory_stats, trace

    x = torch.randn(512, 512, device=dev)
    with trace(str(tmp_path)) as prof:
        y = x @ x
        torch.cuda.synchronize(dev)
    stats = device_memory_stats()
    assert sorted(stats) == [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    assert stats[f"cuda:{dev.index}"]["allocated_bytes.all.current"] >= y.numel() * 4
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "kernel" for e in events), "no kernel in the trace"
    assert sum(e.device_time_total for e in prof.key_averages()) > 0


def test_threed_front_step_holds_the_gradient_gate_with_tf32_on(dev, monkeypatch):
    """``train_atiss_3dfront``'s float32 step (ResNet18 ATISS, DMLL heads)
    on the card with cuDNN's TF32 setting on, against the CPU: within the
    gradient gate of ``test_atiss_grad_gate_sees_tf32_convolutions``
    (CF_GRAD_RTOL), since the step runs its forward and backward under
    ``cudnn_full_fp32``; with that taken out of the extractors and the
    trainer, the same gate rejects it."""
    import contextlib

    import chip_smoke
    from lsdm_tpu_torch.models import atiss, cudnn, feature_extractors

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    errs = chip_smoke.threed_front_step_check(dev, "float32")
    print(f"3D-FRONT train step, cuDNN TF32 setting on: {errs}")
    assert errs["grad"] <= chip_smoke.CF_GRAD_RTOL, errs
    assert errs["loss"] <= chip_smoke.TRAIN_LOSS_RTOL, errs
    for mod in (cudnn, atiss, feature_extractors):
        monkeypatch.setattr(mod, "cudnn_full_fp32", contextlib.nullcontext)
    errs = chip_smoke.threed_front_step_check(dev, "float32")
    print(f"3D-FRONT train step, TF32 convolutions: {errs}")
    assert errs["grad"] > chip_smoke.CF_GRAD_RTOL, errs

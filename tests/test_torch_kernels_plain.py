"""Plain versions of the port's kernels against the Pallas kernels they
replace (run in interpret mode on the CPU, as tests/test_pallas_kernels.py
runs them), and the kernel wrappers' CPU dispatch.

Selection outputs (ball query, 3-NN, FPS indices) must be equal.  The
port's plain versions are the CPU stand-ins and the on-card references
of the CUDA kernels (``lsdm_tpu_torch/csrc``), so this pins the kernels'
contract to the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsdm_tpu.ops.ballquery_pallas import query_ball_point_pallas, three_nn_pallas
from lsdm_tpu.ops.denoise_pallas import DenoiseStepParams as JaxStepParams
from lsdm_tpu.ops.denoise_pallas import fused_denoise_chain as jax_denoise_chain
from lsdm_tpu.ops.fps_batched_pallas import farthest_point_sample_batched
from lsdm_tpu.ops.fps_pallas import farthest_point_sample_pallas
from lsdm_tpu_torch import kernels
from lsdm_tpu_torch.ops import (
    attn, ballquery, chamfer, denoise, fp_fused, fps, sa_fused, sg_fused)
from lsdm_tpu_torch.ops.denoise import DenoiseStepParams


def _cloud(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("n,s,radius,nsample", [
    (64, 64, 1.0, 32),   # balls fill up: the first nsample in index order
    (64, 16, 0.5, 16),   # partly filled: empty slots repeat the first index
    (32, 8, 0.05, 8),    # mostly empty balls
])
def test_ball_query_plain_matches_pallas(n, s, radius, nsample):
    xyz = _cloud(n, 2, n, 3)
    new_xyz = _cloud(s + 100, 2, s, 3)
    new_xyz[0, 0] = 50.0  # a ball with no point in it: all n - 1
    want = np.asarray(query_ball_point_pallas(
        radius, nsample, jnp.asarray(xyz), jnp.asarray(new_xyz), interpret=True))
    got = ballquery.query_ball_point_plain(
        radius, nsample, torch.from_numpy(xyz), torch.from_numpy(new_xyz))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[0, 0] == n - 1).all()


@pytest.mark.parametrize("n,s", [(64, 16), (32, 32), (16, 2)])
def test_three_nn_plain_matches_pallas(n, s):
    xyz1 = _cloud(n, 2, n, 3)
    # s == n: the sources are the targets, as at fp1
    xyz2 = xyz1.copy() if s == n else _cloud(s + 7, 2, s, 3)
    k = min(3, s)
    wd, wi = three_nn_pallas(jnp.asarray(xyz1), jnp.asarray(xyz2), k,
                             interpret=True)
    gd, gi = ballquery.three_nn_plain(torch.from_numpy(xyz1),
                                      torch.from_numpy(xyz2), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    # the JAX distance comes from an XLA dot product, the port's from
    # separately rounded products: they may differ by a few float32 ulps
    # of |x|^2 (~1e-6 here)
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=0, atol=1e-5)


def _grid_cloud():
    # 4 x 4 x 4 integer grid, shuffled: FPS meets many equal distances
    g = np.stack(np.meshgrid(*[np.arange(4.0)] * 3, indexing="ij"), -1)
    g = g.reshape(-1, 3).astype(np.float32)
    rs = np.random.RandomState(0)
    return np.stack([g[rs.permutation(64)] for _ in range(4)])


def test_three_nn_plain_ties_go_to_the_lowest_index_as_in_pallas():
    # every target is equidistant from several grid sources
    xyz2 = _grid_cloud()[:1]
    xyz1 = (xyz2[:, :16] + 0.5).astype(np.float32)
    wd, wi = three_nn_pallas(jnp.asarray(xyz1), jnp.asarray(xyz2), 3,
                             interpret=True)
    gd, gi = ballquery.three_nn_plain(torch.from_numpy(xyz1),
                                      torch.from_numpy(xyz2), 3)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))


@pytest.mark.parametrize("jax_fps", [farthest_point_sample_pallas,
                                     farthest_point_sample_batched])
@pytest.mark.parametrize("cloud", ["random", "grid"])
def test_fps_plain_matches_both_pallas_kernels(jax_fps, cloud):
    xyz = _cloud(3, 4, 64, 3) if cloud == "random" else _grid_cloud()
    start = np.array([0, 5, 17, 63], np.int32)
    want = np.asarray(jax_fps(jnp.asarray(xyz), 16, jnp.asarray(start),
                              interpret=True))
    got = fps.farthest_point_sample_plain(torch.from_numpy(xyz), 16,
                                          torch.from_numpy(start))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _chain_inputs(B=1, T=4, N=32, D=16, seed=0):
    """Random (numpy) inputs of fused_denoise_chain at a tiny width."""
    rs = np.random.RandomState(seed)

    def a(*shape, scale=1.0):
        return (rs.randn(*shape) * scale).astype(np.float32)

    dh, d15 = D // 2, int(D * 1.5)
    params = [
        a(128, 1), a(128, 1, scale=0.1), a(512, 128, scale=128 ** -0.5),
        a(512, 1, scale=0.1), a(N, 512, scale=512 ** -0.5), a(N, 1, scale=0.1),
        a(2 * D, D, scale=(2 * D) ** -0.5), a(1, D, scale=0.1),
        a(3, dh, scale=0.5), a(1, dh, scale=0.1), a(dh, D, scale=dh ** -0.5),
        a(1, D, scale=0.1), a(2 * D, d15, scale=(2 * D) ** -0.5),
        a(1, d15, scale=0.1), a(d15, D, scale=d15 ** -0.5), a(1, D, scale=0.1),
        a(D, dh, scale=D ** -0.5), a(1, dh, scale=0.1), a(dh, 3, scale=0.5),
        a(1, 3, scale=0.1),
    ]
    coef = np.stack([np.linspace(0.2, 0.9, T), np.linspace(0.9, 0.5, T),
                     np.linspace(0.3, 0.0, T)], -1).astype(np.float32)
    data = [a(B, N, 3), a(B, T, N, 3), a(B, N, 3), a(B, T, 2 * D), coef]
    return data, params


@pytest.mark.parametrize("clip", [False, True])
def test_denoise_chain_plain_matches_pallas(clip):
    data, params = _chain_inputs()
    with jax.default_matmul_precision("highest"):
        want = jax_denoise_chain(*map(jnp.asarray, data),
                                 JaxStepParams(*map(jnp.asarray, params)),
                                 clip_denoised=clip, interpret=True)
    got = denoise.denoise_chain_plain(
        *map(torch.from_numpy, data),
        DenoiseStepParams(*map(torch.from_numpy, params)), clip_denoised=clip)
    for g, w in zip(got, want):
        # the Pallas kernel's own fused-vs-composed bound
        # (tests/test_pallas_kernels.py): float32 sums in another order and
        # its rational erf approximation (|err| <= 1.5e-7)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, rtol=0)


@pytest.mark.parametrize("B,T,N,D", [(1, 2, 1024, 128), (2, 5, 37, 16)])
def test_chain_tables_scratch_layout(B, T, N, D):
    """K6's first pass keeps its scratch as csrc/denoise_tables.cuh lays it
    out: w_up2^T and w_up4^T, then u2, u4^T, emb^T (rows of N rounded up
    to 4) and g of every (scene, step); emb is a transposed view."""
    U0, U2, D15 = 128, 512, D * 3 // 2
    dims = (B, T, N, 2 * D, U0, U2, D, D // 2, D15, D // 2)
    ldn = -(-N // 4) * 4
    assert denoise._per_step(dims) == U2 * 2 * D + 3 * D * ldn + N * D15
    assert denoise._weights_floats(dims) == U0 * U2 + U2 * ldn
    size = denoise._weights_floats(dims) + B * T * denoise._per_step(dims)
    scratch = torch.arange(size, dtype=torch.float64)
    emb, g = denoise._table_views(scratch, dims)
    assert emb.shape == (B, T, N, D) and g.shape == (B, T, N, D15)
    o_emb = denoise._weights_floats(dims) + B * T * (U2 * 2 * D + 2 * D * ldn)
    for b, t, n, d in ((0, 0, 0, 0), (B - 1, T - 1, N - 1, D - 1), (B - 1, 0, 2, 1)):
        assert emb[b, t, n, d] == o_emb + ((b * T + t) * D + d) * ldn + n
        assert g[b, t, n, d] == (o_emb + B * T * D * ldn
                                 + ((b * T + t) * N + n) * D15 + d)
    assert g[-1, -1, -1, -1] == scratch[-1]


def test_chain_chunks_at_the_flagship_width():
    # a chunk's tables fill at most CHAIN_SCRATCH_FLOATS: 720,896 floats a
    # (scene, step) at N = 1024, D = 128
    _, params = _chain_inputs(N=1024, D=128)
    p = DenoiseStepParams(*map(torch.from_numpy, params))
    assert [denoise.chain_chunk_steps(b, 1000, p) for b in (1, 4, 8)] == [186, 46, 23]


def test_kernel_wrappers_on_cpu_run_the_plain_versions_and_launch_nothing():
    kernels.reset_launches()
    xyz = torch.from_numpy(_cloud(1, 2, 32, 3))
    new_xyz = xyz[:, :8].contiguous()
    start = torch.zeros(2, dtype=torch.int32)
    assert torch.equal(ballquery.query_ball_point_kernel(0.5, 8, xyz, new_xyz),
                       ballquery.query_ball_point_plain(0.5, 8, xyz, new_xyz))
    for a, b in zip(ballquery.three_nn_kernel(xyz, new_xyz, 3),
                    ballquery.three_nn_plain(xyz, new_xyz, 3)):
        assert torch.equal(a, b)
    assert torch.equal(fps.farthest_point_sample_kernel(xyz, 8, start),
                       fps.farthest_point_sample_plain(xyz, 8, start))
    data, params = _chain_inputs(T=2)
    args = (*map(torch.from_numpy, data),
            DenoiseStepParams(*map(torch.from_numpy, params)))
    for a, b in zip(denoise.fused_denoise_chain(*args),
                    denoise.denoise_chain_plain(*args)):
        assert torch.equal(a, b)
    for a, b in zip(denoise.denoise_chain_tables(args[3], args[5]),
                    denoise.denoise_chain_tables_plain(args[3], args[5])):
        assert torch.equal(a, b)
    step = (args[0], args[1][:, 0], args[2], args[3][:, 0], args[4][0], args[5])
    assert torch.equal(denoise.fused_denoise_step(*step),
                       denoise.denoise_step_plain(*step))
    base = torch.cat([xyz, xyz], -1)
    folded = [(torch.randn(6, 8), torch.randn(8)), (torch.randn(8, 4), torch.randn(4))]
    assert torch.equal(sa_fused.sa_stage_fused_kernel(0.5, 8, xyz, new_xyz, base, folded),
                       sa_fused.sa_stage_fused_plain(0.5, 8, xyz, new_xyz, base, folded))
    fargs = (xyz, new_xyz, None, torch.randn(2, 8, 6), folded, ("relu", "none"))
    assert torch.equal(fp_fused.fp_stage_fused_kernel(*fargs),
                       fp_fused.fp_stage_fused_plain(*fargs))
    assert torch.equal(attn.rank1_mha_kernel(base, base, base),
                       attn.rank1_mha_plain(base, base, base))
    out, den = attn.rank1_mha_plain(base, base, base, denominator=True)
    for a, b in zip(attn.rank1_mha_bwd_kernel(base, base, base, out, base, den),
                    attn.rank1_mha_bwd_plain(base, base, base, out, base)):
        assert torch.equal(a, b)
    for a, b in zip(sg_fused.select_gather_kernel(0.5, 8, xyz, new_xyz, base),
                    sg_fused.select_gather_plain(0.5, 8, xyz, new_xyz, base)):
        assert torch.equal(a, b)
    for a, b in zip(chamfer.directed_nn_kernel(xyz, new_xyz),
                    chamfer.directed_nn_plain(xyz, new_xyz)):
        assert torch.equal(a, b)
    # the bf16 modes of K4, K5 and K10
    bq = base.bfloat16()
    out, den = attn.rank1_mha_kernel(bq, bq, bq, denominator=True)
    assert torch.equal(out, attn.rank1_mha_plain(bq, bq, bq))
    for a, b in zip(attn.rank1_mha_bwd_kernel(bq, bq, bq, out, base, den),
                    attn.rank1_mha_bwd_plain(bq, bq, bq, out, base)):
        assert torch.equal(a, b)
    for a, b in zip(sg_fused.select_gather_kernel(0.5, 8, xyz, new_xyz, bq),
                    sg_fused.select_gather_plain(0.5, 8, xyz, new_xyz, bq)):
        assert torch.equal(a, b)
    assert kernels.LAUNCHES == {name: 0 for name in kernels.LAUNCHES}
    assert set(kernels.LAUNCHES) == {"ball_query", "three_nn", "fps",
                                     "denoise_chain", "rank1_attn", "sa_fused",
                                     "fp_fused", "rank1_attn_bwd", "select_gather",
                                     "chamfer_nn", "denoise_step", "rank1_attn_bf16",
                                     "rank1_attn_bwd_bf16", "select_gather_bf16",
                                     "sa_fused_bf16", "fp_fused_bf16",
                                     "denoise_chain_bf16", "denoise_step_bf16"}

"""The bf16 modes of K6, K7, K8 and K9 and the bf16 fused sampling path
against the JAX package at ``compute_dtype=bfloat16``.

The plain versions of the four kernels' bf16 modes against the Pallas
kernels in interpret mode (K7 and K8 at the shapes of
``tests/test_torch_fused.py``, with the head's trailing layers and an
``acts`` "none" layer; K9 with clip on and off; K6's chain and its first
pass's tables at T = 8); the fused eval backbone of a bf16 model against
JAX's; ``sample_sdm`` of a tiny bf16 model with ``ball_impl="fused"`` on
the chain and the step samplers against JAX's ``sample_sdm(...,
fused_step=..., fused_interpret=True)`` on the same draws; the step rows
the loop is fed (``step_emb2_table`` against JAX's ``step_emb2``); and that
on CPU tensors the wrappers run these plain versions.  Inputs come from
numpy seeds, weights cross through the bridge.

The bound is ``tests/test_torch_bf16.py:_check_bf16``: every entry within
3e-2 x max(1, |JAX|) of JAX's bf16 result, and the mean absolute difference
within half of JAX's own mean bf16-to-float32 gap on the same inputs, so a
port that stayed in float32 fails.  The JAX references are compiled
without XLA's excess precision (``_strict``), which would keep float32
where the program rounds to bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsdm_tpu.config import SDMConfig
from lsdm_tpu.diffusion.schedule import make_schedule as jax_make_schedule
from lsdm_tpu.models.pointnet2 import PointNet2Backbone as JaxBackbone
from lsdm_tpu.models.sampling import sample_sdm as jax_sample_sdm
from lsdm_tpu.models.sdm import CondCache as JaxCondCache
from lsdm_tpu.models.sdm import SceneDiffusionModel as JaxSDM
from lsdm_tpu.ops.denoise_pallas import DenoiseStepParams as JaxStepParams
from lsdm_tpu.ops.denoise_pallas import _gelu as jax_gelu
from lsdm_tpu.ops.denoise_pallas import fused_denoise_chain as jax_denoise_chain
from lsdm_tpu.ops.denoise_pallas import fused_denoise_step as jax_denoise_step
from lsdm_tpu.ops.fp_fused_pallas import fp_stage_fused
from lsdm_tpu.ops.sa_fused_pallas import sa_stage_fused
from lsdm_tpu.train.checkpoint import convert_torch_state_dict
from lsdm_tpu_torch import kernels
from lsdm_tpu_torch.config import SDMConfig as PortConfig
from lsdm_tpu_torch.diffusion.schedule import make_schedule
from lsdm_tpu_torch.models import pointnet2, sampling
from lsdm_tpu_torch.models.sampling import sample_sdm
from lsdm_tpu_torch.models.sdm import CondCache, SceneDiffusionModel
from lsdm_tpu_torch.ops import denoise, fp_fused, sa_fused
from lsdm_tpu_torch.ops.denoise import DenoiseStepParams
from lsdm_tpu_torch.weights import init_weights, state_dict_from_jax
from test_torch_bf16 import _check_bf16, _strict
from test_torch_fused import TINY_KW, _folded, _inputs, _jax, _port, _variables
from test_torch_kernels_plain import _chain_inputs
from test_torch_step import _jax_draws

BF16 = jnp.bfloat16
T_BF16 = torch.bfloat16


def _a(rs, *shape, scale=1.0):
    return (rs.randn(*shape) * scale).astype(np.float32)


# --- K7 and K8 --------------------------------------------------------------------


@pytest.mark.parametrize("radius,far", [(0.8, False), (0.3, False), (0.8, True)])
def test_sa_stage_bf16_plain_matches_pallas(radius, far):
    """K7's bf16 mode: Z1 rounded after its bias, the center term from
    rounded centers, each layer rounded after its ReLU, a bf16 output."""
    rs = np.random.RandomState(0)
    B, N, S, K = 2, 32, 16, 8
    xyz = _a(rs, B, N, 3)
    new_xyz = xyz[:, :S].copy()
    if far:
        new_xyz[1, 3] = 50.0
    base = np.concatenate([xyz, _a(rs, B, N, 5)], -1)
    folded = _folded(rs, (8, 8, 16, 16))

    def jax_run(dt):
        return _strict(lambda x, q, b, f: sa_stage_fused(
            radius, K, x, q, b, f, compute_dtype=dt, interpret=True),
            jnp.asarray(xyz), jnp.asarray(new_xyz), jnp.asarray(base), _jax(folded))

    got = sa_fused.sa_stage_fused_plain(
        radius, K, torch.from_numpy(xyz), torch.from_numpy(new_xyz),
        torch.from_numpy(base), _port(folded), T_BF16)
    want = jax_run(BF16)
    assert got.dtype == T_BF16 and want.dtype == BF16
    _check_bf16(got, want, jax_run(jnp.float32), f"K7 radius {radius} far {far}")


@pytest.mark.parametrize("case", ["points1", "no_points1", "head", "two_sources"])
def test_fp_stage_bf16_plain_matches_pallas(case):
    """K8's bf16 mode: rounded inverse-distance weights and interpolation,
    rounded points1, each layer rounded after its activation ("none" for
    the head's last layer), a bf16 output."""
    rs = np.random.RandomState(1)
    B, N = 2, 32
    S = 2 if case == "two_sources" else 8
    xyz1, xyz2 = _a(rs, B, N, 3), _a(rs, B, S, 3)
    p2 = _a(rs, B, S, 16)
    p1 = None if case in ("no_points1", "head") else _a(rs, B, N, 6)
    widths = (16 + (0 if p1 is None else 6), 8, 16)
    acts = None
    if case == "head":  # the trailing layers the backbone hands fp1
        widths += (16, 3)
        acts = ("relu", "relu", "relu", "none")
    folded = _folded(rs, widths)

    def jax_run(dt):
        return _strict(lambda a, b, c, d, f: fp_stage_fused(
            a, b, c, d, f, acts=acts, compute_dtype=dt, interpret=True),
            jnp.asarray(xyz1), jnp.asarray(xyz2),
            None if p1 is None else jnp.asarray(p1), jnp.asarray(p2), _jax(folded))

    got = fp_fused.fp_stage_fused_plain(
        torch.from_numpy(xyz1), torch.from_numpy(xyz2),
        None if p1 is None else torch.from_numpy(p1), torch.from_numpy(p2),
        _port(folded), acts, T_BF16)
    assert got.dtype == T_BF16
    _check_bf16(got, jax_run(BF16), jax_run(jnp.float32), f"K8 {case}")
    if case == "head":
        assert (got < 0).any()  # the last layer has no ReLU


# --- K9 and K6 --------------------------------------------------------------------


@pytest.mark.parametrize("clip", [False, True])
def test_denoise_step_bf16_plain_matches_pallas(clip):
    data, params = _chain_inputs(B=2, T=1, seed=3)
    x, noise, cpcd, e2, coef = data
    params[18] = params[18] * 4.0  # wo2_t: x0 of order 2, which the clip cuts
    data = (x, noise[:, 0], cpcd, e2[:, 0], coef[0])

    def jax_run(dt):
        return _strict(lambda *a: jax_denoise_step(
            *a[:5], JaxStepParams(*a[5:]), clip_denoised=clip, interpret=True,
            compute_dtype=dt), *map(jnp.asarray, data), *map(jnp.asarray, params))

    got = denoise.denoise_step_plain(
        *map(torch.from_numpy, data), DenoiseStepParams(*map(torch.from_numpy, params)),
        clip_denoised=clip, compute_dtype=T_BF16)
    assert got.dtype == torch.float32
    _check_bf16(got, jax_run(BF16), jax_run(jnp.float32), f"K9 clip {clip}")


@pytest.mark.parametrize("clip", [False, True])
def test_denoise_chain_bf16_plain_matches_pallas(clip):
    data, params = _chain_inputs(B=2, T=8, seed=4)

    def jax_run(dt):
        return _strict(lambda *a: jax_denoise_chain(
            *a[:5], JaxStepParams(*a[5:]), clip_denoised=clip, interpret=True,
            compute_dtype=dt), *map(jnp.asarray, data), *map(jnp.asarray, params))

    got = denoise.denoise_chain_plain(
        *map(torch.from_numpy, data), DenoiseStepParams(*map(torch.from_numpy, params)),
        clip_denoised=clip, compute_dtype=T_BF16)
    want, want32 = jax_run(BF16), jax_run(jnp.float32)
    for name, g, w, w32 in zip(("final", "last_in"), got, want, want32):
        _check_bf16(g, w, w32, f"K6 {name} clip {clip}")


def test_denoise_chain_tables_bf16_plain_match_the_pallas_arithmetic():
    """K6's first pass in bf16 against the Pallas chain body's own t-only
    arithmetic (``denoise_pallas.py:251-255``: its ``_gelu`` and its
    ``dot``), with emb rounded as the concat's half of the first
    combination_extraction product rounds it: the tables emb and g."""
    data, params = _chain_inputs(B=2, T=8, seed=5)
    e2 = data[3]
    D = params[6].shape[1]
    P = JaxStepParams(*map(jnp.asarray, params))

    def jax_tables(dt):
        def dot(a, b):
            return jnp.matmul(a.astype(dt), b.astype(dt),
                              preferred_element_type=jnp.float32)

        def run(e):
            e = e[..., None, :]
            u0 = jax_gelu(P.w_up0 * e + P.b_up0)
            u2 = jax_gelu(dot(P.w_up2, u0) + P.b_up2)
            u4 = jax_gelu(dot(P.w_up4, u2) + P.b_up4)
            emb = jax_gelu(dot(u4, P.wc_t) + P.bc).astype(dt)
            return emb.astype(jnp.float32), dot(emb, P.wx0_t[D:]) + P.bx0

        return _strict(run, jnp.asarray(e2))

    p = DenoiseStepParams(*map(torch.from_numpy, params))
    got = denoise.denoise_chain_tables_plain(torch.from_numpy(e2), p, T_BF16)
    assert torch.equal(got[0], got[0].to(T_BF16).float())  # emb rounded
    for name, g, w, w32 in zip(("emb", "g"), got, jax_tables(BF16),
                               jax_tables(jnp.float32)):
        _check_bf16(g, w, w32, f"K6 tables {name}")


# --- the fused encode and the sampler ---------------------------------------------


@pytest.mark.parametrize("N,npoints,fused", [
    (64, (64, 16, 8, 8), 8),  # every SA and FP stage passes its gate
    (36, (36, 8, 8, 8), 5),   # sa1, fp2 and fp1 (36 points) decline: fp1's
                              # head and conv2 as plain layers in bf16
])
def test_fused_bf16_backbone_matches_jax(N, npoints, fused, monkeypatch):
    """The eval backbone of a bf16 model on ``ball_impl="fused"``: the port
    runs K7's and K8's bf16 modes (plain versions on the CPU) where a stage
    passes its gate, the head riding fp1, and the composed bf16 stages with
    JAX's casts where it declines, as JAX runs its Pallas kernels at
    compute_dtype bfloat16."""
    rs = np.random.RandomState(6)
    B, ns = 2, 16
    xyz = _a(rs, B, N, 3, scale=0.5)
    bb = pointnet2.PointNet2Backbone(sa_npoints=npoints, sa_nsample=ns,
                                     ball_impl="fused", dtype=T_BF16,
                                     bn_dtype=T_BF16)
    init_weights(bb, 2)
    with torch.no_grad():
        for m in bb.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.copy_(torch.from_numpy(_a(rs, *m.running_mean.shape,
                                                         scale=0.1)))
                m.running_var.copy_(torch.from_numpy(
                    (rs.rand(*m.running_var.shape) + 0.5).astype(np.float32)))
    params, stats = convert_torch_state_dict(
        {"pcd_backbone." + k: v.numpy() for k, v in bb.state_dict().items()})
    variables = {"params": params["pcd_backbone"],
                 "batch_stats": stats["pcd_backbone"]}

    def jax_run(dt):
        jb = JaxBackbone(sa_npoints=npoints, sa_nsample=ns, ball_impl="fused",
                         dtype=dt, bn_dtype=dt)
        return _strict(lambda v: jb.apply(v, jnp.asarray(xyz), False), variables)

    modes = []
    for name in ("sa_stage_fused_kernel", "fp_stage_fused_kernel"):
        fn = getattr(pointnet2, name)
        monkeypatch.setattr(pointnet2, name, lambda *a, _fn=fn, _n=name: (
            modes.append((_n, a[-1])), _fn(*a))[1])
    with torch.no_grad():
        got = bb.eval()(torch.from_numpy(xyz))
    assert len(modes) == fused and {dt for _, dt in modes} == {T_BF16}
    assert got.dtype == T_BF16
    _check_bf16(got, jax_run(BF16), jax_run(jnp.float32), "fused bf16 backbone")


def _bf16_port(variables, **kw):
    port = SceneDiffusionModel(PortConfig(**TINY_KW, dtype="bfloat16",
                                          bn_dtype="bfloat16", **kw))
    port.load_state_dict(state_dict_from_jax(variables["params"],
                                             variables["batch_stats"]), strict=True)
    return port.eval()


@pytest.fixture(scope="module")
def tiny_model():
    """The JAX tiny model's inputs and seeded variables (ball_impl fused):
    at pcd_points 32 sa1, sa2, fp3, fp2 and fp1 fuse, sa3, sa4 and fp4 take
    the composed bf16 path, as in JAX."""
    cfg = SDMConfig(**TINY_KW, ball_impl="fused")
    inputs = _inputs(cfg, 2, 4)
    return inputs, _variables(JaxSDM(cfg), cfg, inputs, 5)


@pytest.mark.parametrize("fused_step", ["chain", "step"])
def test_bf16_fused_sampling_matches_jax(tiny_model, fused_step, monkeypatch):
    """``sample_sdm`` of a bf16 model, fused encode and T = 8 DDPM steps on
    K6 (chain) or K9 (step), in their bf16 modes, against JAX's sampler of
    the same model at dtype bfloat16 on the same draws."""
    inputs, variables = tiny_model
    T, key = 8, jax.random.PRNGKey(7)

    def jax_run(dt):
        jm = JaxSDM(SDMConfig(**TINY_KW, ball_impl="fused", dtype=dt, bn_dtype=dt))
        return _strict(lambda v, k, *a: jax_sample_sdm(
            jm, v, jax_make_schedule("cosine", T), *a, k, fused_step=fused_step,
            fused_interpret=True), variables, key, *map(jnp.asarray, inputs))

    want, want32 = jax_run("bfloat16"), jax_run("float32")
    x_init, noise = _jax_draws(key, 2, TINY_KW["pcd_points"], T)
    modes = []
    name = "fused_denoise_chain" if fused_step == "chain" else "make_denoise_step_loop"
    fn = getattr(sampling, name)
    monkeypatch.setattr(sampling, name, lambda *a, **k: (
        modes.append(k.get("compute_dtype", a[-1])), fn(*a, **k))[1])
    s_got, out_got = sample_sdm(
        _bf16_port(variables, ball_impl="fused"), make_schedule("cosine", T),
        *map(torch.from_numpy, inputs), fused_step=fused_step,
        x_init=torch.from_numpy(x_init), noise=torch.from_numpy(noise))
    assert modes == [T_BF16]
    for what, got, w, w32 in (("sample", s_got, want[0], want32[0]),
                              ("x0", out_got.x0, want[1].x0, want32[1].x0),
                              ("guiding", out_got.guiding, want[1].guiding,
                               want32[1].guiding),
                              ("cat", out_got.cat, want[1].cat, want32[1].cat)):
        assert got.dtype == torch.float32, what
        _check_bf16(got, w, w32, f"{fused_step} {what}")


def test_bf16_step_rows_match_jax_step_emb2(tiny_model):
    """The (B, T, 2D) step rows the bf16 loops are fed, the timestep and
    text embeddings of a bf16 model, against JAX's ``step_emb2`` a step."""
    inputs, variables = tiny_model
    B, D = 2, TINY_KW["latent_dim"]
    rs = np.random.RandomState(8)
    enc = _a(rs, B, 1, D)
    ts = np.array([7, 5, 3, 0, 999], np.int32)

    def jax_run(dt):
        jm = JaxSDM(SDMConfig(**TINY_KW, dtype=dt, bn_dtype=dt))
        cond = JaxCondCache(enc_text=jnp.asarray(enc).astype(dt),
                            out_cat=jnp.zeros((B, 1, 13)), cond_pcd=jnp.zeros((B, 32, 3)))
        return _strict(lambda v, t: jax.vmap(lambda tt: jm.apply(
            v, cond, jnp.full((B,), tt), method=jm.step_emb2))(t), variables,
            jnp.asarray(ts))

    port = _bf16_port(variables)
    cond = CondCache(enc_text=torch.from_numpy(enc).to(T_BF16),
                     out_cat=torch.zeros(B, 1, 13), cond_pcd=torch.zeros(B, 32, 3))
    with torch.no_grad():
        got = port.step_emb2_table(cond, torch.from_numpy(ts).long())
    assert got.dtype == T_BF16
    want, want32 = jax_run("bfloat16"), jax_run("float32")  # (T, B, 2D)
    _check_bf16(got.transpose(0, 1), want, want32, "step_emb2 rows")


# --- the wrappers on the CPU ------------------------------------------------------


def test_cpu_wrappers_run_the_bf16_plain_versions():
    """On CPU tensors each wrapper in the bf16 mode returns its plain
    version's result and launches nothing; float16 is no mode of these
    kernels."""
    rs = np.random.RandomState(9)
    t = torch.from_numpy
    kernels.reset_launches()
    xyz = t(_a(rs, 2, 32, 3))
    base = torch.cat([xyz, t(_a(rs, 2, 32, 5))], -1)
    folded = _port(_folded(rs, (8, 8, 16)))
    sa_args = (0.8, 8, xyz, xyz[:, :16].contiguous(), base, folded, T_BF16)
    assert torch.equal(sa_fused.sa_stage_fused_kernel(*sa_args),
                       sa_fused.sa_stage_fused_plain(*sa_args))
    p2 = t(_a(rs, 2, 8, 16)).to(T_BF16)
    fp_args = (xyz, xyz[:, :8].contiguous(), None, p2, _port(_folded(rs, (16, 8, 3))),
               ("relu", "none"), T_BF16)
    assert torch.equal(fp_fused.fp_stage_fused_kernel(*fp_args),
                       fp_fused.fp_stage_fused_plain(*fp_args))
    data, params = _chain_inputs(B=2, T=3, seed=10)
    data = [t(a) for a in data]
    p = DenoiseStepParams(*map(t, params))
    for a, b in zip(denoise.fused_denoise_chain(*data, p, compute_dtype=T_BF16),
                    denoise.denoise_chain_plain(*data, p, compute_dtype=T_BF16)):
        assert torch.equal(a, b)
    for a, b in zip(denoise.denoise_chain_tables(data[3], p, T_BF16),
                    denoise.denoise_chain_tables_plain(data[3], p, T_BF16)):
        assert torch.equal(a, b)
    step = (data[0], data[1][:, 0], data[2], data[3][:, 0], data[4][0])
    want = denoise.denoise_step_plain(*step, p, compute_dtype=T_BF16)
    assert torch.equal(denoise.fused_denoise_step(*step, p, compute_dtype=T_BF16), want)
    assert not torch.equal(denoise.denoise_step_plain(*step, p), want)
    loop = denoise.make_denoise_step_loop(p, 2, 32, 3, torch.device("cpu"),
                                          compute_dtype=T_BF16)
    got = loop(data[0], data[1].transpose(0, 1), data[2], data[3].transpose(0, 1), data[4])
    for a, b in zip(got, denoise.denoise_chain_plain(*data, p, compute_dtype=T_BF16)):
        assert torch.equal(a, b)
    assert not any(kernels.LAUNCHES.values())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        denoise.denoise_step_plain(*step, p, compute_dtype=torch.float16)


def test_bf16_step_params_round_the_products_once_per_model():
    """``step_params`` rounds the product weights (not w_up0 or the biases)
    to bf16 once per model and weights: a second call returns the same
    tensors, an in-place update of the weights makes them anew."""
    model = init_weights(SceneDiffusionModel(PortConfig(**TINY_KW, dtype="bfloat16")),
                         0).eval()
    p = denoise.step_params(model, T_BF16)
    f32 = denoise.extract_step_params(model)
    assert isinstance(p, denoise.Bf16StepParams)
    assert denoise.bf16_step_params(p) is p
    for name, w, w32 in zip(p._fields, p, f32):
        rounded = name in denoise.PRODUCT_WEIGHTS
        assert w.dtype == torch.float32, name
        assert torch.equal(w, w32.to(T_BF16).float() if rounded else w32), name
    assert denoise.step_params(model, T_BF16) is p
    with torch.no_grad():
        model.combine_extraction[0].weight.mul_(2.0)
    again = denoise.step_params(model, T_BF16)
    assert again is not p and not torch.equal(again.wc_t, p.wc_t)
    assert not isinstance(denoise.step_params(model), denoise.Bf16StepParams)


# --- K6 pass 1's scratch and weights in the bf16 mode -----------------------------


def _tables_dims(B, T, N, D):
    return (B, T, N, 2 * D, 128, 512, D, D // 2, D * 3 // 2, D // 2)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("B,T,N,D", [(1, 2, 1024, 128), (2, 5, 37, 16), (3, 4, 1000, 16)])
def test_chain_tables_layout_in_each_mode(B, T, N, D, bf16):
    """K6 pass 1's scratch per mode, as csrc/denoise_tables.cuh lays it out.
    float32: w_up2^T and w_up4^T, then u2, u4^T, emb^T and g, all float32,
    rows of N rounded up to 4.  bf16: no weights, then u0, u2 and u4^T as
    bf16 (two to a float), rows of N rounded up to 8, g float32, then, kept
    only by pass 1 alone, emb^T as bf16."""
    dims = _tables_dims(B, T, N, D)
    U0, U2, D15 = 128, 512, D * 3 // 2
    r = 8 if bf16 else 4
    ldn = -(-N // r) * r
    assert denoise._ldn(N, bf16) == ldn and ldn * (2 if bf16 else 4) % 16 == 0
    if bf16:
        assert denoise._per_step(dims, True) == (U0 + U2) * D + D * ldn + N * D15
        assert denoise._per_step(dims, True, emb=True) == (
            (U0 + U2) * D + 3 * D * ldn // 2 + N * D15)
    else:
        assert denoise._per_step(dims) == U2 * 2 * D + 3 * D * ldn + N * D15
    assert denoise._weights_floats(dims, bf16) == (0 if bf16 else U0 * U2 + U2 * ldn)
    # the defaults are the float32 mode's
    assert denoise._per_step(dims) == denoise._per_step(dims, False)
    assert denoise._weights_floats(dims) == denoise._weights_floats(dims, False)


@pytest.mark.parametrize("B,T,N,D", [(1, 2, 1024, 128), (2, 5, 37, 16)])
def test_chain_table_views_read_the_bf16_layout(B, T, N, D):
    """``_table_views`` in the bf16 mode, on a scratch filled by hand in the
    kernel's layout: g a float32 view after the bf16 u0, u2 and u4^T, then
    emb from the bf16 emb^T table after g (rows of ldn, padding never read),
    widened to float32."""
    dims = _tables_dims(B, T, N, D)
    U0, U2, D15 = 128, 512, D * 3 // 2
    ldn, z = denoise._ldn(N, True), B * T
    rs = np.random.RandomState(3)
    emb = torch.from_numpy(rs.randn(B, T, N, D).astype(np.float32)).to(T_BF16)
    g = torch.from_numpy(rs.randn(B, T, N, D15).astype(np.float32))
    scratch = torch.full((z * denoise._per_step(dims, True, emb=True),), float("nan"))
    o_g = z * ((U0 + U2) * D + D * ldn)  # floats of u0, u2 and u4^T
    scratch[o_g:o_g + z * N * D15] = g.reshape(-1)
    h = scratch[o_g + z * N * D15:].view(T_BF16)
    h.view(B, T, D, ldn)[..., :N] = emb.transpose(-1, -2)
    got_emb, got_g = denoise._table_views(scratch, dims, True)
    assert got_emb.dtype == got_g.dtype == torch.float32
    assert got_emb.shape == (B, T, N, D) and got_g.shape == (B, T, N, D15)
    assert torch.equal(got_emb, emb.float()) and torch.equal(got_g, g)
    assert got_g.data_ptr() == scratch[o_g:].data_ptr()  # a view


def test_chain_chunks_in_each_mode_at_the_flagship_width():
    """Steps a chunk at N = 1024, D = 128: the float32 mode's unchanged
    (720,896 floats a (scene, step)), the bf16 mode's from its 409,600."""
    _, params = _chain_inputs(N=1024, D=128)
    p = DenoiseStepParams(*map(torch.from_numpy, params))
    for dt in (None, torch.float32):
        assert [denoise.chain_chunk_steps(b, 1000, p, dt) for b in (1, 8)] == [186, 23]
    assert [denoise.chain_chunk_steps(b, 1000, p, T_BF16) for b in (1, 8)] == [327, 40]
    dims = _tables_dims(1, 1000, 1024, 128)
    assert (denoise._per_step(dims), denoise._per_step(dims, True)) == (720896, 409600)


def test_bf16_operands_are_made_once_per_model_from_the_rounded_weights():
    """K6 pass 1's bf16 copies of w_up2^T, w_up4^T, wc_t and wx0_t[D:] hang
    on the weights ``step_params`` keeps: made once per model and weights,
    bf16, rows padded with zeros to 8 elements, equal to the rounded float32
    weights; the pointers of the bf16 launch are the 20 weights', then
    theirs, then pass 2's six."""
    model = init_weights(SceneDiffusionModel(PortConfig(**TINY_KW, dtype="bfloat16")),
                         0).eval()
    p = denoise.step_params(model, T_BF16)
    ops = p.operands
    assert denoise.step_params(model, T_BF16).operands is ops
    f32 = denoise.extract_step_params(model)
    D = f32.wc_t.shape[1]
    for name, o, w in zip(ops._fields, ops, (f32.w_up2.t(), f32.w_up4.t(), f32.wc_t,
                                             f32.wx0_t[D:])):
        rows, cols = w.shape
        assert o.dtype == T_BF16 and o.is_contiguous(), name
        assert o.shape == (rows, -(-cols // 8) * 8), name
        assert torch.equal(o[:, :cols], w.to(T_BF16)), name
        assert not o[:, cols:].any(), name
    ptrs = denoise._pointers(p, True)
    # pass 1's four, then pass 2's six (tests/test_torch_chain_bf16.py)
    assert len(ptrs) == 30 and list(ptrs)[:20] == list(denoise._pointers(p))
    assert list(ptrs)[20:] == [o.data_ptr() for o in ops]
    with torch.no_grad():
        model.upsampling_layer[4].weight.mul_(2.0)
    again = denoise.step_params(model, T_BF16).operands
    assert again is not ops and torch.equal(again.w4t.float(), 2 * ops.w4t.float())

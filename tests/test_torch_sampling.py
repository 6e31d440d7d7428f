"""The port's sampling slice end to end against the JAX package.

JAX ``sample_sdm`` runs its composed path (scanned ``denoise_from_cond``)
on the CPU.  The port's ``sample_sdm`` runs both of its paths, the K6
chain (``fused_step="chain"``, its plain version on CPU tensors) and the
composed Python loop, fed the JAX draws: ``split`` then ``normal(init_key)``
for the initial image and ``normal(fold_in(key, i))`` for step i
(``lsdm_tpu/diffusion/sampler.py``).  Weights cross through the bridge.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsdm_tpu.config import SDMConfig
from lsdm_tpu.diffusion.schedule import make_schedule as jax_make_schedule
from lsdm_tpu.diffusion.schedule import spaced_schedule as jax_spaced_schedule
from lsdm_tpu.models.sampling import sample_sdm as jax_sample_sdm
from lsdm_tpu.models.sdm import SceneDiffusionModel as JaxSDM
from lsdm_tpu_torch.config import SDMConfig as PortConfig
from lsdm_tpu_torch.diffusion.schedule import make_schedule, spaced_schedule
from lsdm_tpu_torch.models.sampling import resolve_fast_path, sample_sdm
from lsdm_tpu_torch.models.sdm import SceneDiffusionModel
from lsdm_tpu_torch.weights import state_dict_from_jax

TINY_KW = dict(clip_dim=32, latent_dim=16, cat_emb=8, n_head=4,
               vert_dims=24, pcd_points=32)
TINY = SDMConfig(**TINY_KW)  # the JAX package's
PORT_TINY = PortConfig(**TINY_KW)  # the port's copy
# float32 reassociation between XLA and torch, through 4 steps (the JAX
# package's own fused-vs-composed sampling bound, tests/test_pallas_kernels.py)
ATOL = 2e-5


@pytest.fixture(scope="module")
def setup():
    cfg = TINY
    B, O, N = 2, cfg.max_objs, cfg.pcd_points
    rs = np.random.RandomState(1)
    mask = np.zeros((B, O), np.float32)
    mask[:, 1:4] = 1.0
    inputs = (mask, rs.randn(B, O, N, 3).astype(np.float32),
              np.eye(cfg.max_cats, dtype=np.float32)[rs.randint(0, 13, (B, O))],
              rs.randn(B, cfg.clip_dim).astype(np.float32))
    jmodel = JaxSDM(cfg)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((B, N, 3)), jnp.asarray(mask),
                            jnp.zeros((B,), jnp.int32),
                            *map(jnp.asarray, inputs[1:]))

    def draw(path, a):
        if jax.tree_util.keystr(path).endswith("['var']"):
            return (rs.rand(*a.shape) + 0.5).astype(np.float32)
        return (rs.randn(*a.shape) * 0.2).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    port = SceneDiffusionModel(PORT_TINY)
    port.load_state_dict(state_dict_from_jax(variables["params"],
                                             variables["batch_stats"]),
                         strict=True)
    return jmodel, variables, port.eval(), inputs


VARIANTS = {
    # name: (use_ddim, clip_denoised, respaced)
    "ddpm": (False, False, False),
    "ddpm_clip": (False, True, False),
    "ddim_respaced": (True, False, True),  # 4 of 16 steps, timestep_map
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_sample_sdm_matches_jax(setup, variant):
    jmodel, variables, port, inputs = setup
    use_ddim, clip, respaced = VARIANTS[variant]
    if respaced:
        jsched = jax_spaced_schedule("cosine", 16, "ddim4")
        sched = spaced_schedule("cosine", 16, "ddim4")
    else:
        jsched, sched = jax_make_schedule("cosine", 4), make_schedule("cosine", 4)
    tmap = jsched.timestep_map if respaced else None
    T = jsched.num_timesteps
    B, N = inputs[0].shape[0], TINY.pcd_points
    key = jax.random.PRNGKey(42)

    with jax.default_matmul_precision("highest"):
        s_want, out_want = jax.jit(lambda v, s, k, *a: jax_sample_sdm(
            jmodel, v, s, *a, k, clip_denoised=clip, use_ddim=use_ddim,
            timestep_map=tmap))(variables, jsched, key, *map(jnp.asarray, inputs))
    step_key, init_key = jax.random.split(key)
    x_init = np.array(jax.random.normal(init_key, (B, N, 3), jnp.float32))
    noise = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(step_key, i), (B, N, 3), jnp.float32))
        for i in range(T)])

    for fused_step in ("chain", None):
        s_got, out_got = sample_sdm(
            port, sched, *map(torch.from_numpy, inputs), clip_denoised=clip,
            use_ddim=use_ddim,
            timestep_map=sched.timestep_map if respaced else None,
            fused_step=fused_step, x_init=torch.from_numpy(x_init),
            noise=torch.from_numpy(noise))
        for name, got, want in (("sample", s_got, s_want),
                                ("x0", out_got.x0, out_want.x0),
                                ("guiding", out_got.guiding, out_want.guiding),
                                ("cat", out_got.cat, out_want.cat)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                       rtol=0, err_msg=f"{fused_step}: {name}")


@pytest.mark.parametrize("device,want", [
    ("cpu", ("auto", None)),        # the composed encode and loop
    ("cuda", ("fused", "chain")),   # the fused encode, the whole-loop kernel
])
def test_resolve_fast_path_by_device(device, want):
    dev = torch.device(device)
    assert resolve_fast_path("auto", None, dev) == want
    assert resolve_fast_path("auto", "auto", dev) == want
    assert resolve_fast_path("auto", "none", dev) == (want[0], None)
    # explicit choices pass through
    assert resolve_fast_path("pallas", "chain", dev) == ("pallas", "chain")
    assert resolve_fast_path("topk", None, dev) == ("topk", want[1])
    with pytest.raises(NotImplementedError):
        resolve_fast_path("auto", "step", dev)


# "sg" (K10) is ported with the training slice; these TPU formulations are not
@pytest.mark.parametrize("ball_impl", ["topk_p", "topk2c", "scatter"])
def test_unported_ball_impls_raise(ball_impl):
    import dataclasses

    with pytest.raises(NotImplementedError, match=ball_impl):
        SceneDiffusionModel(dataclasses.replace(PORT_TINY, ball_impl=ball_impl))


@pytest.mark.parametrize("fn", ["q_posterior_mean_variance",
                                "predict_xstart_from_eps",
                                "predict_eps_from_xstart"])
def test_posterior_helpers_match_jax(fn):
    from lsdm_tpu.diffusion import gaussian as jax_gaussian
    from lsdm_tpu_torch.diffusion import gaussian

    rs = np.random.RandomState(5)
    a, b = (rs.randn(3, 8, 3).astype(np.float32) for _ in range(2))
    t = np.array([0, 7, 15], np.int32)
    # (x_start, x_t, t) for the posterior, (x_t, t, eps or x_start) else
    args = (a, b, t) if fn == "q_posterior_mean_variance" else (a, t, b)
    want = getattr(jax_gaussian, fn)(jax_make_schedule("cosine", 16),
                                     *map(jnp.asarray, args))
    got = getattr(gaussian, fn)(make_schedule("cosine", 16),
                                *map(torch.from_numpy, args))
    if fn != "q_posterior_mean_variance":
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        # both tables are made in float64 and cast to float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=1e-6)

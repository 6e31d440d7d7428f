"""K9 (one denoise step) and the step-by-step sampler against the JAX package.

K9's plain version against the Pallas ``fused_denoise_step`` in interpret
mode, as ``tests/test_pallas_kernels.py`` runs it; the port's
``sample_sdm(fused_step="step")`` against JAX's (``fused_interpret=True``)
for DDPM, DDIM and a respaced schedule, fed the JAX draws (``split`` then
``normal(init_key)`` for the initial image, ``normal(fold_in(key, i))`` for
step i: ``lsdm_tpu/models/sampling.py:236-271``); the step sampler against
the chain sampler on the port; and the ``--fused_step`` flag of
``test_sdm``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsdm_tpu.diffusion.schedule import make_schedule as jax_make_schedule
from lsdm_tpu.diffusion.schedule import spaced_schedule as jax_spaced_schedule
from lsdm_tpu.models.sampling import sample_sdm as jax_sample_sdm
from lsdm_tpu.ops.denoise_pallas import DenoiseStepParams as JaxStepParams
from lsdm_tpu.ops.denoise_pallas import fused_denoise_step as jax_denoise_step
from lsdm_tpu_torch import kernels
from lsdm_tpu_torch.config import SDMConfig
from lsdm_tpu_torch.data.synthetic import generate
from lsdm_tpu_torch.diffusion.schedule import make_schedule, spaced_schedule
from lsdm_tpu_torch.models.sampling import resolve_fast_path, sample_sdm
from lsdm_tpu_torch.models.sdm import SceneDiffusionModel
from lsdm_tpu_torch.ops import denoise
from lsdm_tpu_torch.ops.denoise import DenoiseStepParams
from lsdm_tpu_torch.run import test_sdm
from lsdm_tpu_torch.weights import init_weights
from test_torch_kernels_plain import _chain_inputs
from test_torch_sampling import ATOL, TINY, setup  # noqa: F401 (a fixture)


def _step_inputs(B=2, seed=0):
    """One step's (x, noise, cond_pcd, e2, coefs) and the params, numpy.
    x0 reaches past [-1, 1] at these scales, so the clip changes it."""
    data, params = _chain_inputs(B=B, T=1, seed=seed)
    x, noise, cpcd, e2, coef = data
    params[18] = params[18] * 4.0  # wo2_t: x0 of order 2
    return (x, noise[:, 0], cpcd, e2[:, 0], coef[0]), params


@pytest.mark.parametrize("clip", [False, True])
def test_denoise_step_plain_matches_pallas(clip):
    data, params = _step_inputs()
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_denoise_step(
            *map(jnp.asarray, data), JaxStepParams(*map(jnp.asarray, params)),
            clip_denoised=clip, interpret=True))
        unclipped = np.asarray(jax_denoise_step(
            *map(jnp.asarray, data), JaxStepParams(*map(jnp.asarray, params)),
            interpret=True))
    got = denoise.denoise_step_plain(
        *map(torch.from_numpy, data),
        DenoiseStepParams(*map(torch.from_numpy, params)), clip_denoised=clip)
    # the Pallas kernel's own fused-vs-composed bound, as for K6
    # (test_denoise_chain_plain_matches_pallas): float32 sums in another
    # order and its rational erf approximation (|err| <= 1.5e-7)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    if clip:  # the clip was reached
        assert np.abs(want - unclipped).max() > 1e-2


def test_denoise_step_plain_is_one_step_of_the_chain_plain():
    data, params = _chain_inputs(B=2, T=3)
    x, noise, cpcd, e2, coef = map(torch.from_numpy, data)
    p = DenoiseStepParams(*map(torch.from_numpy, params))
    final, last_in = denoise.denoise_chain_plain(x, noise, cpcd, e2, coef, p)
    y = x
    for t in range(3):
        prev = y
        y = denoise.denoise_step_plain(y, noise[:, t], cpcd, e2[:, t], coef[t], p)
    assert torch.equal(y, final) and torch.equal(prev, last_in)


def test_denoise_step_wrapper_on_cpu_runs_the_plain_version():
    data, params = _step_inputs()
    args = (*map(torch.from_numpy, data),
            DenoiseStepParams(*map(torch.from_numpy, params)))
    kernels.reset_launches()
    assert torch.equal(denoise.fused_denoise_step(*args, clip_denoised=True),
                       denoise.denoise_step_plain(*args, clip_denoised=True))
    assert kernels.LAUNCHES["denoise_step"] == 0


@pytest.mark.parametrize("clip", [False, True])
def test_bound_denoise_step_on_cpu_runs_the_plain_version(clip):
    data, params = _step_inputs()
    x, noise, cpcd, e2, coef = map(torch.from_numpy, data)
    p = DenoiseStepParams(*map(torch.from_numpy, params))
    want = denoise.denoise_step_plain(x, noise, cpcd, e2, coef, p, clip_denoised=clip)
    kernels.reset_launches()
    for make in (denoise.make_denoise_step, denoise.make_denoise_step_plain):
        step = make(p, x.shape[1], torch.device("cpu"), clip)
        assert torch.equal(step(x, noise, cpcd, e2, coef), want)  # the bound clip
    assert kernels.LAUNCHES["denoise_step"] == 0


STEP_VARIANTS = {
    # name: (use_ddim, clip_denoised, respaced)
    "ddpm": (False, False, False),
    "ddim": (True, False, False),
    "ddpm_clip_respaced": (False, True, True),  # 4 of 16 steps, timestep_map
}


def _jax_draws(key, B, N, T):
    step_key, init_key = jax.random.split(key)
    x_init = np.array(jax.random.normal(init_key, (B, N, 3), jnp.float32))
    noise = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(step_key, i), (B, N, 3), jnp.float32))
        for i in range(T)])
    return x_init, noise


@pytest.mark.parametrize("variant", list(STEP_VARIANTS))
def test_sample_sdm_step_matches_jax_step(setup, variant):  # noqa: F811
    jmodel, variables, port, inputs = setup
    use_ddim, clip, respaced = STEP_VARIANTS[variant]
    if respaced:
        jsched = jax_spaced_schedule("cosine", 16, "ddim4")
        sched = spaced_schedule("cosine", 16, "ddim4")
    else:
        jsched, sched = jax_make_schedule("cosine", 4), make_schedule("cosine", 4)
    tmap = jsched.timestep_map if respaced else None
    T = jsched.num_timesteps
    B, N = inputs[0].shape[0], TINY.pcd_points
    key = jax.random.PRNGKey(7)

    with jax.default_matmul_precision("highest"):
        s_want, out_want = jax.jit(lambda v, s, k, *a: jax_sample_sdm(
            jmodel, v, s, *a, k, clip_denoised=clip, use_ddim=use_ddim,
            timestep_map=tmap, fused_step="step", fused_interpret=True))(
                variables, jsched, key, *map(jnp.asarray, inputs))
    x_init, noise = _jax_draws(key, B, N, T)
    s_got, out_got = sample_sdm(
        port, sched, *map(torch.from_numpy, inputs), clip_denoised=clip,
        use_ddim=use_ddim, timestep_map=sched.timestep_map if respaced else None,
        fused_step="step", x_init=torch.from_numpy(x_init),
        noise=torch.from_numpy(noise))
    for name, got, want in (("sample", s_got, s_want), ("x0", out_got.x0, out_want.x0),
                            ("guiding", out_got.guiding, out_want.guiding),
                            ("cat", out_got.cat, out_want.cat)):
        # float32 reassociation between XLA and torch and the Pallas
        # kernel's erf, through 4 steps (test_torch_sampling.py's bound)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("use_ddim", [False, True])
def test_step_sampler_equals_chain_sampler_with_the_same_draws(setup, use_ddim):  # noqa: F811
    _, _, port, inputs = setup
    B, N, T = inputs[0].shape[0], TINY.pcd_points, 5
    g = torch.Generator().manual_seed(3)
    x_init = torch.randn(B, N, 3, generator=g)
    noise = torch.randn(T, B, N, 3, generator=g)
    sched = make_schedule("cosine", T)
    kernels.reset_launches()
    step, chain = (sample_sdm(port, sched, *map(torch.from_numpy, inputs),
                              use_ddim=use_ddim, fused_step=mode, x_init=x_init,
                              noise=noise) for mode in ("step", "chain"))
    # on the CPU both run the plain versions, which share the step body:
    # the same float32 operations in the same order
    assert torch.equal(step[0], chain[0])
    for name in ("x0", "guiding", "cat"):
        assert torch.equal(getattr(step[1], name), getattr(chain[1], name)), name
    assert not any(kernels.LAUNCHES.values())


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_resolve_fast_path_passes_step_through(device):
    dev = torch.device(device)
    ball = "fused" if device == "cuda" else "auto"
    assert resolve_fast_path("auto", "step", dev) == (ball, "step")
    assert resolve_fast_path("pallas", "step", dev) == ("pallas", "step")
    # "auto" on CUDA stays the chain
    assert resolve_fast_path("auto", "auto", dev)[1] == (
        "chain" if device == "cuda" else None)
    with pytest.raises(ValueError, match="loop"):
        resolve_fast_path("auto", "loop", dev)


def test_sample_sdm_refuses_an_unknown_fused_step(setup):  # noqa: F811
    _, _, port, inputs = setup
    with pytest.raises(ValueError, match="steps"):
        sample_sdm(port, make_schedule("cosine", 2), *map(torch.from_numpy, inputs),
                   fused_step="steps")


def test_test_sdm_fused_step_flag():
    assert test_sdm.parse_args(["d"]).fused_step == "auto"
    assert test_sdm.parse_args(["d", "--fused_step"]).fused_step == "step"
    assert test_sdm.parse_args(["d", "--fused_step", "--device", "cpu"]).fused_step == "step"
    assert test_sdm.parse_args(["d", "--fused_step", "chain"]).fused_step == "chain"
    with pytest.raises(SystemExit):
        test_sdm.parse_args(["d", "--fused_step", "loop"])


def test_test_sdm_cli_with_the_step_sampler_on_cpu(tmp_path):
    root = str(tmp_path)
    generate(root, "proxd", n_scenes=1, n_seqs=2, pnt_size=32, seed=4, split="test")
    out = os.path.join(root, "out")
    kernels.reset_launches()
    final = test_sdm.main([
        os.path.join(root, "proxd_test"), "--objs_data_dir", os.path.join(root, "objs"),
        "--output_dir", out, "--diffusion_steps", "3", "--pcd_points", "32",
        "--device", "cpu", "--fused_step"])
    assert all(np.isfinite(v) for v in final.values())
    assert not any(kernels.LAUNCHES.values())
    for sub in ("predictions", "guiding_points"):
        names = sorted(os.listdir(os.path.join(out, sub)))
        assert len(names) == 2
        for name in names:
            arr = np.load(os.path.join(out, sub, name))
            assert arr.shape == (32, 3) and np.isfinite(arr).all()


def test_step_sampler_matches_the_composed_loop_at_a_seeded_model():
    # a model made by the port's own seeded init: the step sampler, the
    # chain and the composed loop give one sample (float32 reassociation
    # between the composed modules and the step body's products)
    cfg = SDMConfig(clip_dim=32, latent_dim=16, cat_emb=8, n_head=4,
                    vert_dims=24, pcd_points=32)
    model = init_weights(SceneDiffusionModel(cfg), 1).eval()
    g = torch.Generator().manual_seed(0)
    mask = torch.zeros(1, 9)
    mask[:, 1:4] = 1.0
    cats = torch.nn.functional.one_hot(torch.randint(0, 13, (1, 9), generator=g),
                                       13).float()
    args = (mask, torch.randn(1, 9, 32, 3, generator=g), cats,
            torch.randn(1, 32, generator=g))
    x_init = torch.randn(1, 32, 3, generator=g)
    noise = torch.randn(4, 1, 32, 3, generator=g)
    step, composed = (sample_sdm(model, make_schedule("cosine", 4), *args,
                                 fused_step=mode, x_init=x_init, noise=noise)
                      for mode in ("step", None))
    torch.testing.assert_close(step[0], composed[0], atol=1e-5, rtol=0)
    torch.testing.assert_close(step[1].x0, composed[1].x0, atol=1e-5, rtol=0)

"""The port's diffusion library beyond the SDM sampling path, against JAX.

PLMS (orders 1-4), the DDPM step and loop options (``cond_fn``,
``const_noise``, ``skip_timesteps``, ``init_image``), classifier guidance,
the bits-per-dim bound, the timestep resamplers and the factory, each held
to ``lsdm_tpu/diffusion`` and ``lsdm_tpu/factory.py``.  The denoiser is a
small closed-form function written in both frameworks, and the draws are
JAX's (``fold_in`` keys as the JAX loops make them), fed to the port.

Tolerance: float32 elementwise math on both sides; the loops agree to
LOOP_ATOL and single functions to FN_ATOL (absolute, on values of order 1).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsdm_tpu import config as jax_config
from lsdm_tpu import factory as jax_factory
from lsdm_tpu.diffusion import gaussian as jg
from lsdm_tpu.diffusion import resample as jr
from lsdm_tpu.diffusion import sampler as js
from lsdm_tpu.diffusion.schedule import make_schedule as jax_make_schedule
from lsdm_tpu.diffusion.schedule import spaced_schedule as jax_spaced_schedule
from lsdm_tpu_torch import config, factory
from lsdm_tpu_torch.diffusion import gaussian as pg
from lsdm_tpu_torch.diffusion import resample as pr
from lsdm_tpu_torch.diffusion import sampler as ps
from lsdm_tpu_torch.diffusion.schedule import extract, make_schedule, spaced_schedule

LOOP_ATOL = 2e-5
FN_ATOL = 1e-6
T = 12
SHAPE = (3, 16, 3)


def _jax_model(x, t):
    s = jnp.sin(t.astype(jnp.float32) * 0.37)[:, None, None]
    x0 = jnp.tanh(0.8 * x + 0.3 * s)
    cat = jax.nn.softmax(jnp.stack([x0.mean((1, 2)), s[:, 0, 0]], -1), -1)[:, None]
    return jg.DenoiserOutput(x0, cat, 0.5 * x0)


def _port_model(x, t):
    s = torch.sin(t.float() * 0.37)[:, None, None]
    x0 = torch.tanh(0.8 * x + 0.3 * s)
    cat = torch.softmax(torch.stack([x0.mean((1, 2)), s[:, 0, 0]], -1), -1)[:, None]
    return pg.DenoiserOutput(x0, cat, 0.5 * x0)


def _jax_cond(x, t):
    return -0.5 * x + 0.01 * t.astype(jnp.float32)[:, None, None]


def _port_cond(x, t):
    return -0.5 * x + 0.01 * t.float()[:, None, None]


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


def _t(a):
    return torch.from_numpy(np.array(a))


def _loop_draws(key, steps):
    """(initial image, per-step noise) as the JAX DDPM loop draws them."""
    key, init_key = jax.random.split(key)
    x = jax.random.normal(init_key, SHAPE, jnp.float32)
    noise = jnp.stack([jax.random.normal(jax.random.fold_in(key, i), SHAPE, jnp.float32)
                       for i in range(steps)])
    return x, noise


@pytest.fixture
def schedules():
    return jax_make_schedule("cosine", T), make_schedule("cosine", T)


@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_plms_sample_loop_equals_jax(schedules, order):
    js_sched, ps_sched = schedules
    x_init = np.random.RandomState(order).randn(*SHAPE).astype(np.float32)
    want, wout = js.plms_sample_loop(js_sched, _jax_model, SHAPE, jax.random.PRNGKey(0),
                                     noise=jnp.asarray(x_init), order=order)
    got, gout = ps.plms_sample_loop(ps_sched, _port_model, SHAPE, x_init=_t(x_init),
                                    order=order)
    _close(got, want, LOOP_ATOL)
    _close(gout.x0, wout.x0, LOOP_ATOL)
    _close(gout.cat, wout.cat, LOOP_ATOL)


def test_plms_refuses_orders_outside_1_to_4(schedules):
    for order in (0, 5):
        with pytest.raises(ValueError, match="order"):
            ps.plms_sample_loop(schedules[1], _port_model, SHAPE, order=order)


@pytest.mark.parametrize("const_noise", [False, True])
@pytest.mark.parametrize("guided", [False, True])
def test_p_sample_step_equals_jax(schedules, const_noise, guided):
    js_sched, ps_sched = schedules
    rng = np.random.RandomState(3)
    x = rng.randn(*SHAPE).astype(np.float32)
    t = np.array([5, 0, 11])
    key = jax.random.PRNGKey(4)
    noise = jax.random.normal(key, SHAPE, jnp.float32)
    want = js.p_sample_step(js_sched, _jax_model, jnp.asarray(x), jnp.asarray(t), key,
                            const_noise=const_noise,
                            cond_fn=_jax_cond if guided else None)
    got = ps.p_sample_step(ps_sched, _port_model, _t(x), _t(t), _t(noise),
                           const_noise=const_noise, cond_fn=_port_cond if guided else None)
    for g, w in ((got[0], want[0]), (got[1], want[1]), (got[2].x0, want[2].x0)):
        _close(g, w, FN_ATOL)
    if const_noise:  # one draw for the whole batch: entries 0 and 2 differ by the mean only
        mean0 = pg.p_mean_variance(ps_sched, _port_model, _t(x), _t(t))[0]
        if not guided:
            d = got[0] - mean0
            scale = torch.exp(0.5 * extract(ps_sched.posterior_log_variance_clipped,
                                            _t(t), 3))
            _close(d[2] / scale[2], d[0] / scale[0], 1e-5)


@pytest.mark.parametrize("skip,with_image,const_noise", [
    (0, False, False), (0, False, True), (4, False, False), (5, True, False),
    (11, True, True)])
def test_p_sample_loop_options_equal_jax(schedules, skip, with_image, const_noise):
    js_sched, ps_sched = schedules
    init_image = (np.random.RandomState(9).rand(*SHAPE).astype(np.float32) * 2 - 1
                  if with_image else None)
    key = jax.random.PRNGKey(skip + 7)
    kw = dict(const_noise=const_noise, skip_timesteps=skip)
    want, wout = js.p_sample_loop(
        js_sched, _jax_model, SHAPE, key,
        init_image=None if init_image is None else jnp.asarray(init_image), **kw)
    x_init, noise = _loop_draws(key, T - skip)
    got, gout = ps.p_sample_loop(
        ps_sched, _port_model, SHAPE, x_init=_t(x_init), noise=_t(noise),
        init_image=None if init_image is None else _t(init_image), **kw)
    _close(got, want, LOOP_ATOL)
    _close(gout.x0, wout.x0, LOOP_ATOL)
    with pytest.raises(ValueError, match="noise"):
        ps.p_sample_loop(ps_sched, _port_model, SHAPE, x_init=_t(x_init),
                         noise=torch.zeros((T + 1,) + SHAPE), skip_timesteps=skip)


def test_condition_mean_and_score_equal_jax(schedules):
    js_sched, ps_sched = schedules
    rng = np.random.RandomState(5)
    x, x0 = rng.randn(2, *SHAPE).astype(np.float32)
    mean, var = rng.randn(*SHAPE).astype(np.float32), rng.rand(3, 1, 1).astype(np.float32)
    t = np.array([0, 6, 11])
    _close(pg.condition_mean(_port_cond, _t(mean), _t(var), _t(x), _t(t)),
           jg.condition_mean(_jax_cond, jnp.asarray(mean), jnp.asarray(var),
                             jnp.asarray(x), jnp.asarray(t)), FN_ATOL)
    _close(pg.condition_score(_port_cond, ps_sched, _t(x0), _t(x), _t(t)),
           jg.condition_score(_jax_cond, js_sched, jnp.asarray(x0), jnp.asarray(x),
                              jnp.asarray(t)), 1e-5)


def test_q_mean_variance_and_kl_equal_jax(schedules):
    js_sched, ps_sched = schedules
    rng = np.random.RandomState(6)
    x, m = rng.uniform(-1, 1, (2,) + SHAPE).astype(np.float32)
    lv, lv2 = rng.randn(2, *SHAPE).astype(np.float32) * 0.5 - 3
    t = np.array([0, 6, 11])
    for g, w in zip(pg.q_mean_variance(ps_sched, _t(x), _t(t)),
                    jg.q_mean_variance(js_sched, jnp.asarray(x), jnp.asarray(t))):
        _close(g, w, FN_ATOL)
    _close(pg.normal_kl(_t(x), _t(lv), _t(m), _t(lv2)),
           jg.normal_kl(*map(jnp.asarray, (x, lv, m, lv2))), 1e-4)


# The decoder likelihood takes the log of a difference of two CDFs; where
# a bin lies many standard deviations out, that difference is below
# float32's resolution and each side's tanh rounds it its own way (up to
# 11 nats apart at the 1e-12 floor).  So the likelihood and the bound
# are compared in float64 on both sides (JAX under enable_x64), where
# the same formula gives the same numbers to F64_RTOL (the cancellation
# still costs float64 about ten of its digits there).
F64_RTOL = 1e-6


def _close64(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=F64_RTOL, atol=1e-9)
def test_discretized_gaussian_log_likelihood_equals_jax_in_float64():
    rng = np.random.RandomState(6)
    x, m = rng.uniform(-1, 1, (2,) + SHAPE)
    x[0, :2] = [[-1, 1, 0.9995], [-0.9995, 0.5, 1]]  # both edge bins
    lv = rng.randn(*SHAPE) * 0.5 - 3
    with jax.enable_x64(True):
        want = jg.discretized_gaussian_log_likelihood(
            jnp.asarray(x), means=jnp.asarray(m), log_scales=jnp.asarray(lv))
        got = pg.discretized_gaussian_log_likelihood(_t(x), means=_t(m), log_scales=_t(lv))
        assert got.dtype == torch.float64
        _close64(got, want)


@pytest.mark.parametrize("clip_denoised", [False, True])
def test_vb_terms_and_calc_bpd_loop_equal_jax_in_float64(schedules, clip_denoised):
    js_sched, ps_sched = schedules
    rng = np.random.RandomState(8)
    x_start = np.tanh(rng.randn(*SHAPE))
    x_t = rng.randn(*SHAPE)
    t = np.array([0, 3, 11])
    with jax.enable_x64(True):
        got = pg.vb_terms_bpd(ps_sched, _port_model, _t(x_start), _t(x_t), _t(t),
                              clip_denoised=clip_denoised)
        want = jg.vb_terms_bpd(js_sched, _jax_model, jnp.asarray(x_start),
                               jnp.asarray(x_t), jnp.asarray(t),
                               clip_denoised=clip_denoised)
        _close64(got[0], want[0])
        _close64(got[1], want[1])

        key = jax.random.PRNGKey(2)
        want = jg.calc_bpd_loop(js_sched, _jax_model, jnp.asarray(x_start), key,
                                clip_denoised=clip_denoised)
        noise = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key, ti), SHAPE))
                          for ti in range(T)])
        got = pg.calc_bpd_loop(ps_sched, _port_model, _t(x_start), noise=_t(noise),
                               clip_denoised=clip_denoised)
    assert noise.dtype == np.float64
    assert got["vb"].shape == got["mse"].shape == (3, T)
    for name in ("total_bpd", "prior_bpd", "vb", "mse"):
        _close64(got[name], want[name])


def _histories(T, seed):
    rng = np.random.RandomState(seed)
    ts = rng.randint(0, T, 400)
    return ts, (rng.rand(400) * (1 + ts)).tolist()


def test_resamplers_weights_equal_jax():
    Tn = 16
    for name in ("uniform", "loss-second-moment"):
        ours = pr.create_named_schedule_sampler(name, Tn)
        ref = jr.create_named_schedule_sampler(name, Tn)
        assert type(ours).__name__ == type(ref).__name__
        np.testing.assert_array_equal(ours.weights(), ref.weights())
    with pytest.raises(NotImplementedError):
        pr.create_named_schedule_sampler("fancy", Tn)

    ours, ref = pr.LossSecondMomentResampler(Tn, 4), jr.LossSecondMomentResampler(Tn, 4)
    ts, losses = _histories(Tn, 0)
    for lo in range(0, 400, 50):  # before, during and after the warm-up
        ours.update_with_local_losses(torch.as_tensor(ts[lo:lo + 50]),
                                      torch.as_tensor(losses[lo:lo + 50],
                                                      dtype=torch.float64))
        ref.update_with_local_losses(ts[lo:lo + 50], np.asarray(losses[lo:lo + 50]))
        np.testing.assert_array_equal(ours.weights(), ref.weights())
        np.testing.assert_array_equal(ours._loss_history, ref._loss_history)
    assert ours._warmed_up()


@pytest.mark.parametrize("name", ["uniform", "loss-second-moment"])
def test_resampler_sample_draws_importance_weights(name):
    Tn = 16
    s = pr.create_named_schedule_sampler(name, Tn)
    if name != "uniform":
        s.update_with_all_losses(*_histories(Tn, 1))
    w = s.weights()
    p = w / w.sum()
    g = torch.Generator().manual_seed(0)
    t, weights = s.sample(20000, generator=g)
    assert t.dtype == torch.int64 and weights.dtype == torch.float32
    assert int(t.min()) >= 0 and int(t.max()) < Tn
    np.testing.assert_allclose(weights.numpy(), (1.0 / (Tn * p))[t.numpy()], rtol=1e-6)
    freq = np.bincount(t.numpy(), minlength=Tn) / len(t)
    np.testing.assert_allclose(freq, p, atol=0.015)
    t2, _ = s.sample(20000, generator=torch.Generator().manual_seed(0))
    assert torch.equal(t, t2)


def _gather_worker(rank, port, out_dir):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    s = pr.LossSecondMomentResampler(4, 2)
    s.update_with_local_losses(torch.tensor([rank, rank + 2]),
                               torch.tensor([1.0 + rank, 3.0 + rank]))
    np.save(f"{out_dir}/rank{rank}.npy", s._loss_history)
    dist.destroy_process_group()


def test_loss_aware_sampler_gathers_every_rank(tmp_path):
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    mp.spawn(_gather_worker, args=(port, str(tmp_path)), nprocs=2)
    want = [[1.0, 0.0], [2.0, 0.0], [3.0, 0.0], [4.0, 0.0]]
    for rank in range(2):
        np.testing.assert_array_equal(np.load(tmp_path / f"rank{rank}.npy"), want)


@pytest.mark.parametrize("datatype,respacing,overrides", [
    ("proxd", "", {}), ("humanise", "", {}), ("proxd", "ddim10", {"pcd_points": 256}),
    ("humanise", "25", {"latent_dim": 64})])
def test_factory_equals_jax(datatype, respacing, overrides):
    jcfg = jax_config.DiffusionConfig(steps=100, timestep_respacing=respacing)
    pcfg = config.DiffusionConfig(steps=100, timestep_respacing=respacing)
    jmodel, jsched = jax_factory.create_model_and_diffusion(datatype, jcfg, **overrides)
    model, sched = factory.create_model_and_diffusion(datatype, pcfg, **overrides)
    for f in dataclasses.fields(model.cfg):
        assert getattr(model.cfg, f.name) == getattr(jmodel.cfg, f.name), f.name
    assert sched.num_timesteps == jsched.num_timesteps
    for f in dataclasses.fields(sched):
        np.testing.assert_array_equal(getattr(sched, f.name).numpy(),
                                      np.asarray(getattr(jsched, f.name)), err_msg=f.name)


def test_load_yaml_config(tmp_path):
    p = tmp_path / "c.yaml"
    p.write_text("data:\n  dataset_type: cached_threedfront\n  n: 3\n")
    assert factory.load_yaml_config(str(p)) == jax_factory.load_yaml_config(str(p)) == {
        "data": {"dataset_type": "cached_threedfront", "n": 3}}


def test_spaced_factory_schedule_matches_spaced_schedule():
    _, sched = factory.create_model_and_diffusion(
        "proxd", config.DiffusionConfig(steps=50, timestep_respacing="ddim5"))
    ref = spaced_schedule("cosine", 50, "ddim5")
    assert torch.equal(sched.timestep_map, ref.timestep_map)
    assert sched.timestep_map.tolist() == np.asarray(
        jax_spaced_schedule("cosine", 50, "ddim5").timestep_map).tolist()

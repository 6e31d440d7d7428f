"""The port's optimizer, checkpoints, trainer and ``train_sdm`` CLI.

AdamW against ``optax.adamw`` on identical gradients (also with the
learning-rate anneal and the EMA), both starting from the same moments
through ``weights.load_adamw_state_from_optax``; the ``.pt`` checkpoint
read back by the JAX package's ``load_torch_checkpoint`` and by
``--load_ckpt``; the CLI on a tiny synthetic split, its ``final.pt`` in the
port's ``test_sdm``; ``--mesh 2x1`` as one command (two CPU gloo ranks)
against the same run in one process; and a tiny overfit.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lsdm_tpu.config import SDMConfig
from lsdm_tpu.models.sdm import SceneDiffusionModel as JaxSDM
from lsdm_tpu.train.checkpoint import load_torch_checkpoint as jax_load_torch_checkpoint
from lsdm_tpu.train.state import make_optimizer as jax_make_optimizer
from lsdm_tpu.train.state import update_ema as jax_update_ema
from lsdm_tpu_torch.config import SDMConfig as PortConfig
from lsdm_tpu_torch.data.synthetic import generate
from lsdm_tpu_torch.diffusion.schedule import make_schedule
from lsdm_tpu_torch.models.sdm import SceneDiffusionModel
from lsdm_tpu_torch.run import test_sdm, train_sdm
from lsdm_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from lsdm_tpu_torch.train.state import apply_gradients, create_train_state
from lsdm_tpu_torch.train.trainer import make_train_step
from lsdm_tpu_torch.weights import (
    init_weights, load_adamw_state_from_optax, params_from_jax, state_dict_from_jax)

TINY_KW = dict(clip_dim=32, latent_dim=16, cat_emb=8, n_head=4, vert_dims=24,
               pcd_points=32)


def _tiny_jax_params(seed):
    cfg = SDMConfig(**TINY_KW)
    B, N = 1, cfg.pcd_points
    shapes = jax.eval_shape(
        JaxSDM(cfg).init, jax.random.PRNGKey(0), jnp.zeros((B, N, 3)),
        jnp.zeros((B, 9)), jnp.zeros((B,), jnp.int32), jnp.zeros((B, 9, N, 3)),
        jnp.zeros((B, 9, 13)), jnp.zeros((B, cfg.clip_dim)))
    rs = np.random.RandomState(seed)
    draw = lambda a: (rs.randn(*a.shape) * 0.1).astype(np.float32)
    return jax.tree.map(draw, shapes["params"]), jax.tree.map(
        lambda a: (rs.rand(*a.shape) + 0.5).astype(np.float32), shapes["batch_stats"])


@pytest.mark.parametrize("anneal,ema", [(0, 0.0), (5, 0.9)])
def test_adamw_matches_optax(anneal, ema):
    """Three updates on the same gradient sets, from the same non-zero
    moments: the parameters within 1e-6 after each (and the EMA)."""
    params, stats = _tiny_jax_params(0)
    rs = np.random.RandomState(1)
    draw = lambda: jax.tree.map(lambda a: (rs.randn(*a.shape) * 0.01).astype(np.float32),
                                params)
    mu, nu = draw(), jax.tree.map(np.abs, draw())
    tx = jax_make_optimizer(lr=1e-3, weight_decay=0.01, lr_anneal_steps=anneal)
    opt_state = tx.init(params)
    opt_state = (opt_state[0]._replace(count=jnp.asarray(2, jnp.int32), mu=mu, nu=nu),
                 *opt_state[1:])
    jparams, jema = params, params

    model = SceneDiffusionModel(PortConfig(**TINY_KW))
    model.load_state_dict(state_dict_from_jax(params, stats))
    state = create_train_state(model, lr=1e-3, weight_decay=0.01,
                               lr_anneal_steps=anneal, ema=ema > 0)
    load_adamw_state_from_optax(state.optimizer, model, mu, nu, 2)
    for _ in range(3):
        grads = draw()
        updates, opt_state = tx.update(grads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        if ema:
            jema = jax_update_ema(jema, jparams, ema)
        for name, g in params_from_jax(grads).items():
            dict(model.named_parameters())[name].grad = g.reshape(
                dict(model.named_parameters())[name].shape)
        apply_gradients(state, ema)
        want = params_from_jax(jax.tree.map(np.asarray, jparams))
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].reshape(p.shape),
                                       atol=1e-6, rtol=0, err_msg=name)
        if ema:
            want = params_from_jax(jax.tree.map(np.asarray, jema))
            for name, e in state.ema_params.items():
                np.testing.assert_allclose(e.numpy(), want[name].reshape(e.shape),
                                           atol=1e-6, rtol=0, err_msg=f"ema {name}")


def test_zero_gradient_parameters_still_decay():
    """optax decays every parameter; torch would skip those without .grad
    (attn_layer's value projection never reaches the loss)."""
    model = init_weights(SceneDiffusionModel(PortConfig(**TINY_KW)), 0)
    state = create_train_state(model, lr=1e-2, weight_decay=0.5)
    w = model.attn_layer.v_proj_weight
    before = w.detach().clone()
    apply_gradients(state)
    torch.testing.assert_close(w.detach(), before * (1 - 1e-2 * 0.5))


class _Params(torch.nn.Module):
    """A few parameters, as the JAX optimizer tests' dict of arrays."""

    def __init__(self, tree):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(np.array(tree["w"])))
        self.b = torch.nn.Parameter(torch.from_numpy(np.array(tree["b"])))


def _set_grads(model, tree):
    model.w.grad = torch.from_numpy(np.array(tree["w"]))
    model.b.grad = torch.from_numpy(np.array(tree["b"]))


def test_skip_nonfinite_skips_a_nan_step_then_applies():
    """As tests/test_checkpoint.py:111-126: a NaN step changes nothing, not
    the parameters, AdamW's moments or the update count; the next finite one
    applies.  The train step still advances."""
    model = _Params({"w": np.ones((3, 2), np.float32), "b": np.ones(2, np.float32)})
    state = create_train_state(model, skip_nonfinite=True)
    _set_grads(model, {"w": np.full((3, 2), np.nan, np.float32), "b": np.ones(2, np.float32)})
    apply_gradients(state)
    assert torch.equal(model.w.detach(), torch.ones(3, 2)) and not state.optimizer.state
    assert (state.step, state.updates, state.optimizer.notfinite_count) == (1, 0, 1)
    # the counts travel with the optimizer's state_dict (the checkpoints)
    again = create_train_state(_Params({"w": np.ones((3, 2), np.float32),
                                        "b": np.ones(2, np.float32)}), skip_nonfinite=True)
    again.optimizer.load_state_dict(state.optimizer.state_dict())
    assert (again.optimizer.notfinite_count, again.optimizer.total_notfinite) == (1, 1)
    _set_grads(model, {"w": np.ones((3, 2), np.float32), "b": np.ones(2, np.float32)})
    apply_gradients(state)
    assert not torch.allclose(model.w.detach(), torch.ones(3, 2))
    assert (state.step, state.updates, state.optimizer.notfinite_count) == (2, 1, 0)
    assert state.optimizer.total_notfinite == 1


def test_skip_nonfinite_gives_up_after_100_in_a_row():
    """optax's ``max_consecutive_errors=100``: 100 consecutive non-finite
    steps are skipped, the 101st is applied (and poisons the parameters),
    as ``notfinite_count > max_consecutive_errors`` has it."""
    model = _Params({"w": np.ones((1, 2), np.float32), "b": np.ones(2, np.float32)})
    state = create_train_state(model, skip_nonfinite=True)
    bad = {"w": np.array([[np.inf, 1.0]], np.float32), "b": np.ones(2, np.float32)}
    for _ in range(100):
        _set_grads(model, bad)
        apply_gradients(state)
    assert torch.equal(model.w.detach(), torch.ones(1, 2)) and state.updates == 0
    _set_grads(model, bad)
    apply_gradients(state)
    assert state.updates == 1 and not torch.isfinite(model.w).all()


def test_skipped_step_does_not_advance_the_anneal():
    """The learning-rate anneal reads the count of updates applied, optax's
    inner count, which a skipped step leaves alone."""
    from lsdm_tpu_torch.train.state import lr_at

    model = _Params({"w": np.ones((1, 2), np.float32), "b": np.ones(2, np.float32)})
    state = create_train_state(model, lr=1.0, lr_anneal_steps=4, skip_nonfinite=True)
    rates = []
    for g in (1.0, np.nan, np.nan, 1.0):
        rates.append(lr_at(state))
        _set_grads(model, {"w": np.full((1, 2), g, np.float32), "b": np.ones(2, np.float32)})
        apply_gradients(state)
    assert rates == [1.0, 0.75, 0.75, 0.75] and lr_at(state) == 0.5
    assert (state.step, state.updates) == (4, 2)


def test_skip_nonfinite_matches_optax():
    """A sequence of finite, NaN, finite, infinite and finite gradients over
    a few parameters, with weight decay and a learning-rate anneal: the
    parameters after each step equal optax's ``apply_if_finite(adamw)`` to
    float32 tolerance."""
    rs = np.random.RandomState(4)
    params = {"w": rs.randn(3, 2).astype(np.float32), "b": rs.randn(2).astype(np.float32)}
    tx = jax_make_optimizer(lr=1e-2, weight_decay=0.1, lr_anneal_steps=6,
                            skip_nonfinite=True)
    opt_state = tx.init(params)
    jparams = params
    model = _Params(params)
    state = create_train_state(model, lr=1e-2, weight_decay=0.1, lr_anneal_steps=6,
                               skip_nonfinite=True)
    for bad in (None, np.nan, None, np.inf, None, None):
        grads = {k: rs.randn(*v.shape).astype(np.float32) for k, v in params.items()}
        if bad is not None:
            grads["b"][1] = bad
        updates, opt_state = tx.update(grads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        _set_grads(model, grads)
        apply_gradients(state)
        for k in ("w", "b"):
            np.testing.assert_allclose(getattr(model, k).detach().numpy(),
                                       np.asarray(jparams[k]), rtol=0, atol=1e-6,
                                       err_msg=f"{k} after a {bad} step")
    assert (state.step, state.updates) == (6, 4)


def _batch(cfg, B, seed):
    g = torch.Generator().manual_seed(seed)
    O, N = cfg.max_objs, cfg.pcd_points
    mask = torch.zeros(B, O)
    mask[:, 1:4] = 1.0
    cats = torch.nn.functional.one_hot(torch.randint(0, 13, (B, O), generator=g), 13)
    return (mask, 0.3 * torch.randn(B, O, N, 3, generator=g), cats.float(),
            0.2 * torch.randn(B, N, 3, generator=g) + 0.3,
            torch.nn.functional.one_hot(torch.tensor([2, 5]), 13).float(),
            torch.randn(B, cfg.clip_dim, generator=g))


def test_checkpoint_round_trip(tmp_path):
    """A port .pt read by the JAX package's load_torch_checkpoint gives the
    tree the port's weights came from; load_checkpoint resumes the same
    parameters, optimizer moments, step and EMA."""
    cfg = PortConfig(**TINY_KW)
    params, stats = _tiny_jax_params(3)
    model = SceneDiffusionModel(cfg)
    model.load_state_dict(state_dict_from_jax(params, stats))
    state = create_train_state(model, ema=True)
    step = make_train_step(make_schedule("cosine", 8), ema_rate=0.9)
    step(state, *_batch(cfg, 2, 0), generator=torch.Generator().manual_seed(0))
    path = str(tmp_path / "ckpt.pt")
    save_checkpoint(path, state, {"epoch": 3, "train_loss": 0.5})
    assert json.load(open(path + ".json")) == {"epoch": 3, "train_loss": 0.5}

    jparams, jstats, extra = jax_load_torch_checkpoint(path)
    assert extra["epoch"] == 3
    back = state_dict_from_jax(jparams, jstats)
    for name, t in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        torch.testing.assert_close(back[name], t, atol=0, rtol=0, msg=name)

    fresh = create_train_state(init_weights(SceneDiffusionModel(cfg), 9), ema=True)
    assert load_checkpoint(path, fresh) == {"epoch": 3, "train_loss": 0.5}
    assert fresh.step == state.step == 1
    for (n, a), b in zip(model.named_parameters(), fresh.model.parameters()):
        torch.testing.assert_close(a, b, atol=0, rtol=0, msg=n)
        sa, sb = state.optimizer.state[a], fresh.optimizer.state[b]
        for k in ("exp_avg", "exp_avg_sq", "step"):
            torch.testing.assert_close(sa[k], sb[k], atol=0, rtol=0, msg=f"{n} {k}")
        torch.testing.assert_close(state.ema_params[n], fresh.ema_params[n])


def test_tiny_model_overfits_one_batch():
    """As the JAX package's tests/test_train_convergence.py: a tiny SDM
    fits one fixed batch within a few dozen steps.  From the port's seeded
    init (torch's default scales, not flax's) the loss levels off near 0.6
    of its start by 60-120 steps, with fresh t and noise every step; JAX's
    test asks for half from its own init."""
    cfg = PortConfig(**TINY_KW)
    torch.manual_seed(0)
    model = init_weights(SceneDiffusionModel(cfg), 0)
    state = create_train_state(model, lr=3e-3)
    step = make_train_step(make_schedule("cosine", 16))
    batch = _batch(cfg, 2, 1)
    gen = torch.Generator().manual_seed(1)
    losses = [float(step(state, *batch, generator=gen)["loss"]) for _ in range(60)]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < 0.7 * np.mean(losses[:5]), losses


def test_train_cli_on_cpu(tmp_path):
    """The synthetic split at 32 points, T=4, one epoch with validation:
    checkpoints, sidecars and logs; --load_ckpt resumes; final.pt loads
    into the port's test_sdm."""
    root = str(tmp_path)
    train = generate(root, "proxd", n_scenes=1, n_seqs=4, pnt_size=32, split="train")
    valid = generate(root, "proxd", n_scenes=1, n_seqs=2, pnt_size=32, seed=1,
                     split="valid")
    out = os.path.join(root, "out")
    common = ["--train_data_dir", train, "--valid_data_dir", valid,
              "--objs_data_dir", os.path.join(root, "objs"), "--pcd_points", "32",
              "--diffusion_steps", "4", "--epochs", "1", "--eval_every", "1",
              "--batch_size", "2", "--device", "cpu"]
    state = train_sdm.main(common + ["--save_dir", out])
    assert state.step == 2
    names = sorted(os.listdir(out))
    for ckpt in ("best_model_cfd", "best_model_train_loss", "epoch_0000", "final"):
        assert f"{ckpt}.pt" in names and f"{ckpt}.pt.json" in names
    with open(os.path.join(out, "logs", "events.jsonl")) as f:
        keys = {k for line in f for k in json.loads(line) if "/" in k}
    assert {"train/loss", "train/grad_norm", "valid/cfd", "valid/acc"} <= keys

    resumed = train_sdm.main(common + ["--save_dir", os.path.join(root, "out2"),
                                       "--load_ckpt", os.path.join(out, "final.pt")])
    assert resumed.step == 4

    final = test_sdm.main([generate(root, "proxd", n_scenes=1, n_seqs=2, pnt_size=32,
                                    seed=2, split="test"),
                           "--objs_data_dir", os.path.join(root, "objs"),
                           "--load_model", os.path.join(out, "final.pt"),
                           "--output_dir", os.path.join(root, "test_out"),
                           "--pcd_points", "32", "--diffusion_steps", "4",
                           "--device", "cpu"])
    assert np.isfinite(final["cfd"])


@pytest.mark.parametrize("flag", [["--steps_per_dispatch", "4"],
                                  ["--sa_hoist"], ["--gather_bwd", "matmul"],
                                  ["--platform", "cpu"]])
def test_train_cli_refuses_what_is_not_ported(flag):
    with pytest.raises(SystemExit, match="not ported"):
        train_sdm.main(["--train_data_dir", "unused", "--device", "cpu", *flag])


@pytest.mark.parametrize("flag", [["--fps_batched"], ["--bn_dtype", "float32"],
                                  ["--dtype", "bfloat16"], ["--bn_dtype", "bfloat16"],
                                  ["--mesh", "2x1"]])
def test_train_cli_takes_jax_flags_it_runs_as_is(tmp_path, flag):
    # past the flag checks, the run stops at the missing split
    with pytest.raises(FileNotFoundError):
        train_sdm.main(["--train_data_dir", str(tmp_path / "none"), "--device", "cpu",
                        "--save_dir", str(tmp_path / "out"), *flag])


def test_train_cli_mesh_equals_single_process(tmp_path):
    """``train_sdm --mesh 2x1`` as one command on the CPU (two gloo ranks
    started by the CLI) against the same run in one process: the same
    per-epoch losses; the first rank alone writes the checkpoints."""
    root = str(tmp_path)
    train = generate(root, "proxd", n_scenes=1, n_seqs=4, pnt_size=32, split="train")
    common = ["--train_data_dir", train, "--objs_data_dir", os.path.join(root, "objs"),
              "--pcd_points", "32", "--diffusion_steps", "4", "--epochs", "1",
              "--batch_size", "2", "--device", "cpu"]
    logs = {}
    for name, extra in (("single", []), ("mesh", ["--mesh", "2x1"])):
        out = os.path.join(root, name)
        train_sdm.main(common + ["--save_dir", out] + extra)
        assert "final.pt" in os.listdir(out)
        with open(os.path.join(out, "logs", "events.jsonl")) as f:
            logs[name] = {k: v for line in f for k, v in json.loads(line).items()
                          if k.startswith("train/") and k != "train/epoch_seconds"}
    assert sorted(logs["mesh"]) == sorted(logs["single"])
    for k, v in logs["single"].items():
        np.testing.assert_allclose(logs["mesh"][k], v, rtol=1e-5, err_msg=k)


def test_train_cli_in_bf16_on_cpu(tmp_path):
    """``--dtype bfloat16 --bn_dtype bfloat16`` on the synthetic split at 32
    points, one epoch with validation (the composed sampler of the bf16
    model): a finite loss, and ``final.pt`` loads into a float32 model."""
    from lsdm_tpu_torch.checkpoint import load_torch_checkpoint

    root = str(tmp_path)
    train = generate(root, "proxd", n_scenes=1, n_seqs=4, pnt_size=32, split="train")
    valid = generate(root, "proxd", n_scenes=1, n_seqs=2, pnt_size=32, seed=1,
                     split="valid")
    out = os.path.join(root, "out")
    state = train_sdm.main(["--train_data_dir", train, "--valid_data_dir", valid,
                            "--objs_data_dir", os.path.join(root, "objs"),
                            "--pcd_points", "32", "--diffusion_steps", "4",
                            "--epochs", "1", "--eval_every", "1", "--batch_size", "2",
                            "--device", "cpu", "--dtype", "bfloat16",
                            "--bn_dtype", "bfloat16", "--save_dir", out])
    assert state.model.cfg.dtype == state.model.cfg.bn_dtype == "bfloat16"
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    with open(os.path.join(out, "logs", "events.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    assert all(np.isfinite(e["train/loss"]) for e in logged if "train/loss" in e)
    assert any(np.isfinite(e["valid/cfd"]) for e in logged if "valid/cfd" in e)
    back = SceneDiffusionModel(dataclasses.replace(state.model.cfg, dtype="float32",
                                                   bn_dtype="float32"))
    load_torch_checkpoint(os.path.join(out, "final.pt"), back)
    for name, t in state.model.state_dict().items():
        torch.testing.assert_close(back.state_dict()[name], t, atol=0, rtol=0, msg=name)


@pytest.mark.parametrize("fused_step", ["chain", "step"])
@pytest.mark.parametrize("ball_impl", ["pallas", "fused"])
def test_sample_sdm_refuses_bf16_on_the_fused_kernels(fused_step, ball_impl,
                                                      monkeypatch):
    """A bf16 model reaches K6 or K9 (and, with ``ball_impl="fused"``, K7
    and K8), whose bf16 modes are ported: ``sample_sdm`` no longer refuses
    it, and each of those kernels is called in its bf16 mode, never in
    float32.  The fourth case is the fused encode with the composed loop.
    (The bf16 results are held to JAX in ``tests/test_torch_fused_bf16.py``.)"""
    from lsdm_tpu_torch.models import pointnet2, sampling
    from lsdm_tpu_torch.models.sampling import sample_sdm

    cfg = PortConfig(**TINY_KW, dtype="bfloat16", ball_impl=ball_impl)
    model = init_weights(SceneDiffusionModel(cfg), 0).eval()
    mask, objs, cats, _, _, text = _batch(cfg, 2, 0)
    step = None if ball_impl == "fused" and fused_step == "step" else fused_step
    modes = []
    for mod, name in ((pointnet2, "sa_stage_fused_kernel"),
                      (pointnet2, "fp_stage_fused_kernel"),
                      (sampling, "fused_denoise_chain"),
                      (sampling, "make_denoise_step_loop")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name, **k: (
            modes.append((_n, k.get("compute_dtype", a[-1]))), _fn(*a, **k))[1])
    sample, last = sample_sdm(model, make_schedule("cosine", 2), mask, objs, cats,
                              text, fused_step=step)
    assert sample.shape == (2, cfg.pcd_points, 3) and sample.dtype == torch.float32
    assert torch.isfinite(sample).all() and torch.isfinite(last.x0).all()
    called = {n for n, _ in modes}
    assert {dt for _, dt in modes} == {torch.bfloat16}
    want = {"fused_denoise_chain"} if step == "chain" else (
        {"make_denoise_step_loop"} if step == "step" else set())
    if ball_impl == "fused":
        want |= {"sa_stage_fused_kernel", "fp_stage_fused_kernel"}
    assert called == want


def test_train_cli_refuses_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(SystemExit, match="--device cpu"):
        train_sdm.main(["--train_data_dir", "unused"])


def test_train_resolvers_follow_the_device():
    from lsdm_tpu_torch.models.sampling import resolve_train_attn_impl

    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert resolve_train_attn_impl("auto", cuda) == "pallas"
    assert resolve_train_attn_impl("auto", cpu) == "xla"
    assert resolve_train_attn_impl("pallas", cpu) == "pallas"

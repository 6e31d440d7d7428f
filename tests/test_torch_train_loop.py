"""The port's optimizer, checkpoints, trainer and ``train_sdm`` CLI.

AdamW against ``optax.adamw`` on identical gradients (also with the
learning-rate anneal and the EMA), both starting from the same moments
through ``weights.load_adamw_state_from_optax``; the ``.pt`` checkpoint
read back by the JAX package's ``load_torch_checkpoint`` and by
``--load_ckpt``; the CLI on a tiny synthetic split, its ``final.pt`` in the
port's ``test_sdm``; and a tiny overfit.
"""

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


@pytest.mark.parametrize("flag", [["--mesh", "4x2"], ["--steps_per_dispatch", "4"],
                                  ["--sa_hoist"], ["--gather_bwd", "matmul"],
                                  ["--dtype", "bfloat16"]])
def test_train_cli_refuses_what_is_not_ported(flag):
    with pytest.raises(SystemExit, match="not ported"):
        train_sdm.main(["--train_data_dir", "unused", "--device", "cpu", *flag])


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

"""The port's train-mode model against the JAX package.

The train-mode PointNet++ backbone (flax BatchNorm statistics, dropout,
the ``pallas`` and ``sg`` SA paths, the FP distance recompute and its
``N % 8`` gate) and one whole train graph (``training_losses`` through
``SceneDiffusionModel`` in training mode) against JAX's ``train=True``
with ``mutable=["batch_stats"]``: outputs, every parameter gradient and
the updated statistics.  Weights cross through ``state_dict_from_jax``;
inputs, timesteps, noise and the dropout keep-mask come from numpy (the
test patches ``flax.linen.Dropout.__call__`` on the JAX side to apply the
same mask).  JAX runs its Pallas kernels in interpret mode under
``jax.default_matmul_precision("highest")``; the port its plain versions.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsdm_tpu.config import SDMConfig
from lsdm_tpu.diffusion import make_schedule as jax_make_schedule
from lsdm_tpu.diffusion import training_losses as jax_training_losses
from lsdm_tpu.models.pointnet2 import PointNet2Backbone as JaxBackbone
from lsdm_tpu.models.sdm import SceneDiffusionModel as JaxSDM
from lsdm_tpu.train.checkpoint import convert_torch_state_dict
from lsdm_tpu_torch.config import SDMConfig as PortConfig
from lsdm_tpu_torch.diffusion.gaussian import training_losses
from lsdm_tpu_torch.diffusion.schedule import make_schedule
from lsdm_tpu_torch.models import pointnet2
from lsdm_tpu_torch.models.sdm import SceneDiffusionModel
from lsdm_tpu_torch.weights import (
    init_weights, params_from_jax, state_dict_from_jax)

TINY_KW = dict(clip_dim=32, latent_dim=16, cat_emb=8, n_head=4, vert_dims=24,
               pcd_points=32)


def _a(rs, *shape, scale=1.0):
    return (rs.randn(*shape) * scale).astype(np.float32)


def _jax_variables(port_model, seed, prefix=""):
    """Seeded weights at the scale of the reference init (the port's
    ``init_weights``, U(+-1/sqrt(fan_in)) with random running statistics),
    carried to the JAX tree by the JAX package's own converter.  (Weights
    far off that scale saturate the sigmoid and GELU layers and leave the
    backbone gradients at rounding level.)"""
    init_weights(port_model, seed)
    rs = np.random.RandomState(seed)
    with torch.no_grad():
        for m in port_model.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.copy_(torch.from_numpy(_a(rs, *m.running_mean.shape, scale=0.1)))
                m.running_var.copy_(torch.from_numpy(
                    (rs.rand(*m.running_var.shape) + 0.5).astype(np.float32)))
    params, stats = convert_torch_state_dict(
        {prefix + k: v.numpy() for k, v in port_model.state_dict().items()})
    if prefix:
        params, stats = params[prefix[:-1]], stats[prefix[:-1]]
    return {"params": params, "batch_stats": stats}


@pytest.fixture
def keep_mask(monkeypatch):
    """Make flax's Dropout apply given keep-masks: returns a setter that
    takes one mask, applied by every call, or a list, one mask a call in
    call order (DGCNN's head drops out twice).  A Dropout of rate 0 (the
    STGCN blocks') passes its input through, as flax's does."""
    box = {}

    def call(self, inputs, deterministic=None, rng=None):
        if (self.rate == 0.0 or deterministic
                or (deterministic is None and self.deterministic)):
            return inputs
        mask = box["mask"]
        if isinstance(mask, list):
            mask = box["calls"][box["n"] % len(mask)]
            box["n"] += 1
        assert mask.shape == inputs.shape
        return jnp.where(mask, inputs / (1.0 - self.rate), 0.0)

    def set_mask(m):
        box.update(mask=m, calls=m, n=0)

    monkeypatch.setattr(fnn.Dropout, "__call__", call)
    return set_mask


def _check_grads(got, want, what):
    """The JAX package's bound for this graph (tests/test_pallas_kernels.py:
    238-293): atol 1e-4 * max|g| per leaf, rtol 1e-3."""
    assert sorted(got) == sorted(want), what
    bad = []
    for name, w in want.items():
        scale = max(float(w.abs().max()), 1e-3)
        if not torch.allclose(got[name], w, atol=1e-4 * scale, rtol=1e-3):
            bad.append(f"{name} (max |g| {float(w.abs().max()):.3g}, max |diff| "
                       f"{float((got[name] - w).abs().max()):.3g})")
    assert not bad, f"{what}: " + "; ".join(bad)


# Under jax.jit on the CPU, JAX's gradient of a PointNet++ SA stage (the max
# over K after a train-mode BatchNorm and ReLU) departs from its eager
# gradient, and the eager one agrees with finite differences and with the
# port (ROADMAP.md queue 3).  So the stage and backbone tests take JAX's
# gradient eagerly, and the jitted whole-graph test leaves the SA leaves to
# them.
SA_LEAVES = "pcd_backbone.sa"


def _check_stats(port_sd, jax_sd):
    for name, w in jax_sd.items():
        if name.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(port_sd[name], w, rtol=1e-5, atol=1e-6,
                                       msg=lambda m: f"{name}: {m}")


# --- stages and backbone ----------------------------------------------------
#
# Both sides compute in float64 (JAX under ``enable_x64`` with
# ``dtype=bn_dtype=float64``; its Pallas kernels still round their
# distances to float32).  In float32, flax's fast variance
# E[x^2] - E[x]^2 loses digits to cancellation: at these shapes JAX's
# float32 backbone output lies ~60x further from the float64 value than the
# port's (2.8e-3 against 4.3e-4 at the output), so a float32 comparison
# would measure JAX's rounding.

def _grid(a):
    """Points on a 1/256 grid: their squared distances are exact in float32
    and float64 alike, so JAX's float32 selection kernels and the port's
    float64 plain versions select the same points."""
    return (np.round(a * 256) / 256).astype(np.float32)


def _stage_case(kind, rs, B=3):
    """(port module, JAX module, args as numpy, name) of one stage."""
    from lsdm_tpu.models.pointnet2 import (
        PointNetFeaturePropagation as JFP, PointNetSetAbstraction as JSA)

    f64 = dict(dtype=jnp.float64, bn_dtype=jnp.float64)
    if kind.startswith("sa"):
        impl, S = {"sa_pallas": ("pallas", 8), "sa_sg": ("sg", 8),
                   "sa_sg_declines": ("sg", 4)}[kind]
        port = pointnet2.PointNetSetAbstraction(S, 0.4, 16, 6 + 3, (16, 32), impl=impl)
        jax_mod = JSA(S, 0.4, 16, (16, 32), ball_impl=impl, **f64)
        return port, jax_mod, (_grid(_a(rs, B, 32, 3, scale=0.3)), _a(rs, B, 32, 6))
    N, S = {"fp_kernel": (16, 8), "fp_composed": (12, 8), "fp_one_source": (8, 1)}[kind]
    port = pointnet2.PointNetFeaturePropagation(5 + 7, (16, 8))
    jax_mod = JFP((16, 8), nn_impl="pallas", **f64)
    return port, jax_mod, (_grid(_a(rs, B, N, 3, scale=0.3)),
                           _grid(_a(rs, B, S, 3, scale=0.3)), _a(rs, B, N, 5),
                           _a(rs, B, S, 7))


@pytest.mark.parametrize("kind", ["sa_pallas", "sa_sg", "sa_sg_declines",
                                  "fp_kernel", "fp_composed", "fp_one_source"])
def test_train_stage_matches_jax(kind):
    """One train-mode stage: output, every parameter gradient, the input
    features' gradients and the updated statistics.  ``sa_sg_declines``
    (S % 8 != 0) and ``fp_composed`` (N % 8 != 0) take the composed
    branches of the JAX gates; ``fp_kernel`` recomputes its distances at
    the K2 indices."""
    rs = np.random.RandomState(len(kind))
    port, jax_mod, args = _stage_case(kind, rs)
    init_weights(port, 2)
    name = "sa1" if kind.startswith("sa") else "fp1"  # the converter's names
    variables = jax.tree.map(np.asarray, convert_torch_state_dict(
        {f"pcd_backbone.{name}.{k}": v.numpy() for k, v in port.state_dict().items()}))
    params = variables[0]["pcd_backbone"][name]
    stats = variables[1]["pcd_backbone"][name]
    feat = len(args) - 1  # the features that carry gradients: the last argument(s)
    grad_args = (feat - 1, feat) if kind.startswith("fp") else (feat,)
    with jax.enable_x64(True):
        J = [jnp.asarray(a, jnp.float64) for a in args]
        out_j0 = jax_mod.apply({"params": params, "batch_stats": stats}, *J, True,
                               mutable=["batch_stats"])[0]
        cot = _a(rs, *np.shape(out_j0[1] if kind.startswith("sa") else out_j0))

        def loss(p, *feats):
            a = list(J)
            for i, f in zip(grad_args, feats):
                a[i] = f
            out, mut = jax_mod.apply({"params": p, "batch_stats": stats}, *a, True,
                                     mutable=["batch_stats"])
            out = out[1] if kind.startswith("sa") else out
            return jnp.sum(out * cot), (out, mut["batch_stats"])

        (_, (out_j, stats_j)), grads = jax.value_and_grad(
            loss, argnums=tuple(range(1 + len(grad_args))), has_aux=True)(
                params, *(J[i] for i in grad_args))
    port.double().train()
    T = [torch.from_numpy(a).double() for a in args]
    for i in grad_args:
        T[i].requires_grad_()
    out = port(*T)
    out = out[1] if kind.startswith("sa") else out
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), atol=1e-6,
                               rtol=1e-6)
    want = {k[len(f"pcd_backbone.{name}."):]: v for k, v in params_from_jax(
        {"pcd_backbone": {name: jax.tree.map(lambda a: np.asarray(a, np.float32),
                                              grads[0])}}).items()}
    _check_grads({n: p.grad.float() for n, p in port.named_parameters()}, want, kind)
    # the sg backward of JAX (onehot_segment_sum) rounds its cotangent to
    # bf16 before summing it into the features
    tol = 1e-2 if kind == "sa_sg" else 1e-6
    for i, g in zip(grad_args, grads[1:]):
        np.testing.assert_allclose(T[i].grad.numpy(), np.asarray(g), atol=tol,
                                   rtol=tol, err_msg=f"input {i}")
    for layer, bn in zip(("mlp_0", "mlp_1"), port.mlp_bns):
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   np.asarray(stats_j[layer]["bn"]["mean"]), rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   np.asarray(stats_j[layer]["bn"]["var"]), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("ball_impl", ["pallas", "sg"])
def test_train_backbone_matches_jax(ball_impl, keep_mask):
    """The whole train-mode backbone at the tiny model's stages (32, 8, 2,
    1: sa3/sa4 decline the sg kernel, fp4 has one source) with the head's
    dropout on a given keep-mask: output, statistics and every parameter
    gradient against JAX, whose gradient is taken eagerly (``SA_LEAVES``)."""
    rs = np.random.RandomState(len(ball_impl))
    B, N = 3, 32
    xyz = _grid(_a(rs, B, N, 3, scale=0.3))
    mask = rs.rand(B, N, 128) < 0.5
    keep_mask(jnp.asarray(mask))
    npoints = (32, 8, 2, 1)
    bb = pointnet2.PointNet2Backbone(sa_npoints=npoints, sa_nsample=32,
                                     ball_impl=ball_impl)
    variables = _jax_variables(bb, 1, prefix="pcd_backbone.")
    cot = _a(rs, B, N, 3)
    with jax.enable_x64(True):
        jb = JaxBackbone(sa_npoints=npoints, sa_nsample=32, ball_impl=ball_impl,
                         dtype=jnp.float64, bn_dtype=jnp.float64)
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)

        def loss(params):
            out, mut = jb.apply({"params": params, "batch_stats": v64["batch_stats"]},
                                jnp.asarray(xyz, jnp.float64), True,
                                mutable=["batch_stats"])
            return jnp.sum(out * cot), (out, mut["batch_stats"])

        (_, (out_j, stats_j)), grads_j = jax.value_and_grad(loss, has_aux=True)(
            v64["params"])
        out_j, grads_j, stats_j = (jax.tree.map(lambda a: np.asarray(a, np.float32), t)
                                   for t in (out_j, grads_j, stats_j))
    bb.double().train()
    x64, keep, c64 = (torch.from_numpy(xyz).double(), torch.from_numpy(mask),
                      torch.from_numpy(cot).double())
    out = bb(x64, dropout_mask=keep)
    (out * c64).sum().backward()
    # JAX's sg kernel accumulates its one-hot gather in float32
    # (preferred_element_type) also when it computes in float64, so the
    # gathered features carry float32 rounding into the later stages
    tol = 1e-4 if ball_impl == "sg" else 1e-5
    torch.testing.assert_close(out.detach().float(), torch.from_numpy(out_j),
                               atol=tol, rtol=tol)
    new = state_dict_from_jax({"pcd_backbone": variables["params"]},
                              {"pcd_backbone": stats_j})
    _check_stats({f"pcd_backbone.{k}": v.float() for k, v in bb.state_dict().items()}, new)
    want = {k[len("pcd_backbone."):]: v for k, v in params_from_jax(
        {"pcd_backbone": grads_j}).items()}
    if ball_impl == "sg":  # JAX's sg backward rounds its cotangents to bf16
        for name, w in want.items():
            torch.testing.assert_close(
                bb.get_parameter(name).grad.float(), w, rtol=1e-2,
                atol=1e-2 * max(float(w.abs().max()), 1e-3), msg=lambda m: f"{name}: {m}")
    else:
        _check_grads({n: p.grad.float() for n, p in bb.named_parameters()}, want,
                     "backbone")


def test_bn_train_is_flax_batchnorm():
    """Fast biased variance, momentum 0.9 on the biased variance; torch's
    own batch_norm would update with the unbiased one."""
    rs = np.random.RandomState(3)
    x = _a(rs, 4, 6, 5, scale=2.0) + 1.0
    bn = torch.nn.BatchNorm1d(5)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(_a(rs, 5)))
        bn.bias.copy_(torch.from_numpy(_a(rs, 5)))
    got = pointnet2.bn_train(bn, torch.from_numpy(x))
    fbn = fnn.BatchNorm(momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": bn.weight.detach().numpy(),
                            "bias": bn.bias.detach().numpy()},
                 "batch_stats": {"mean": np.zeros(5, np.float32),
                                 "var": np.ones(5, np.float32)}}
    want, mut = fbn.apply(variables, jnp.asarray(x), use_running_average=False,
                          mutable=["batch_stats"])
    torch.testing.assert_close(got.detach(), torch.from_numpy(np.asarray(want)),
                               atol=2e-6, rtol=1e-6)
    torch.testing.assert_close(bn.running_var, torch.from_numpy(
        np.asarray(mut["batch_stats"]["var"])), atol=0, rtol=1e-6)
    torch.testing.assert_close(bn.running_mean, torch.from_numpy(
        np.asarray(mut["batch_stats"]["mean"])), atol=1e-7, rtol=1e-6)


# --- the whole train graph ---------------------------------------------------

def _graph_inputs(cfg, B, seed):
    rs = np.random.RandomState(seed)
    O, N = cfg.max_objs, cfg.pcd_points
    mask = np.zeros((B, O), np.float32)
    mask[:, 1:4] = 1.0
    eye = np.eye(cfg.max_cats, dtype=np.float32)
    return dict(mask=mask, objs=_a(rs, B, O, N, 3, scale=0.3),
                cats=eye[rs.randint(0, 13, (B, O))],
                text=_a(rs, B, cfg.clip_dim),
                target=_a(rs, B, N, 3, scale=0.2),
                target_cat=eye[[2, 5][:B]], noise=_a(rs, B, N, 3),
                t=np.array([3, 11][:B], np.int32),
                keep=rs.rand(B * O, N, 128) < 0.5)


@pytest.mark.parametrize("attn_impl", ["pallas", "xla"])
def test_train_graph_matches_jax(attn_impl, keep_mask, monkeypatch):
    """One value_and_grad of the loss at the tiny config, B=2, T=16:
    ``ball_impl="pallas"`` (selection kernels, FP recompute) with the
    port's K4/K5 attention or its composed one, against JAX's composed
    attention (its K4/K5 pair is held to the port's in
    ``test_torch_train_kernels.py``; eagerly, in the Pallas interpreter,
    it would add a minute here).  Both sides compute in float64
    (JAX under ``enable_x64`` with ``dtype=bn_dtype=float64``; its Pallas
    kernels still round inside to float32, and both chamfers run in
    float32): in float32, flax's fast variance loses digits to cancellation
    and the cross-framework rounding of the 1e-5-scale gradients alone
    exceeds the bound.  The SA stages' gradients are left to
    ``test_train_backbone_matches_jax`` (``SA_LEAVES``).  Both chamfers
    take the direct form
    ``sum((x - y) ** 2)`` here (the loss's chamfer functions are held to
    each other on their own: ``test_torch_train_kernels.py``): the
    expansion form's float32 cancellation puts ~4% noise on the smallest
    gradients (``upsampling_layer.4``, 2e-5)."""
    import lsdm_tpu.diffusion.gaussian as jax_gaussian
    from lsdm_tpu_torch.diffusion import gaussian

    def direct(x, y):
        d = ((x[:, :, None] - y[:, None]) ** 2).sum(-1)
        return (d.min(2).values.mean(1) + d.min(1).values.mean(1)).mean()

    def direct_jax(x, y):
        d = jnp.sum((x[:, :, None] - y[:, None]) ** 2, -1)
        return jnp.mean(jnp.mean(jnp.min(d, 2), 1) + jnp.mean(jnp.min(d, 1), 1))

    monkeypatch.setattr(gaussian, "chamfer_distance", direct)
    monkeypatch.setattr(jax_gaussian, "chamfer_distance", direct_jax)
    cfg = SDMConfig(**TINY_KW, ball_impl="pallas", attn_impl="xla",
                    dtype=jnp.float64, bn_dtype=jnp.float64)
    x = _graph_inputs(cfg, 2, 7)
    keep_mask(jnp.asarray(x["keep"]))
    jmodel = JaxSDM(cfg)
    port = SceneDiffusionModel(PortConfig(**TINY_KW, ball_impl="pallas",
                                          attn_impl=attn_impl))
    variables = _jax_variables(port, 8)

    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        J = {k: jnp.asarray(v, jnp.float64 if v.dtype == np.float32 else None)
             for k, v in x.items()}

        def loss_fn(params):
            box = {}

            def model_fn(x_t, tt):
                out, mut = jmodel.apply(
                    {"params": params, "batch_stats": v64["batch_stats"]},
                    x_t, J["mask"], tt, J["objs"], J["cats"], J["text"], True,
                    mutable=["batch_stats"])
                box["stats"] = mut["batch_stats"]
                return out

            terms = jax_training_losses(jax_make_schedule("cosine", 16), model_fn,
                                        J["target"], J["t"], J["target_cat"],
                                        J["noise"])
            return terms["loss"], box["stats"]

        (loss_j, stats_j), grads_j = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(v64["params"])
        grads_j, stats_j = (jax.tree.map(lambda a: np.asarray(a, np.float32), t)
                            for t in (grads_j, stats_j))

    port.load_state_dict(state_dict_from_jax(variables["params"],
                                             variables["batch_stats"]))
    port.double().train()
    T = {k: torch.from_numpy(np.asarray(v)) for k, v in x.items()}
    T = {k: v.double() if v.dtype == torch.float32 else v for k, v in T.items()}

    def model_fn(x_t, tt):
        return port(x_t, T["mask"], tt, T["objs"], T["cats"], T["text"],
                    dropout_mask=T["keep"])

    loss = training_losses(make_schedule("cosine", 16), model_fn, T["target"],
                           T["t"].long(), T["target_cat"], T["noise"])["loss"]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    want = {n: g for n, g in params_from_jax(grads_j).items()
            if not n.startswith(SA_LEAVES)}
    got = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).float()
           for n, p in port.named_parameters() if n in want}
    _check_grads(got, want, "train graph")
    _check_stats({k: v.float() for k, v in port.state_dict().items()},
                 state_dict_from_jax(variables["params"], stats_j))


def test_category_loss_leaves_embed_text_alone():
    """The category head reads ``enc_text`` detached (JAX's stop_gradient,
    reference ``model/sdm.py:157``): the category loss alone gives
    ``embed_text`` a zero gradient, and ``predict_cat`` a non-zero one."""
    cfg = PortConfig(**TINY_KW)
    x = _graph_inputs(cfg, 2, 3)
    model = SceneDiffusionModel(cfg).train()
    T = {k: torch.from_numpy(np.asarray(v)) for k, v in x.items()}
    out = model(T["target"], T["mask"], T["t"].long(), T["objs"], T["cats"],
                T["text"], dropout_mask=T["keep"])
    log_probs = torch.log_softmax(out.cat[:, 0], dim=-1)
    (-log_probs.gather(1, T["target_cat"].argmax(1)[:, None]).mean()).backward()
    for name, p in model.named_parameters():
        if name.startswith("embed_text."):
            assert p.grad is None or not p.grad.any(), name
    assert model.predict_cat[0].weight.grad.abs().max() > 0


def test_dropout_draws_from_the_generator_and_drops_half():
    bb = pointnet2.PointNet2Backbone(sa_npoints=(32, 8, 2, 1), sa_nsample=32).train()
    xyz = torch.from_numpy(_a(np.random.RandomState(0), 2, 32, 3, scale=0.3))
    runs = [bb(xyz, generator=torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    with pytest.raises(ValueError, match="dropout mask"):
        bb(xyz, dropout_mask=torch.ones(2, 32, 3, dtype=torch.bool))
    bb.eval()
    assert torch.equal(bb(xyz), bb(xyz))


def test_sample_sdm_refuses_a_model_in_training_mode():
    """JAX samples with train=False; the port refuses a model left in
    training mode instead of sampling with batch statistics and dropout."""
    from lsdm_tpu_torch.models.sampling import sample_sdm

    cfg = PortConfig(**TINY_KW)
    x = _graph_inputs(cfg, 1, 0)
    args = [torch.from_numpy(x[k]) for k in ("mask", "objs", "cats", "text")]
    with pytest.raises(ValueError, match="eval"):
        sample_sdm(SceneDiffusionModel(cfg), make_schedule("cosine", 2), *args)

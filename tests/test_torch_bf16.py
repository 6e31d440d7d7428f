"""The port's bf16 compute against the JAX package at ``dtype=bfloat16``.

Every module that the bf16 train step runs, at the tiny configuration of
``tests/test_torch_train_model.py``: the compute-dtype Linear and the MLPs
(GELU, SiLU, sigmoid), both attentions (the 8-head ``attn_layer`` and the
rank-1 ``pcd_attention``, composed and through K4/K5's plain versions),
the POSA decoder, the train-mode PointNet++ backbone at ``bn_dtype``
float32 and bf16, the SDM forward and one ``value_and_grad`` of the train
loss, with ``attn_impl`` pallas and xla.  Weights cross through the JAX
package's converter; inputs, timesteps, noise and the dropout keep-mask come
from numpy seeds.  The JAX side runs with ``gather_bwd="matmul_fwd"`` (the
JAX train CLI's default, whose bf16 gather backward accumulates in
float32, as the port's does) and its Pallas kernels in interpret mode.

A forward must lie within 3e-2 x max(1, |JAX|) of JAX's bf16 result (the
JAX package's own bf16 bound, ``tests/test_pointcloud_ops.py:663``), and,
to show that bf16 is really computed, within half of JAX's own
bf16-to-float32 gap on the same inputs, both distances the mean absolute
difference: a port that stayed in float32 would sit a whole gap away,
while a bf16 rounding that flips between the two frameworks (a sum in
another order, torch's exp against XLA's) moves one entry by one bf16
step, which a maximum would weigh as much as the whole gap of a shallow
module.  Then the plain versions of K4's, K5's and
K10's bf16 modes against the JAX kernels at ``compute_dtype=bfloat16``:
K4 and K5 within the card's bound (one flipped bf16 rounding of a weight
moves it by 2^-8 of itself), K10 equal.
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
from lsdm_tpu.models.common import MLP as JaxMLP
from lsdm_tpu.models.common import TimestepEmbedder as JaxTimestepEmbedder
from lsdm_tpu.models.pointnet2 import PointNet2Backbone as JaxBackbone
from lsdm_tpu.models.posa import POSADecoderBackbone as JaxPOSA
from lsdm_tpu.models.sdm import SceneDiffusionModel as JaxSDM
from lsdm_tpu.ops.attention import TorchMultiheadAttention as JaxMHA
from lsdm_tpu.ops.attn_pallas import _rank1_mha_bwd_pallas, rank1_mha_pallas
from lsdm_tpu.ops.sg_fused_pallas import _sg_call
from lsdm_tpu.train.checkpoint import convert_torch_state_dict
from lsdm_tpu_torch.config import SDMConfig as PortConfig
from lsdm_tpu_torch.diffusion.gaussian import training_losses
from lsdm_tpu_torch.diffusion.schedule import make_schedule
from lsdm_tpu_torch.models import pointnet2
from lsdm_tpu_torch.models.sdm import SceneDiffusionModel
from lsdm_tpu_torch.ops import attn, sg_fused
from lsdm_tpu_torch.weights import init_weights, params_from_jax, state_dict_from_jax

TINY_KW = dict(clip_dim=32, latent_dim=16, cat_emb=8, n_head=4, vert_dims=24,
               pcd_points=32)
BF16 = jnp.bfloat16
FWD_RTOL = 3e-2
# JAX's gradient of a train-mode SA stage must be taken eagerly
# (tests/test_torch_train_model.py, ROADMAP.md queue 3): the jitted graph
# test leaves these leaves to the backbone test
SA_LEAVES = "pcd_backbone.sa"
# K4 and K5 bf16 against the JAX kernels in interpret mode: one weight's
# bf16 rounding flips between the two exponentials (2^-8 of the weight)
ATTN_BF16_ATOL = 2.0 ** -7


def _a(rs, *shape, scale=1.0):
    return (rs.randn(*shape) * scale).astype(np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _check_bf16(got, want, want_f32, what):
    """``got`` (the port, bf16) against JAX's bf16 ``want``: every entry
    within FWD_RTOL x max(1, |want|), and the mean absolute difference
    within half of the mean distance of ``want`` from JAX's float32 result
    ``want_f32``."""
    got, want, want_f32 = _np(got), _np(want), _np(want_f32)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= FWD_RTOL * max(1.0, float(np.abs(want).max())), (what, err)
    mean_err = float(np.abs(got - want).mean())
    gap = float(np.abs(want - want_f32).mean())
    assert gap > 0, f"{what}: JAX's bf16 result equals its float32 one"
    assert mean_err <= 0.5 * gap, (f"{what}: mean |port - JAX| {mean_err:.3g}, "
                                   f"mean bf16 gap {gap:.3g}")


def _strict(fn, *args):
    """``jax.jit(fn)(*args)`` compiled without XLA's excess precision
    (``xla_allow_excess_precision``, on by default, lets XLA keep float32
    where the program rounds to bf16): the JAX program's own bf16
    roundings, which eager execution also gives, at a compiled program's
    speed."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _model(seed=0, **kw):
    """A seeded port SDM (bf16) and its weights as the JAX tree, with random
    running statistics (the scale of ``test_torch_train_model``'s)."""
    port = SceneDiffusionModel(PortConfig(**TINY_KW, dtype="bfloat16", **kw))
    init_weights(port, seed)
    rs = np.random.RandomState(seed)
    with torch.no_grad():
        for m in port.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.copy_(torch.from_numpy(_a(rs, *m.running_mean.shape,
                                                         scale=0.1)))
                m.running_var.copy_(torch.from_numpy(
                    (rs.rand(*m.running_var.shape) + 0.5).astype(np.float32)))
    params, stats = convert_torch_state_dict(
        {k: v.numpy() for k, v in port.state_dict().items()})
    return port, {"params": params, "batch_stats": stats}


@pytest.fixture(scope="module")
def model():
    return _model()


@pytest.fixture
def keep_mask(monkeypatch):
    """Make flax's Dropout apply a given keep-mask: returns a setter."""
    box = {}

    def call(self, inputs, deterministic=None, rng=None):
        if deterministic or (deterministic is None and self.deterministic):
            return inputs
        return jnp.where(box["mask"], inputs / (1.0 - self.rate), 0.0)

    monkeypatch.setattr(fnn.Dropout, "__call__", call)
    return lambda m: box.__setitem__("mask", m)


def _both(mod_fn, variables, *args, **kw):
    """A JAX module's result at bf16 and at float32 on the same inputs."""
    return tuple(_strict(lambda v, *a: mod_fn(dt).apply(v, *a, **kw), variables, *args)
                 for dt in (BF16, jnp.float32))


# --- Linear and MLPs ----------------------------------------------------------

@pytest.mark.parametrize("name,act", [("embed_text", "gelu"),
                                      ("input_process.pose_embedding", "sigmoid"),
                                      ("embed_timestep", "silu")])
def test_mlp_matches_jax(model, name, act):
    """The compute-dtype Linear stacks with each activation: GELU in flax's
    bf16 erfc form, sigmoid, and the timestep embedder's SiLU."""
    port, v = model
    rs = np.random.RandomState(len(name))
    sub = port.get_submodule(name)
    path = name.split(".")
    tree = v["params"]
    for p in path:
        tree = tree[p]
    if name == "embed_timestep":
        t = np.array([0, 3, 17, 4000])
        pe = port.sequence_pos_encoder.pe
        got = sub(torch.from_numpy(t), pe)
        want, want32 = _both(lambda dt: JaxTimestepEmbedder(16, dtype=dt),
                             {"params": tree}, jnp.asarray(t))
    else:
        width = sub[0].in_features
        x = _a(rs, 5, 7, width)
        feats = tuple(m.out_features for m in sub if isinstance(m, torch.nn.Linear))
        got = sub(torch.from_numpy(x))
        want, want32 = _both(lambda dt: JaxMLP(feats, (act,) * len(feats), dtype=dt),
                             {"params": tree}, jnp.asarray(x))
    assert got.dtype == torch.bfloat16
    _check_bf16(got, want, want32, name)


# --- attention ------------------------------------------------------------------

@pytest.mark.parametrize("case", ["attn_layer", "pcd_attention", "pcd_attention_fused"])
def test_attention_matches_jax(model, case):
    """The 8-head-style ``attn_layer`` (4 heads here) with the additive
    mask, and the rank-1 ``pcd_attention`` composed and through the K4/K5
    pair's plain versions (``fused_train``), against JAX's module at bf16:
    the output, the head-averaged weights and, for the rank-1 pair, the
    input gradients."""
    port, v = model
    rs = np.random.RandomState(len(case))
    name = case.replace("_fused", "")
    sub = getattr(port, name)
    B = 2
    if name == "attn_layer":
        q, k, val = _a(rs, B, 1, 16), _a(rs, B, 9, 8), _a(rs, B, 9, 96)
        mask = np.zeros((B, 9), np.float32)
        mask[:, 1:4] = 1.0
        mask = np.tile(mask[:, None, :], (4, 1, 1))
        kw_j = dict(attn_mask=jnp.asarray(mask))
        kw_p = dict(attn_mask=torch.from_numpy(mask))
        dims = dict(embed_dim=16, num_heads=4, kdim=8, vdim=96)
    else:
        q, k, val = _a(rs, B, 32, 12), _a(rs, B, 32, 3), _a(rs, B, 32, 3)
        kw_j = dict(fused_train=case.endswith("fused"))
        kw_p = dict(fused_train=case.endswith("fused"))
        dims = dict(embed_dim=12, num_heads=12, kdim=3, vdim=3)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, val))
    out, weights = sub(tq, tk, tv, **kw_p)
    cot = _a(rs, *out.shape)

    def run(dt):
        mod = JaxMHA(**dims, dtype=dt)

        def f(*a):
            o, w = mod.apply({"params": v["params"][name]}, *a, **kw_j)
            return o, w

        def fwd_bwd(*a):
            (o, w), vjp = jax.vjp(f, *a)
            return o, w, vjp((cot.astype(o.dtype), None if w is None else jnp.zeros_like(w)))

        return _strict(fwd_bwd, *map(jnp.asarray, (q, k, val)))

    (o_b, w_b, g_b), (o_f, w_f, g_f) = run(BF16), run(jnp.float32)
    _check_bf16(out, o_b, o_f, f"{case} output")
    if weights is not None:
        _check_bf16(weights, w_b, w_f, f"{case} weights")
    if case.endswith("fused"):
        (out.float() * torch.from_numpy(cot)).sum().backward()
        for t, gb, gf, nm in zip((tq, tk, tv), g_b, g_f, "qkv"):
            _check_bf16(t.grad, gb, gf, f"{case} d{nm}")


# --- POSA ---------------------------------------------------------------------

def test_posa_decoder_matches_jax(model):
    """The human backbone: linears in bf16, GroupNorm promoted to float32."""
    port, v = model
    x = _a(np.random.RandomState(5), 2, 32, 3, scale=0.3)
    got = port.human_backbone(torch.from_numpy(x))
    want, want32 = _both(lambda dt: JaxPOSA(vert_dims=24, pcd_points=32, dtype=dt),
                         {"params": v["params"]["human_backbone"]}, jnp.asarray(x))
    assert got.dtype == torch.bfloat16
    _check_bf16(got, want, want32, "POSA")


# --- the train-mode backbone ------------------------------------------------------

def _grad_errors(got, want, want32):
    """Per leaf: ||port - JAX bf16|| / ||JAX bf16|| and ||JAX bf16 - JAX
    f32|| / ||JAX bf16|| (2-norms).  A conv bias ahead of a train-mode
    BatchNorm is left out: its gradient is zero in exact arithmetic
    (BatchNorm takes the batch mean away), rounding noise in both."""
    out = {}
    for name, w in want.items():
        if name.endswith("bias") and ("mlp_convs" in name or "conv1" in name):
            continue
        norm = max(float(w.norm()), 1e-30)
        out[name] = (float((got[name] - w).norm()) / norm,
                     float((want32[name] - w).norm()) / norm)
    return out


def _check_grads(errs, rtol, what):
    """Every leaf within ``rtol`` of JAX's bf16 gradient in relative
    2-norm, or, for a leaf whose bf16 gradient JAX itself computes further
    than that from its float32 one (a gradient that bf16 rounding
    dominates), within that gap; and the leaves together no further from
    JAX's bf16 gradients than half of JAX's own bf16-to-float32 gap (the
    sums over the leaves).  A 2-norm, as the forward's mean: a bf16
    rounding that flips between the frameworks can move a max-pool's
    argmax or a chamfer's nearest point, which sends one entry's gradient
    elsewhere."""
    bad = {n: e for n, e in errs.items() if e[0] > max(rtol, e[1])}
    assert not bad, f"{what}: {bad}"
    err, gap = sum(e[0] for e in errs.values()), sum(e[1] for e in errs.values())
    assert err <= 0.5 * gap, f"{what}: port - JAX {err:.3g}, bf16 gap {gap:.3g}"


def _grid(a):
    """Points on a 1/256 grid, whose squared distances are exact: both
    sides select the same points."""
    return (np.round(a * 256) / 256).astype(np.float32)


# a stage's gradient leaves against JAX's bf16 ones: the port and JAX round
# the same bf16 values, but their float32 sums (BatchNorm statistics,
# products) run in other orders, so a rounding can flip, by 2^-8 of a term.
# Readings: at most 2.8e-3 (relative 2-norm) over the eight cases.
STAGE_GRAD_RTOL = 1e-2


# each stage's (and the backbone's) float32 JAX run, shared by its two
# bn_dtype cases
_STAGE_F32: dict = {}


@pytest.mark.parametrize("kind", ["sa_pallas", "sa_sg", "fp_kernel", "fp_one_source"])
@pytest.mark.parametrize("bn_dtype", ["float32", "bfloat16"])
def test_train_stage_matches_jax(kind, bn_dtype):
    """One train-mode stage of the backbone at bf16: the output, every
    parameter gradient, the input features' gradients and the updated
    statistics against JAX's, its gradient taken eagerly (``SA_LEAVES``).
    ``sa_sg`` runs K10's bf16 plain version; ``fp_kernel`` recomputes its
    distances at the K2 indices; ``fp_one_source`` broadcasts its one
    source."""
    from lsdm_tpu.models.pointnet2 import (
        PointNetFeaturePropagation as JFP, PointNetSetAbstraction as JSA)
    from lsdm_tpu_torch.models.common import compute_dtype

    rs = np.random.RandomState(len(kind))  # the same inputs for both bn_dtype
    B = 3
    kw = dict(dtype=torch.bfloat16, bn_dtype=compute_dtype(bn_dtype))
    if kind.startswith("sa"):
        impl = kind[3:]
        port = pointnet2.PointNetSetAbstraction(8, 0.4, 16, 6 + 3, (16, 32),
                                                impl=impl, **kw)
        jax_mod = lambda dt, bn: JSA(8, 0.4, 16, (16, 32), ball_impl=impl,
                                     gather_bwd="matmul_fwd", dtype=dt, bn_dtype=bn)
        args = (_grid(_a(rs, B, 32, 3, scale=0.3)), _a(rs, B, 32, 6))
        name, grad_args = "sa1", (1,)
    else:
        N, S = (16, 8) if kind == "fp_kernel" else (8, 1)
        port = pointnet2.PointNetFeaturePropagation(5 + 7, (16, 8), **kw)
        jax_mod = lambda dt, bn: JFP((16, 8), nn_impl="pallas", gather_bwd="matmul_fwd",
                                     dtype=dt, bn_dtype=bn)
        args = (_grid(_a(rs, B, N, 3, scale=0.3)), _grid(_a(rs, B, S, 3, scale=0.3)),
                _a(rs, B, N, 5), _a(rs, B, S, 7))
        name, grad_args = "fp1", (2, 3)
    init_weights(port, 2)
    params, stats = convert_torch_state_dict(
        {f"pcd_backbone.{name}.{k}": v.numpy() for k, v in port.state_dict().items()})
    params, stats = params["pcd_backbone"][name], stats["pcd_backbone"][name]
    sa = kind.startswith("sa")
    out_shape = (B, 8, 32) if sa else (B, args[0].shape[1], 8)
    cot = _a(rs, *out_shape)

    def jax_run(dt, bn):
        mod = jax_mod(dt, bn)

        def loss(p, *feats):
            a = [jnp.asarray(x) for x in args]
            for i, f in zip(grad_args, feats):
                a[i] = f
            out, mut = mod.apply({"params": p, "batch_stats": stats}, *a, True,
                                 mutable=["batch_stats"])
            out = out[1] if sa else out
            return jnp.sum(out.astype(jnp.float32) * cot), (out, mut["batch_stats"])

        vg = jax.value_and_grad(loss, argnums=tuple(range(1 + len(grad_args))),
                                has_aux=True)
        # an SA stage's gradient eagerly (SA_LEAVES); an FP stage's compiled
        run = (lambda f, *a: f(*a)) if sa else _strict
        (_, (out, st)), grads = run(vg, params, *(jnp.asarray(args[i]) for i in grad_args))
        return out, st, grads

    out_b, stats_b, grads_b = jax_run(BF16, jnp.dtype(bn_dtype))
    if kind not in _STAGE_F32:
        _STAGE_F32[kind] = jax_run(jnp.float32, jnp.float32)
    out_f, _, grads_f = _STAGE_F32[kind]
    port.train()
    T = [torch.from_numpy(x) for x in args]
    for i in grad_args:
        T[i].requires_grad_()
    out = port(*T)
    out = out[1] if sa else out
    (out.float() * torch.from_numpy(cot)).sum().backward()
    assert out.dtype == (torch.bfloat16 if bn_dtype == "bfloat16" else torch.float32)
    _check_bf16(out, out_b, out_f, f"{kind} bn {bn_dtype}")
    leaves = lambda g: {k[len(f"pcd_backbone.{name}."):]: w for k, w in params_from_jax(
        {"pcd_backbone": {name: jax.tree.map(np.asarray, g)}}).items()}
    errs = _grad_errors({n: p.grad.float() for n, p in port.named_parameters()},
                        leaves(grads_b[0]), leaves(grads_f[0]))
    _check_grads(errs, STAGE_GRAD_RTOL, f"{kind} bn {bn_dtype}")
    for i, gb, gf in zip(grad_args, grads_b[1:], grads_f[1:]):
        _check_bf16(T[i].grad, gb, gf, f"{kind} input {i} gradient")
    for layer, bn in zip(("mlp_0", "mlp_1"), port.mlp_bns):
        for stat, mine in (("mean", bn.running_mean), ("var", bn.running_var)):
            np.testing.assert_allclose(mine.numpy(), np.asarray(stats_b[layer]["bn"][stat]),
                                       rtol=1e-5, atol=1e-6, err_msg=f"{layer} {stat}")


@pytest.mark.parametrize("bn_dtype", ["float32", "bfloat16"])
def test_train_backbone_matches_jax(bn_dtype, keep_mask):
    """The whole train-mode backbone at bf16 (``ball_impl="pallas"``, the
    head's dropout on a given keep-mask): output and running statistics
    against JAX's.  Through eight train-mode BatchNorms the bf16 roundings
    are amplified (a channel whose mean is many times its spread loses the
    bf16 rounding of its inputs relative to that spread): JAX's own bf16
    output lies up to a quarter of its largest value from its float32 one
    at these shapes (stages 32, 16, 8, 4 of 32 points, 16 samples), and a
    rounding that flips between the frameworks travels the same way.  So
    the whole backbone is held to JAX's own gap (the largest entry no
    further than the largest gap, the mean within half of the mean gap);
    the 3e-2 bound holds stage by stage (:func:`test_train_stage_matches_jax`)
    and at the stages' entry, sa1."""
    from lsdm_tpu_torch.models.common import compute_dtype

    rs = np.random.RandomState(7)
    B, N, npoints, ns = 4, 32, (32, 16, 8, 4), 16
    xyz = _grid(_a(rs, B, N, 3))
    mask = rs.rand(B, N, 128) < 0.5
    keep_mask(jnp.asarray(mask))
    bb = pointnet2.PointNet2Backbone(sa_npoints=npoints, sa_nsample=ns,
                                     ball_impl="pallas", dtype=torch.bfloat16,
                                     bn_dtype=compute_dtype(bn_dtype))
    init_weights(bb, 1)
    params, stats = convert_torch_state_dict(
        {"pcd_backbone." + k: v.numpy() for k, v in bb.state_dict().items()})
    variables = {"params": params["pcd_backbone"],
                 "batch_stats": stats["pcd_backbone"]}

    def jax_run(dt, bn):
        jb = JaxBackbone(sa_npoints=npoints, sa_nsample=ns, ball_impl="pallas",
                         gather_bwd="matmul_fwd", dtype=dt, bn_dtype=bn)
        out, mut = _strict(lambda v: jb.apply(
            v, jnp.asarray(xyz), True, mutable=["batch_stats", "intermediates"],
            capture_intermediates=lambda m, _: m.name == "sa1"), variables)
        return out, mut["batch_stats"], mut["intermediates"]["sa1"]["__call__"][0][1]

    out_b, stats_b, sa1_b = jax_run(BF16, jnp.dtype(bn_dtype))
    if "backbone" not in _STAGE_F32:  # the same inputs for both bn_dtype
        _STAGE_F32["backbone"] = jax_run(jnp.float32, jnp.float32)
    out_f, _, sa1_f = _STAGE_F32["backbone"]
    sa1 = {}
    bb.sa1.register_forward_hook(lambda m, i, o: sa1.__setitem__("out", o[1]))
    bb.train()
    out = bb(torch.from_numpy(xyz), dropout_mask=torch.from_numpy(mask))
    assert out.dtype == torch.bfloat16
    _check_bf16(sa1["out"], sa1_b, sa1_f, f"backbone sa1, bn {bn_dtype}")
    got, want, want32 = _np(out), _np(out_b), _np(out_f)
    assert np.abs(got - want).max() <= np.abs(want - want32).max(), bn_dtype
    assert np.abs(got - want).mean() <= 0.5 * np.abs(want - want32).mean(), bn_dtype
    # sa1's statistics, ahead of the amplification
    new = state_dict_from_jax({"pcd_backbone": variables["params"]},
                              {"pcd_backbone": stats_b})
    for name, t in bb.sa1.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(t, new[f"pcd_backbone.sa1.{name}"], rtol=1e-3,
                                       atol=1e-4, msg=name)


# --- the SDM ------------------------------------------------------------------------

def _graph_inputs(B, seed):
    rs = np.random.RandomState(seed)
    mask = np.zeros((B, 9), np.float32)
    mask[:, 1:4] = 1.0
    eye = np.eye(13, dtype=np.float32)
    return dict(mask=mask, objs=_a(rs, B, 9, 32, 3, scale=0.3),
                cats=eye[rs.randint(0, 13, (B, 9))], text=_a(rs, B, 32),
                target=_a(rs, B, 32, 3, scale=0.2), target_cat=eye[[2, 5][:B]],
                noise=_a(rs, B, 32, 3), t=np.array([3, 11][:B], np.int32),
                keep=rs.rand(B * 9, 32, 128) < 0.5)


def test_sdm_forward_matches_jax(model):
    """The eval-mode SDM forward at bf16 (``ball_impl="pallas"``): x0, the
    category probabilities and the guiding points, each returned float32."""
    port, v = model
    x = _graph_inputs(2, 1)
    J = {k: jnp.asarray(a) for k, a in x.items()}
    args = ("mask", "t", "objs", "cats", "text")

    def run(dt):
        cfg = SDMConfig(**TINY_KW, ball_impl="pallas", dtype=dt, bn_dtype=dt)
        return _strict(lambda vv: JaxSDM(cfg).apply(vv, J["noise"], *(J[a] for a in args)), v)

    want, want32 = run("bfloat16"), run("float32")
    T = {k: torch.from_numpy(a) for k, a in x.items()}
    port.eval()
    got = port(T["noise"], T["mask"], T["t"].long(), T["objs"], T["cats"], T["text"])
    for field in ("x0", "cat", "guiding"):
        assert getattr(got, field).dtype == torch.float32, field
        _check_bf16(getattr(got, field), getattr(want, field), getattr(want32, field),
                    f"SDM {field}")


# the train graph's per-leaf gradient bound (leaves that bf16 rounding
# dominates in JAX itself are held to their own gap, _check_grads)
GRAPH_GRAD_RTOL = 5e-2
# the loss: a float32 chamfer of bf16 outputs plus the category term
GRAPH_LOSS_RTOL = 1e-2


def _direct_chamfer(x, y):
    d = ((x[:, :, None] - y[:, None]) ** 2).sum(-1)
    return (d.amin(2).mean(1) + d.amin(1).mean(1)).mean()


def _direct_chamfer_jax(x, y):
    d = jnp.sum((x[:, :, None] - y[:, None]) ** 2, -1)
    return jnp.mean(jnp.mean(jnp.min(d, 2), 1) + jnp.mean(jnp.min(d, 1), 1))


@pytest.fixture(scope="module")
def train_graph_jax():
    """JAX's loss and gradients (bf16 and float32) of the train graph, for
    both attn_impl cases of the port: the inputs, the weights, JAX's bf16
    loss, its bf16 and float32 gradients without the SA leaves."""
    import lsdm_tpu.diffusion.gaussian as jax_gaussian

    x = _graph_inputs(2, 7)
    _, v = _model(8, bn_dtype="bfloat16")
    J = {k: jnp.asarray(a) for k, a in x.items()}

    def dropout(self, inputs, deterministic=None, rng=None):
        return inputs if deterministic else jnp.where(J["keep"], inputs / 0.5, 0.0)

    def jax_run(dt):
        jmodel = JaxSDM(SDMConfig(**TINY_KW, ball_impl="pallas", attn_impl="xla",
                                  gather_bwd="matmul_fwd", dtype=dt, bn_dtype=dt))

        def loss_fn(params):
            def model_fn(x_t, tt):
                out, _ = jmodel.apply(
                    {"params": params, "batch_stats": v["batch_stats"]},
                    x_t, J["mask"], tt, J["objs"], J["cats"], J["text"], True,
                    mutable=["batch_stats"])
                return out

            return jax_training_losses(jax_make_schedule("cosine", 16), model_fn,
                                       J["target"], J["t"], J["target_cat"],
                                       J["noise"])["loss"]

        loss, g = _strict(jax.value_and_grad(loss_fn), v["params"])
        return float(loss), {n: w for n, w in params_from_jax(
            jax.tree.map(np.asarray, g)).items() if not n.startswith(SA_LEAVES)}

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", dropout)
        mp.setattr(jax_gaussian, "chamfer_distance", _direct_chamfer_jax)
        (loss_b, grads_b), (_, grads_f) = jax_run("bfloat16"), jax_run("float32")
    return x, loss_b, grads_b, grads_f


@pytest.mark.parametrize("attn_impl", ["pallas", "xla"])
def test_train_graph_matches_jax(attn_impl, train_graph_jax, monkeypatch):
    """One value_and_grad of the loss at the tiny config, B=2, T=16, bf16
    compute with bf16 BatchNorms, ``ball_impl="pallas"``, the dropout on a
    given keep-mask: the port's K4/K5 attention or its composed one against
    JAX's composed attention, which at bf16 rounds the same weights (K4/K5's
    plain versions against JAX's kernels: below).  The SA leaves' gradients
    are left to the stage tests (``SA_LEAVES``).  Both chamfers take the
    direct form, as ``test_torch_train_model.py`` has them."""
    from lsdm_tpu_torch.diffusion import gaussian

    monkeypatch.setattr(gaussian, "chamfer_distance", _direct_chamfer)
    x, loss_b, grads_b, grads_f = train_graph_jax
    port, _ = _model(8, bn_dtype="bfloat16", ball_impl="pallas", attn_impl=attn_impl)
    port.train()
    T = {k: torch.from_numpy(a) for k, a in x.items()}

    def model_fn(x_t, tt):
        return port(x_t, T["mask"], tt, T["objs"], T["cats"], T["text"],
                    dropout_mask=T["keep"])

    loss = training_losses(make_schedule("cosine", 16), model_fn, T["target"],
                           T["t"].long(), T["target_cat"], T["noise"])["loss"]
    loss.backward()
    np.testing.assert_allclose(loss.item(), loss_b, rtol=GRAPH_LOSS_RTOL)
    got = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).float()
           for n, p in port.named_parameters() if n in grads_b}
    _check_grads(_grad_errors(got, grads_b, grads_f), GRAPH_GRAD_RTOL,
                 f"train graph attn {attn_impl}")


# --- the kernels' bf16 modes: plain versions against the JAX kernels -----------------

def _bf16(a):
    return np.asarray(jnp.asarray(a).astype(BF16).astype(jnp.float32))


@pytest.mark.parametrize("B,L", [(3, 64), (2, 256)])
def test_rank1_bf16_plain_matches_jax(B, L):
    """K4's and K5's bf16 plain versions against ``rank1_mha_pallas`` and
    ``_rank1_mha_bwd_pallas`` at ``compute_dtype=bfloat16`` in interpret
    mode, on bf16 q, k, v: the output within ATTN_BF16_ATOL x max(1,
    max |v|), the gradients (cast to bf16, as the JAX custom VJP casts
    them) within that bound on their own scale."""
    rs = np.random.RandomState(L + B)
    H = 12
    q, k, v = (_bf16(_a(rs, B, L, H)) for _ in range(3))
    g = _a(rs, B, L, H)
    with jax.default_matmul_precision("highest"):
        out_j = rank1_mha_pallas(*map(jnp.asarray, (q, k, v)), compute_dtype=BF16,
                                 interpret=True)
        grads_j = _rank1_mha_bwd_pallas(*map(jnp.asarray, (q, k, v)), out_j,
                                        jnp.asarray(g), compute_dtype=BF16,
                                        interpret=True)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    out = attn.rank1_mha_plain(tq, tk, tv)
    assert out.dtype == torch.float32
    tol = ATTN_BF16_ATOL * max(1.0, float(np.abs(v).max()))
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=tol, rtol=0)
    # the backward from JAX's forward output, as K5 takes K4's
    grads = attn.rank1_mha_bwd_plain(tq, tk, tv, torch.from_numpy(np.asarray(out_j)),
                                     torch.from_numpy(g))
    for name, got, want in zip("qkv", grads, grads_j):
        assert got.dtype == torch.bfloat16
        want = _bf16(want)
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=ATTN_BF16_ATOL * max(1.0, float(np.abs(want).max())),
                                   rtol=0, err_msg=f"d{name}")


def test_rank1_bf16_train_function_casts_like_jax():
    """``rank1_mha_train`` on bf16 inputs: a float32 output and bf16
    gradients (the JAX custom VJP's ``astype(q.dtype)``)."""
    rs = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(_a(rs, 2, 16, 12)).bfloat16().requires_grad_()
               for _ in range(3))
    out = attn.rank1_mha_train(q, k, v)
    assert out.dtype == torch.float32
    out.sum().backward()
    assert all(t.grad.dtype == torch.bfloat16 and torch.isfinite(t.grad).all()
               for t in (q, k, v))


@pytest.mark.parametrize("case", ["jax_test", "empty_slots", "empty_ball"])
def test_select_gather_bf16_plain_equals_jax(case):
    """K10's bf16 plain version equal to the JAX kernel at
    ``compute_dtype=bfloat16``: the grouped bf16 output (the center rounded
    to bf16, ``g - qc`` rounded once) and the indices, as
    ``tests/test_sg_fused.py:41-48`` holds JAX's own."""
    rs = np.random.RandomState({"jax_test": 1, "empty_slots": 3, "empty_ball": 4}[case])
    B, N, S, C = 2, 64, 16, 9
    xyz = rs.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    base = np.concatenate([xyz, _a(rs, B, N, C - 3)], -1)
    new_xyz = xyz[:, :S].copy() + _a(rs, B, S, 3, scale=1e-3)
    radius = 0.05 if case == "empty_slots" else 0.4
    if case == "empty_ball":
        new_xyz[1, 5] += 10.0
    grouped_j, idx_j = _sg_call(radius, 8, jnp.asarray(xyz), jnp.asarray(new_xyz),
                                jnp.asarray(base).astype(BF16), BF16, True)
    got, idx = sg_fused.select_gather_plain(
        radius, 8, torch.from_numpy(xyz), torch.from_numpy(new_xyz),
        torch.from_numpy(base).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(got.float().numpy(), _np(grouped_j))
    if case == "empty_ball":
        assert (idx[1, 5] == N - 1).all()


def test_select_gather_bf16_backward_sums_in_float32():
    """The bf16 select-gather's ``grad_base``: the bf16 cotangent summed in
    float32 and rounded once to bf16, equal to JAX's ``onehot_segment_sum``
    path up to the order of its float32 sums."""
    from lsdm_tpu.ops.sg_fused_pallas import select_gather_grouped as jax_sg

    rs = np.random.RandomState(6)
    B, N, S, C = 2, 64, 16, 9
    xyz = rs.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    base = _bf16(np.concatenate([xyz, _a(rs, B, N, C - 3)], -1))
    new_xyz = xyz[:, :S].copy()
    cot = _bf16(_a(rs, B, S, 8, C))
    want = jax.grad(lambda b: jnp.sum(jax_sg(0.4, 8, BF16, True, jnp.asarray(xyz),
                                             jnp.asarray(new_xyz), b)
                                      .astype(jnp.float32) * cot))(
        jnp.asarray(base).astype(BF16))
    tb = torch.from_numpy(base).bfloat16().requires_grad_()
    out = sg_fused.select_gather_grouped(0.4, 8, torch.from_numpy(xyz),
                                         torch.from_numpy(new_xyz), tb)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    assert tb.grad.dtype == torch.bfloat16
    want = _np(want)
    np.testing.assert_allclose(tb.grad.float().numpy(), want, rtol=2 ** -8,
                               atol=1e-6 * float(np.abs(want).max()))


def test_bf16_gather_backward_sums_in_float32():
    """``index_points`` of a bf16 tensor: its gradient is the float32 sum of
    the bf16 cotangent rows, rounded once (torch's own bf16 backward would
    round after every add)."""
    from lsdm_tpu_torch.ops.pointcloud import index_points

    points = torch.zeros(1, 2, 1, dtype=torch.bfloat16, requires_grad=True)
    idx = torch.zeros(1, 300, dtype=torch.int64)  # 300 rows into point 0
    cot = torch.full((1, 300, 1), 1.0 + 2 ** -7, dtype=torch.bfloat16)
    index_points(points, idx).backward(cot)
    want = torch.tensor(300 * (1.0 + 2 ** -7)).bfloat16()
    assert points.grad[0, 0, 0] == want and points.grad[0, 1, 0] == 0

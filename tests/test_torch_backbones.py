"""The alternate backbones of the port against the JAX package.

``knn`` (indices equal to ``lax.top_k``'s, ties and duplicates included),
the STGCN's adjacency stack, the DGCNN object backbone and the STGCN
("P2R") human backbone in eval and train mode, in float32, float64 and
bf16, and a ``SceneDiffusionModel`` with both: its conditioning, its
forward, one train loss with every gradient, a short chain sample and the
weight bridge.  JAX's parameters cross to the port through
``weights.state_dict_from_jax``; inputs and dropout keep-masks come from
numpy seeds.

Train mode is compared in float64 (flax's fast variance E[x^2] - E[x]^2
loses digits in float32; with one frame the STGCN's positional branch
feeds a BatchNorm rows that are all equal, where only that cancellation is
left).  The JAX modules pin their BatchNorms to ``dtype=float32``, which
under ``enable_x64`` still takes the statistics in float32; the float64
tests patch ``flax.linen.BatchNorm`` to infer its dtype (``_BN64``), so
both sides normalise in float64.  The float32 tests leave JAX as it is.
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
from lsdm_tpu.models import dgcnn as jax_dgcnn
from lsdm_tpu.models import stgcn as jax_stgcn
from lsdm_tpu.models.sampling import sample_sdm as jax_sample_sdm
from lsdm_tpu.models.sdm import SceneDiffusionModel as JaxSDM
from lsdm_tpu.ops.pointcloud import knn as jax_knn
from lsdm_tpu_torch.config import SDMConfig as PortConfig
from lsdm_tpu_torch.diffusion.gaussian import training_losses
from lsdm_tpu_torch.diffusion.schedule import make_schedule
from lsdm_tpu_torch.models import dgcnn, stgcn
from lsdm_tpu_torch.models.sampling import sample_sdm
from lsdm_tpu_torch.models.sdm import SceneDiffusionModel
from lsdm_tpu_torch.ops.pointcloud import knn
from lsdm_tpu_torch.weights import params_from_jax, state_dict_from_jax
from test_torch_bf16 import _check_bf16, _strict
from test_torch_train_model import _check_grads, keep_mask  # noqa: F401

TINY_KW = dict(clip_dim=32, latent_dim=16, cat_emb=8, n_head=4, vert_dims=24,
               pcd_points=32)
ALT = dict(pcd_backbone_type="DGCNN", human_backbone_type="P2R")
F32_ATOL = 2e-5  # float32 reassociation between XLA and torch
F64_ATOL = 1e-9


class _BN64(fnn.BatchNorm):
    """flax BatchNorm with its dtype inferred from the input (float64 under
    ``enable_x64``) instead of the modules' pinned float32."""

    def __post_init__(self):
        object.__setattr__(self, "dtype", None)
        super().__post_init__()


def _a(rs, *shape, scale=1.0):
    return (rs.randn(*shape) * scale).astype(np.float32)


def _variables(module, seed, *args):
    """Seeded variables of the shapes ``module.init`` gives at ``args``
    (``eval_shape``: no eager init to compile): kernels at the scale of
    flax's lecun init, scales and edge importances near 1, biases near 0,
    random running statistics."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(seed), *args)
    rs = np.random.RandomState(seed)

    def draw(path, a):
        name = jax.tree_util.keystr(path)
        if name.endswith("['var']"):
            return (rs.rand(*a.shape) + 0.5).astype(np.float32)
        if name.endswith("['kernel']"):
            return _a(rs, *a.shape, scale=np.prod(a.shape[:-1]) ** -0.5)
        if name.endswith(("['scale']", "importance_0']", "importance_1']")):
            return 1.0 + _a(rs, *a.shape, scale=0.1)
        return _a(rs, *a.shape, scale=0.1)  # biases, running means

    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


def _load(port, variables, prefix):
    sd = state_dict_from_jax({prefix: variables["params"]},
                             {prefix: variables.get("batch_stats", {})})
    port.load_state_dict({k[len(prefix) + 1:]: v for k, v in sd.items()}, strict=True)
    return port


# --- knn --------------------------------------------------------------------

def _knn_clouds():
    rs = np.random.RandomState(0)
    x = _a(rs, 5, 64, 3)
    x[1] = 0.0  # an empty object slot: every distance ties
    x[2] = x[2, :1]  # one point repeated
    x[3, 32:] = x[3, :32]  # every point twice
    x[4, ::3] = x[4, 5]  # a third of the points on one
    feats = _a(rs, 3, 64, 16)
    feats[1, 40:] = feats[1, 7]
    return x, feats


@pytest.mark.parametrize("which", ["points", "features"])
def test_knn_indices_equal_jax(which):
    """``lax.top_k``'s indices, ties to the lowest index: random clouds,
    an all-equal cloud, duplicated points, and 16-channel features."""
    x = _knn_clouds()[0 if which == "points" else 1]
    for k in (1, 10, 20):
        want = np.asarray(jax_knn(jnp.asarray(x), k))
        got = knn(torch.from_numpy(x), k).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"k={k}")
    if which == "points":
        np.testing.assert_array_equal(got[1], np.tile(np.arange(20), (64, 1)))


@pytest.mark.parametrize("nodes", [64, 1024])
def test_virtualroom_adjacency_is_jaxs(nodes):
    got = stgcn.virtualroom_adjacency(nodes)
    assert got.shape == (11, nodes, nodes)
    np.testing.assert_array_equal(got, jax_stgcn.virtualroom_adjacency(nodes))


# --- the backbones alone ----------------------------------------------------

def _backbone(kind, dtype=None, jax_dtype=jnp.float32, V=32):
    """(port module, JAX module, input, its prefix in an SDM)."""
    rs = np.random.RandomState(1)
    if kind == "dgcnn":
        x = _a(rs, 3, V, 3, scale=0.3)
        x[1] = 0.0  # an empty object slot
        return (dgcnn.DGCNN(emb_dims=24, output_channels=V * 3, dtype=dtype),
                jax_dgcnn.DGCNN(emb_dims=24, output_channels=V * 3, dtype=jax_dtype),
                x, "pcd_backbone")
    x = _a(rs, 3, V, 3, scale=0.3)
    return (stgcn.STGCN(joint_num=V, out_channels=V * 3, dtype=dtype),
            jax_stgcn.STGCN(joint_num=V, out_channels=V * 3, dtype=jax_dtype),
            x, "human_backbone")


@pytest.mark.parametrize("kind", ["dgcnn", "stgcn"])
def test_backbone_eval_matches_jax(kind):
    port, jax_mod, x, prefix = _backbone(kind)
    v = _variables(jax_mod, 2, jnp.asarray(x))
    want = jax.jit(jax_mod.apply)(v, jnp.asarray(x))
    got = _load(port, v, prefix).eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=F32_ATOL,
                               rtol=1e-5)


def test_stgcn_takes_a_sequence_of_frames():
    """(B, T, V, 3): the temporal window, the (3, 1) temporal convolutions'
    three taps and the frame-mixing reshape before ``conv_joint``."""
    port, jax_mod, _, prefix = _backbone("stgcn")
    x = _a(np.random.RandomState(3), 2, 5, 32, 3, scale=0.3)
    v = _variables(jax_mod, 3, jnp.asarray(x))
    want = jax.jit(jax_mod.apply)(v, jnp.asarray(x))
    got = _load(port, v, prefix).eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=F32_ATOL,
                               rtol=1e-5)


@pytest.mark.parametrize("kind", ["dgcnn", "stgcn"])
def test_backbone_train_matches_jax(kind, keep_mask, monkeypatch):
    """Train mode in float64: output, updated statistics and every
    parameter gradient, DGCNN's two dropouts on given keep-masks."""
    monkeypatch.setattr(fnn, "BatchNorm", _BN64)
    port, jax_mod, x, prefix = _backbone(kind, jax_dtype=jnp.float64)
    rs = np.random.RandomState(4)
    masks = [rs.rand(3, 512) < 0.9, rs.rand(3, 256) < 0.9]
    keep_mask([jnp.asarray(m) for m in masks])
    v = _variables(jax_mod, 5, jnp.asarray(x))
    cot = _a(rs, 3, 32, 3)
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), v)

        def loss(params):
            out, mut = jax_mod.apply({"params": params,
                                      "batch_stats": v64["batch_stats"]},
                                     jnp.asarray(x, jnp.float64), True,
                                     mutable=["batch_stats"])
            return jnp.sum(out * cot), (out, mut["batch_stats"])

        (_, (out_j, stats_j)), grads_j = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(v64["params"])
        out_j, stats_j, grads_j = (jax.tree.map(np.asarray, t)
                                   for t in (out_j, stats_j, grads_j))
    port = _load(port, v, prefix).double().train()
    kw = {"dropout_mask": [torch.from_numpy(m) for m in masks]} if kind == "dgcnn" else {}
    out = port(torch.from_numpy(x).double(), **kw)
    (out * torch.from_numpy(cot).double()).sum().backward()
    # the JAX STGCN's graph contraction returns float32
    # (preferred_element_type) also in float64: its rounding, 6e-8 of the
    # contraction's values, reaches the output
    atol = F64_ATOL if kind == "dgcnn" else 1e-6 * max(1.0, np.abs(out_j).max())
    np.testing.assert_allclose(out.detach().numpy(), out_j, atol=atol, rtol=1e-7)
    want_stats = state_dict_from_jax({prefix: v["params"]}, {prefix: stats_j})
    for name, w in want_stats.items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(
                port.state_dict()[name[len(prefix) + 1:]].numpy(), w.numpy(),
                rtol=1e-6, atol=1e-7, err_msg=name)
    want = {k[len(prefix) + 1:]: w for k, w in params_from_jax(
        {prefix: jax.tree.map(lambda a: np.asarray(a, np.float32), grads_j)}).items()}
    _check_grads({n: p.grad.float() for n, p in port.named_parameters()}, want, kind)


@pytest.mark.parametrize("kind", ["dgcnn", "stgcn"])
def test_backbone_bf16_matches_jax(kind):
    """``dtype=bfloat16`` over float32 parameters, eval: within FWD_RTOL of
    JAX's bf16 output, and nearer to it than to JAX's float32 one."""
    port, jax_mod, x, prefix = _backbone(kind, dtype=torch.bfloat16,
                                         jax_dtype=jnp.bfloat16)
    jax32 = _backbone(kind)[1]
    v = _variables(jax32, 6, jnp.asarray(x))
    want = _strict(lambda v, x: jax_mod.apply(v, x), v, jnp.asarray(x))
    want32 = jax.jit(jax32.apply)(v, jnp.asarray(x))
    got = _load(port, v, prefix).eval()(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _check_bf16(got, want, want32, kind)


def test_graph_contraction_of_a_bf16_input_is_float32():
    """``ConvTemporalGraphical`` at bf16: the Dense in bf16, then the
    contraction with the float32 ``A * importance`` promoted to float32,
    as ``jnp.einsum`` promotes it."""
    rs = np.random.RandomState(7)
    x = _a(rs, 2, 1, 32, 4)
    A = jax_stgcn.virtualroom_adjacency(32) * (1 + _a(rs, 11, 32, 32, scale=0.1))
    jmod = jax_stgcn.ConvTemporalGraphical(6, 11, dtype=jnp.bfloat16)
    v = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                           jnp.asarray(A)))
    want = _strict(lambda v, x, A: jmod.apply(v, x, A), v, jnp.asarray(x), jnp.asarray(A))
    port = stgcn.ConvTemporalGraphical(4, 6, 11, dtype=torch.bfloat16)
    with torch.no_grad():
        port.conv.weight.copy_(torch.from_numpy(v["params"]["conv"]["kernel"].T))
        port.conv.bias.copy_(torch.from_numpy(v["params"]["conv"]["bias"]))
    got = port(torch.from_numpy(x), torch.from_numpy(A))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# --- the SDM with both -------------------------------------------------------

def _inputs(cfg, B, seed):
    rs = np.random.RandomState(seed)
    O, N = cfg.max_objs, cfg.pcd_points
    mask = np.zeros((B, O), np.float32)
    mask[:, 1:4] = 1.0
    objs = _a(rs, B, O, N, 3, scale=0.3)
    objs[:, 5:] = 0.0  # empty slots, as the datasets pad them
    eye = np.eye(cfg.max_cats, dtype=np.float32)
    return dict(mask=mask, objs=objs, cats=eye[rs.randint(0, 13, (B, O))],
                text=_a(rs, B, cfg.clip_dim), target=_a(rs, B, N, 3, scale=0.2),
                target_cat=eye[[2, 5][:B]], noise=_a(rs, B, N, 3),
                t=np.array([3, 11][:B], np.int32),
                keep=[rs.rand(B * O, 512) < 0.9, rs.rand(B * O, 256) < 0.9])


def _sdm(seed=0, **kw):
    """The JAX SDM, its randomised variables and the port's SDM carrying
    them (strict load: no missing and no unexpected key)."""
    cfg = SDMConfig(**TINY_KW, **kw)
    jmodel = JaxSDM(cfg)
    x = _inputs(cfg, 2, 0)
    v = _variables(jmodel, seed, jnp.asarray(x["target"]), jnp.asarray(x["mask"]),
                   jnp.asarray(x["t"]), jnp.asarray(x["objs"]), jnp.asarray(x["cats"]),
                   jnp.asarray(x["text"]))
    port = SceneDiffusionModel(PortConfig(**TINY_KW, **kw))
    port.load_state_dict(state_dict_from_jax(v["params"], v["batch_stats"]), strict=True)
    return jmodel, v, port


@pytest.mark.parametrize("kw", [ALT, dict(pcd_backbone_type="DGCNN"),
                                dict(human_backbone_type="P2R")],
                         ids=["dgcnn_p2r", "dgcnn_posa", "pnt2_p2r"])
def test_sdm_forward_matches_jax(kw):
    """Each backbone alone beside the default tower, and both: the weight
    bridge loads JAX's tree strictly, and ``encode_conditioning``'s
    ``cond_pcd`` and the eval forward equal JAX's."""
    jmodel, v, port = _sdm(**kw)
    port.eval()
    x = _inputs(jmodel.cfg, 2, 1)
    J = {k: jnp.asarray(a) for k, a in x.items() if k != "keep"}
    T = {k: torch.from_numpy(a) for k, a in x.items() if k != "keep"}
    with jax.default_matmul_precision("highest"):
        cond = jax.jit(lambda v, *a: jmodel.apply(
            v, *a, method=JaxSDM.encode_conditioning))(
                v, J["mask"], J["objs"], J["cats"], J["text"])
        out = jax.jit(jmodel.apply)(v, J["target"], J["mask"], J["t"], J["objs"],
                                    J["cats"], J["text"])
    with torch.no_grad():
        got_cond = port.encode_conditioning(T["mask"], T["objs"], T["cats"], T["text"])
        got = port(T["target"], T["mask"], T["t"].long(), T["objs"], T["cats"], T["text"])
    np.testing.assert_allclose(got_cond.cond_pcd.numpy(), np.asarray(cond.cond_pcd),
                               atol=F32_ATOL, rtol=1e-5)
    for name in ("x0", "guiding", "cat"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(out, name)), atol=F32_ATOL,
                                   rtol=1e-5, err_msg=name)


def test_sdm_train_graph_matches_jax(keep_mask, monkeypatch):
    """One value_and_grad of the train loss of a DGCNN + P2R model, B=2,
    T=16, in float64, DGCNN's dropouts on given keep-masks: the loss,
    every parameter gradient and the updated statistics.  Both chamfers take
    the direct form (as ``test_torch_train_model.py`` does)."""
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
    monkeypatch.setattr(fnn, "BatchNorm", _BN64)
    _, v, port = _sdm(1, **ALT)
    jmodel = JaxSDM(SDMConfig(**TINY_KW, **ALT, dtype=jnp.float64,
                              bn_dtype=jnp.float64))
    x = _inputs(jmodel.cfg, 2, 2)
    keep_mask([jnp.asarray(m) for m in x["keep"]])
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), v)
        J = {k: jnp.asarray(a, jnp.float64 if a.dtype == np.float32 else None)
             for k, a in x.items() if k != "keep"}

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
    port.double().train()
    T = {k: torch.from_numpy(np.asarray(a)) for k, a in x.items() if k != "keep"}
    T = {k: a.double() if a.dtype == torch.float32 else a for k, a in T.items()}
    keep = [torch.from_numpy(m) for m in x["keep"]]

    def model_fn(x_t, tt):
        return port(x_t, T["mask"], tt, T["objs"], T["cats"], T["text"],
                    dropout_mask=keep)

    loss = training_losses(make_schedule("cosine", 16), model_fn, T["target"],
                           T["t"].long(), T["target_cat"], T["noise"])["loss"]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-7)
    want = params_from_jax(grads_j)
    got = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).float()
           for n, p in port.named_parameters()}
    _check_grads(got, want, "DGCNN + P2R train graph")
    new = state_dict_from_jax(v["params"], stats_j)
    sd = port.state_dict()
    for name, w in new.items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[name].numpy(), w.numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=name)


def test_sdm_chain_sample_matches_jax():
    """A DGCNN + P2R model sampled for 4 steps on the chain (K6's plain
    version) and on the composed loop, fed JAX's draws."""
    jmodel, v, port = _sdm(2, **ALT)
    port.eval()
    x = _inputs(jmodel.cfg, 2, 3)
    inputs = (x["mask"], x["objs"], x["cats"], x["text"])
    key = jax.random.PRNGKey(42)
    with jax.default_matmul_precision("highest"):
        s_want, out_want = jax.jit(lambda v, s, k, *a: jax_sample_sdm(
            jmodel, v, s, *a, k))(v, jax_make_schedule("cosine", 4), key,
                                   *map(jnp.asarray, inputs))
    B, N = 2, jmodel.cfg.pcd_points
    step_key, init_key = jax.random.split(key)
    x_init = np.array(jax.random.normal(init_key, (B, N, 3), jnp.float32))
    noise = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(step_key, i), (B, N, 3), jnp.float32)) for i in range(4)])
    for fused_step in ("chain", None):
        s_got, out_got = sample_sdm(
            port, make_schedule("cosine", 4), *map(torch.from_numpy, inputs),
            fused_step=fused_step, x_init=torch.from_numpy(x_init),
            noise=torch.from_numpy(noise))
        for name, got, want in (("sample", s_got, s_want),
                                ("x0", out_got.x0, out_want.x0),
                                ("guiding", out_got.guiding, out_want.guiding)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL,
                                       rtol=0, err_msg=f"{fused_step}: {name}")


def test_dgcnn_dropout_draws_from_the_generator_and_checks_masks():
    bb = dgcnn.DGCNN(emb_dims=16, output_channels=96).train()
    x = torch.from_numpy(_a(np.random.RandomState(0), 2, 32, 3, scale=0.3))
    runs = [bb(x, generator=torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    with pytest.raises(ValueError, match="dropout mask"):
        bb(x, dropout_mask=[torch.ones(2, 256, dtype=torch.bool)] * 2)

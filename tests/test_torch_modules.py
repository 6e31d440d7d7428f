"""Port modules against their JAX counterparts through the weight bridge.

One tiny JAX SceneDiffusionModel is initialised and randomised (every
parameter and BatchNorm statistic, so biases, norms and running stats are
all exercised); :func:`lsdm_tpu_torch.weights.state_dict_from_jax` loads
the same weights into the port.  The same numpy inputs then go through
the POSA backbone, the PointNet++ backbone (eval), ``encode_conditioning``
and ``denoise_from_cond`` of both packages.  The JAX side runs its
composed path at "highest" matmul precision; the port's selection ops run
their plain versions (CPU tensors).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsdm_tpu.config import SDMConfig
from lsdm_tpu.models.pointnet2 import PointNet2Backbone as JaxPointNet2
from lsdm_tpu.models.posa import POSADecoderBackbone as JaxPOSA
from lsdm_tpu.models.sdm import SceneDiffusionModel as JaxSDM
from lsdm_tpu_torch.config import SDMConfig as PortConfig
from lsdm_tpu_torch.models.pointnet2 import PointNet2Backbone
from lsdm_tpu_torch.models.sdm import CondCache, SceneDiffusionModel
from lsdm_tpu_torch.ops.denoise import denoise_chain_tables, extract_step_params
from lsdm_tpu_torch.weights import state_dict_from_jax

TINY_KW = dict(clip_dim=32, latent_dim=16, cat_emb=8, n_head=4,
               vert_dims=24, pcd_points=32)
TINY = SDMConfig(**TINY_KW)  # the JAX package's
PORT_TINY = PortConfig(**TINY_KW)  # the port's copy
# float32 through a few dozen layers whose sums XLA and torch take in
# different orders (the torch-replica parity test holds the category head
# to 2e-5 as well, tests/test_full_sdm_parity.py)
ATOL = 2e-5


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _randomize(tree, rs, stats=False):
    def leaf(path, a):  # a: ShapeDtypeStruct
        name = jax.tree_util.keystr(path)
        if stats and name.endswith("['var']"):
            return (rs.rand(*a.shape) + 0.5).astype(np.float32)
        scale = 0.1 if stats else 0.2
        return (rs.randn(*a.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.fixture(scope="module")
def setup():
    cfg = TINY
    B, O, N = 2, cfg.max_objs, cfg.pcd_points
    rs = np.random.RandomState(0)
    inputs = dict(
        x=rs.randn(B, N, 3).astype(np.float32),
        mask=np.zeros((B, O), np.float32),
        t=np.array([3, 7], np.int32),
        objs=rs.randn(B, O, N, 3).astype(np.float32),
        cats=np.eye(cfg.max_cats, dtype=np.float32)[rs.randint(0, 13, (B, O))],
        text=rs.randn(B, cfg.clip_dim).astype(np.float32),
    )
    inputs["mask"][:, 1:5] = 1.0
    jmodel = JaxSDM(cfg)
    # every leaf is drawn below, so only the tree's shapes are needed
    variables = jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0),
        *(jnp.asarray(inputs[k]) for k in ("x", "mask", "t", "objs", "cats", "text")))
    params = _randomize(variables["params"], rs)
    stats = _randomize(variables["batch_stats"], rs, stats=True)
    port = SceneDiffusionModel(PORT_TINY)
    port.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    port.eval()
    return jmodel, {"params": params, "batch_stats": stats}, port, inputs


def _t(a):
    return torch.from_numpy(np.array(a))


def test_posa_backbone_matches_jax(setup):
    _, variables, port, inputs = setup
    verts = inputs["objs"][:, 0]
    want = jax.jit(JaxPOSA(vert_dims=TINY.vert_dims,
                           pcd_points=TINY.pcd_points).apply)(
        {"params": variables["params"]["human_backbone"]}, jnp.asarray(verts))
    with torch.no_grad():
        got = port.human_backbone(_t(verts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("fps_mode", ["auto", "exact"])
def test_pointnet2_backbone_matches_jax(setup, fps_mode):
    """"auto" skips FPS at sa1 (npoint == N); "exact" runs it there too."""
    _, variables, port, inputs = setup
    N = TINY.pcd_points
    kw = dict(sa_npoints=(N, max(N // 4, 4), max(N // 16, 2), max(N // 64, 1)),
              sa_nsample=min(32, N), fps_mode=fps_mode)
    clouds = inputs["objs"].reshape(-1, N, 3)
    want = jax.jit(JaxPointNet2(out_dim=TINY.pcd_dim, **kw).apply)(
        {"params": variables["params"]["pcd_backbone"],
         "batch_stats": variables["batch_stats"]["pcd_backbone"]},
        jnp.asarray(clouds))
    backbone = PointNet2Backbone(out_dim=TINY.pcd_dim, ball_impl="pallas", **kw)
    prefix = "pcd_backbone."
    backbone.load_state_dict(
        {k[len(prefix):]: v for k, v in port.state_dict().items()
         if k.startswith(prefix)}, strict=True)
    with torch.no_grad():
        got = backbone(_t(clouds))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def _jax_cond(jmodel, variables, inputs):
    return jax.jit(lambda v, *a: jmodel.apply(
        v, *a, method=jmodel.encode_conditioning))(
        variables, *(jnp.asarray(inputs[k]) for k in
                     ("mask", "objs", "cats", "text")))


def test_encode_conditioning_matches_jax(setup):
    jmodel, variables, port, inputs = setup
    want = _jax_cond(jmodel, variables, inputs)
    with torch.no_grad():
        got = port.encode_conditioning(*(_t(inputs[k]) for k in
                                         ("mask", "objs", "cats", "text")))
    for name in CondCache._fields:
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            atol=ATOL, rtol=0, err_msg=name)


def test_denoise_from_cond_matches_jax(setup):
    jmodel, variables, port, inputs = setup
    jcond = _jax_cond(jmodel, variables, inputs)
    want = jax.jit(lambda v, *a: jmodel.apply(
        v, *a, method=jmodel.denoise_from_cond))(
        variables, jcond, jnp.asarray(inputs["x"]), jnp.asarray(inputs["t"]))
    with torch.no_grad():
        got = port.denoise_from_cond(CondCache(*map(_t, jcond)),
                                     _t(inputs["x"]), _t(inputs["t"]))
    for name in ("x0", "cat", "guiding"):
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            atol=ATOL, rtol=0, err_msg=name)


def test_chain_tables_match_jax_timestep_cond_emb(setup):
    """K6's first pass (plain version on the CPU) builds, for a sequence of
    steps, the embedding that the JAX model's timestep_cond_emb gives."""
    jmodel, variables, port, inputs = setup
    jcond = _jax_cond(jmodel, variables, inputs)
    ts = np.array([15, 7, 3, 0], np.int32)
    B = inputs["x"].shape[0]
    want = np.stack([np.asarray(jax.jit(lambda v, c, t: jmodel.apply(
        v, c, t, method=jmodel.timestep_cond_emb))(
        variables, jcond, jnp.full((B,), t, jnp.int32))) for t in ts], axis=1)
    cond = CondCache(*map(_t, jcond))
    with torch.no_grad():
        p = extract_step_params(port)
        emb, g = denoise_chain_tables(port.step_emb2_table(cond, _t(ts)), p)
    np.testing.assert_allclose(emb.numpy(), want, atol=ATOL, rtol=0)
    D = TINY.latent_dim
    torch.testing.assert_close(g, emb @ p.wx0_t[D:] + p.bx0, atol=0, rtol=0)

"""The port's fused encode against the JAX package.

The plain versions of K7 (``sa_stage_fused``), K8 (``fp_stage_fused``) and
K4 (``rank1_mha_pallas``) against the Pallas kernels run in interpret mode
on the CPU, at the small shapes of the JAX package's own tests
(``tests/test_pointcloud_ops.py``); ``fold_conv_bn`` against JAX's; the
gates (which stages fuse at a tiny config) against JAX's; and the port's
``sample_sdm`` with ``ball_impl="fused"`` against JAX's composed sampler
with the same draws.  Inputs come from numpy seeds; weights cross through
the bridge.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsdm_tpu.config import SDMConfig
from lsdm_tpu.diffusion.schedule import make_schedule as jax_make_schedule
from lsdm_tpu.models.sampling import sample_sdm as jax_sample_sdm
from lsdm_tpu.models.sdm import SceneDiffusionModel as JaxSDM
from lsdm_tpu.ops.attn_pallas import rank1_mha_pallas
from lsdm_tpu.ops.fp_fused_pallas import fp_stage_fused
from lsdm_tpu.ops.sa_fused_pallas import fold_conv_bn as jax_fold_conv_bn
from lsdm_tpu.ops.sa_fused_pallas import sa_stage_fused
from lsdm_tpu_torch.config import SDMConfig as PortConfig
from lsdm_tpu_torch.diffusion.schedule import make_schedule
from lsdm_tpu_torch.models import pointnet2
from lsdm_tpu_torch.models.pointnet2 import Conv1x1
from lsdm_tpu_torch.models.sampling import sample_sdm
from lsdm_tpu_torch.models.sdm import SceneDiffusionModel
from lsdm_tpu_torch.ops import attention, attn, ballquery, fp_fused, sa_fused
from lsdm_tpu_torch.weights import state_dict_from_jax

# the JAX package's fused-vs-composed kernel bound (tests/test_pointcloud_ops.py)
RTOL, ATOL = 2e-5, 2e-6


def _a(rs, *shape, scale=1.0):
    return (rs.randn(*shape) * scale).astype(np.float32)


def _folded(rs, widths):
    return [(_a(rs, a, b, scale=a ** -0.5), _a(rs, b, scale=0.1))
            for a, b in zip(widths[:-1], widths[1:])]


def _port(folded):
    return [(torch.from_numpy(w), torch.from_numpy(b)) for w, b in folded]


def _jax(folded):
    return tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in folded)


@pytest.mark.parametrize("radius,far", [
    (0.8, False),  # the JAX test's case
    (0.3, False),  # most balls hold fewer points than nsample
    (0.8, True),   # one center far from the cloud: an empty ball
])
def test_sa_stage_plain_matches_pallas(radius, far):
    rs = np.random.RandomState(0)
    B, N, S, K = 2, 32, 16, 8
    xyz = _a(rs, B, N, 3)
    new_xyz = xyz[:, :S].copy()
    if far:
        new_xyz[1, 3] = 50.0
    base = np.concatenate([xyz, _a(rs, B, N, 5)], -1)
    folded = _folded(rs, (8, 8, 16))
    want = sa_stage_fused(radius, K, jnp.asarray(xyz), jnp.asarray(new_xyz),
                          jnp.asarray(base), _jax(folded), interpret=True)
    got = sa_fused.sa_stage_fused_plain(
        radius, K, torch.from_numpy(xyz), torch.from_numpy(new_xyz),
        torch.from_numpy(base), _port(folded))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    idx = ballquery.query_ball_point_plain(radius, K, torch.from_numpy(xyz),
                                           torch.from_numpy(new_xyz), empty=0)
    if far:  # K7's own rule: an empty ball gathers point 0 (K1's gives N - 1)
        assert (idx[1, 3] == 0).all()
    elif radius == 0.3:  # rows with fewer in-radius points than nsample
        assert (idx[..., -1] == idx[..., 0]).any()


@pytest.mark.parametrize("case", ["points1", "no_points1", "head", "two_sources"])
def test_fp_stage_plain_matches_pallas(case):
    rs = np.random.RandomState(1)
    B, N = 2, 32
    S = 2 if case == "two_sources" else 8  # S = 2: k = 2
    xyz1, xyz2 = _a(rs, B, N, 3), _a(rs, B, S, 3)
    p2 = _a(rs, B, S, 16)
    p1 = None if case in ("no_points1", "head") else _a(rs, B, N, 6)
    widths = (16 + (0 if p1 is None else 6), 8, 16)
    acts = None
    if case == "head":  # trailing layers as the backbone hands fp1 its head
        widths += (16, 3)
        acts = ("relu", "relu", "relu", "none")
    folded = _folded(rs, widths)
    want = fp_stage_fused(jnp.asarray(xyz1), jnp.asarray(xyz2),
                          None if p1 is None else jnp.asarray(p1),
                          jnp.asarray(p2), _jax(folded), acts=acts,
                          interpret=True)
    got = fp_fused.fp_stage_fused_plain(
        torch.from_numpy(xyz1), torch.from_numpy(xyz2),
        None if p1 is None else torch.from_numpy(p1), torch.from_numpy(p2),
        _port(folded), acts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    if case == "head":
        assert (got < 0).any()  # the last layer has no ReLU


def test_rank1_attention_plain_matches_pallas():
    rs = np.random.RandomState(2)
    q, k, v = _a(rs, 3, 64, 12), _a(rs, 3, 64, 12), _a(rs, 3, 64, 12)
    want = rank1_mha_pallas(*map(jnp.asarray, (q, k, v)), interpret=True)
    got = attn.rank1_mha_plain(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_fold_conv_bn_matches_jax():
    rs = np.random.RandomState(3)
    conv, bn = Conv1x1(7, 5, 2), torch.nn.BatchNorm1d(5, eps=1e-5)
    w, b = _a(rs, 5, 7, 1, 1), _a(rs, 5)
    gamma, beta, mean = _a(rs, 5), _a(rs, 5), _a(rs, 5)
    var = (rs.rand(5) + 0.5).astype(np.float32)
    with torch.no_grad():
        for t, a in ((conv.weight, w), (conv.bias, b), (bn.weight, gamma),
                     (bn.bias, beta), (bn.running_mean, mean), (bn.running_var, var)):
            t.copy_(torch.from_numpy(a))
    want = jax_fold_conv_bn({
        "params": {"conv": {"kernel": w.reshape(5, 7).T, "bias": b},
                   "bn": {"scale": gamma, "bias": beta}},
        "batch_stats": {"bn": {"mean": mean, "var": var}}})
    got = sa_fused.fold_conv_bn(conv, bn)
    for g, wv in zip(got, want):
        assert g.is_contiguous()
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(wv), rtol=1e-6, atol=0)


TINY_KW = dict(clip_dim=32, latent_dim=16, cat_emb=8, n_head=4, vert_dims=24,
               pcd_points=32)


def _inputs(cfg, B, seed):
    rs = np.random.RandomState(seed)
    O, N = cfg.max_objs, cfg.pcd_points
    mask = np.zeros((B, O), np.float32)
    mask[:, 1:4] = 1.0
    return (mask, _a(rs, B, O, N, 3),
            np.eye(cfg.max_cats, dtype=np.float32)[rs.randint(0, 13, (B, O))],
            _a(rs, B, cfg.clip_dim))


def _variables(jmodel, cfg, inputs, seed):
    B, N = inputs[0].shape[0], cfg.pcd_points
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((B, N, 3)), jnp.asarray(inputs[0]),
                            jnp.zeros((B,), jnp.int32),
                            *map(jnp.asarray, inputs[1:]))
    rs = np.random.RandomState(seed)

    def draw(path, a):
        if jax.tree_util.keystr(path).endswith("['var']"):
            return (rs.rand(*a.shape) + 0.5).astype(np.float32)
        return (rs.randn(*a.shape) * 0.2).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _recorder(log, name, fn, fake=None):
    """A stand-in for ``fn`` that logs the stage's shapes (and returns
    ``fake(...)`` instead of calling ``fn`` when it is given)."""
    def rec(*args, **kw):
        log.append((name,) + _shape_key(name, args))
        return fake(*args, **kw) if fake else fn(*args, **kw)
    return rec


def _shape_key(name, args):
    if name == "sa":   # (radius, nsample, xyz, new_xyz, ...): N -> S
        return args[2].shape[1], args[3].shape[1]
    if name == "fp":   # (xyz1, xyz2, ...): S -> N
        return args[1].shape[1], args[0].shape[1]
    return tuple(args[0].shape[1:])  # attention: (L, H)


def test_fused_gates_take_the_same_stages_as_jax(monkeypatch):
    """At pcd_points=32 the stage sizes are (32, 8, 2, 1): sa3/sa4 and fp4
    fail the gates, the other stages and the attention fuse, in JAX and in
    the port alike."""
    from lsdm_tpu.ops import attn_pallas, fp_fused_pallas, sa_fused_pallas

    cfg = SDMConfig(**TINY_KW, ball_impl="fused")
    inputs = _inputs(cfg, 1, 4)
    jmodel = JaxSDM(cfg)
    variables = _variables(jmodel, cfg, inputs, 5)

    def fake_sa(radius, nsample, xyz, new_xyz, base, folded, **_):
        return jnp.zeros(new_xyz.shape[:2] + (folded[-1][0].shape[1],))

    def fake_fp(xyz1, xyz2, p1, p2, folded, **_):
        return jnp.zeros(xyz1.shape[:2] + (folded[-1][0].shape[1],))

    jlog, plog = [], []
    monkeypatch.setattr(sa_fused_pallas, "sa_stage_fused",
                        _recorder(jlog, "sa", None, fake_sa))
    monkeypatch.setattr(fp_fused_pallas, "fp_stage_fused",
                        _recorder(jlog, "fp", None, fake_fp))
    monkeypatch.setattr(attn_pallas, "rank1_mha_pallas",
                        _recorder(jlog, "attn", None, lambda q, *a, **k: q))
    jmodel.apply(variables, *map(jnp.asarray, inputs),
                 method=JaxSDM.encode_conditioning)

    for mod, attr, name in ((pointnet2, "sa_stage_fused_kernel", "sa"),
                            (pointnet2, "fp_stage_fused_kernel", "fp"),
                            (attention, "rank1_mha_kernel", "attn")):
        monkeypatch.setattr(mod, attr, _recorder(plog, name, getattr(mod, attr)))
    port = SceneDiffusionModel(PortConfig(**TINY_KW, ball_impl="fused")).eval()
    with torch.no_grad():
        port.encode_conditioning(*map(torch.from_numpy, inputs))

    assert plog == jlog
    assert sorted(jlog) == sorted([("sa", 32, 32), ("sa", 32, 8), ("fp", 2, 8),
                                   ("fp", 8, 32), ("fp", 32, 32), ("attn", 32, 12)])


def test_fused_sampling_slice_matches_jax_composed(monkeypatch):
    """pcd_points=512 (stage sizes 512, 128, 32, 8: every stage passes its
    gate), tiny widths, 4 DDPM steps: the port's fused encode and K6 chain
    (plain versions on the CPU) against JAX's composed sampler."""
    kw = dict(TINY_KW, pcd_points=512, vert_dims=256)
    cfg = SDMConfig(**kw)
    inputs = _inputs(cfg, 1, 6)
    jmodel = JaxSDM(cfg)
    variables = _variables(jmodel, cfg, inputs, 7)
    key = jax.random.PRNGKey(11)
    with jax.default_matmul_precision("highest"):
        s_want, out_want = jax.jit(lambda v, k, *a: jax_sample_sdm(
            jmodel, v, jax_make_schedule("cosine", 4), *a, k))(
                variables, key, *map(jnp.asarray, inputs))
    step_key, init_key = jax.random.split(key)
    N = cfg.pcd_points
    x_init = np.array(jax.random.normal(init_key, (1, N, 3), jnp.float32))
    noise = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(step_key, i), (1, N, 3), jnp.float32)) for i in range(4)])

    port = SceneDiffusionModel(PortConfig(**kw, ball_impl="fused"))
    port.load_state_dict(state_dict_from_jax(variables["params"],
                                             variables["batch_stats"]), strict=True)
    calls = []
    for mod, attr, name in ((pointnet2, "sa_stage_fused_kernel", "sa"),
                            (pointnet2, "fp_stage_fused_kernel", "fp"),
                            (attention, "rank1_mha_kernel", "attn")):
        monkeypatch.setattr(mod, attr, _recorder(calls, name, getattr(mod, attr)))
    s_got, out_got = sample_sdm(
        port.eval(), make_schedule("cosine", 4), *map(torch.from_numpy, inputs),
        fused_step="chain", x_init=torch.from_numpy(x_init),
        noise=torch.from_numpy(noise))
    assert sorted(c[0] for c in calls) == ["attn"] + ["fp"] * 4 + ["sa"] * 4
    # folded BatchNorm and float32 sums in another order (the JAX package's
    # own fused-vs-composed sampling bound, tests/test_pallas_kernels.py)
    for name, got, want in (("sample", s_got, s_want), ("x0", out_got.x0, out_want.x0),
                            ("guiding", out_got.guiding, out_want.guiding),
                            ("cat", out_got.cat, out_want.cat)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                                   rtol=0, err_msg=name)


def test_fused_impl_runs_the_pallas_selection_where_a_gate_declines():
    assert pointnet2._resolve_impl("fused") == "fused"
    bb = pointnet2.PointNet2Backbone(sa_npoints=(32, 8, 2, 1), sa_nsample=32,
                                     ball_impl="fused")
    assert {m.sel for m in (bb.sa3, bb.sa4, bb.fp4)} == {"pallas"}
    with pytest.raises(NotImplementedError, match="K10"):
        pointnet2._resolve_impl("sg")

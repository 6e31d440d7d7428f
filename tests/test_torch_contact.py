"""The port's contact-semantics stack against the JAX package on the CPU.

Spiral extraction, the mesh graph operators and assets, the four contact
loaders, the POSA VAE, ContactFormer in each decoder mode (forward in
float32, one Adam train step in float64), the weight bridge and the
Bridge's box preprocessing, at the tiny sizes of ``tests/test_atiss_cf.py``
(mesh levels (16, 8, 4), ``seg_len`` 8, one layer, two heads, ``d_hid``
32).  The reparameterisation noise is JAX's draw, handed to the port.
"""

import functools
import os

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.sparse as sp
import torch

import chip_smoke
from lsdm_tpu.data import contact_dataset as jax_contact
from lsdm_tpu.data import mesh_assets as jax_assets
from lsdm_tpu.models import atiss as jax_atiss
from lsdm_tpu.models import contactformer as jax_cf
from lsdm_tpu.models.bridge import BridgeModel as JaxBridge
from lsdm_tpu.models import posa as jax_posa
from lsdm_tpu.models.posa import POSA as JaxPOSA
from lsdm_tpu.ops import mesh as jax_mesh
from lsdm_tpu.ops import spiral as jax_spiral
from lsdm_tpu.ops.recon_metrics import compute_recon_loss as jax_recon_loss
from lsdm_tpu_torch.data import contact_dataset, mesh_assets
from lsdm_tpu_torch.models.bridge import BridgeModel, contact_class_to_category
from lsdm_tpu_torch.models.contactformer import ContactFormer
from lsdm_tpu_torch.models.posa import POSA
from lsdm_tpu_torch.ops import mesh, spiral
from lsdm_tpu_torch.train.contact import contact_loss, contact_train_step
from lsdm_tpu_torch.weights import contactformer_state_dict_from_jax, init_weights

NV = (16, 8, 4)
KW = dict(seg_len=8, n_layer=1, n_head=2, dim_ff=32, d_hid=32)
T_VALID = 5  # frames of the 8-frame window that hold data; the rest is padding
# float32 forward: |port - JAX| <= FWD_TOL * max(1, max |JAX|) over each
# output, and |port - float64| <= FWD_TOL * max(1, |float64|) elementwise.
# Elementwise against JAX's float32 it does not hold: flax's norms take the
# variance as E[x^2] - E[x]^2, and JAX's own mu and logvar lie up to 2.7e-5
# from its float64 values where the port's lie 1.2e-6 away (mode 0).
FWD_TOL = 1e-5
F64_RTOL = 1e-9  # float64 train step: loss, gradients (of each leaf's max)
# float64 parameters after one Adam step (lr 1e-3): an attention's key bias
# has a gradient that is zero in exact arithmetic (softmax ignores a shift of
# its logits), ~1e-17 of rounding on each side, which Adam scales by lr/eps
# (1e5) into updates of ~1e-12 that differ
F64_PARAM_ATOL = 1e-11


def _mesh():
    verts, faces = jax_spiral.grid_mesh(4)
    sp0 = jax_spiral.extract_spirals(verts, faces, 9)
    sp1 = np.tile(np.arange(NV[1])[:, None], (1, 9)).astype(np.int32)
    sp2 = np.tile(np.arange(NV[2])[:, None], (1, 9)).astype(np.int32)
    d1 = np.array(jax_mesh.synthetic_graph_params(NV[1], NV[0]).D)
    d2 = np.array(jax_mesh.synthetic_graph_params(NV[2], NV[1]).D)
    return (sp0, sp1, sp2), (d1, d2)


def _inputs(seed=0):
    """A padded 8-frame window: T_VALID frames of one-hot contacts and
    vertices, zeros after them, and its (1, 8) mask."""
    rs = np.random.RandomState(seed)
    cf = np.zeros((8, NV[0], 8), np.float32)
    cf[:T_VALID] = np.eye(8, dtype=np.float32)[rs.randint(0, 8, (T_VALID, NV[0]))]
    verts = np.zeros((8, NV[0], 3), np.float32)
    verts[:T_VALID] = rs.randn(T_VALID, NV[0], 3)
    mask = np.zeros((1, 8), np.float32)
    mask[0, :T_VALID] = 1.0
    return cf, verts, mask


def _jax_model(mode, dtype=jnp.float32):
    spirals, downs = _mesh()
    return jax_cf.ContactFormer(spiral_indices=spirals,
                                down_mats=tuple(jnp.asarray(d) for d in downs),
                                decoder_mode=mode, dtype=dtype, vert_dims=NV[0],
                                **KW)


def _port_model(mode):
    spirals, downs = _mesh()
    return ContactFormer(spirals, tuple(torch.from_numpy(d) for d in downs),
                         decoder_mode=mode, **KW)


@pytest.fixture(scope="module")
def jax_params():
    """JAX's initial params of each mode, every leaf moved by a seeded
    draw (scales off one, biases off zero), as numpy float32."""
    cache = {}

    def get(mode):
        if mode not in cache:
            cf, verts, mask = _inputs()
            jm = _jax_model(mode)
            shapes = jax.eval_shape(lambda: jm.init(
                {"params": jax.random.PRNGKey(0)}, cf, verts, mask,
                jax.random.PRNGKey(1)))["params"]
            rs = np.random.RandomState(mode)

            def draw(s):
                if len(s.shape) == 1:  # a bias or a norm's scale
                    return (1.0 + 0.2 * rs.randn(*s.shape)).astype(np.float32)
                return (rs.randn(*s.shape) / np.sqrt(s.shape[-1])).astype(np.float32)

            cache[mode] = jax.tree.map(draw, shapes)
        return cache[mode]
    return get


def _close(got, want, tol, what, elementwise=True):
    """|got - want| <= tol * max(1, |want|), elementwise or at the scale of
    the whole tensor (its largest |want|)."""
    got = got.detach().double().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float64)
    scale = np.abs(want) if elementwise else np.abs(want).max()
    err = np.abs(got - want) / np.maximum(1.0, scale)
    assert err.max() <= tol, f"{what}: worst {err.max():.3g} > {tol}"


def _jax_float64(monkeypatch):
    """JAX's model computed wholly in float64: its attention and its mesh
    product sum into float32 (``preferred_element_type``) whatever their
    inputs, so they are taken without that rounding (``_attention_f64``,
    ``_ds_us_f64``), and flax's LSTM cell keeps a float32 carry unless its
    ``param_dtype`` says otherwise; the float32 tests hold the real
    functions."""
    monkeypatch.setattr(jax_cf, "multihead_attention", _attention_f64)
    monkeypatch.setattr(jax_atiss, "multihead_attention", _attention_f64)
    monkeypatch.setattr(jax_posa, "ds_us", _ds_us_f64)
    monkeypatch.setattr(jax_cf.nn, "OptimizedLSTMCell", functools.partial(
        flax.linen.OptimizedLSTMCell, param_dtype=jnp.float64))


# ---------------------------------------------------------------- meshes


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7])
@pytest.mark.parametrize("seq_length,dilation", [(1, 1), (9, 1), (5, 2), (15, 1)])
def test_extract_spirals_and_grid_mesh_equal_jax(n, seq_length, dilation):
    # n = 1, 2 (and 3 at 15) run the rings dry: sklearn's KD-tree order
    verts, faces = spiral.grid_mesh(n)
    jverts, jfaces = jax_spiral.grid_mesh(n)
    np.testing.assert_array_equal(verts, jverts)
    np.testing.assert_array_equal(faces, jfaces)
    got = spiral.extract_spirals(verts, faces, seq_length, dilation)
    np.testing.assert_array_equal(
        got, jax_spiral.extract_spirals(jverts, jfaces, seq_length, dilation))


def test_kdtree_fallback_orders_ties_as_sklearn():
    """The nearest-neighbour fallback against scikit-learn's KD-tree on
    integer grids full of equal distances, every vertex, up to 80 vertices
    and 15 neighbours (one leaf; ``ops/spiral.py``)."""
    from sklearn.neighbors import KDTree

    rs = np.random.RandomState(0)
    for _ in range(60):
        n = rs.randint(1, 81)
        pts = rs.randint(0, 3, (n, 3)).astype(np.float64) * rs.choice([1.0, 0.1])
        k = rs.randint(1, min(n, 15) + 1)
        want = KDTree(pts).query(pts, k=k, return_distance=False)
        for v in range(n):
            assert spiral._kdtree_knn(pts, v, k) == want[v].tolist(), (n, k, v)


def test_load_obj_equals_jax(tmp_path):
    path = tmp_path / "m.obj"
    path.write_text("# mesh\nv 0 0 0\nv 1 0.5 0\nv 0 1 2.5\nvn 0 0 1\n"
                    "f 1/1/1 2/2/2 3/3/3\nf 3 2 1\n")
    for got, want in zip(spiral.load_obj(str(path)), jax_spiral.load_obj(str(path))):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _adjacency(n, seed):
    rs = np.random.RandomState(seed)
    a = (rs.rand(n, n) < 0.3).astype(np.float32)
    return np.maximum(a, a.T)


@pytest.mark.parametrize("nsize", [1, 2])
def test_row_normalized_adjacency_equals_jax(nsize):
    a = _adjacency(12, nsize)
    np.testing.assert_array_equal(mesh.row_normalized_adjacency(a, nsize),
                                  jax_mesh.row_normalized_adjacency(a, nsize))


@pytest.mark.parametrize("shape", [(8, 16), (4, 8), (41, 164), (1, 3)])
def test_synthetic_graph_params_equal_jax(shape):
    got = mesh.synthetic_graph_params(*shape)
    want = jax_mesh.synthetic_graph_params(*shape)
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor) and g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _write_mesh_ds(root):
    """A mesh_ds folder: grid meshes for levels 2-4, A/D/U for levels 3-4."""
    os.makedirs(root)
    for level, n in ((2, 4), (3, 3), (4, 2)):
        verts, faces = spiral.grid_mesh(n)
        with open(os.path.join(root, f"mesh_{level}.obj"), "w") as f:
            f.writelines(f"v {x} {y} {z}\n" for x, y, z in verts)
            f.writelines(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in faces)
    for layer, (n_out, n_in) in ((3, (9, 16)), (4, (4, 9))):
        rs = np.random.RandomState(layer)
        sp.save_npz(os.path.join(root, f"A_{layer}.npz"),
                    sp.csr_matrix(_adjacency(n_in, layer)))
        sp.save_npz(os.path.join(root, f"D_{layer}.npz"),
                    sp.csr_matrix(rs.rand(n_out, n_in) * (rs.rand(n_out, n_in) < 0.4)))
        sp.save_npz(os.path.join(root, f"U_{layer}.npz"),
                    sp.csr_matrix(rs.rand(n_in, n_out) * (rs.rand(n_in, n_out) < 0.4)))


def test_get_graph_params_equals_jax(tmp_path):
    root = str(tmp_path / "mesh_ds")
    _write_mesh_ds(root)
    for layer in (3, 4):
        got = mesh.get_graph_params(root, layer)
        for g, w in zip(got, jax_mesh.get_graph_params(root, layer)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("real,nv", [(False, None), (False, (16, 8, 4)),
                                     (False, (16, 4, 1)), (True, None)])
def test_load_mesh_assets_equals_jax(tmp_path, real, nv):
    """The synthetic grid assets (no mesh_ds folder: nv from the override or
    BODY_NV), and assets read from a mesh_ds folder, each array equal;
    spirals cached beside the meshes."""
    root = str(tmp_path / "mesh_ds")
    if real:
        _write_mesh_ds(root)
    got = mesh_assets.load_mesh_assets(root, 9, nv)
    want = jax_assets.load_mesh_assets(root, 9, nv)
    assert got.synthetic == want.synthetic == (not real)
    assert tuple(got.nv) == tuple(want.nv)
    for g, w in zip(got.spiral_indices, want.spiral_indices):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got.down_mats + got.up_mats, want.down_mats + want.up_mats):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_ds_us_equals_jax():
    rs = np.random.RandomState(0)
    M = rs.rand(41, 164).astype(np.float32)
    x = rs.randn(3, 164, 64).astype(np.float32)
    got = mesh.ds_us(torch.from_numpy(M), torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (3, 41, 64)
    # sums of 164 float32 products in another order: <= 1e-6 of the largest
    want = np.asarray(jax_mesh.ds_us(M, x))
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()


# ---------------------------------------------------------------- loaders


@pytest.fixture(scope="module")
def contact_data(tmp_path_factory):
    return chip_smoke.contact_split(str(tmp_path_factory.mktemp("contact")),
                                    n_seqs=3, frames=70, nv=NV[0], seed=4)


@pytest.mark.parametrize("cls,kw", [
    ("ProxContactDataset", dict(max_frame=8, jump_step=2)),
    ("ProxContactDataset", dict(max_frame=32, jump_step=4)),  # windows past the end
    ("ProxSegDataset", dict(train_seg_len=8, jump_step=2)),
    ("ProxSegDatasetSeq", dict(train_seg_len=6, num_seg=3, stride=5)),
    ("ProxSegDatasetVar", dict(max_frame=8, num_seg=4, dist_eps=0.2, jump_step=2)),
])
def test_contact_loaders_draw_as_jax(contact_data, cls, kw):
    got = getattr(contact_dataset, cls)(contact_data, seed=3, **kw)
    want = getattr(jax_contact, cls)(contact_data, seed=3, **kw)
    assert len(got) == len(want) and got.seq_names == want.seq_names
    for i in range(6):
        for g, w in zip(got[i], want[i]):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("cls", ["ProxContactDataset", "ProxSegDataset"])
def test_contact_loaders_fix_orientation_as_jax(contact_data, tmp_path, cls):
    """``fix_ori``: the port's ``normalize_orientation`` (float32 torch)
    against JAX's, within 1e-6; the draws stay equal."""
    w = np.random.RandomState(0).rand(NV[0], 4)
    path = str(tmp_path / "weights.npy")
    np.save(path, w)
    kw = dict(fix_orientation=True, ds_weights_path=path, seed=5)
    got = getattr(contact_dataset, cls)(contact_data, **kw)
    want = getattr(jax_contact, cls)(contact_data, **kw)
    for i in range(4):
        g, w_ = got[i], want[i]
        np.testing.assert_allclose(g[0], w_[0], rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(g[1], w_[1])


# ---------------------------------------------------------------- models


def test_posa_forward_and_decode_equal_jax():
    spirals, downs = _mesh()
    cf, verts, _ = _inputs(1)
    jm = JaxPOSA(spiral_indices=spirals, down_mats=downs, nv=NV)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), cf, verts,
                                            jax.random.PRNGKey(1)))["params"]
    rs = np.random.RandomState(7)
    params = jax.tree.map(lambda s: (rs.randn(*s.shape) * 0.3).astype(np.float32),
                          shapes)
    out, mu, logvar = jm.apply({"params": params}, cf, verts, jax.random.PRNGKey(2))
    eps = jax.random.normal(jax.random.PRNGKey(2), mu.shape, jnp.float32)
    port = POSA(spirals, tuple(torch.from_numpy(d) for d in downs))
    port.load_state_dict(contactformer_state_dict_from_jax(params))
    got = port(torch.from_numpy(cf), torch.from_numpy(verts),
               eps=torch.from_numpy(np.array(eps)))
    for g, w, what in zip(got, (out, mu, logvar), ("logits", "mu", "logvar")):
        assert tuple(g.shape) == w.shape
        _close(g, w, FWD_TOL, what)
    z = rs.randn(8, 256).astype(np.float32)
    want = jm.apply({"params": params}, z, verts, method=jm.decode)
    _close(port.decode(torch.from_numpy(z), torch.from_numpy(verts)), want,
           FWD_TOL, "decode")


@pytest.mark.parametrize("mode", [0, 1, 2, 3, 4])
def test_contactformer_forward_equals_jax(jax_params, mode, monkeypatch):
    """The port in float32 against JAX's float32 forward at the scale of
    each output, and elementwise against JAX's float64 forward (FWD_TOL)."""
    params = jax_params(mode)
    cf, verts, mask = _inputs()
    port = _port_model(mode)
    port.load_state_dict(contactformer_state_dict_from_jax(params))
    key = jax.random.PRNGKey(3)

    def run(eps):
        return port(torch.from_numpy(cf), torch.from_numpy(verts),
                    torch.from_numpy(mask), eps=torch.from_numpy(np.array(eps)))

    want = _jax_model(mode).apply({"params": params}, cf, verts, mask, key)
    got = run(jax.random.normal(key, (8, 256), jnp.float32))
    for g, w, what in zip(got, want, ("logits", "mu", "logvar")):
        assert tuple(g.shape) == w.shape
        _close(g, w, FWD_TOL, f"mode {mode} {what}", elementwise=False)
    _jax_float64(monkeypatch)
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        want = _jax_model(mode, jnp.float64).apply(
            {"params": p64}, *(jnp.asarray(a, jnp.float64) for a in (cf, verts, mask)),
            key)
        eps = np.asarray(jax.random.normal(key, (8, 256), jnp.float64), np.float32)
    for g, w, what in zip(run(eps), want, ("logits", "mu", "logvar")):
        _close(g, w, FWD_TOL, f"mode {mode} {what} against float64")


def _to_jax_tree(sd, mode):
    """A mapping of the port's parameter names (to numpy arrays: the
    parameters, their gradients) as JAX's tree: the bridge inverted (norm
    ``weight`` -> ``scale``; the LSTM's stacked gates split)."""
    flat = {}
    for key, v in sd.items():
        if key.startswith("lstm."):
            continue
        leaf = key.rsplit(".", 1)
        if leaf[1] == "weight" and leaf[0].split(".")[-1].startswith("norm"):
            key = leaf[0] + ".scale"
        flat[key] = v
    if mode == 4:
        for direction, suffix in (("fwd", "_l0"), ("bwd", "_l0_reverse")):
            assert not sd[f"lstm.bias_ih{suffix}"].any()
            for kind, w in (("i", sd[f"lstm.weight_ih{suffix}"]),
                            ("h", sd[f"lstm.weight_hh{suffix}"])):
                for gate, rows in zip("ifgo", np.split(w, 4)):
                    flat[f"lstm_{direction}.cell.{kind}{gate}.kernel"] = rows.T
            for gate, b in zip("ifgo", np.split(sd[f"lstm.bias_hh{suffix}"], 4)):
                flat[f"lstm_{direction}.cell.h{gate}.bias"] = b
    tree = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


@pytest.mark.parametrize("mode", [0, 1, 2, 3, 4])
def test_weight_bridge_round_trip(jax_params, mode):
    """JAX params -> the port (a strict load, every parameter and buffer
    the port keeps) -> back: every leaf of JAX's tree, bit for bit."""
    params = jax_params(mode)
    port = _port_model(mode)
    port.load_state_dict(contactformer_state_dict_from_jax(params), strict=True)
    back = _to_jax_tree({k: v.numpy() for k, v in port.state_dict().items()}, mode)
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, params))
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(params)[0],
                            jax.tree.leaves(back)):
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(path))


def _ds_us_f64(M, x):
    """JAX's ``ds_us`` with no float32 ``preferred_element_type``."""
    return jnp.einsum("mn,...nc->...mc", M, x)


def _attention_f64(q, k, v, num_heads, attn_mask=None, dtype=None):
    """JAX's ``multihead_attention`` (general path), with no float32
    ``preferred_element_type``: in float64 its products are float64."""
    B, L, E = q.shape
    S, H = k.shape[1], num_heads
    Dh = E // H
    qh, kh, vh = (t.reshape(B, -1, H, Dh).transpose(0, 2, 1, 3) for t in (q, k, v))
    logits = jnp.einsum("bhld,bhsd->bhls", qh / jnp.sqrt(float(Dh)), kh)
    if attn_mask is not None:
        logits = logits + attn_mask.astype(logits.dtype)[None, None]
    weights = jax.nn.softmax(logits, axis=-1)
    out = jnp.einsum("bhls,bhsd->bhld", weights, vh)
    return out.transpose(0, 2, 1, 3).reshape(B, L, E), weights.mean(1)


@pytest.mark.parametrize("mode", [0, 1, 2, 3, 4])
def test_contactformer_train_step_equals_jax_in_float64(jax_params, mode, monkeypatch):
    """One ``train_contactformer`` step, both sides in float64
    (``_jax_float64``): JAX's ``value_and_grad`` of its trainer's loss +
    ``optax.adam`` against ``train/contact.py`` (``torch.optim.Adam``).
    flax's norms take the fast variance, torch's two passes: in float64
    they agree far below the bounds."""
    _jax_float64(monkeypatch)
    lr, kl_beta = 1e-3, 0.5
    params32 = jax_params(mode)
    cf, verts, mask = _inputs(2)
    with jax.enable_x64(True):
        jm = _jax_model(mode, jnp.float64)
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params32)
        key = jax.random.PRNGKey(9)
        J = [jnp.asarray(a, jnp.float64) for a in (cf, verts, mask)]

        def loss_fn(p):  # lsdm_tpu/run/train_contactformer.py:82-90
            out, mu, logvar = jm.apply({"params": p}, J[0], J[1], J[2], key)
            gt = jnp.argmax(J[0], -1)[None]
            frame_mask = jnp.broadcast_to(J[2][..., None], gt.shape)
            recon, acc = jax_recon_loss(gt, out, mask=frame_mask)
            kl = -0.5 * jnp.mean(1 + logvar - mu ** 2 - jnp.exp(logvar))
            return recon + kl_beta * kl, (recon, acc)

        (loss_j, (recon_j, acc_j)), grads_j = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        tx = optax.adam(lr)
        updates, _ = tx.update(grads_j, tx.init(params), params)
        new_j = optax.apply_updates(params, updates)
        eps = np.asarray(jax.random.normal(key, (8, 256), jnp.float64))
        grads_j, new_j = (jax.tree.map(np.asarray, t) for t in (grads_j, new_j))

    port = _port_model(mode)
    port.load_state_dict(contactformer_state_dict_from_jax(params32))
    port.double().train()
    T = [torch.from_numpy(a).double() for a in (cf, verts, mask)]
    names = dict(port.named_parameters())
    optimizer = torch.optim.Adam(port.parameters(), lr=lr)
    loss, recon, acc = contact_train_step(port, optimizer, *T, kl_beta,
                                          eps=torch.from_numpy(eps))
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=F64_RTOL)
    np.testing.assert_allclose(recon.item(), float(recon_j), rtol=F64_RTOL)
    assert acc.item() == float(acc_j)
    grads = _to_jax_tree({n: (p.grad if p.grad is not None else torch.zeros_like(p))
                          .numpy() for n, p in names.items()}, mode)
    new = _to_jax_tree({n: p.detach().numpy() for n, p in names.items()}, mode)
    for (path, w), g, p, pw in zip(jax.tree_util.tree_flatten_with_path(grads_j)[0],
                                   jax.tree.leaves(grads), jax.tree.leaves(new),
                                   jax.tree.leaves(new_j)):
        name = jax.tree_util.keystr(path)
        assert np.abs(g - w).max() <= F64_RTOL * max(np.abs(w).max(), 1e-30), name
        assert np.abs(p - pw).max() <= F64_PARAM_ATOL, name


def test_contact_loss_is_the_trainer_objective():
    """``contact_loss`` = masked CE + kl_beta * KL, the padded frames out."""
    port = init_weights(_port_model(3), 0)
    cf, verts, mask = (torch.from_numpy(a) for a in _inputs(3))
    eps = torch.zeros(8, 256)
    loss, (recon, acc, kl) = contact_loss(port, cf, verts, mask, 0.25, eps=eps)
    out, mu, logvar = port(cf, verts, mask, eps=eps)
    logp = torch.log_softmax(out[0, :T_VALID], -1)
    ce = -logp.gather(-1, cf[:T_VALID].argmax(-1)[..., None]).mean()
    torch.testing.assert_close(recon, ce)
    torch.testing.assert_close(loss, recon + 0.25 * kl)
    assert 0.0 <= float(acc) <= 1.0


# ---------------------------------------------------------------- bridge


def test_contact_class_lookup():
    assert contact_class_to_category(3, "proxd") == 1  # chair
    assert contact_class_to_category(1, "proxd") == -1  # wall not a category
    assert contact_class_to_category(6, "humanise") == 1  # bed


@pytest.mark.parametrize("seed", [0, 1])
def test_bridge_make_boxes_equals_jax(seed):
    """The same boxes from the same seed, with a stand-in decoder (logits
    from the vertex positions, as ``tests/test_atiss_cf.py``'s) on each
    side; ATISS stays a callable (a stub that returns the boxes)."""
    def decode_jax(z, verts):
        return jnp.tile(verts[..., :1], (1, 1, 8)) * jnp.arange(8) + 0.1 * z[:, :1, None]

    def decode_port(z, verts):
        return verts[..., :1].repeat(1, 1, 8) * torch.arange(8) + 0.1 * z[:, :1, None]

    rng = np.random.RandomState(seed)
    objs = rng.randn(2, 5, 64, 3).astype(np.float32)
    cats = np.eye(12, dtype=np.float32)[rng.randint(0, 12, (2, 5))]
    mask = np.zeros((2, 5), np.float32)
    mask[:, :4] = 1
    got = BridgeModel(lambda b: b, decode_port, "proxd", 15, seed=seed)(objs, cats, mask)
    want = JaxBridge(lambda b: b, decode_jax, "proxd", 15, seed=seed)(objs, cats, mask)
    assert sorted(got) == sorted(want)
    for k in want:
        assert isinstance(got[k], torch.Tensor)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)

"""Shared parts of the ATISS parity tests (``test_torch_atiss.py``,
``test_torch_atiss_sampling.py``): the JAX and port models at tiny widths,
their inputs, numpy-drawn weights carried across, jitted JAX applies, the
tolerances, JAX's random draws in the port's order, and JAX's attention
summed in float64 for the float64 cases.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import traverse_util

from lsdm_tpu.models import atiss as jax_atiss
from lsdm_tpu_torch.models import atiss
from lsdm_tpu_torch.weights import atiss_state_dict_from_jax

C = 15  # classes
KW = dict(n_layers=2, n_heads=4, dim_ff=64, hidden_dims=32, feature_size=8,
          n_mixtures=3)
NR = KW["n_mixtures"]
# readings (worst |port - JAX| / max(1, |JAX|)) in each test's docstring
F32_TOL = 1e-5
F64_TOL = 1e-10
FEATURES = {"quirk": "resnet18", "alexnet": "alexnet", "pe_resnet": "resnet18",
            "mime_resnet": "resnet18"}  # else the simple extractor


def _jax_model(variant, dtype=jnp.float32, scalar=True, n_classes=C):
    kw = dict(KW, scalar_head=scalar, dtype=dtype,
              feature_extractor_name=FEATURES.get(variant, "simple"),
              torch_seq_axis_quirk=variant == "quirk")
    if variant.startswith("pe"):
        return jax_atiss.AutoregressiveTransformerPE(n_classes=n_classes, **kw)
    if variant.startswith("mime"):
        return jax_atiss.MIME(n_classes, **kw)
    return jax_atiss.AutoregressiveTransformer(n_classes=n_classes, **kw)


def _port_model(variant, scalar=True, n_classes=C):
    kw = dict(KW, scalar_head=scalar,
              feature_extractor_name=FEATURES.get(variant, "simple"),
              torch_seq_axis_quirk=variant == "quirk")
    if variant.startswith("pe"):
        return atiss.AutoregressiveTransformerPE(n_classes, **kw)
    if variant.startswith("mime"):
        return atiss.MIME(n_classes, **kw)
    return atiss.AutoregressiveTransformer(n_classes, **kw)


def _boxes(B=2, L=5, contact=False, seed=0, valid=True, n_classes=C):
    rs = np.random.RandomState(seed)
    eye = np.eye(n_classes, dtype=np.float32)
    b = {
        "class_labels": eye[rs.randint(0, n_classes, (B, L))],
        "translations": rs.randn(B, L, 3) * 0.5,
        "sizes": rs.rand(B, L, 3),
        "angles": rs.randn(B, L, 1) * 0.3,
        "room_layout": (rs.rand(B, 1, 64, 64) > 0.4).astype(np.float32),
        "class_labels_tr": eye[rs.randint(0, n_classes, (B, 1))],
        "translations_tr": rs.randn(B, 1, 3) * 0.5,
        "sizes_tr": rs.rand(B, 1, 3),
        "angles_tr": rs.randn(B, 1, 1) * 0.3,
    }
    if valid:  # padded slots, a different count a scene
        vm = np.ones((B, L))
        vm[0, L - 2:] = 0
        vm[-1, 2:] = 0
        b["valid_mask"] = vm
    if contact:
        b["contact_labels"] = (rs.rand(B, L, 1) > 0.5).astype(np.float32)
    return {k: np.asarray(v, np.float32) for k, v in b.items()}


def _jax(b, dtype=jnp.float32):
    return {k: jnp.asarray(v, dtype) for k, v in b.items()}


def _torch(b, dtype=torch.float32):
    return {k: torch.as_tensor(np.asarray(v), dtype=dtype) for k, v in b.items()}


def _draw(shapes, seed=1):
    """numpy values for a tree of JAX shapes: weights N(0, 1 / fan_in)
    (torch layout (out, in, ...) for ``weight``, flax's (..., in, out) for
    ``kernel``), norms' scales 1 + N(0, 0.04), biases N(0, 0.04), running
    means N(0, 0.25), variances U(0.5, 2), embeddings N(0, 1)."""
    rs = np.random.RandomState(seed)
    out = {}
    for col, tree in shapes.items():
        flat = traverse_util.flatten_dict(tree)
        for path, sd in flat.items():
            shape, leaf = sd.shape, path[-1]
            if leaf == "mean":
                v = 0.5 * rs.randn(*shape)
            elif leaf == "var":
                v = rs.uniform(0.5, 2.0, shape)
            elif leaf == "scale":
                v = 1.0 + 0.2 * rs.randn(*shape)
            elif leaf in ("bias", "in_proj_bias"):
                v = 0.2 * rs.randn(*shape)
            elif leaf == "kernel":
                v = rs.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
            elif leaf in ("weight", "in_proj_weight"):
                v = rs.randn(*shape) / np.sqrt(np.prod(shape[1:]))
            else:  # the empty token, the slot embedding
                v = rs.randn(*shape)
            flat[path] = v.astype(np.float32)
        out[col] = traverse_util.unflatten_dict(flat)
    return out


@functools.lru_cache(maxsize=None)
def _setup(variant, scalar=True, n_classes=C, end_bias=0.0):
    """(JAX model, its variables as numpy trees, the port model with them)."""
    jm = _jax_model(variant, scalar=scalar, n_classes=n_classes)
    b = _boxes(L=3, contact=variant.startswith("mime"), n_classes=n_classes)
    variables = _draw(jax.eval_shape(jm.init, jax.random.PRNGKey(0), _jax(b)))
    variables["params"]["hidden2output"]["class_layer"]["bias"][-1] += end_bias
    port = _port_model(variant, scalar, n_classes)
    port.load_state_dict(atiss_state_dict_from_jax(
        variables["params"], variables.get("batch_stats")), strict=True)
    return jm, variables, port.eval()


def _port64(variant, scalar=True, n_classes=C, end_bias=0.0):
    port = _setup(variant, scalar, n_classes, end_bias)[2]
    port64 = _port_model(variant, scalar, n_classes).double()
    port64.load_state_dict(port.state_dict())
    return port64.eval()


@functools.lru_cache(maxsize=None)
def _japply(variant, dtype="float32", scalar=True, n_classes=C, method=None):
    """The JAX model's ``apply`` (or ``method``), jitted once; float64 ones
    are called under ``jax.enable_x64``."""
    jm = _jax_model(variant, getattr(jnp, dtype), scalar, n_classes)
    return jax.jit(functools.partial(jm.apply, method=method))


def _close(got, want, tol, what):
    got = got.detach().double().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= tol, f"{what}: worst {err.max():.3g} > {tol}"
    return float(err.max())


_jax_attention = jax_atiss.multihead_attention


def _attention(q, k, v, num_heads, attn_mask=None, dtype=jnp.float32):
    """JAX's ``multihead_attention``; in float64 (general path) without its
    float32 ``preferred_element_type`` sums, so that its products are
    float64 (the scale stays the float32 1/sqrt(Dh), as JAX's and the
    port's)."""
    if q.dtype != jnp.float64:
        return _jax_attention(q, k, v, num_heads, attn_mask, dtype)
    B, L, E = q.shape
    S, H = k.shape[1], num_heads
    Dh = E // H
    scale = 1.0 / jnp.sqrt(jnp.asarray(Dh, jnp.float32))
    qh, kh, vh = (t.reshape(B, -1, H, Dh).transpose(0, 2, 1, 3) for t in (q, k, v))
    logits = jnp.einsum("bhld,bhsd->bhls", qh * scale, kh)
    if attn_mask is not None:
        logits = logits + (attn_mask.reshape(B, H, L, S) if attn_mask.ndim == 3
                           else attn_mask[None, None])
    weights = jax.nn.softmax(logits, axis=-1)
    out = jnp.einsum("bhls,bhsd->bhld", weights, vh)
    return out.transpose(0, 2, 1, 3).reshape(B, L, E), weights.mean(1)


def use_float64_attention(monkeypatch):
    """Every test takes JAX's attention through ``_attention``."""
    monkeypatch.setattr(jax_atiss, "multihead_attention", _attention)


def _f64_tree(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


# ---------------------------------------------------------------- draws


def _dmll_draws(key, n):
    """``sample_from_dmll``'s: the component's Gumbel noise, the uniform."""
    k1, k2 = jax.random.split(key)
    return [jax.random.gumbel(k1, (n, NR)),
            jax.random.uniform(k2, (n,), minval=1e-5, maxval=1 - 1e-5)]


def _prop_draws(key, n, scalar, axes=3):
    if scalar:
        return []
    if axes == 1:
        return _dmll_draws(key, n)
    return [d for k in jax.random.split(key, 3) for d in _dmll_draws(k, n)]


def _decode_draws(key, n, scalar, n_classes=C):
    """``decode_step``'s, in the port's order (class, x/y/z translations,
    angle, x/y/z sizes)."""
    ks = jax.random.split(key, 4)
    return ([jax.random.gumbel(ks[0], (n, n_classes))] + _prop_draws(ks[1], n, scalar)
            + _prop_draws(ks[2], n, scalar, 1) + _prop_draws(ks[3], n, scalar))


def _fill_draws(key, steps, n, scalar):
    out, k = [], key
    for _ in range(steps):
        k, sub = jax.random.split(k)
        out += _decode_draws(sub, n, scalar)
    return out


def _given(draws):
    return atiss.Draws(given=[np.asarray(d) for d in draws])


# ---------------------------------------------------------------- decoding
# The decoding chain runs in float64 on both sides: a scalar head's outputs
# are unbounded and feed the next property's sin/cos encoding at
# frequencies up to ~58, which turns float32's roundings into visible
# differences (an angle 4e-5 apart makes the sizes 8e-4 apart), in JAX's
# own float32 as in the port's.


def _same_boxes(got, want, what, keys=("class_labels", "translations", "sizes",
                                       "angles")):
    for k in keys:
        if k == "class_labels":
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          err_msg=f"{what} {k}")
        else:
            _close(got[k], want[k], F64_TOL, f"{what} {k}")

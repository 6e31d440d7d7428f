"""The port's ATISS samplers against the JAX package on the CPU.

The DMLL machinery (``sample_from_dmll`` with JAX's draws, ``dmll``,
``mmd``, the translation mixtures), ``decode_step`` and the two
distributions, scene generation and completion with ``add_object*``, the
recording ``Draws``, and ``sample_in_bbox``, at the tiny widths of
``test_torch_atiss.py`` (its shared parts in ``_torch_atiss_common.py``).
The random draws are JAX's, handed to the port in the order its samplers
ask for them.  The decoding chain runs in float64 on both sides (below);
classes and box counts must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_atiss_common import (
    C, F32_TOL, F64_TOL, KW, NR, _boxes, _close, _decode_draws, _dmll_draws, _f64_tree,
    _fill_draws, _given, _jax, _jax_model, _port64, _prop_draws, _same_boxes, _setup,
    _torch, use_float64_attention)
from lsdm_tpu.fitting.next_obj_class import sample_in_bbox as jax_sample_in_bbox
from lsdm_tpu.models import atiss as jax_atiss
from lsdm_tpu_torch.fitting.next_obj_class import sample_in_bbox
from lsdm_tpu_torch.models import atiss


@pytest.fixture(autouse=True)
def _float64_attention(monkeypatch):
    use_float64_attention(monkeypatch)


# ---------------------------------------------------------------- DMLL


def test_dmll_machinery_equals_jax():
    """``scalar_head=False``: ``pred_dmll_params_translation``,
    ``sample_from_dmll`` with JAX's draws (the samples clipped and not),
    ``dmll`` (both edge bins) and ``mmd``, in float32 (readings up to
    2.7e-7)."""
    jm, variables, port = _setup("base", scalar=False)
    rs = np.random.RandomState(3)
    feat = rs.randn(2, 1, KW["hidden_dims"]).astype(np.float32)
    cls = np.eye(C, dtype=np.float32)[rs.randint(0, C, (2, 1))]
    want = jax.jit(lambda v, f, c: jm.apply(
        v, f, c, method=lambda m, f, c: m.hidden2output.pred_dmll_params_translation(
            f, c)))(variables, jnp.asarray(feat), jnp.asarray(cls))
    with torch.no_grad():
        got = port.hidden2output.pred_dmll_params_translation(torch.from_numpy(feat),
                                                              torch.from_numpy(cls))
    for ax in range(3):
        for part, what in enumerate(("probs", "means", "scales")):
            _close(got[ax][part], want[ax][part], F32_TOL, f"axis {ax} {what}")

    pred = (rs.randn(64, 3 * NR) * 2).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jax.jit(jax_atiss.sample_from_dmll)(jnp.asarray(pred), key))
    got = atiss.sample_from_dmll(torch.from_numpy(pred), _given(_dmll_draws(key, 64)))
    _close(got, want, F32_TOL, "sample_from_dmll")
    assert (np.abs(want) < 1).any() and (np.abs(want) == 1).any()

    target = np.clip(rs.randn(2, 7, 1), -1.2, 1.2).astype(np.float32)
    target[0, :2] = [[-1.0], [1.0]]  # both edge bins
    pred3 = pred[:14].reshape(2, 7, -1)
    _close(atiss.dmll(torch.from_numpy(pred3), torch.from_numpy(target)),
           jax.jit(jax_atiss.dmll)(jnp.asarray(pred3), jnp.asarray(target)),
           F32_TOL, "dmll")
    x, y = rs.randn(6, 3).astype(np.float32), rs.randn(8, 3).astype(np.float32)
    _close(atiss.mmd(torch.from_numpy(x), torch.from_numpy(y)),
           jax.jit(jax_atiss.mmd)(jnp.asarray(x), jnp.asarray(y)), F32_TOL, "mmd")


def test_decode_steps_and_distributions_equal_jax():
    """DMLL heads, float64, B = 2 with padded slots (readings up to
    9.7e-15): ``decode_step`` with JAX's draws, ``distribution_classes``
    and ``distribution_translations`` (JAX's three in one jitted program;
    the decode steps with a given class run in ``add_object*`` below)."""
    b = _boxes()
    one = {k: v[:1] for k, v in b.items()}
    key = jax.random.PRNGKey(7)
    A = jax_atiss.AutoregressiveTransformer
    port = _port64("base", False)
    with jax.enable_x64(True), torch.no_grad():
        jm = _jax_model("base", jnp.float64, False)

        @jax.jit
        def decode(vs, jb, jone):
            return (jm.apply(vs, jb, key, method=A.decode_step),
                    jm.apply(vs, jb, method=A.distribution_classes),
                    jax_atiss.distribution_translations(jm, vs, jone, jone["room_layout"], 4))

        want = decode(_f64_tree(_setup("base", False)[1]), _jax(b, jnp.float64),
                      _jax(one, jnp.float64))
        draws = _decode_draws(key, 2, False)
    tb, tone = _torch(b, torch.float64), _torch(one, torch.float64)
    with torch.no_grad():
        _same_boxes(port.decode_step(tb, _given(draws)), want[0], "decode_step")
        _close(port.distribution_classes(tb), want[1], F64_TOL, "distribution_classes")
        got = atiss.distribution_translations(port, tone, tone["room_layout"], 4)
    for ax in range(3):
        for part in range(3):
            _close(got[ax][part], want[2][ax][part], F64_TOL, f"translations {ax} {part}")


@pytest.mark.parametrize("variant,scalar,seed", [("base", False, 4), ("mime", True, 0)])
def test_generation_equals_jax(variant, scalar, seed):
    """``generate_boxes``, ``complete_scene``, ``add_object`` and
    ``add_object_with_class_and_translation`` with JAX's draws, float64
    (float32 box buffers, as JAX's; readings up to 1.4e-15; JAX's four in
    one jitted program): equal classes and counts.  The end class's logit
    is raised, and the key chosen, so that the fill stops after 5 boxes of
    8; ``complete_scene`` keeps the first 2 and adds up to 4."""
    room = _boxes(B=1)["room_layout"]
    key = jax.random.PRNGKey(seed)
    ks3, ks2 = jax.random.split(key, 3), jax.random.split(key, 2)
    keys = ("class_labels", "translations", "sizes", "angles", "valid_mask")
    contact = variant == "mime"  # add_object takes no contact labels, in JAX as here
    port = _port64(variant, scalar, end_bias=3.0)
    with jax.enable_x64(True):
        jm = _jax_model(variant, jnp.float64, scalar)

        @jax.jit
        def generate(vs, room):
            boxes, count = jax_atiss.generate_boxes(jm, vs, room, key, 8)
            given = {k: boxes[k][:, :2] for k in keys[:4]}
            out = [(boxes, count), jax_atiss.complete_scene(jm, vs, given, room, key, 4)]
            if not contact:
                out += [jax_atiss.add_object(jm, vs, room, 4, given, key),
                        jax_atiss.add_object_with_class_and_translation(
                            jm, vs, room, jnp.eye(C)[6], jnp.asarray([0.1, -0.2, 0.3]),
                            given, key)]
            return out

        want = generate(_f64_tree(_setup(variant, scalar, end_bias=3.0)[1]),
                        jnp.asarray(room, jnp.float64))
        draws = [_fill_draws(key, 8, 1, scalar), _fill_draws(key, 4, 1, scalar),
                 _prop_draws(ks3[0], 1, scalar) + _prop_draws(ks3[1], 1, scalar, 1)
                 + _prop_draws(ks3[2], 1, scalar),
                 _prop_draws(ks2[0], 1, scalar, 1) + _prop_draws(ks2[1], 1, scalar)]
    troom = torch.as_tensor(room, dtype=torch.float64)
    got, count = atiss.generate_boxes(port, troom, _given(draws[0]), 8)
    assert count == int(want[0][1]) == 5
    _same_boxes(got, want[0][0], "generate_boxes", keys)
    given = {k: got[k][:, :2] for k in keys[:4]}
    got, count = atiss.complete_scene(port, given, troom, _given(draws[1]), 4)
    assert count == int(want[1][1])
    _same_boxes(got, want[1][0], "complete_scene", keys)
    assert torch.equal(got["class_labels"][:, :2], given["class_labels"])
    if contact:
        return
    got = atiss.add_object(port, troom, 4, given, _given(draws[2]))
    _same_boxes(got, want[2], "add_object")
    assert int(got["class_labels"][0, 2].argmax()) == 4
    got = atiss.add_object_with_class_and_translation(
        port, troom, np.eye(C)[6], [0.1, -0.2, 0.3], given, _given(draws[3]))
    _same_boxes(got, want[3], "add_object_with_class_and_translation")


def test_draws_from_a_generator_replay_where_recorded():
    """A recording ``Draws`` replays the same scene (what ``chip_smoke``
    does between the CPU and the card)."""
    port = _setup("base", False, end_bias=3.0)[2]
    room = torch.ones(1, 1, 64, 64)
    rec = atiss.Draws(torch.Generator().manual_seed(0), record=True)
    a, n = atiss.generate_boxes(port, room, rec, max_boxes=8)
    b, m = atiss.generate_boxes(port, room, atiss.Draws(given=rec.taken), max_boxes=8)
    assert n == m and all(torch.equal(a[k], b[k]) for k in a if k != "room_layout")


def test_sample_in_bbox_equals_jax():
    """The class by ``jax.random.choice``'s rule and the translation drawn
    until inside the box (the 4th try here), float64, JAX's draws (reading
    2.2e-16)."""
    b = {k: v[:1, :1] if k != "room_layout" else v[:1]
         for k, v in _boxes(valid=False).items()}
    lo, hi = np.array([-0.2, 0.0, -1.0]), np.array([0.3, 0.7, 0.0])
    key = jax.random.PRNGKey(2)
    port = _port64("base", False)
    with jax.enable_x64(True):
        jm = _jax_model("base", jnp.float64, False)
        variables = _f64_tree(_setup("base", False)[1])
        cls, tr = jax_sample_in_bbox(jm, variables, _jax(b, jnp.float64), lo, hi, key,
                                     max_tries=BBOX_TRIES)
        k1, k = jax.random.split(key)
        draws = [jax.random.uniform(k1, (), jnp.float64)]
        for _ in range(BBOX_TRIES):
            k, sub = jax.random.split(k)
            draws += _prop_draws(sub, 1, False)
        got_cls, got_tr = sample_in_bbox(port, _torch(b, torch.float64), lo, hi,
                                         _given(draws), max_tries=BBOX_TRIES)
    assert got_cls == cls
    _close(got_tr, tr, F64_TOL, "translation")
    assert ((got_tr >= lo) & (got_tr <= hi)).all()


BBOX_TRIES = 6

"""The port's ATISS / MIME stack against the JAX package on the CPU.

The room-layout extractors (ResNet18 frozen, live in eval and in train
mode, AlexNet, the simple one), the scene transformers (base with padded
slots, the batch-axis quirk over ResNet18, the learned-slot PE variant,
MIME), the cf_atiss bridge, and the weight bridges both ways, at tiny widths (2
layers, hidden 32, 4 heads, ff 64; the extractors' topologies are fixed,
at B = 2 on 64 x 64 masks).  The weights are drawn with numpy into JAX's
parameter trees (BatchNorm statistics included, so the frozen and live
formulas differ) and carried to the port by
``weights.py:atiss_state_dict_from_jax``; the JAX side runs jitted.  The
samplers are in ``test_torch_atiss_sampling.py``, the train step in
``test_torch_atiss_train.py``, the shared parts in
``_torch_atiss_common.py``.

Tolerances: float32 |port - JAX| <= F32_TOL * max(1, |JAX|) elementwise,
float64 <= F64_TOL * max(1, |JAX|), JAX's attention taken without its
float32 sums (``_torch_atiss_common._attention``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from _torch_atiss_common import (
    C, F32_TOL, F64_TOL, _boxes, _close, _draw, _f64_tree, _jax, _jax_model,
    _japply, _port64, _setup, _torch, use_float64_attention)
from lsdm_tpu.models import atiss as jax_atiss
from lsdm_tpu.models import feature_extractors as jax_fe
from lsdm_tpu.models.bridge import BridgeModel as JaxBridge
from lsdm_tpu.models.posa import POSADecoder as JaxPOSADecoder
from lsdm_tpu.train.checkpoint import convert_atiss_state_dict
from lsdm_tpu_torch.checkpoint import load_atiss_checkpoint
from lsdm_tpu_torch.models import atiss
from lsdm_tpu_torch.models import feature_extractors as fe
from lsdm_tpu_torch.models.bridge import BridgeModel
from lsdm_tpu_torch.models.posa import POSADecoder
from lsdm_tpu_torch.ops.spiral import identity_spirals
from lsdm_tpu_torch.weights import (
    atiss_state_dict_from_jax, contactformer_state_dict_from_jax)


@pytest.fixture(autouse=True)
def _float64_attention(monkeypatch):
    use_float64_attention(monkeypatch)


# ---------------------------------------------------------------- extractors


def _jax_extractor(name, dtype):
    if name.startswith("resnet18"):
        return jax_fe.ResNet18Features(8, freeze_bn=name == "resnet18_frozen",
                                       dtype=dtype)
    if name == "alexnet":
        return jax_fe.AlexNetFeatures(8, dtype=dtype)
    return jax_atiss.RoomFeatureExtractor(8, dtype=dtype)


def _port_extractor(name):
    if name.startswith("resnet18"):
        return fe.ResNet18Features(8, freeze_bn=name == "resnet18_frozen")
    if name == "alexnet":
        return fe.AlexNetFeatures(8)
    return atiss.RoomFeatureExtractor(8)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", ["resnet18_frozen", "resnet18_live", "resnet18_train",
                                  "alexnet", "simple"])
def test_feature_extractors_equal_jax(name, dtype):
    """Each extractor at B = 2 on a binary 64 x 64 mask (NCHW, and NHWC
    for the simple one): frozen BN without eps, live BN in eval mode (eps
    1e-5) and in train mode (batch statistics and the running update).
    float32 readings 1.2e-7 (simple) to 1.3e-6, 4.2e-6 in train mode;
    float64 up to 5.8e-15."""
    x = _boxes()["room_layout"]
    if name == "simple":
        x = x.transpose(0, 2, 3, 1)  # NHWC, told apart by to_nchw
    variables = _draw(jax.eval_shape(_jax_extractor(name, jnp.float32).init,
                                     jax.random.PRNGKey(0), jnp.asarray(x)))
    port = _port_extractor(name)
    sd = atiss_state_dict_from_jax({"feature_extractor": variables["params"]},
                                   {"feature_extractor": variables.get("batch_stats", {})})
    port.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()}, strict=True)
    train = name == "resnet18_train"
    port.train(train)
    tol = F64_TOL if dtype == "float64" else F32_TOL
    with jax.enable_x64(dtype == "float64"):
        jdt = getattr(jnp, dtype)
        kw = dict(train=True, mutable=["batch_stats"]) if train else {}
        apply = jax.jit(functools.partial(_jax_extractor(name, jdt).apply, **kw))
        want = apply(jax.tree.map(lambda a: jnp.asarray(a, jdt), variables),
                     jnp.asarray(x, jdt))
    if dtype == "float64":
        port.double()
    got = port(torch.as_tensor(x, dtype=getattr(torch, dtype)))
    if train:
        want, stats = want
        moved = atiss_state_dict_from_jax(
            {}, {"feature_extractor": jax.tree.map(np.asarray, stats["batch_stats"])},
            dtype=torch.float64)
        buffers = dict(port.named_buffers())
        assert len(moved) == len(buffers)
        for key, v in moved.items():
            _close(buffers[key.split(".", 1)[1]], v, tol, key)
    _close(got, want, tol, f"{name} {dtype}")


# ---------------------------------------------------------------- forward


VARIANTS = ("base", "quirk", "pe", "mime")


@pytest.mark.parametrize("variant,dtype", [(v, "float32") for v in VARIANTS]
                         + [("base", "float64"), ("quirk", "float64")])
def test_forward_equals_jax(variant, dtype):
    """Every ``BBoxPrediction`` member, B = 2 scenes of 5 slots with 3 and
    2 valid (ignored by the quirk, over ResNet18); float64 on the masked
    path and on the quirk's.  float32 readings up to 2.9e-6, float64 up to
    1.6e-15."""
    _, variables, port = _setup(variant)
    b = _boxes(contact=variant == "mime")
    with jax.enable_x64(dtype == "float64"):
        vs = _f64_tree(variables) if dtype == "float64" else variables
        want = _japply(variant, dtype)(vs, _jax(b, getattr(jnp, dtype)))
    if dtype == "float64":
        port = _port64(variant)
    with torch.no_grad():
        got = port(_torch(b, getattr(torch, dtype)))
    assert got._fields == want._fields
    tol = F32_TOL if dtype == "float32" else F64_TOL
    for name, g, w in zip(got._fields, got, want):
        _close(g, w, tol, f"{variant} {dtype} {name}")


def test_head_with_extra_fc_equals_jax():
    """The property head's optional pre-head MLP (``with_extra_fc``, the
    reference's ``hidden2output.hidden2output``), which only the training
    forward applies: every member against JAX's head in float32."""
    b = _boxes()
    x = np.random.RandomState(5).randn(2, 1, 32).astype(np.float32)
    jh = jax_atiss.AutoregressiveDMLLHead(n_classes=C, n_mixtures=3, hidden_size=32,
                                          with_extra_fc=True)
    variables = _draw(jax.eval_shape(jh.init, jax.random.PRNGKey(0), jnp.asarray(x),
                                     _jax(b)))
    port = atiss.AutoregressiveDMLLHead(C, 3, hidden_size=32, with_extra_fc=True)
    sd = atiss_state_dict_from_jax({"hidden2output": variables["params"]})
    port.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()}, strict=True)
    want = jax.jit(jh.apply)(variables, jnp.asarray(x), _jax(b))
    with torch.no_grad():
        got = port(torch.from_numpy(x), _torch(b))
    for name, g, w in zip(got._fields, got, want):
        _close(g, w, F32_TOL, f"extra fc {name}")


def test_valid_mask_tiles_over_heads_as_jax():
    """The bias is tiled head-major and read batch-major, as JAX reads
    it: with B = 2 and 4 heads scene 0's odd heads take scene 1's mask, so
    scene 0's output moves when only scene 1's mask changes."""
    _, _, port = _setup("base")
    b = _boxes()
    other = dict(b, valid_mask=b["valid_mask"].copy())
    other["valid_mask"][1, 1] = 0.0
    with torch.no_grad():
        a, c = port.encode(_torch(b)), port.encode(_torch(other))
    assert not torch.equal(a[0], c[0])


# ---------------------------------------------------------------- bridge


def test_cf_atiss_bridge_equals_jax():
    """The whole ``BridgeModel`` from one seed: the frozen POSA decoder
    (JAX's weights) over 655 drawn human points, the category vote, the
    boxes and the ATISS prediction (20 = 13 proxd categories + 7); float32
    (readings up to 1.8e-6)."""
    n_classes = 20
    _, variables, port = _setup("base", n_classes=n_classes)
    sp = np.tile(identity_spirals(655), (1, 9))
    jdec = JaxPOSADecoder(spiral_indices=sp, no_obj_classes=8)
    dvars = _draw(jax.eval_shape(jdec.init, jax.random.PRNGKey(0), jnp.zeros((1, 256)),
                                 jnp.zeros((1, 655, 3))))
    pdec = POSADecoder(sp, no_obj_classes=8)
    pdec.load_state_dict(contactformer_state_dict_from_jax(dvars["params"]), strict=True)
    rng = np.random.RandomState(0)
    objs = rng.randn(2, 5, 96, 3).astype(np.float32)
    cats = np.eye(13, dtype=np.float32)[rng.randint(0, 13, (2, 5))]
    mask = np.zeros((2, 5), np.float32)
    mask[:, :4] = 1
    apply = _japply("base", n_classes=n_classes)
    decode = jax.jit(jdec.apply)
    want = JaxBridge(lambda bx: apply(variables, bx), lambda z, v: decode(dvars, z, v),
                     "proxd", n_classes, seed=3)(objs, cats, mask)
    got = BridgeModel(port, pdec.eval(), "proxd", n_classes, seed=3)(objs, cats, mask)
    for name, g, w in zip(got._fields, got, want):
        _close(g, w, F32_TOL, f"bridge {name}")


# ---------------------------------------------------------------- weights


@pytest.mark.parametrize("variant", ["quirk", "alexnet", "mime_resnet", "pe_resnet"])
def test_weight_bridge_round_trips_through_the_jax_converter(variant):
    """JAX's parameters -> ``atiss_state_dict_from_jax`` -> a strict load
    into the port -> the port's ``state_dict`` -> JAX's
    ``convert_atiss_state_dict``: the same trees, bit for bit."""
    _, variables, port = _setup(variant)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    params, stats = convert_atiss_state_dict(sd)
    for col, tree in (("params", params), ("batch_stats", stats)):
        want = traverse_util.flatten_dict(variables.get(col, {}))
        got = traverse_util.flatten_dict(jax.tree.map(np.asarray, tree))
        assert sorted(got) == sorted(want), col
        for path in want:
            np.testing.assert_array_equal(got[path], want[path], err_msg=str(path))


def test_reference_pt_loads_and_matches_the_torch_oracle(tmp_path):
    """A reference-layout ``.pt`` (``tests/test_atiss_conversion.py``'s
    torch replica, with its unused ``start_token_embedding``, plus a
    ``num_batches_tracked``) loads into the port and gives the replica's
    forward within F32_TOL (reading 0: the same torch operations); an
    unknown key raises ``KeyError``."""
    from test_atiss_conversion import TATISS, _sample_params

    torch.manual_seed(2)
    tm = TATISS(10).eval()
    sd = dict(tm.state_dict())
    assert "start_token_embedding" in sd
    sd["feature_extractor._feature_extractor.bn1.num_batches_tracked"] = torch.tensor(5)
    path = str(tmp_path / "ref.pt")
    torch.save({"model_state_dict": sd, "epoch": 3}, path)
    port = atiss.AutoregressiveTransformer(
        10, n_layers=2, n_heads=4, dim_ff=128, n_mixtures=4, feature_size=32,
        feature_extractor_name="resnet18", torch_seq_axis_quirk=True)
    assert load_atiss_checkpoint(path, port) == {"epoch": 3}
    sp = _sample_params(10)
    with torch.no_grad():
        want = tm(sp)
        got = port.eval()(sp)
    _close(got.class_labels, want["class_labels"], F32_TOL, "class_labels")
    for i, ax in enumerate("xyz"):
        _close(getattr(got, f"translations_{ax}"), want["translations"][i], F32_TOL, ax)
        _close(getattr(got, f"sizes_{ax}"), want["sizes"][i], F32_TOL, ax)
    _close(got.angles, want["angles"], F32_TOL, "angles")
    sd["hidden2output.bogus.weight"] = torch.zeros(3)
    torch.save({"model_state_dict": sd}, path)
    with pytest.raises(KeyError, match="hidden2output.bogus.weight"):
        load_atiss_checkpoint(path, port)

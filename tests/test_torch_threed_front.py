"""The port's 3D-FRONT stack and ``train_atiss_3dfront`` against the JAX
package.

``data/threed_front.py``, ``data/threed_front_scene.py`` and
``data/threed_front_dataset.py`` are copies of the JAX package's host numpy
modules (meshes read by the port's ``load_obj``), so their outputs must be
equal, array for array, on the fixtures of the JAX package's own tests: the
raw scene layout of ``tests/test_threed_front_stack.py`` (``raw_front``,
imported from there), the cached ``boxes.npz`` layout of its
``test_cached_rooms_path``, and the cases of
``tests/test_threed_front_factory.py`` (the 3D-FUTURE library, the
splits, ``CachedThreedFront``).  Every encoding that draws from
``np.random`` is run on both sides from one seed.  Then ``train_atiss_3dfront``
on one synthetic cache, the simple extractor, two epochs of one step, is
held to JAX's CLI: JAX's initial weights cross by a spy on its
``create_train_state`` (``weights.atiss_state_dict_from_jax``), and the
per-epoch losses agree within 1e-4 relative.
"""

import dataclasses
import json
import os
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from lsdm_tpu.data import threed_front as jtf
from lsdm_tpu.data import threed_front_dataset as jtfd
from lsdm_tpu.data import threed_front_scene as jtfs
from lsdm_tpu.fitting.meshio import write_obj
from lsdm_tpu.ops.spiral import grid_mesh
from lsdm_tpu_torch.data import threed_front as ptf
from lsdm_tpu_torch.data import threed_front_dataset as ptfd
from lsdm_tpu_torch.data import threed_front_scene as ptfs
from test_threed_front_stack import raw_front  # noqa: F401  (the shared fixture)

C = 5  # the cache's classes, start and end included


def same(a, b, path="$"):
    """``a`` (JAX package) and ``b`` (port) hold equal values: arrays equal
    element for element with one dtype, objects of the same class name
    attribute for attribute."""
    if isinstance(a, np.ndarray) or isinstance(a, np.generic):
        assert type(a) is type(b) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)) and not hasattr(a, "_fields"):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
    elif type(a).__module__.startswith("lsdm_tpu."):
        assert type(a).__name__ == type(b).__name__, path
        fields = (a._asdict() if hasattr(a, "_fields")
                  else {f.name: getattr(a, f.name) for f in dataclasses.fields(a)}
                  if dataclasses.is_dataclass(a) else vars(a))
        for k, v in fields.items():
            same(v, getattr(b, k), f"{path}.{k}")
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b), path
    else:
        assert a == b, (path, a, b)


def _parsed(mod, raw):
    return mod.parse_threed_front_scenes(str(raw / "scenes"), str(raw / "model_info.json"),
                                         str(raw / "models"))


def _room_view(tfs, room):
    """A room's derived quantities, on either side."""
    return {"arrays": tfs.room_arrays(room), "bbox": room.bbox,
            "centroid": room.centroid, "floor_plan": room.floor_plan,
            "floor_plan_centroid": room.floor_plan_centroid,
            "furniture": room.furniture_in_room,
            "corners": [b.corners() for b in room.bboxes],
            "z_angles": [b.z_angle for b in room.bboxes],
            "sizes": [b.size for b in room.bboxes], "order": tfs.box_order(room)}


def test_parsed_rooms_equal(raw_front):  # noqa: F811
    jrooms, prooms = _parsed(jtfs, raw_front), _parsed(ptfs, raw_front)
    assert len(jrooms) == len(prooms) == 4
    same(jrooms, prooms)
    for j, p in zip(jrooms, prooms):
        same(_room_view(jtfs, j), _room_view(ptfs, p))


def _threed_front(tfs, tfd, raw):
    return tfd.ThreedFront(_parsed(tfs, raw))


def test_dataset_statistics_equal(raw_front):  # noqa: F811
    j, p = _threed_front(jtfs, jtfd, raw_front), _threed_front(ptfs, ptfd, raw_front)
    for name in ("bounds", "class_labels", "class_frequencies", "class_order",
                 "count_furniture", "object_types", "n_classes", "centroids",
                 "sizes", "angles", "bbox"):
        same(getattr(j, name), getattr(p, name), name)


@pytest.mark.parametrize("encoding", ["autoregressive_wocm", "eval"])
def test_encodings_equal(raw_front, encoding):  # noqa: F811
    """Each encoding from one seed on both sides (the module-level
    ``np.random`` draws of its permutation and split), the collate and
    ``post_process``."""
    out = []
    for tfs, tfd in ((jtfs, jtfd), (ptfs, ptfd)):
        filt = tfd.compose_filters(tfd.room_type_contains("bed"), tfd.at_least_boxes(2),
                                   tfd.at_most_boxes(13),
                                   tfd.contains_any_label(["king-size bed"]))
        ds = tfd.ThreedFront([s for s in map(filt, _parsed(tfs, raw_front)) if s])
        np.random.seed(0)
        enc = tfd.dataset_encoding_factory(encoding, ds)
        samples = [enc[i] for i in range(len(enc))]
        out.append({"samples": samples,
                    "collate": None if encoding == "eval" else enc.collate_fn(samples[:3]),
                    "post": enc.post_process({k: samples[0][k] for k in
                                              ("translations", "class_labels")})})
    same(*out)


def test_filter_spec_table_equal(raw_front):  # noqa: F811
    (raw_front / "invalid_scenes.txt").write_text("room_1_1\n")
    (raw_front / "invalid_jids.txt").write_text("not_a_real_jid\n")
    (raw_front / "splits.csv").write_text(
        "room_0_0,train\nroom_0_1,train\nroom_1_0,val\nroom_1_1,train\n")
    config = {"filter_fn": "threed_front_bedroom",
              "path_to_invalid_scene_ids": str(raw_front / "invalid_scenes.txt"),
              "path_to_invalid_bbox_jids": str(raw_front / "invalid_jids.txt"),
              "annotation_file": str(raw_front / "splits.csv")}
    kept = []
    for tfs, tfd in ((jtfs, jtfd), (ptfs, ptfd)):
        fn = tfd.filter_function(config, split=["train"], without_lamps=True)
        kept.append([s for s in map(fn, _parsed(tfs, raw_front)) if s])
    assert [r.scene_id for r in kept[1]] == ["room_0_0", "room_0_1"]
    same(*kept)


def test_future_models_and_augmentation_equal(raw_front):  # noqa: F811
    out = []
    for tf, tfs, tfd in ((jtf, jtfs, jtfd), (ptf, ptfs, ptfd)):
        models = tfs.parse_threed_future_models(
            str(raw_front / "scenes"), str(raw_front / "models"),
            str(raw_front / "model_info.json"))
        room = _parsed(tfs, raw_front)[0]
        np.random.seed(3)
        augmented = room.augment_room(tf.ThreedFutureDataset(models))
        ds = tfd.ThreedFront(_parsed(tfs, raw_front))
        base = tfd.raw_room_sample(ds)(0)
        np.random.seed(5)
        rotated = tfd.rotation_augmented(ds.bounds)({k: np.copy(v) for k, v in base.items()})
        jit = tfd.jittered()({k: np.copy(v) for k, v in base.items()})
        out.append({"models": models, "augmented": augmented,
                    "view": _room_view(tfs, augmented), "rotated": rotated, "jit": jit})
    same(*out)


@pytest.fixture
def cache(tmp_path):
    """The cached ``boxes.npz`` layout of ``tests/test_threed_front_stack.py::
    test_cached_rooms_path`` (bedrooms of 3-5 boxes, 64 x 64 layouts,
    ``stats.json``, a split csv with a ``test`` room), five rooms so that
    the trainer draws batches of two (``chip_smoke.threed_front_cache``)."""
    import chip_smoke

    base, split_csv = chip_smoke.threed_front_cache(
        str(tmp_path), rooms=5, classes=C,
        splits=["train", "train", "test", "train", "val"], seed=0)
    return Path(base), Path(split_csv)


@pytest.mark.parametrize("ordering", [None, "class_frequencies"])
def test_cached_rooms_equal(cache, ordering):
    base, split_csv = cache
    config = {"dataset_type": "cached_threedfront",
              "encoding_type": "cached_autoregressive_wocm",
              "dataset_directory": str(base), "annotation_file": str(split_csv),
              "train_stats": "stats.json", "room_layout_size": "32,32",
              "box_ordering": ordering}
    out = []
    for tfd in (jtfd, ptfd):
        np.random.seed(1)
        raw, enc = tfd.get_dataset_raw_and_encoded(config, split=["train", "val"])
        samples = [enc[i] for i in range(len(enc))]
        out.append({"rooms": [raw[i] for i in range(len(raw))],
                    "params": [raw.get_room_params(i) for i in range(len(raw))],
                    "bounds": raw.bounds, "labels": raw.class_labels,
                    "samples": samples, "collate": enc.collate_fn(samples)})
    assert len(out[1]["rooms"]) == 4
    same(*out)


def test_factory_cases_equal(tmp_path, rng):
    """``tests/test_threed_front_factory.py``'s 3D-FRONT cases: the
    3D-FUTURE library from a directory and its retrieval, the split csv,
    ``CachedThreedFront`` items and collate."""
    v, f = grid_mesh(3)
    os.makedirs(tmp_path / "lib" / "table" / "t1")
    os.makedirs(tmp_path / "lib" / "chair")
    write_obj(str(tmp_path / "lib" / "table" / "t1" / "raw_model.obj"), v * 2, f)
    write_obj(str(tmp_path / "lib" / "chair" / "c1.obj"), v, f)
    (tmp_path / "splits.csv").write_text("room1,train\nroom2,test\nroom3,train\n")
    for sid in ("roomA", "roomB"):
        os.makedirs(tmp_path / "boxes" / sid)
        L = 5
        np.savez(tmp_path / "boxes" / sid / "boxes.npz",
                 class_labels=np.eye(7, dtype=np.float32)[rng.randint(0, 7, L)],
                 translations=rng.randn(L, 3).astype(np.float32),
                 sizes=rng.rand(L, 3).astype(np.float32),
                 angles=rng.randn(L, 1).astype(np.float32))
    out = []
    for tf in (jtf, ptf):
        lib = tf.ThreedFutureDataset.from_directory(str(tmp_path / "lib"))
        cached = tf.CachedThreedFront(str(tmp_path / "boxes"), max_boxes=8)
        out.append({"lib": [lib[i] for i in range(len(lib))],
                    "closest": lib.get_closest_furniture_to_box("table",
                                                                np.array([1.0, 1.0, 0.0])),
                    "none": lib.get_closest_furniture_to_box("sofa", np.zeros(3)),
                    "splits": tf.build_splits(str(tmp_path / "splits.csv")),
                    "items": [cached[0], cached[1]], "collate": cached.collate([0, 1])})
    assert out[1]["closest"].model_jid == "t1"
    same(*out)


def test_train_atiss_3dfront_cli_equals_jax(cache, monkeypatch, capsys):
    from lsdm_tpu.models import atiss as jax_atiss
    from lsdm_tpu.run import train_atiss_3dfront as jax_cli
    from lsdm_tpu.train import state as jax_state
    from lsdm_tpu_torch import weights
    from lsdm_tpu_torch.run import train_atiss_3dfront

    base, split_csv = cache
    common = ["--dataset_directory", str(base), "--annotation_file", str(split_csv),
              "--train_stats", "stats.json", "--room_layout_size", "32,32",
              "--feature_extractor", "simple", "--n_layers", "1", "--dim_ff", "64",
              "--batch_size", "2", "--epochs", "2", "--steps_per_epoch", "1",
              "--seed", "3"]
    losses = {}
    create_train_state = jax_state.create_train_state
    seeded = []  # JAX's initial weights, as its CLI hands them to its train state
    monkeypatch.setattr(jax_state, "create_train_state",
                        lambda variables, *a, **kw: seeded.append(variables)
                        or create_train_state(variables, *a, **kw))
    # JAX's CLI initialises its model eagerly, one compile an operation
    # (~30 s here): the same draws under one jit
    model_cls = jax_atiss.AutoregressiveTransformer
    init = model_cls.init
    monkeypatch.setattr(model_cls, "init", lambda self, key, *a: jax.jit(
        lambda k, *x: init(self, k, *x))(key, *a))
    monkeypatch.setattr(sys, "argv", ["train_atiss_3dfront", "--save_dir",
                                      str(base.parent / "jax")] + common)
    jax_cli.main()
    init_weights = weights.init_weights

    def jax_weights(model, seed):
        v = jax.tree.map(np.asarray, seeded[0])
        model.load_state_dict(weights.atiss_state_dict_from_jax(
            v["params"], v.get("batch_stats")))
        return model

    monkeypatch.setattr(weights, "init_weights", jax_weights)
    state = train_atiss_3dfront.main(common + ["--save_dir", str(base.parent / "port"),
                                               "--device", "cpu"])
    monkeypatch.setattr(weights, "init_weights", init_weights)
    assert state.step == 2
    for name in ("jax", "port"):
        with open(base.parent / name / "logs" / "events.jsonl") as f:
            losses[name] = [json.loads(line)["train/loss"] for line in f]
    assert len(losses["port"]) == 2 and np.isfinite(losses["port"]).all()
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=1e-4)
    names = sorted(os.listdir(base.parent / "port"))
    assert {"best_model_3dfront.pt", "final_3dfront.pt"} <= set(names)
    ckpt = torch.load(base.parent / "port" / "final_3dfront.pt", weights_only=False)
    assert ckpt["n_classes"] == C and ckpt["step"] == 2


def test_train_atiss_3dfront_refuses_platform(cache):
    from lsdm_tpu_torch.run import train_atiss_3dfront

    base, split_csv = cache
    with pytest.raises(SystemExit, match="not ported"):
        train_atiss_3dfront.main(["--dataset_directory", str(base), "--annotation_file",
                                  str(split_csv), "--platform", "cpu"])

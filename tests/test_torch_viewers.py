"""The port's fitting and dataset viewers against the JAX package's.

Both packages' ``vis_fitting_results`` and ``vis_dataset`` run on the same
seeded inputs with ``--no_png --html``: the per-frame PLYs must be equal
byte for byte and the viewer pages' embedded ``DATA`` equal.
"""

import json
import os
import re
import sys

import numpy as np
import pytest

import chip_smoke
from lsdm_tpu.run import vis_dataset as jax_vis_dataset
from lsdm_tpu.run import vis_fitting_results as jax_vis_fitting
from lsdm_tpu.utils.html_viewer import write_scene_html as jax_write_scene_html
from lsdm_tpu_torch.fitting.meshio import write_obj, write_ply
from lsdm_tpu_torch.run import vis_dataset, vis_fitting_results
from lsdm_tpu_torch.utils.html_viewer import write_scene_html


def _run_jax(main, argv, monkeypatch):
    # the JAX CLIs' main() takes no argv
    monkeypatch.setattr(sys, "argv", ["vis"] + argv)
    main()


def _data(path):
    text = open(path).read()
    return json.loads(re.search(r"const DATA = (.*);\n", text).group(1)), text


def _box(center, size):
    verts = np.array([[x, y, z] for z in (0.0, size[2]) for x, y in
                      ((-1, -1), (1, -1), (1, 1), (-1, 1))], np.float64)
    verts[:, :2] *= np.asarray(size[:2]) / 2
    faces = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5],
                      [0, 5, 4], [1, 2, 6], [1, 6, 5], [2, 3, 7], [2, 7, 6],
                      [3, 0, 4], [3, 4, 7]], np.int32)
    return verts + center, faces


@pytest.fixture(scope="module")
def fitting_results(tmp_path_factory):
    """What the fitting runners leave: ``fit_best_obj/<class>/<idx>/<obj>/
    opt_best.obj`` for two fitted objects, a 24-frame human of 655
    vertices and its faces."""
    root = tmp_path_factory.mktemp("fits")
    rs = np.random.RandomState(0)
    for cls, idx, obj, center, size in (("table", 0, "large", (1.0, 0.2, 0.0), (1.6, 0.9, 0.74)),
                                        ("chair", 1, "small", (-0.5, 0.4, 0.0), (0.5, 0.5, 0.9))):
        d = root / "fit_best_obj" / cls / str(idx) / obj
        d.mkdir(parents=True)
        write_obj(str(d / "opt_best.obj"), *_box(np.asarray(center), size))
    verts = (rs.rand(24, 655, 3) * [0.4, 0.3, 1.7]).astype(np.float32)
    np.save(root / "verts.npy", verts)
    np.save(root / "faces.npy", rs.randint(0, 655, (1200, 3)).astype(np.int32))
    return root


@pytest.mark.parametrize("flags", [
    [],  # the objects' points with the human's
    ["--faces_path", "faces.npy"],
    ["--faces_path", "faces.npy", "--every", "5", "--max_frames", "3"],
])
def test_vis_fitting_results_equals_jax(fitting_results, tmp_path, monkeypatch, flags):
    flags = [str(fitting_results / f) if f.endswith(".npy") else f for f in flags]
    outs = {}
    for name in ("jax", "port"):
        root = tmp_path / name
        root.mkdir()
        os.symlink(fitting_results / "fit_best_obj", root / "fit_best_obj")
        argv = ["--fitting_results_path", str(root), "--vertices_path",
                str(fitting_results / "verts.npy"), "--no_png", "--html", *flags]
        if name == "jax":
            _run_jax(jax_vis_fitting.main, argv, monkeypatch)
        else:
            assert vis_fitting_results.main(argv) == root / "rendering"
        outs[name] = root / "rendering"
    names = sorted(os.listdir(outs["jax"]))
    assert names == sorted(os.listdir(outs["port"])) and "scene.html" in names
    assert not [n for n in names if n.endswith(".png")]
    plys = [n for n in names if n.endswith(".ply")]
    every = int(flags[flags.index("--every") + 1]) if "--every" in flags else 8
    assert len(plys) == len(range(0, 24, every)[:3])
    for n in plys:
        assert (outs["port"] / n).read_bytes() == (outs["jax"] / n).read_bytes(), n
    (got, got_page), (want, want_page) = (_data(outs[k] / "scene.html")
                                          for k in ("port", "jax"))
    assert got == want and got_page == want_page
    assert len(got["objects"]) == 2 and len(got["frames"]) == 3


@pytest.fixture(scope="module")
def contact_split(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("contact"))
    chip_smoke.contact_split(root, n_seqs=2, frames=30, nv=655, seed=2)
    scene, _ = _box(np.zeros(3), (3.0, 2.0, 2.5))
    write_ply(os.path.join(root, "scene.ply"), np.random.RandomState(1).rand(5000, 3) * 3)
    write_obj(os.path.join(root, "scene.obj"), scene)
    return root


@pytest.mark.parametrize("flags", [
    [],
    ["--show_canonical"],
    ["--scene_path", "scene.ply", "--every", "3", "--max_frames", "5"],
    ["--scene_path", "scene.obj", "--single_frame", "7", "--no_obj_classes", "5"],
])
def test_vis_dataset_equals_jax(contact_split, tmp_path, monkeypatch, flags):
    flags = [os.path.join(contact_split, f) if f.startswith("scene.") else f
             for f in flags]
    pages = {}
    for name in ("jax", "port"):
        argv = ["--data_dir", contact_split, "--seq_name", "seq1",
                "--save_dir", str(tmp_path / name), "--no_png", "--html", *flags]
        if name == "jax":
            _run_jax(jax_vis_dataset.main, argv, monkeypatch)
        else:
            assert vis_dataset.main(argv) == tmp_path / name
        assert os.listdir(tmp_path / name) == ["scene.html"]
        pages[name] = _data(tmp_path / name / "scene.html")
    assert pages["port"] == pages["jax"]
    data = pages["port"][0]
    assert len(data["palette"]) == (5 if "--no_obj_classes" in flags else 8)
    assert len(data["objects"]) == (1 if "--scene_path" in flags else 0)


def test_vis_dataset_refuses_a_missing_sequence(contact_split, tmp_path):
    with pytest.raises(FileNotFoundError, match="seq9"):
        vis_dataset.main(["--data_dir", contact_split, "--seq_name", "seq9",
                          "--save_dir", str(tmp_path), "--no_png"])


@pytest.mark.parametrize("case", ["empty", "subsampled", "labels"])
def test_write_scene_html_equals_jax(tmp_path, case):
    rs = np.random.RandomState(3)
    kw = {}
    if case == "subsampled":
        kw = dict(frames=rs.rand(2, 5000, 3), max_points=700,
                  objects=[{"verts": rs.rand(9000, 3)},
                           {"verts": rs.rand(8, 3), "faces": rs.randint(0, 8, (12, 3)),
                            "color": "#123"}])
    elif case == "labels":
        kw = dict(frames=rs.rand(40, 3), frame_labels=rs.randint(0, 8, 40),
                  palette=["#000", "#fff"])
    got = write_scene_html(str(tmp_path / "p.html"), **kw)
    jax_write_scene_html(str(tmp_path / "j.html"), **kw)
    assert got == str(tmp_path / "p.html")
    assert open(got).read() == open(tmp_path / "j.html").read()

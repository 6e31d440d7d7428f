"""The port's fitting pipeline against the JAX package's, on the CPU.

The pose losses (contact, signed distances, penetration), the 36 x 11 x 11
grid search (and its chunking) and the Adam refinement on the same numpy
inputs; the copied host helpers (OBJ reading, surface sampling, the SDF);
then the CLIs ``fit_custom_obj``, ``fit_best_obj`` and ``fit_prob_obj`` of
both packages (the port's with ``--device cpu``, JAX's with ``--platform
cpu``) on one synthetic object library and human sequence, and
``custom_collision`` and ``gen_human_meshes``.  The SDF is 32^3.

Tolerances: the losses are float32 sums over up to a few hundred points,
taken by XLA and by torch in different orders, so a loss is held to
1e-5 relative; refined poses run 20-200 Adam steps from equal starts and
are held to 1e-4 (radians, metres) and their losses to 1e-4 relative.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsdm_tpu.fitting import meshio as jax_meshio
from lsdm_tpu.fitting import place_obj as jax_place
from lsdm_tpu.fitting import sdf as jax_sdf
from lsdm_tpu_torch.fitting import meshio, place_obj, sdf
from lsdm_tpu_torch.fitting.meshio import write_obj

LOSS_RTOL = 1e-5
REFINE_ATOL = 1e-4
REFINE_RTOL = 1e-4


def _scene(seed=0, D=32):
    rs = np.random.RandomState(seed)
    sdf_grid = (rs.rand(D, D, D).astype(np.float32) - 0.5)
    centroid = np.array([0.1, 0.2, 0.5], np.float32)
    extents = np.array([2.0, 2.0, 1.5], np.float32)
    obj = ((rs.rand(256, 3) - 0.5) * [0.6, 0.4, 0.8]).astype(np.float32)
    contact = ((rs.rand(60, 3) - 0.5) * 0.5 + [0.3, 0.1, 0.4]).astype(np.float32)
    return sdf_grid, centroid, extents, obj, contact


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_losses_and_signed_distances_match_jax():
    sdf_grid, centroid, extents, obj, contact = _scene(1)
    # points inside, on and beyond the grid's cube (clipped to its faces)
    q = ((np.random.RandomState(2).rand(500, 3) - 0.5) * 3.0).astype(np.float32)
    got = place_obj.compute_signed_distances(_t(sdf_grid), _t(centroid), _t(extents), _t(q))
    want = jax_place.compute_signed_distances(sdf_grid, centroid, extents, q)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    for thresh, w in ((0.0, 1.0), (-0.05, 10.0)):
        got = place_obj.penetration_loss(_t(sdf_grid), _t(centroid), _t(extents),
                                         _t(obj), thresh, w)
        want = jax_place.penetration_loss(sdf_grid, centroid, extents, obj, thresh, w)
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    got = place_obj.contact_loss(_t(contact), _t(obj), 100.0)
    want = jax_place.contact_loss(contact, obj, 100.0)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


def test_loss_gradients_match_jax():
    """The refinement's gradient: the SDF lookup's through its corner
    weights, the contact loss's through each contact's nearest point."""
    sdf_grid, centroid, extents, obj, contact = _scene(3)

    def jax_loss(pts):
        return (jax_place.contact_loss(contact, pts, 100.0)
                + jax_place.penetration_loss(sdf_grid, centroid, extents, pts, 0.0, 10.0))

    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(obj)))
    pts = _t(obj).clone().requires_grad_()
    (place_obj.contact_loss(_t(contact), pts, 100.0)
     + place_obj.penetration_loss(_t(sdf_grid), _t(centroid), _t(extents), pts,
                                  0.0, 10.0)).backward()
    np.testing.assert_allclose(pts.grad.numpy(), want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


def _pose_loss(obj, contact, sdf_grid, centroid, extents, deg, x, y):
    """JAX's grid loss of one pose (the JAX package's own functions)."""
    rot = jax_place.rotz(jnp.deg2rad(jnp.float32(deg)))
    pts = jnp.asarray(obj) @ rot.T
    pts = pts.at[:, 0].add(x).at[:, 1].add(y)
    return float(jax_place.contact_loss(contact, pts, 100.0)
                 + jax_place.penetration_loss(sdf_grid, centroid, extents, pts,
                                              -0.05, 10.0))


@pytest.mark.parametrize("seed", [0, 4])
def test_grid_search_matches_jax(seed):
    """The best pose of the 4356, and its loss.  Where two poses' losses
    differ by rounding, the two packages may pick either: the test then
    holds JAX's loss at the port's pick to JAX's minimum."""
    sdf_grid, centroid, extents, obj, contact = _scene(seed)
    center = np.zeros(2, np.float32)
    want = jax_place.grid_search(obj, center, contact, sdf_grid, centroid, extents)
    got = place_obj.grid_search(obj, center, contact, sdf_grid, centroid, extents)
    np.testing.assert_allclose(float(got.loss), float(want.loss), rtol=LOSS_RTOL)
    pose = [float(got.rot_deg), float(got.transl_x), float(got.transl_y)]
    if pose != [float(want.rot_deg), float(want.transl_x), float(want.transl_y)]:
        assert float(got.rot_deg) == float(want.rot_deg)
        np.testing.assert_allclose(pose[1:], [float(want.transl_x),
                                              float(want.transl_y)], atol=1e-6)
    at_pick = _pose_loss(obj, contact, sdf_grid, centroid, extents, *pose)
    np.testing.assert_allclose(at_pick, float(want.loss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points), atol=1e-5)


def test_grid_search_chunks_change_no_loss():
    sdf_grid, centroid, extents, obj, contact = _scene(5)
    args = (obj, np.zeros(2, np.float32), contact, sdf_grid, centroid, extents)
    whole = place_obj.grid_search(*args)
    for chunk in (1, 7, 1000):
        part = place_obj.grid_search(*args, chunk=chunk)
        assert float(part.loss) == float(whole.loss)
        assert [float(part.rot_deg), float(part.transl_x), float(part.transl_y)] == [
            float(whole.rot_deg), float(whole.transl_x), float(whole.transl_y)]


def test_grid_poses_are_jaxs():
    _, _, _, obj, contact = _scene(6)
    poses = place_obj.grid_poses(_t(obj), _t(contact))
    assert poses.shape == (4356, 3)
    rot = np.repeat(np.arange(0, 360, 10, dtype=np.float32), 121)
    np.testing.assert_array_equal(poses[:, 0].numpy(), rot)


@pytest.mark.parametrize("start", [(40.0, 0.3, -0.1), (0.0, 0.0, 0.0)])
def test_refine_pose_matches_jax(start):
    """20 Adam steps from the same pose: the best loss, rotation,
    translation and points."""
    sdf_grid, centroid, extents, obj, contact = _scene(7)
    deg, x, y = start
    center = np.array([x, y], np.float32)
    kw = dict(opt_steps=20, pen_weight=10.0)
    want = jax_place.refine_pose(obj, center, deg, contact, sdf_grid, centroid,
                                 extents, **kw)
    got = place_obj.refine_pose(obj, center, deg, contact, sdf_grid, centroid,
                                extents, **kw)
    np.testing.assert_allclose(float(got.loss), float(want.loss), rtol=REFINE_RTOL)
    for name in ("rot", "transl_x", "transl_y", "points"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=REFINE_ATOL, err_msg=name)


def test_meshio_and_sdf_are_jaxs(tmp_path):
    rs = np.random.RandomState(8)
    verts = rs.rand(30, 3).astype(np.float32)
    faces = rs.randint(0, 30, (40, 3)).astype(np.int32)
    path = str(tmp_path / "m.obj")
    write_obj(path, verts, faces)
    for got, want in zip(meshio.load_obj(path), jax_meshio.load_obj(path)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(meshio.sample_surface(verts, faces, 300, seed=3),
                                  jax_meshio.sample_surface(verts, faces, 300, seed=3))
    surface = meshio.sample_surface(verts, faces, 2000, seed=1)
    for got, want in zip(sdf.generate_sdf(surface, 24), jax_sdf.generate_sdf(surface, 24)):
        np.testing.assert_array_equal(got, want)


# --- the CLIs -------------------------------------------------------------


def _box(lo, hi):
    """A closed box mesh (8 vertices, 12 triangles)."""
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    v = np.array([[x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0],
                  [x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1]], np.float32)
    f = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5], [0, 5, 4],
                  [1, 2, 6], [1, 6, 5], [2, 3, 7], [2, 7, 6], [3, 0, 4], [3, 4, 7]],
                 np.int32)
    return v, f


def _fitting_data(root):
    """A library of two tables, a 16-frame human sequence of 300 vertices
    standing on the floor (z = 0) beside a table top at z = 0.72, contact
    labels (table on the hand vertices, floor on the feet), their
    probabilities, and a predicted table-top cloud."""
    rs = np.random.RandomState(9)
    lib = os.path.join(root, "lib", "table")
    os.makedirs(lib)
    for name, (sx, sy, sz) in (("small", (0.5, 0.35, 0.7)), ("wide", (1.0, 0.6, 0.75))):
        write_obj(os.path.join(lib, f"{name}.obj"),
                  *_box((-sx / 2, -sy / 2, 0.0), (sx / 2, sy / 2, sz)))
    T, V = 16, 300
    body = np.concatenate([
        (rs.rand(200, 3) - 0.5) * [0.3, 0.2, 0.0] + [0.0, 0.0, 0.9]
        + rs.rand(200, 1) * [0.0, 0.0, 0.8],                    # torso and head
        (rs.rand(50, 3) - 0.5) * [0.2, 0.2, 0.02] + [0.0, 0.0, 0.01],  # feet
        (rs.rand(50, 3) - 0.5) * [0.25, 0.25, 0.02] + [0.55, 0.1, 0.74]])  # hands
    verts = (body[None] + rs.randn(T, 1, 3) * [0.005, 0.005, 0.0]).astype(np.float32)
    labels = np.zeros((T, V), np.int32)
    labels[:, 200:250] = 2  # floor
    labels[:, 250:] = 5  # table
    probs = np.full((T, V, 8), 0.02, np.float32)
    probs[np.arange(T)[:, None], np.arange(V)[None], labels] = 0.86
    pred = ((rs.rand(80, 3) - 0.5) * [0.5, 0.35, 0.02] + [0.6, 0.05, 0.72]).astype(np.float32)
    paths = {}
    for name, arr in (("verts", verts), ("labels", labels), ("probs", probs),
                      ("pred", pred)):
        paths[name] = os.path.join(root, f"{name}.npy")
        np.save(paths[name], arr)
    paths["lib"] = os.path.join(root, "lib")
    return paths


def _run_jax(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [module.__name__] + argv)
    return module.main()


def _fits(out_dir):
    """{class/idx: best_obj_id.json} under a fitting output directory."""
    found = {}
    for dirpath, _, files in os.walk(out_dir):
        if "best_obj_id.json" in files:
            with open(os.path.join(dirpath, "best_obj_id.json")) as f:
                found[os.path.relpath(dirpath, out_dir)] = json.load(f)
    return found


def _check_fits(got_dir, want_dir):
    got, want = _fits(got_dir), _fits(want_dir)
    assert got and sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        assert g["best_obj_id"] == w["best_obj_id"], key
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=REFINE_RTOL, err_msg=key)
        assert g["grid_rot_deg"] == w["grid_rot_deg"], key
        np.testing.assert_allclose(g["grid_transl"], w["grid_transl"], atol=1e-6)
        np.testing.assert_allclose(
            [g["refine_rot"], *g["refine_transl"]],
            [w["refine_rot"], *w["refine_transl"]], atol=REFINE_ATOL, err_msg=key)
        mesh = os.path.join(key, g["best_obj_id"], "opt_best.obj")
        np.testing.assert_allclose(meshio.load_obj(os.path.join(got_dir, mesh))[0],
                                   meshio.load_obj(os.path.join(want_dir, mesh))[0],
                                   atol=REFINE_ATOL)


@pytest.fixture(scope="module")
def fitting_data(tmp_path_factory):
    return _fitting_data(str(tmp_path_factory.mktemp("fitting")))


def test_fit_custom_obj_cli_matches_jax(fitting_data, tmp_path, monkeypatch):
    from lsdm_tpu.run import fit_custom_obj as jax_cli
    from lsdm_tpu_torch.run import fit_custom_obj

    d = fitting_data
    common = ["--file_name", d["pred"], "--label", "table", "--vertices_path",
              d["verts"], "--obj_lib", d["lib"], "--sdf_dim", "32"]
    _run_jax(jax_cli, common + ["--output_dir", str(tmp_path / "jax"),
                                "--platform", "cpu"], monkeypatch)
    fit_custom_obj.main(common + ["--output_dir", str(tmp_path / "port"),
                                  "--device", "cpu"])
    _check_fits(str(tmp_path / "port" / "fit_best_obj"),
                str(tmp_path / "jax" / "fit_best_obj"))


def test_fit_best_obj_cli_matches_jax(fitting_data, tmp_path, monkeypatch):
    from lsdm_tpu.run import fit_best_obj as jax_cli
    from lsdm_tpu_torch.run import fit_best_obj

    d = fitting_data
    common = ["--vertices_path", d["verts"], "--contact_labels", d["labels"],
              "--obj_lib", d["lib"], "--sdf_dim", "32"]
    _run_jax(jax_cli, common + ["--output_dir", str(tmp_path / "jax"),
                                "--platform", "cpu"], monkeypatch)
    results = fit_best_obj.main(common + ["--output_dir", str(tmp_path / "port"),
                                          "--device", "cpu"])
    assert results
    _check_fits(str(tmp_path / "port" / "fit_best_obj"),
                str(tmp_path / "jax" / "fit_best_obj"))


def test_fit_prob_obj_cli_matches_jax(fitting_data, tmp_path, monkeypatch):
    from lsdm_tpu.run import fit_prob_obj as jax_cli
    from lsdm_tpu_torch.run import fit_prob_obj

    d = fitting_data
    common = ["seq0", d["verts"], d["probs"], "2", "--obj_lib", d["lib"],
              "--sdf_dim", "32"]
    _run_jax(jax_cli, common + ["--output_dir", str(tmp_path / "jax"),
                                "--platform", "cpu"], monkeypatch)
    summary = fit_prob_obj.main(common + ["--output_dir", str(tmp_path / "port"),
                                          "--device", "cpu"])
    with open(tmp_path / "jax" / "prob_fit.json") as f:
        want = json.load(f)
    assert summary["best_sample"] == want["best_sample"]
    for s, (g, w) in enumerate(zip(summary["samples"], want["samples"])):
        assert [f["obj_id"] for f in g["fits"]] == [f["obj_id"] for f in w["fits"]]
        np.testing.assert_allclose(g["total_loss"], w["total_loss"], rtol=REFINE_RTOL)
        _check_fits(str(tmp_path / "port" / f"sample_{s:02d}" / "fit_best_obj"),
                    str(tmp_path / "jax" / f"sample_{s:02d}" / "fit_best_obj"))


def test_gen_human_meshes_and_custom_collision_write_what_jax_writes(
        fitting_data, tmp_path, monkeypatch):
    from lsdm_tpu.run import custom_collision as jax_collision
    from lsdm_tpu.run import gen_human_meshes as jax_meshes
    from lsdm_tpu_torch.data.synthetic import generate
    from lsdm_tpu_torch.run import custom_collision, gen_human_meshes

    v, f = _box((0, 0, 0), (1, 1, 1))
    faces = str(tmp_path / "faces.obj")
    write_obj(faces, v, f)
    argv = ["--vertices_path", fitting_data["verts"], "--faces_path", faces]
    _run_jax(jax_meshes, argv + ["--output_dir", str(tmp_path / "jax")], monkeypatch)
    out = gen_human_meshes.main(argv + ["--output_dir", str(tmp_path / "port")])
    names = sorted(os.listdir(out))
    assert len(names) == 16 and names == sorted(
        os.listdir(tmp_path / "jax" / "human" / "mesh"))
    for name in names:
        with open(os.path.join(out, name)) as a, open(
                tmp_path / "jax" / "human" / "mesh" / name) as b:
            assert a.read() == b.read()

    # the CLIs read clouds of the dataset's default 1024 points
    data = generate(str(tmp_path / "d"), "proxd", n_scenes=1, n_seqs=3, split="test")
    preds = tmp_path / "preds"
    preds.mkdir()
    rs = np.random.RandomState(10)
    for seq in sorted(os.listdir(os.path.join(data, "context")))[:2]:
        np.save(preds / (os.path.splitext(seq)[0] + ".npy"),
                rs.rand(64, 3).astype(np.float32))
    argv = [data, "--predictions_dir", str(preds), "--objs_data_dir",
            str(tmp_path / "d" / "objs")]
    score = custom_collision.main(argv + ["--device", "cpu"])
    jax_out = tmp_path / "jax_score.txt"
    monkeypatch.setattr(sys, "argv", ["custom_collision"] + argv + ["--platform", "cpu"])
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jax_collision.main()
    jax_out.write_text(buf.getvalue())
    assert f"{score:.4f}" in jax_out.read_text()


@pytest.mark.parametrize("cli", ["fit_custom_obj", "fit_best_obj", "fit_prob_obj",
                                 "custom_collision"])
def test_fitting_clis_run_on_cuda_or_refuse(cli, tmp_path, monkeypatch):
    """``--platform`` is refused with its reason; ``--device`` defaults to
    cuda and, without a GPU, the CLI stops and names ``--device cpu``."""
    import importlib

    mod = importlib.import_module(f"lsdm_tpu_torch.run.{cli}")
    argv = {"fit_custom_obj": ["--file_name", "p.npy", "--label", "table",
                               "--vertices_path", "v.npy", "--obj_lib", "lib"],
            "fit_best_obj": ["--vertices_path", "v.npy", "--contact_labels", "l.npy",
                             "--obj_lib", "lib"],
            "fit_prob_obj": ["s", "v.npy", "p.npy", "1", "--obj_lib", "lib"],
            "custom_collision": ["data", "--predictions_dir", "p"]}[cli]
    with pytest.raises(SystemExit, match="--platform .*not ported"):
        mod.main(argv + ["--platform", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        mod.main(argv)


def test_loader_raises_what_its_producer_raised():
    """The loader's prefetch thread hands a failed batch's exception to the
    consumer (``custom_collision`` over a malformed split stops with it
    instead of waiting forever)."""
    from lsdm_tpu_torch.data.dataset import DataLoader

    class Broken:
        def __len__(self):
            return 3

        def __getitem__(self, i):
            raise ValueError(f"item {i} is malformed")

    with pytest.raises(ValueError, match="item 0 is malformed"):
        list(DataLoader(Broken(), 1, prefetch=2))

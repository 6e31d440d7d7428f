"""The scene-editing slice of the port against the JAX package.

The rotations, ICP (from a given pose, and with random restarts fed JAX's
quaternions), the Sinkhorn EMD, the contact-reconstruction metrics and the
geometry helpers, each on the same numpy inputs; then
``lsdm_tpu_torch.run.scene_edit`` end to end on the CPU with a prompt that
hits the keyword table (the port's mirror of
``tests/test_e2e_fitting_edit.py:test_scene_edit_cli_with_keyword``).

ICP inputs keep inliers in every try: where a try has none, Kabsch takes
the SVD of a zero matrix, whose bases JAX and torch may pick differently.
"""

import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsdm_tpu.fitting.native import dbscan as jax_native_dbscan
from lsdm_tpu.ops import geometry as jax_geometry
from lsdm_tpu.ops import recon_metrics as jax_recon
from lsdm_tpu.ops import rotations as jax_rot
from lsdm_tpu.ops.metrics import emd_sinkhorn as jax_emd_sinkhorn
from lsdm_tpu_torch import kernels
from lsdm_tpu_torch.data.synthetic import generate
from lsdm_tpu_torch.ops import geometry, icp, recon_metrics, rotations
from lsdm_tpu_torch.ops.metrics import emd_sinkhorn
from lsdm_tpu_torch.run import scene_edit

# the module: lsdm_tpu.ops re-exports its function icp under the same name
jax_icp = importlib.import_module("lsdm_tpu.ops.icp")


def _rs(seed):
    return np.random.RandomState(seed)


def _f32(*shape, seed=0, scale=1.0):
    return (_rs(seed).randn(*shape) * scale).astype(np.float32)


def _rot_inputs(name):
    rs = _rs(1)
    if name in ("quaternion_to_matrix",):
        return (_f32(5, 3, 4),)
    if name in ("matrix_to_quaternion", "matrix_to_axis_angle", "matrix_to_rotation_6d"):
        # proper rotations with each quaternion component the largest once
        q = _f32(12, 4, seed=2)
        q[:4] *= np.array([4.0, 1, 1, 1], np.float32)
        q[4:8] *= np.array([1, 4.0, 1, 1], np.float32)
        q[8:] *= np.array([1, 1, 1, 4.0], np.float32)
        return (np.array(jax_rot.quaternion_to_matrix(jnp.asarray(q))),)
    if name == "axis_angle_to_matrix":
        aa = _f32(6, 3, seed=3)
        aa[0] = 0.0  # no rotation
        return (aa,)
    if name == "rotation_6d_to_matrix":
        return (_f32(4, 6, seed=4),)
    if name == "rotz":
        return ((rs.rand(7).astype(np.float32) - 0.5) * 8,)
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "quaternion_to_matrix", "matrix_to_quaternion", "axis_angle_to_matrix",
    "matrix_to_axis_angle", "rotation_6d_to_matrix", "matrix_to_rotation_6d",
    "rotz"])
def test_rotation_matches_jax(name):
    args = _rot_inputs(name)
    want = np.asarray(getattr(jax_rot, name)(*map(jnp.asarray, args)))
    got = getattr(rotations, name)(*map(torch.from_numpy, args))
    assert got.dtype == torch.float32 and got.shape == want.shape
    # float32 transcendental functions and sums of a few terms
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=0)


@pytest.mark.parametrize("axes", ["sxyz", "szyx"])
def test_euler_to_matrix_matches_jax(axes):
    a = (_rs(5).rand(3, 4).astype(np.float32) - 0.5) * 6
    want = np.asarray(jax_rot.euler_to_matrix(*map(jnp.asarray, a), axes=axes))
    got = rotations.euler_to_matrix(*map(torch.from_numpy, a), axes=axes)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=0)
    # the scalar form load_scene_data uses
    np.testing.assert_allclose(
        rotations.euler_to_matrix(np.pi / 2, 0.0, 0.0).numpy(),
        np.asarray(jax_rot.euler_to_matrix(jnp.asarray(np.pi / 2),
                                           jnp.asarray(0.0), jnp.asarray(0.0))),
        atol=1e-7)


def _icp_clouds(n=96, m=80, seed=0):
    """A source cloud and a target: part of the source, rotated by ~25
    degrees about a tilted axis, moved, and jittered."""
    src = (_rs(seed).rand(n, 3).astype(np.float32) - 0.5) * np.float32([0.8, 0.6, 0.4])
    R = np.asarray(jax_rot.axis_angle_to_matrix(jnp.asarray([0.2, 0.1, 0.4])))
    tgt = src[:m] @ R.T + np.float32([0.3, -0.2, 0.1])
    tgt = (tgt + _f32(m, 3, seed=seed + 1, scale=0.005)).astype(np.float32)
    return src, tgt


# float32 SVDs (LAPACK in both, reached by other routes) through 30
# iterations of alignment: the poses agree to ~1e-6; the statistics count
# the same inliers
ICP_ATOL = 1e-4


def _check_icp(got, want):
    np.testing.assert_allclose(got.transformation.numpy(),
                               np.asarray(want.transformation), atol=ICP_ATOL)
    assert int(got.n_correspondences) == int(want.n_correspondences)
    np.testing.assert_allclose(float(got.fitness), float(want.fitness), rtol=1e-6)
    np.testing.assert_allclose(float(got.inlier_rmse), float(want.inlier_rmse),
                               atol=ICP_ATOL)


@pytest.mark.parametrize("threshold", [0.05, 0.2])
def test_icp_from_a_given_pose_matches_jax(threshold):
    src, tgt = _icp_clouds()
    init = np.eye(4, dtype=np.float32)
    init[:3, 3] = tgt.mean(0) - src.mean(0)
    want = jax_icp.icp(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(init),
                       threshold=threshold)
    got = icp.icp(torch.from_numpy(src), torch.from_numpy(tgt),
                  torch.from_numpy(init), threshold=threshold)
    _check_icp(got, want)
    if threshold == 0.2:  # it did align
        assert float(got.fitness) > 0.5


def test_random_restart_icp_with_jax_quaternions_matches_jax():
    src, tgt = _icp_clouds(seed=3)
    key = jax.random.PRNGKey(11)
    n_tries = 8
    want = jax_icp.random_restart_icp(jnp.asarray(src), jnp.asarray(tgt), key,
                                      n_tries=n_tries, threshold=0.2)
    quats = np.array(jax.random.normal(key, (n_tries, 4)))
    kernels.reset_launches()
    got = icp.random_restart_icp(torch.from_numpy(src), torch.from_numpy(tgt),
                                 n_tries=n_tries, threshold=0.2,
                                 quats=torch.from_numpy(quats))
    _check_icp(got, want)
    assert kernels.LAUNCHES["chamfer_nn"] == 0  # the CPU ran K11's plain version
    # every try against JAX's vmap of icp from the same initial poses
    inits = np.tile(np.eye(4, dtype=np.float32), (n_tries, 1, 1))
    inits[:, :3, :3] = np.asarray(jax_rot.quaternion_to_matrix(jnp.asarray(quats)))
    inits[:, :3, 3] = tgt.mean(0) - src.mean(0)
    inits[0, :3, :3] = np.eye(3)
    for k in range(n_tries):
        w = jax_icp.icp(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(inits[k]))
        assert int(w.n_correspondences) > 0  # inliers in every try
        _check_icp(icp.icp(torch.from_numpy(src), torch.from_numpy(tgt),
                           torch.from_numpy(inits[k])), w)


def test_random_restart_icp_draws_from_the_generator():
    src, tgt = _icp_clouds(seed=5)
    a, b = (icp.random_restart_icp(torch.from_numpy(src), torch.from_numpy(tgt),
                                   generator=torch.Generator().manual_seed(2),
                                   n_tries=4) for _ in range(2))
    assert torch.equal(a.transformation, b.transformation)
    moved = icp.transform_points(torch.from_numpy(src), a.transformation)
    want = jax_icp.transform_points(jnp.asarray(src), jnp.asarray(a.transformation.numpy()))
    np.testing.assert_allclose(moved.numpy(), np.asarray(want), atol=1e-6)


def test_emd_sinkhorn_matches_jax():
    pred = _f32(2, 40, 3, seed=6)
    gt = _f32(2, 36, 3, seed=7, scale=0.8)
    want = float(jax_emd_sinkhorn(jnp.asarray(pred), jnp.asarray(gt)))
    got = float(emd_sinkhorn(torch.from_numpy(pred), torch.from_numpy(gt)))
    # 100 float32 log-sum-exp sweeps at epsilon 0.01 in another order
    np.testing.assert_allclose(got, want, rtol=1e-5)


def _contact(seed, V=60, C=8):
    rs = _rs(seed)
    labels = rs.randint(0, C, (2, V))
    labels[:, :20] = 0
    return labels


@pytest.mark.parametrize("name", ["compute_iou", "compute_f1_score", "compute_tpr",
                                  "compute_tnr"])
def test_contact_scores_match_jax(name):
    gt, pred = _contact(1), _contact(2)
    for g, p in ((gt, pred), (np.zeros_like(gt), np.zeros_like(gt)), (gt, gt)):
        want = float(getattr(jax_recon, name)(jnp.asarray(g), jnp.asarray(p)))
        got = float(getattr(recon_metrics, name)(torch.from_numpy(g), torch.from_numpy(p)))
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("form", ["labels", "onehot", "masked", "sum"])
def test_recon_loss_matches_jax(form):
    gt = _contact(3)
    logits = _f32(2, 60, 8, seed=4)
    mask = (_rs(5).rand(2, 60) > 0.3).astype(np.float32)
    g = np.eye(8, dtype=np.float32)[gt] if form == "onehot" else gt
    kw = {"mask": mask} if form == "masked" else {}
    red = "sum" if form == "sum" else "mean"
    want = jax_recon.compute_recon_loss(
        jnp.asarray(g), jnp.asarray(logits),
        **{k: jnp.asarray(v) for k, v in kw.items()}, reduction=red)
    got = recon_metrics.compute_recon_loss(
        torch.from_numpy(g), torch.from_numpy(logits),
        **{k: torch.from_numpy(v) for k, v in kw.items()}, reduction=red)
    np.testing.assert_allclose([float(x) for x in got], [float(x) for x in want],
                               rtol=1e-6)


def test_consistency_metric_matches_jax():
    verts = (_rs(6).rand(80, 3).astype(np.float32)) * 0.5
    labels = _contact(7, V=80)[0]
    want = float(jax_recon.compute_consistency_metric(jnp.asarray(verts),
                                                      jnp.asarray(labels)))
    got = float(recon_metrics.compute_consistency_metric(torch.from_numpy(verts),
                                                         torch.from_numpy(labels)))
    assert got == pytest.approx(want, rel=1e-6)
    assert 0.0 < got < 1.0


def test_rotation_helpers_and_bboxes_match_jax():
    for a, b in (([1.0, 0.2, 0.0], [1.0, 0.0, 0.0]), ([0, 0, 1.0], [0, 0, 1.0]),
                 ([0, 0, 1.0], [0, 0, -1.0]), ([0.3, -1.0, 0.5], [0.0, 1.0, 0.2])):
        np.testing.assert_array_equal(geometry.rotation_matrix_from_vectors(a, b),
                                      jax_geometry.rotation_matrix_from_vectors(a, b))
    pts = _f32(50, 3, seed=8) * np.float32([1.0, 0.4, 0.2])
    for got, want in zip(geometry.oriented_bbox(pts), jax_geometry.oriented_bbox(pts)):
        np.testing.assert_array_equal(got, want)
    clouds = _f32(3, 40, 3, seed=9)
    for got, want in zip(geometry.translate_objs_to_bbox(clouds),
                         jax_geometry.translate_objs_to_bbox(clouds)):
        np.testing.assert_array_equal(got, want)
    R = geometry.rotation_matrix_from_vectors([1, 1, 0], [1, 0, 0])
    np.testing.assert_array_equal(
        geometry.translate_bbox_obj([1, 2, 3], [0.5, 0.2, 0.1], 64, 3, R),
        jax_geometry.translate_bbox_obj([1, 2, 3], [0.5, 0.2, 0.1], 64, 3, R))


def test_normalize_orientation_matches_jax():
    verts = _f32(4, 30, 3, seed=10)
    joints = _rs(11).randint(0, 4, 30)
    want = np.asarray(jax_geometry.normalize_orientation(jnp.asarray(verts), joints))
    got = geometry.normalize_orientation(torch.from_numpy(verts), joints)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_read_sdf_matches_jax():
    D = 6
    grid = _f32(D, D, D, seed=12)
    gmin, gmax = np.float32([-1, -1, 0]), np.float32([1, 2, 1.5])
    pts = (_rs(13).rand(2, 50, 3).astype(np.float32) * 1.4 - 0.2) * (gmax - gmin) + gmin
    pts[0, 0] = gmax  # the far corner, and points outside the grid
    want = np.asarray(jax_geometry.read_sdf(*map(jnp.asarray, (pts, grid, gmin, gmax))))
    got = geometry.read_sdf(*map(torch.from_numpy, (pts, grid, gmin, gmax)))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)


def test_load_scene_data_matches_jax(tmp_path):
    D = 4
    sem = _rs(14).randint(20, 40, D ** 3).astype(np.float32)
    sem[:3] = [34, 25, 41]
    np.save(tmp_path / "room_sdf.npy", _f32(D ** 3, seed=15))
    np.save(tmp_path / "room_semantics.npy", sem)
    (tmp_path / "room.json").write_text(json.dumps(
        {"dim": D, "min": [-1, -1, 0], "max": [1, 1, 2], "bbox": [[0, 0, 0], [1, 1, 1]],
         "badding_val": 7}))
    got = geometry.load_scene_data("room", str(tmp_path), use_semantics=True)
    want = jax_geometry.load_scene_data("room", str(tmp_path), use_semantics=True)
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_allclose(got[k], v, atol=1e-7, err_msg=k)
        else:
            assert got[k] == v, k


def _heights(seed):
    rs = _rs(seed)
    return np.concatenate([rs.randn(300) * 0.002, 0.8 + rs.randn(120) * 0.002,
                           rs.rand(60) * 2.0, 1.5 + rs.randn(200) * 0.002]
                          ).astype(np.float32)[rs.permutation(680)]


@pytest.mark.parametrize("seed", [0, 1])
def test_dbscan_1d_matches_the_native_dbscan(seed):
    z = _heights(seed)
    pts = np.stack([z, np.zeros_like(z), np.zeros_like(z)], -1)
    for eps, min_pts in ((0.005, 68), (0.01, 10), (0.002, 3)):
        want = jax_native_dbscan(pts, eps=eps, min_pts=min_pts)
        got = geometry.dbscan_1d(z, eps, min_pts)
        np.testing.assert_array_equal(got, want, err_msg=f"eps {eps}")
    assert len(set(want[want >= 0])) > 1


def test_estimate_floor_height_matches_jax():
    verts = _heights(2).reshape(1, -1, 1) * np.float32([0, 0, 1]) + _f32(
        1, 680, 3, seed=3) * np.float32([1, 1, 0])
    contact = (_rs(4).rand(1, 680) > 0.2).astype(np.float32)
    for mask in (None, contact, np.zeros_like(contact)):
        want = jax_geometry.estimate_floor_height(verts, mask)
        got = geometry.estimate_floor_height(verts, mask)
        assert got == pytest.approx(want, abs=1e-7)
    assert abs(got) < 0.01  # the floor cluster near 0 is the densest


def _edit_split(root, rs):
    generate(root, "proxd", n_scenes=1, n_seqs=2, pnt_size=32, seed=0, split="test")
    ctx = os.path.join(root, "proxd_test", "context")
    for s in sorted(os.listdir(ctx)):
        with open(os.path.join(ctx, s)) as f:
            lines = f.readlines()
        lines[0] = "place a desk next to the person\n"
        with open(os.path.join(ctx, s), "w") as f:
            f.writelines(lines)
    os.makedirs(os.path.join(root, "objs", "N3Office"), exist_ok=True)
    np.save(os.path.join(root, "objs", "N3Office", "table_0.npy"),
            rs.rand(32, 3).astype(np.float32))


@pytest.mark.parametrize("edit_type", ["obj_mod", "shape_alt"])
def test_scene_edit_cli_with_keyword_on_cpu(tmp_path, edit_type):
    root = str(tmp_path / "data")
    _edit_split(root, _rs(0))
    out = str(tmp_path / "editout")
    final = scene_edit.main([
        os.path.join(root, "proxd_test"), "--objs_data_dir", os.path.join(root, "objs"),
        "--output_dir", out, "--edit_type", edit_type, "--diffusion_steps", "6",
        "--pcd_points", "32", "--icp_tries", "8", "--device", "cpu"])
    results = open(os.path.join(out, "results.txt")).read().splitlines()
    # output contract: a line per sequence, the finals, the ICP lines
    assert [line.split(":")[0] for line in results[2:]] == [
        "Final Chamfer distance", "Final EMD", "Final F1 score",
        "Category accuracy", "Top 3 accuracy", "Fitness", "MSE", "Corr set"]
    assert 0.0 < final["fitness"] <= 1.0 and all(np.isfinite(v) for v in final.values())
    for sub in ("predictions", "guiding_points"):
        names = sorted(os.listdir(os.path.join(out, sub)))
        assert len(names) == 2
        for name in names:
            arr = np.load(os.path.join(out, sub, name))
            assert arr.shape == (32, 3) and arr.dtype == np.float32
            assert np.isfinite(arr).all()


def test_scene_edit_prompt_phrases_and_masks():
    assert scene_edit.prompt_phrases("place a chest of drawers here") == [
        "chest", "chest of", "chest of drawers"]
    assert scene_edit.prompt_phrases("put a desk") == ["desk", "desk", "desk"]
    gt = _f32(1, 16, 3, seed=1)
    m = scene_edit.edit_mask(gt, "shape_alt")
    kept = np.flatnonzero(m[0, :, 0])
    assert len(kept) == 4 and set(kept) == set(np.argsort(gt[0, :, 2])[:4])
    assert not scene_edit.edit_mask(gt, "obj_dis").any()


@pytest.mark.parametrize("flag", [["--platform", "cpu"]])
def test_scene_edit_cli_refuses_jax_flags_with_a_reason(tmp_path, flag):
    with pytest.raises(SystemExit, match=f"{flag[0]} is not ported"):
        scene_edit.main([str(tmp_path), "--device", "cpu", *flag])


def test_scene_edit_cli_refuses_what_the_port_cannot_run(tmp_path):
    with pytest.raises(SystemExit, match="torch .pt"):
        scene_edit.main([str(tmp_path), "--load_model", "model.ckpt"])
    if not torch.cuda.is_available():  # no silent CPU run
        with pytest.raises(SystemExit, match="--device cpu"):
            scene_edit.main([str(tmp_path)])

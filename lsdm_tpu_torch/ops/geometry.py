"""Scene-geometry utilities: orientation normalisation, SDF sampling,
oriented bounding boxes, floor estimation.

Counterpart of ``lsdm_tpu/ops/geometry.py``: the host numpy helpers
(``rotation_matrix_from_vectors``, ``oriented_bbox``,
``translate_objs_to_bbox``, ``translate_bbox_obj``) are copied from it;
``normalize_orientation`` and ``read_sdf`` are in torch, the trilinear
sample written out (JAX: ``map_coordinates(order=1, mode="nearest")``);
``estimate_floor_height`` clusters the heights with a 1-D DBSCAN of its
own (the JAX package calls its native C++ DBSCAN, which this package does
not load).  The reference: ``posa/data_utils.py`` (``:124``, ``:138``,
``:216``, ``:253``), ``util/translate_obj_bbox.py`` and ``utils.py:354-371``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def rotation_matrix_from_vectors(vec1: np.ndarray, vec2: np.ndarray) -> np.ndarray:
    """Rotation aligning vec1 to vec2 (host numpy; reference
    ``data_utils.py:124-136``)."""
    a = np.asarray(vec1, np.float64).reshape(3)
    b = np.asarray(vec2, np.float64).reshape(3)
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    s = float(np.linalg.norm(v))
    if s < 1e-12:
        return np.eye(3) if c > 0 else -np.eye(3)
    kmat = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + kmat + kmat @ kmat * ((1 - c) / (s**2))


def normalize_orientation(verts_can: torch.Tensor,
                          associated_joints: np.ndarray) -> torch.Tensor:
    """Rotate a motion sequence about z so the first-frame pose faces +x
    (reference ``data_utils.py:138-163``): direction = mean(verts of joint
    1) - mean(verts of joint 2), z zeroed, aligned to (1, 0, 0); the
    rotation is applied to all frames.  verts_can (T, V, 3)."""
    first = verts_can[0].detach().cpu().numpy()
    joints = np.asarray(associated_joints)
    direction = first[joints == 1].mean(0) - first[joints == 2].mean(0)
    direction[2] = 0.0
    rot = rotation_matrix_from_vectors(direction, np.array([1.0, 0.0, 0.0]))
    rot = torch.as_tensor(rot, dtype=torch.float32, device=verts_can.device)
    return torch.einsum("ij,tvj->tvi", rot, verts_can)


def read_sdf(vertices: torch.Tensor, sdf_grid: torch.Tensor,
             grid_min: torch.Tensor, grid_max: torch.Tensor) -> torch.Tensor:
    """Trilinear SDF sample at world-space points (reference ``read_sdf``,
    ``data_utils.py:253-265``: ``grid_sample(align_corners=True,
    padding_mode='border')``, the verts' (x, y, z) on grid axes (0, 1, 2)).
    vertices (B, N, 3), sdf_grid (D, D, D) -> (B, N)."""
    D = sdf_grid.shape[0]
    coords = (vertices - grid_min) / (grid_max - grid_min) * (D - 1)
    coords = torch.clamp(coords, 0, D - 1)         # padding_mode='border'
    return trilinear(coords, sdf_grid)


def trilinear(coords: torch.Tensor, sdf_grid: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of ``sdf_grid`` (D, D, D) at grid coordinates
    (..., 3) within [0, D - 1]: the 8 corners in
    ``jax.scipy.ndimage.map_coordinates(order=1, mode="nearest")``'s order,
    each weight the product of its three axis weights, summed corner after
    corner.  Differentiable in ``coords``."""
    D = sdf_grid.shape[0]
    lo = torch.floor(coords)
    frac = coords - lo
    lo = lo.long()
    hi = torch.clamp(lo + 1, max=D - 1)
    flat = sdf_grid.reshape(-1)
    out = torch.zeros(coords.shape[:-1], dtype=sdf_grid.dtype,
                      device=coords.device)
    for corner in range(8):
        idx, w = [], torch.ones_like(out)
        for axis in range(3):
            up = (corner >> (2 - axis)) & 1
            idx.append((hi if up else lo)[..., axis])
            w = w * (frac[..., axis] if up else 1 - frac[..., axis])
        out = out + w * flat[(idx[0] * D + idx[1]) * D + idx[2]]
    return out


def load_scene_data(name: str, sdf_dir: str, use_semantics: bool = False,
                    no_obj_classes: int = 42) -> dict:
    """Load a scene SDF grid + optional semantics (reference
    ``load_scene_data``, ``posa/data_utils.py:216-251``), including the
    label remaps (34 -> 10 seating->sofa, 25 -> 28 shower->lighting)."""
    import json
    import os.path as osp

    from lsdm_tpu_torch.ops.rotations import euler_to_matrix

    with open(osp.join(sdf_dir, name + ".json")) as f:
        meta = json.load(f)
    grid_dim = meta["dim"]
    grid_min = np.asarray(meta["min"], np.float32)
    grid_max = np.asarray(meta["max"], np.float32)
    sdf = np.load(osp.join(sdf_dir, name + "_sdf.npy")).astype(np.float32)
    sdf = sdf.reshape(grid_dim, grid_dim, grid_dim)
    out = {
        "R": euler_to_matrix(np.pi / 2, 0.0, 0.0).numpy(),
        "t": np.zeros((1, 3), np.float32),
        "grid_dim": grid_dim,
        "grid_min": grid_min,
        "grid_max": grid_max,
        "voxel_size": (grid_max - grid_min) / grid_dim,
        "bbox": np.asarray(meta.get("bbox", []), np.float32),
        "badding_val": meta.get("badding_val"),
        "sdf": sdf,
        "semantics": None,
        "scene_semantics": None,
    }
    if use_semantics:
        sem = np.load(osp.join(sdf_dir, name + "_semantics.npy")).astype(np.float32)
        sem = sem.reshape(grid_dim, grid_dim, grid_dim)
        sem[sem == 34] = 10  # seating -> sofa (N0SittingBooth)
        sem[sem == 25] = 28  # mislabeled shower -> lighting
        present = np.unique(sem).astype(int)
        onehot = np.zeros((1, no_obj_classes), np.float32)
        onehot[0, present[present < no_obj_classes]] = 1
        out["semantics"] = sem
        out["scene_semantics"] = onehot
    return out


def oriented_bbox(points: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """PCA oriented bounding box: (center (3,), rotation (3, 3), extent (3,)).

    Replaces open3d ``OrientedBoundingBox.create_from_points``
    (reference ``util/translate_obj_bbox.py:6-16``).  Columns of the
    rotation are the principal axes.
    """
    pts = np.asarray(points, np.float64)
    mean = pts.mean(0)
    centered = pts - mean
    cov = centered.T @ centered / max(len(pts) - 1, 1)
    eigval, eigvec = np.linalg.eigh(cov)
    order = np.argsort(eigval)[::-1]
    R = eigvec[:, order]
    if np.linalg.det(R) < 0:
        R[:, 2] = -R[:, 2]
    local = centered @ R
    lo, hi = local.min(0), local.max(0)
    extent = hi - lo
    center = mean + R @ ((lo + hi) / 2)
    return center.astype(np.float32), R.astype(np.float32), extent.astype(np.float32)


def translate_objs_to_bbox(obj_verts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Batch point clouds -> (centers (B, 3), sizes (B, 3))
    (reference ``translate_objs_to_bbox``, ``util/translate_obj_bbox.py:18-38``,
    minus its self-assignment bug at ``:34``)."""
    obj_verts = np.asarray(obj_verts)
    centers = np.zeros((obj_verts.shape[0], 3), np.float32)
    sizes = np.zeros((obj_verts.shape[0], 3), np.float32)
    for i, verts in enumerate(obj_verts):
        c, _, e = oriented_bbox(verts)
        centers[i] = c
        sizes[i] = e
    return centers, sizes


def translate_bbox_obj(center: np.ndarray, size: np.ndarray,
                       n_points: int = 1024, seed: int = 0,
                       rotation: Optional[np.ndarray] = None) -> np.ndarray:
    """Uniformly sample points inside a bbox (reference
    ``translate_bbox_obj``, ``util/translate_obj_bbox.py:55-71``)."""
    rng = np.random.RandomState(seed)
    local = (rng.rand(n_points, 3).astype(np.float32) - 0.5) * np.asarray(
        size, np.float32)
    if rotation is not None:
        local = local @ np.asarray(rotation, np.float32).T
    return local + np.asarray(center, np.float32)


def dbscan_1d(z: np.ndarray, eps: float, min_pts: int) -> np.ndarray:
    """DBSCAN labels of 1-D values z (n,): a cluster id >= 0, or -1 for
    noise, as open3d / sklearn / the JAX package's native DBSCAN give
    them.  Neighbours lie within eps (self included); a point with at
    least min_pts neighbours is a core point; clusters are numbered in the
    order of their lowest-index core point, and a border point joins the
    lowest-numbered cluster with a core point within eps.  In 1-D two cores
    are connected exactly when no gap above eps separates them in sorted
    order, so this is a sort and a scan."""
    z = np.asarray(z, np.float64).reshape(-1)
    n = len(z)
    order = np.argsort(z, kind="stable")
    zs = z[order]
    lo = np.searchsorted(zs, zs - eps, side="left")
    hi = np.searchsorted(zs, zs + eps, side="right")
    core = (hi - lo) >= min_pts
    labels = np.full(n, -1, np.int64)
    if not core.any():
        return labels
    # components of the core points in sorted order
    cpos = np.flatnonzero(core)
    comp = np.concatenate([[0], np.cumsum(np.diff(zs[cpos]) > eps)])
    # number the components by their lowest original index
    first = np.full(comp[-1] + 1, n, np.int64)
    np.minimum.at(first, comp, order[cpos])
    rank = np.empty_like(first)
    rank[np.argsort(first, kind="stable")] = np.arange(len(first))
    cid = rank[comp]
    labels[order[cpos]] = cid
    # border points: the lowest cluster id among the cores within eps
    for i in np.flatnonzero(~core):
        lo_c = np.searchsorted(zs[cpos], zs[i] - eps, side="left")
        hi_c = np.searchsorted(zs[cpos], zs[i] + eps, side="right")
        if hi_c > lo_c:
            labels[order[i]] = cid[lo_c:hi_c].min()
    return labels


def estimate_floor_height(verts: np.ndarray,
                          contact_mask: Optional[np.ndarray] = None,
                          eps: float = 0.005, min_samples: int = 100) -> float:
    """Floor height = center of the densest 1-D cluster of (floor-contact)
    vertex z values (reference ``estimate_floor_height``,
    ``utils.py:354-371``, sklearn DBSCAN over heights)."""
    verts = np.asarray(verts)
    z = verts.reshape(-1, verts.shape[-1])[:, 2]
    if contact_mask is not None:
        flat = np.asarray(contact_mask).reshape(-1) > 0
        if flat.any():
            z = z[flat]
    if len(z) == 0:
        return 0.0
    labels = dbscan_1d(z, eps, min(min_samples, max(len(z) // 10, 1)))
    valid = labels >= 0
    if not valid.any():
        return float(np.median(z))
    densest = int(np.argmax(np.bincount(labels[valid])))
    return float(z[labels == densest].mean())

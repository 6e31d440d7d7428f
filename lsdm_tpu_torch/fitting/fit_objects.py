"""Object-fitting pipeline (reference ``fit_best_obj.py`` /
``fit_custom_obj.py`` / ``fit_custom_obj_humanise.py``).

Counterpart of ``lsdm_tpu/fitting/fit_objects.py``.  Given contact
evidence (either LSDM-generated points or voted contact labels on the
human sequence) and a library of candidate CAD meshes, fit the best mesh
per contact cluster:

  human mesh seq -> merged surface -> SDF (native EDT, cached)
  contact evidence -> (vote ->) per-class DBSCAN clusters
  per cluster x candidate mesh: floor-align, center, sample surface,
      the batched 36x11x11 grid search -> 200-step Adam refinement, both
      on the given torch device (``fitting/place_obj.py``)
  keep the best candidate -> ``fit_best_obj/<class>/<idx>/<id>/opt_best.obj``
      + ``best_obj_id.json``

The host-side steps (floor alignment, centring, DBSCAN, voting, surface
sampling) are the JAX module's numpy, copied.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from lsdm_tpu_torch.fitting import native
from lsdm_tpu_torch.fitting.config import (
    CLASSES_EPS,
    CLUSTER_MIN_POINTS,
    FITTING_PARAMS,
    PTS_PER_UNIT,
    VOTING_EPS,
    VOXEL_SIZE,
)
from lsdm_tpu_torch.fitting.meshio import (
    MPCAT40_CLASS_IDS,
    load_obj_candidates,
    sample_surface,
    write_obj,
)
from lsdm_tpu_torch.fitting.place_obj import grid_search, refine_pose


def align_to_floor(verts: np.ndarray, floor_height: float) -> np.ndarray:
    """Drop the mesh so its lowest point sits on the floor
    (reference ``align_obj_to_floor``, ``utils.py:382-395``)."""
    out = np.asarray(verts, np.float32).copy()
    out[:, 2] += floor_height - out[:, 2].min()
    return out


def center_xy(verts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    out = np.asarray(verts, np.float32).copy()
    center = np.array(
        [(out[:, 0].min() + out[:, 0].max()) / 2,
         (out[:, 1].min() + out[:, 1].max()) / 2], np.float32
    )
    out[:, 0] -= center[0]
    out[:, 1] -= center[1]
    return out, center


def cluster_contact_points(
    points: np.ndarray, class_id: int, eps: Optional[float] = None
) -> List[np.ndarray]:
    """Per-class DBSCAN clustering (reference ``fit_best_obj.py:166-199``)."""
    eps = eps if eps is not None else CLASSES_EPS.get(class_id, 0.2)
    labels = native.dbscan(points, eps=eps, min_pts=CLUSTER_MIN_POINTS)
    clusters = []
    for cid in range(labels.max() + 1):
        sel = points[labels == cid]
        if len(sel) >= CLUSTER_MIN_POINTS:
            clusters.append(sel)
    return clusters


def vote_contact_points(
    verts_seq: np.ndarray,  # (T, V, 3)
    contact_labels: np.ndarray,  # (T, V) int 8-class predictions
) -> Dict[int, np.ndarray]:
    """Local majority voting of contact labels (reference
    ``fit_best_obj.py:116-163``): pool contact verts across frames, voxel
    downsample, assign each representative the modal label of its
    ``VOTING_EPS`` neighborhood; returns {class_id: points}."""
    T, V, _ = verts_seq.shape
    flat_pts = verts_seq.reshape(-1, 3)
    flat_lbl = contact_labels.reshape(-1)
    contact = flat_lbl >= 3  # object classes only (chair..stool)
    pts = flat_pts[contact]
    lbl = flat_lbl[contact]
    if len(pts) == 0:
        return {}
    reps = native.voxel_downsample(pts, VOXEL_SIZE)
    out: Dict[int, List[np.ndarray]] = {}
    for rep in reps:
        d2 = ((pts - rep) ** 2).sum(1)
        nbr = d2 <= VOTING_EPS**2
        if not nbr.any():
            continue
        votes = np.bincount(lbl[nbr])
        klass = int(votes.argmax())
        # map 8-class subset id -> mpcat40 id used by the fitting tables
        name = {3: "chair", 4: "sofa", 5: "table", 6: "bed", 7: "stool"}.get(klass)
        if name is None:
            continue
        mp = MPCAT40_CLASS_IDS[name]
        out.setdefault(mp, []).append(rep)
    return {k: np.stack(v) for k, v in out.items()}


def fit_cluster(
    cluster_points: np.ndarray,
    candidates: Sequence[Tuple[str, np.ndarray, np.ndarray]],
    sdf: np.ndarray,
    sdf_centroid: np.ndarray,
    sdf_extents: np.ndarray,
    class_id: int,
    floor_height: float,
    params: Optional[dict] = None,
    sample_seed: int = 0,
    device=None,
):
    """Fit every candidate mesh to one contact cluster on ``device``
    (default: the SDF's if it is a tensor, else the CPU); return
    (best_id, best_points, best_loss, best_pose)."""
    p = params or FITTING_PARAMS["default"]
    gs_pen_w = p["grid_search_classes_pen_weight"].get(class_id, 10.0)
    opt_pen_w = p["opt_classes_pen_weight"].get(class_id, 1.0)

    best = (None, None, float("inf"), None)
    for obj_id, verts, faces in candidates:
        verts = align_to_floor(verts, floor_height)
        verts, _ = center_xy(verts)
        extent = verts.max(0) - verts.min(0)
        n_pts = int(np.clip(extent[:2].prod() * PTS_PER_UNIT**2, 256, 2048))
        pts = sample_surface(verts, faces, n_pts, seed=sample_seed)
        # grid translations are absolute (the object is xy-centered, so the
        # grid's contact-bbox-derived range already spans the scene)
        g = grid_search(
            pts, np.zeros(2, np.float32), cluster_points, sdf, sdf_centroid,
            sdf_extents,
            contact_weight=p["grid_search_contact_weight"],
            pen_thresh=p["grid_search_pen_thresh"], pen_weight=gs_pen_w,
            device=device,
        )
        r = refine_pose(
            pts,
            np.array([float(g.transl_x), float(g.transl_y)], np.float32),
            float(g.rot_deg), cluster_points, sdf, sdf_centroid, sdf_extents,
            contact_weight=p["opt_contact_weight"],
            pen_thresh=p["opt_pen_thresh"], pen_weight=opt_pen_w,
            lr=p["lr"], opt_steps=p["opt_steps"], device=device,
        )
        if float(r.loss) < best[2]:
            pose = {
                "grid_rot_deg": float(g.rot_deg),
                "grid_transl": [float(g.transl_x), float(g.transl_y)],
                "refine_rot": float(r.rot),
                "refine_transl": [float(r.transl_x), float(r.transl_y)],
            }
            best = (obj_id, r.points.cpu().numpy(), float(r.loss), pose)
    return best


def fit_contact_clusters(
    clusters_by_class: Dict[int, List[np.ndarray]],
    obj_lib_dir: str,
    sdf: np.ndarray, sdf_centroid: np.ndarray, sdf_extents: np.ndarray,
    floor_height: float,
    output_dir: str,
    params: Optional[dict] = None,
    device=None,
) -> List[dict]:
    """Fit all clusters on ``device`` (the SDF moves there once); writes
    per-cluster ``opt_best.obj`` + ``best_obj_id.json`` under
    ``output_dir/<class>/<idx>/`` (reference output contract,
    ``fit_best_obj.py:349-369``)."""
    if device is not None:
        sdf, sdf_centroid, sdf_extents = (
            torch.as_tensor(np.asarray(a, np.float32), device=device)
            for a in (sdf, sdf_centroid, sdf_extents))
    id_by_mp = {v: k for k, v in MPCAT40_CLASS_IDS.items()}
    results = []
    for class_id, clusters in clusters_by_class.items():
        class_name = id_by_mp.get(class_id, str(class_id))
        candidates = load_obj_candidates(os.path.join(obj_lib_dir, class_name))
        if not candidates:
            candidates = load_obj_candidates(obj_lib_dir)
        if not candidates:
            continue
        for ci, cluster in enumerate(clusters):
            obj_id, points, loss, pose = fit_cluster(
                cluster, candidates, sdf, sdf_centroid, sdf_extents, class_id,
                floor_height, params, device=device,
            )
            if obj_id is None:
                continue
            # reference layout (fit_best_obj.py:349-369, consumed by
            # scene_completion): meta at <class>/<idx>/best_obj_id.json,
            # mesh at <class>/<idx>/<obj_id>/opt_best.obj
            slot_dir = os.path.join(output_dir, class_name, str(ci))
            mesh_dir = os.path.join(slot_dir, obj_id)
            os.makedirs(mesh_dir, exist_ok=True)
            write_obj(os.path.join(mesh_dir, "opt_best.obj"), points)
            with open(os.path.join(slot_dir, "best_obj_id.json"), "w") as f:
                json.dump({"best_obj_id": obj_id, "loss": loss, **pose}, f)
            results.append({
                "class": class_name, "cluster": ci, "obj_id": obj_id,
                "loss": loss, "points": points,
            })
    return results

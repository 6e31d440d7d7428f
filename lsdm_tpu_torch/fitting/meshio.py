"""Mesh / point-cloud IO and surface sampling — no open3d/trimesh.

A copy of ``lsdm_tpu/fitting/meshio.py``; its OBJ reader is the port's
``ops/spiral.py:load_obj``, as the JAX module's is ``lsdm_tpu/ops/spiral.py``'s.

Replaces the reference's mesh utilities (``utils.py``): OBJ/PLY read/write
(``write_verts_faces_obj`` ``utils.py:340``), mesh merging (``:312``),
frame-sequence loading (``:288``), Poisson-disk sampling (open3d) ->
area-weighted surface sampling, and the mpcat40 label-table parser
(``:124-135``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from lsdm_tpu_torch.ops.spiral import load_obj


def write_obj(path: str, verts: np.ndarray, faces: Optional[np.ndarray] = None):
    """(reference ``write_verts_faces_obj``, ``utils.py:340-352``)"""
    with open(path, "w") as f:
        for v in np.asarray(verts):
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        if faces is not None:
            for face in np.asarray(faces):
                f.write(f"f {face[0] + 1} {face[1] + 1} {face[2] + 1}\n")


def write_ply(path: str, verts: np.ndarray, faces: Optional[np.ndarray] = None,
              colors: Optional[np.ndarray] = None):
    """ASCII PLY writer (replaces open3d mesh export for visualization)."""
    verts = np.asarray(verts)
    n = len(verts)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        if faces is not None:
            f.write(f"element face {len(faces)}\n")
            f.write("property list uchar int vertex_indices\n")
        f.write("end_header\n")
        for i, v in enumerate(verts):
            line = f"{v[0]} {v[1]} {v[2]}"
            if colors is not None:
                c = (np.asarray(colors[i]) * 255).astype(int) if colors.dtype.kind == "f" else colors[i]
                line += f" {int(c[0])} {int(c[1])} {int(c[2])}"
            f.write(line + "\n")
        if faces is not None:
            for face in np.asarray(faces):
                f.write(f"3 {face[0]} {face[1]} {face[2]}\n")


def read_ply(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal ASCII PLY reader (verts + triangle faces)."""
    verts: List[List[float]] = []
    faces: List[List[int]] = []
    with open(path) as f:
        n_verts = n_faces = 0
        for line in f:
            line = line.strip()
            if line.startswith("element vertex"):
                n_verts = int(line.split()[-1])
            elif line.startswith("element face"):
                n_faces = int(line.split()[-1])
            elif line == "end_header":
                break
        for _ in range(n_verts):
            parts = f.readline().split()
            verts.append([float(x) for x in parts[:3]])
        for _ in range(n_faces):
            parts = f.readline().split()
            faces.append([int(x) for x in parts[1:4]])
    return np.asarray(verts, np.float64), np.asarray(faces, np.int32)


def load_mesh(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Extension-dispatching mesh loader (.obj / .ply)."""
    if path.endswith(".ply"):
        return read_ply(path)
    return load_obj(path)


def merge_meshes(meshes: List[Tuple[np.ndarray, np.ndarray]]) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenate (verts, faces) pairs with index offsets
    (reference ``merge_meshes``, ``utils.py:312-331``)."""
    all_v, all_f = [], []
    offset = 0
    for verts, faces in meshes:
        all_v.append(np.asarray(verts))
        if faces is not None and len(faces):
            all_f.append(np.asarray(faces) + offset)
        offset += len(verts)
    return np.concatenate(all_v), (
        np.concatenate(all_f) if all_f else np.zeros((0, 3), np.int32)
    )


def sample_surface(verts: np.ndarray, faces: np.ndarray, n_points: int,
                   seed: int = 0) -> np.ndarray:
    """Area-weighted uniform surface sampling (replaces open3d Poisson-disk
    sampling at ``fit_best_obj.py:279`` — uniform-density; flagged)."""
    rng = np.random.RandomState(seed)
    v = np.asarray(verts, np.float64)
    f = np.asarray(faces, np.int64)
    if len(f) == 0:
        idx = rng.randint(0, len(v), n_points)
        return v[idx].astype(np.float32)
    a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    probs = areas / max(areas.sum(), 1e-12)
    tri = rng.choice(len(f), n_points, p=probs)
    r1 = np.sqrt(rng.rand(n_points))
    r2 = rng.rand(n_points)
    pts = (
        (1 - r1)[:, None] * a[tri]
        + (r1 * (1 - r2))[:, None] * b[tri]
        + (r1 * r2)[:, None] * c[tri]
    )
    return pts.astype(np.float32)


def read_human_mesh_sequence(
    vertices_path: str, faces_path: Optional[str] = None, down_sample: int = 8
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Load a (T, V, 3) vertex sequence npy + optional faces npy, frame
    downsampled (reference ``read_sequence_human_mesh`` ``utils.py:288-310``
    + ``fit_best_obj.py:45-52``)."""
    verts = np.load(vertices_path).astype(np.float32)
    if verts.ndim == 2:
        verts = verts[None]
    verts = verts[::down_sample]
    faces = None
    if faces_path and os.path.exists(faces_path):
        faces = np.load(faces_path).astype(np.int32)
    return verts, faces


def read_mpcat40(path: str) -> Dict[int, Tuple[str, str]]:
    """Parse an mpcat40-style tsv: index -> (label, hex color)
    (reference ``read_mpcat40``, ``utils.py:124-135``)."""
    table = {}
    with open(path) as f:
        header = f.readline()
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 3:
                table[int(parts[0])] = (parts[1], parts[2])
    return table


# The 8-class contact-prediction subset -> mpcat40 names used throughout the
# fitting pipeline (reference ``pred_subset_to_mpcat40``, ``utils.py:101-110``).
PRED_SUBSET_TO_MPCAT40 = {
    0: "void", 1: "wall", 2: "floor", 3: "chair", 4: "sofa", 5: "table",
    6: "bed", 7: "stool",
}

# mpcat40 ids for the fittable classes (keys of fitting config tables).
MPCAT40_CLASS_IDS = {
    "chair": 3, "table": 5, "cabinet": 7, "sofa": 10, "bed": 11, "stool": 19,
    "shelf": 31, "shelving": 31,
}


def load_obj_candidates(directory: str) -> List[Tuple[str, np.ndarray, np.ndarray]]:
    """Load every .obj in a directory as (id, verts, faces) — the candidate
    CAD library (3D-FUTURE in the reference, any obj collection here)."""
    out = []
    if not os.path.isdir(directory):
        return out
    for name in sorted(os.listdir(directory)):
        if name.endswith(".obj"):
            verts, faces = load_obj(os.path.join(directory, name))
            out.append((name[:-4], verts.astype(np.float32), faces))
    return out

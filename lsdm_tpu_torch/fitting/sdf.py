"""SDF generation from human-mesh surfaces (native, with numpy fallback).

A copy of ``lsdm_tpu/fitting/sdf.py``: the repository's ``native/libsdf.so``
loaded by path, no JAX.

Replaces mesh_to_sdf (reference ``generate_sdf``, ``utils.py:242-275``):
returns ``(sdf (dim^3 grid), centroid (3,), extents (3,))`` in exactly the
normalization ``compute_signed_distances`` expects — the grid spans a cube
of side ``extents.max()`` centered at the bbox centroid, align_corners
mapping (index 0 <-> centroid - extents.max()/2).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", "..", "native", "libsdf.so")
    )
    if not os.path.exists(path):
        makefile_dir = os.path.dirname(path)
        os.system(f"make -C {makefile_dir} libsdf.so >/dev/null 2>&1")
    if os.path.exists(path):
        lib = ctypes.CDLL(path)
        lib.generate_sdf.restype = None
        lib.generate_sdf.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_long,
            ctypes.POINTER(ctypes.c_float), ctypes.c_float,
            ctypes.POINTER(ctypes.c_float),
        ]
        _LIB = lib
    return _LIB


def generate_sdf(
    surface_points: np.ndarray, dim: int = 256, padding: float = 0.1
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Surface point samples -> (sdf (dim, dim, dim), centroid, extents).

    Negative inside (voxel flood-fill sign), world units.
    """
    pts = np.ascontiguousarray(surface_points.reshape(-1, 3), np.float32)
    lo, hi = pts.min(0), pts.max(0)
    centroid = (lo + hi) / 2
    extents = (hi - lo) * (1 + padding)
    side = float(extents.max())
    grid_min = centroid - side / 2
    voxel = side / (dim - 1)

    lib = _lib()
    out = np.empty(dim * dim * dim, np.float32)
    if lib is not None:
        lib.generate_sdf(
            pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(pts), dim,
            np.ascontiguousarray(grid_min, np.float32).ctypes.data_as(
                ctypes.POINTER(ctypes.c_float)
            ),
            ctypes.c_float(voxel), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        sdf = out.reshape(dim, dim, dim)
    else:  # numpy fallback: unsigned distance via scipy EDT + flood fill
        from scipy import ndimage

        occ = np.zeros((dim, dim, dim), bool)
        ijk = np.floor((pts - grid_min) / voxel).astype(int)
        valid = ((ijk >= 0) & (ijk < dim)).all(1)
        ijk = ijk[valid]
        occ[ijk[:, 0], ijk[:, 1], ijk[:, 2]] = True
        dist = ndimage.distance_transform_edt(~occ) * voxel
        # flood the outside across the 1-voxel-dilated wall (sampling holes
        # must not leak), matching the native kernel's sign rule
        # L-inf radius-2 dilation, matching the native kernel's cube wall
        wall = ndimage.binary_dilation(occ, structure=np.ones((5, 5, 5), bool))
        labels, _ = ndimage.label(~wall)
        border_labels = np.unique(
            np.concatenate([
                labels[0].ravel(), labels[-1].ravel(),
                labels[:, 0].ravel(), labels[:, -1].ravel(),
                labels[:, :, 0].ravel(), labels[:, :, -1].ravel(),
            ])
        )
        outside = np.isin(labels, border_labels[border_labels > 0])
        inside = ~outside & ~occ
        sdf = np.where(inside, -dist, dist).astype(np.float32)
    return sdf, centroid.astype(np.float32), extents.astype(np.float32)


def cached_sdf(cache_path: str, surface_points: np.ndarray, dim: int = 256):
    """Disk-cached generation (the reference caches its SDF next to the
    predictions, ``fit_best_obj.py:94-99``)."""
    if os.path.exists(cache_path):
        data = np.load(cache_path)
        return data["sdf"], data["centroid"], data["extents"]
    sdf, centroid, extents = generate_sdf(surface_points, dim)
    np.savez_compressed(cache_path, sdf=sdf, centroid=centroid, extents=extents)
    return sdf, centroid, extents

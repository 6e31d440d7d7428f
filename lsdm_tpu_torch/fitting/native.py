"""ctypes bridge to the native geometry kernels (native/fitting.cpp):
DBSCAN, voxel downsampling, nearest-point distances.

A copy of ``lsdm_tpu/fitting/native.py``: the repository's
``native/libfitting.so`` loaded by path, no JAX.  Replaces the reference's
open3d/sklearn calls (``fit_best_obj.py:129-199``, ``utils.py:354``).
Falls back to sklearn (DBSCAN) / numpy when the shared library is absent.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", "..", "native", "libfitting.so")
    )
    if not os.path.exists(path):
        makefile_dir = os.path.dirname(path)
        if os.path.exists(os.path.join(makefile_dir, "Makefile")):
            os.system(f"make -C {makefile_dir} libfitting.so >/dev/null 2>&1")
    if os.path.exists(path):
        lib = ctypes.CDLL(path)
        lib.dbscan.restype = ctypes.c_long
        lib.dbscan.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_float,
            ctypes.c_long, ctypes.POINTER(ctypes.c_int),
        ]
        lib.voxel_downsample.restype = ctypes.c_long
        lib.voxel_downsample.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_float,
            ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ]
        lib.nearest_sqdist.restype = None
        lib.nearest_sqdist.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_long,
            ctypes.POINTER(ctypes.c_float), ctypes.c_long,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ]
        _LIB = lib
    return _LIB


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def dbscan(points: np.ndarray, eps: float, min_pts: int) -> np.ndarray:
    """Cluster labels (n,): id >= 0 or -1 noise (open3d/sklearn contract)."""
    pts = np.ascontiguousarray(points, np.float32)
    lib = _lib()
    if lib is None:
        from sklearn.cluster import DBSCAN

        return DBSCAN(eps=eps, min_samples=min_pts).fit(pts).labels_
    labels = np.empty(len(pts), np.int32)
    lib.dbscan(_fptr(pts), len(pts), ctypes.c_float(eps), min_pts,
               labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return labels


def voxel_downsample(points: np.ndarray, voxel: float) -> np.ndarray:
    """Voxel-grid average downsample (open3d voxel_down_sample contract)."""
    pts = np.ascontiguousarray(points, np.float32)
    lib = _lib()
    if lib is None:
        keys = np.floor(pts / voxel).astype(np.int64)
        _, inv = np.unique(keys, axis=0, return_inverse=True)
        out = np.zeros((inv.max() + 1, 3), np.float64)
        counts = np.bincount(inv)
        for d in range(3):
            out[:, d] = np.bincount(inv, weights=pts[:, d]) / counts
        return out.astype(np.float32)
    out = np.empty((len(pts), 3), np.float32)
    m = lib.voxel_downsample(_fptr(pts), len(pts), ctypes.c_float(voxel),
                             _fptr(out), len(pts))
    return out[:m].copy()


def nearest_sqdist(query: np.ndarray, ref: np.ndarray, n_threads: int = 0) -> np.ndarray:
    """Squared distance from each query point to the nearest ref point."""
    q = np.ascontiguousarray(query, np.float32)
    r = np.ascontiguousarray(ref, np.float32)
    lib = _lib()
    if lib is None:
        d = ((q[:, None, :] - r[None, :, :]) ** 2).sum(-1)
        return d.min(1)
    out = np.empty(len(q), np.float32)
    lib.nearest_sqdist(_fptr(q), len(q), _fptr(r), len(r), _fptr(out), n_threads)
    return out

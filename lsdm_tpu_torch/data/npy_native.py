"""ctypes bridge to the native .npy reader (``native/npy_reader.cpp``).

A copy of ``lsdm_tpu/data/npy_native.py``: the repository's
``native/libnpy.so`` loaded by path, as ``fitting/native.py`` loads its
libraries, with the same fallback to ``np.load`` when the library is
absent (a host file reader, not a device path).  The JAX module's attempt
to build the library with ``make`` when it is missing is not ported: the
library is in the repository, and a reader should not run a build.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional

import numpy as np

LIB_PATH = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..",
                                        "native", "libnpy.so"))
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.path.exists(LIB_PATH):
        lib = ctypes.CDLL(LIB_PATH)
        lib.npy_read.restype = ctypes.c_long
        lib.npy_read.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.npy_read_batch.restype = ctypes.c_long
        lib.npy_read_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_long,
            ctypes.c_int,
        ]
        _LIB = lib
    return _LIB


def load(path: str) -> np.ndarray:
    """Load one .npy file as float32 (native when available)."""
    lib = _lib()
    if lib is None:
        return np.load(path).astype(np.float32)
    size = os.path.getsize(path)
    max_elems = max(size // 4 + 16, 64)
    out = np.empty(max_elems, np.float32)
    shape = (ctypes.c_long * 8)()
    ndim = ctypes.c_int(0)
    n = lib.npy_read(
        path.encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_elems,
        shape,
        ctypes.byref(ndim),
    )
    if n < 0:  # unsupported dtype/layout -> numpy fallback
        return np.load(path).astype(np.float32)
    return out[:n].reshape([shape[i] for i in range(ndim.value)]).copy()


def load_batch(paths: List[str], elems_per_item: int, n_threads: int = 0) -> np.ndarray:
    """Load many same-sized .npy files into one (n, elems_per_item) buffer."""
    lib = _lib()
    out = np.zeros((len(paths), elems_per_item), np.float32)
    if lib is None:
        for i, p in enumerate(paths):
            a = np.load(p).astype(np.float32).ravel()
            out[i, : a.size] = a
        return out
    arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    lib.npy_read_batch(
        arr,
        len(paths),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        elems_per_item,
        n_threads,
    )
    return out

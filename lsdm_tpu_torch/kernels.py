"""Build, load and launch-count the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` process per source, all started together, and
the objects are linked into ONE shared library with a plain C interface,
loaded with ``ctypes``.  The build happens at the first kernel launch,
never at import time, into ``build/lsdm_tpu_torch/`` beside the package
(listed in ``.gitignore``); the library name carries a hash of the sources,
the headers they share (``csrc/*.cuh``) and the flags, so an edited source
is rebuilt and an unchanged one is reused.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an
exception.  There is no fallback: a CUDA tensor either goes through its
kernel or the call raises.

``LAUNCHES`` counts kernel launches per kernel name.  A wrapper adds one
where it calls its C entry point and nowhere else, so a run can show that
its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "lsdm_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

# streaming multiprocessors of an H100 SXM, which the host plans
# (ops/ballquery.py, ops/rowmlp.py) size their grids to fill
SMS = 132

LAUNCHES = {"ball_query": 0, "three_nn": 0, "fps": 0, "denoise_chain": 0,
            "rank1_attn": 0, "sa_fused": 0, "fp_fused": 0,
            "rank1_attn_bwd": 0, "select_gather": 0, "chamfer_nn": 0,
            "denoise_step": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # (xyz, new_xyz, B, N, S, radius2, nsample, queries a warp, out, stream)
    "lsdm_ball_query": (_P, _P, _I, _I, _I, _F, _I, _I, _P, _P),
    # (xyz1, xyz2, B, N, S, k, dist, idx, stream)
    "lsdm_three_nn": (_P, _P, _I, _I, _I, _I, _P, _P, _P),
    # (xyz, start or null, B, N, npoint, warps, points a lane, out, stream)
    "lsdm_fps": (_P, _P, _I, _I, _I, _I, _I, _P, _P),
    # (x_init, noise, cond_pcd, e2, coef, weights[20], final, last_in,
    #  scratch, dims[11], clip, stream)
    "lsdm_denoise_chain": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P),
    # (e2, weights[20], scratch, dims[11], stream)
    "lsdm_denoise_chain_tables": (_P, _P, _P, _P, _P),
    # (x, noise, cond_pcd, e2, coefs, weights[20], out, scratch, dims[9],
    #  clip, stream)
    "lsdm_denoise_step": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P),
    # (q, k, v, B, L, S, H, out, denom or null, stream)
    "lsdm_rank1_attn": (_P, _P, _P, _I, _I, _I, _I, _P, _P, _P),
    # (xyz, new_xyz, z1, w1x, params[2(L-1)], widths[L], L, B, N, S,
    #  radius2, nsample, plan, out, stream)
    "lsdm_sa_fused": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P, _P,
                      _P),
    # (xyz1, xyz2, points1, points2, params[2L], widths[L], relu[L], L, B, N,
    #  S, D1, D2, plan, out, stream)
    "lsdm_fp_fused": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
                      _P, _P),
    # (q, k, v, out, g, denom, B, L, S, H, dq, dk, dv, scratch, stream)
    "lsdm_rank1_attn_bwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P,
                            _P, _P),
    # (S) -> key tiles of one (cloud, head)
    "lsdm_rank1_attn_bwd_tiles": (_I,),
    # (xyz, new_xyz, base, B, N, S, C, radius2, nsample, out, idx, stream)
    "lsdm_select_gather": (_P, _P, _P, _I, _I, _I, _I, _F, _I, _P, _P, _P),
    # (x, y, B, N, M, min, argmin, stream)
    "lsdm_chamfer_nn": (_P, _P, _I, _I, _I, _P, _P, _P),
}

_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    for cand in ((Path(CUDA_HOME) / "bin" / "nvcc") if CUDA_HOME else None,
                 shutil.which("nvcc")):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build() -> Path:
    """Compile ``csrc/*.cu`` into the build directory (if not yet built)
    and return the library's path."""
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):  # the sources and their headers
        h.update(f.name.encode())
        h.update(f.read_bytes())
    out = BUILD_DIR / f"liblsdm_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    work = BUILD_DIR / f"{out.stem}.{os.getpid()}.tmp"
    work.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # one nvcc per source, all at once: the build takes as long as the
    # slowest source, not the sum
    objects = [str(work / f"{src.stem}.o") for src in sources]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj]
            for src, obj in zip(sources, objects)]
    jobs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE, text=True))
            for cmd in cmds]
    link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(work / out.name), *objects]
    try:
        for cmd, proc in jobs:
            _finish(cmd, *proc.communicate(), proc.returncode)
        res = subprocess.run(link, capture_output=True, text=True)
        _finish(link, res.stdout, res.stderr, res.returncode)
        # atomic: a concurrent process never sees half a file
        os.replace(work / out.name, out)
    finally:
        for _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(work, ignore_errors=True)
    return out


def _finish(cmd, stdout: str, stderr: str, returncode: int) -> None:
    if returncode != 0:
        raise RuntimeError(f"nvcc failed with code {returncode}:\n"
                           f"{' '.join(cmd)}\n{stdout}\n{stderr}")
    if stderr.strip():
        print(stderr.strip())  # compiler warnings


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.lsdm_error_string.argtypes = (ctypes.c_int,)
        lib.lsdm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        msg = load().lsdm_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed: error {rc} ({msg})")


def stream(device: torch.device) -> int:
    """The current PyTorch CUDA stream of ``device``, as an address."""
    return torch.cuda.current_stream(device).cuda_stream


def require(name: str, t: torch.Tensor, dtype: torch.dtype,
            shape: Sequence[Optional[int]], device: torch.device) -> None:
    """Check what a kernel takes: CUDA device, dtype, shape (None = any
    size) and contiguity.  Raises ``ValueError`` otherwise."""
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the wrappers then run the
    plain version); False when all lie on CUDA devices.  Anything else
    raises: no kernel exists for it and no silent fallback is taken."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"kernel inputs must all be on the CPU or all on CUDA, "
                     f"got {sorted(kinds)}")

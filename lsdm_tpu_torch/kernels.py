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
its main path went through the kernels.  The step sampler's CUDA graph
(``ops/denoise.py:DenoiseStepGraph``) counts nothing while it is
captured, where no kernel runs; each replay adds the K9 calls the
captured graph holds, read from its kernel nodes, to ``GRAPH_LAUNCHES``.
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
# (ops/ballquery.py, ops/chamfer.py, ops/rowmlp.py) size their grids to fill
SMS = 132
# dynamic shared memory a block may take on Hopper (by opting in past 48 KB),
# which bounds the clouds the selection kernels stage
SMEM_MAX = 232_448

LAUNCHES = {"ball_query": 0, "three_nn": 0, "fps": 0, "denoise_chain": 0,
            "rank1_attn": 0, "sa_fused": 0, "fp_fused": 0,
            "rank1_attn_bwd": 0, "select_gather": 0, "chamfer_nn": 0,
            "denoise_step": 0,
            # the bf16 modes of K4-K10, counted apart
            "rank1_attn_bf16": 0, "rank1_attn_bwd_bf16": 0,
            "select_gather_bf16": 0, "sa_fused_bf16": 0, "fp_fused_bf16": 0,
            "denoise_chain_bf16": 0, "denoise_step_bf16": 0}
GRAPH_LAUNCHES = dict.fromkeys(LAUNCHES, 0)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # (xyz, new_xyz, B, N, S, radius2, nsample, queries a warp, out, stream)
    "lsdm_ball_query": (_P, _P, _I, _I, _I, _F, _I, _I, _P, _P),
    # (xyz1, xyz2, B, N, S, k, lanes a target, dist, idx, stream)
    "lsdm_three_nn": (_P, _P, _I, _I, _I, _I, _I, _P, _P, _P),
    # (xyz, start or null, B, N, npoint, warps, points a lane, out, stream)
    "lsdm_fps": (_P, _P, _I, _I, _I, _I, _I, _P, _P),
    # (x_init, noise, cond_pcd, e2, coef, weights[20], final, last_in,
    #  scratch, dims[11], clip, stream); the _bf16 entry is the same call
    #  of the bf16 mode (weights rounded to bf16 by the caller, then the
    #  ten bf16 operand copies of both passes: weights[30]) with pass 2's
    #  plan (warps a tile, tiles a block) before clip
    "lsdm_denoise_chain": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P),
    "lsdm_denoise_chain_bf16": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                _I, _P),
    # (first, last float32 bit pattern, mismatches (a zeroed uint64 on the
    #  device), stream): where pass 2's branch-free reciprocal and 1.0f / y
    #  differ
    "lsdm_denoise_recip_check": (_I, _I, _P, _P),
    # (e2, weights[20] (bf16: [30]), scratch, dims[11], stream)
    "lsdm_denoise_chain_tables": (_P, _P, _P, _P, _P),
    "lsdm_denoise_chain_tables_bf16": (_P, _P, _P, _P, _P),
    # K9's two launches: (e2, weights[20], scratch, dims[9], stream)
    "lsdm_denoise_step_u2": (_P, _P, _P, _P, _P),
    # (x, noise, cond_pcd, coefs, weights[20], w_up4^T, out, scratch,
    #  dims[9], cluster, clip, stream)
    "lsdm_denoise_step_tiles": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P),
    # (dims[9], cluster) -> clusters of K9's tile kernel the device runs at
    #  once
    "lsdm_denoise_step_max_clusters": (_P, _I),
    # K9 bf16's two launches: (e2, operands[13], scratch, dims[9], stream)
    # and (x, noise, cond_pcd, coefs, operands[13], out, scratch, dims[9],
    # m16 tiles a block, clip, stream)
    "lsdm_denoise_step_bf16_u2": (_P, _P, _P, _P, _P),
    "lsdm_denoise_step_bf16_tiles": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P),
    # (m16 tiles a block) -> blocks of K9 bf16's tile kernel the device
    #  runs at once
    "lsdm_denoise_step_bf16_max_blocks": (_I,),
    # (cudaGraph_t, counts[3]): kernel nodes, K9's u2 and tile nodes
    "lsdm_graph_kernel_nodes": (_P, _P),
    # (q, k, v, B, L, S, H, out, denom or null, stream); the _bf16 entry
    # takes bf16 q, k, v
    "lsdm_rank1_attn": (_P, _P, _P, _I, _I, _I, _I, _P, _P, _P),
    "lsdm_rank1_attn_bf16": (_P, _P, _P, _I, _I, _I, _I, _P, _P, _P),
    # (xyz, new_xyz, z1, w1x, params[2(L-1)], widths[L], L, B, N, S,
    #  radius2, nsample, plan, out, stream); the _bf16 entry
    #  (csrc/sa_fused_bf16.cu) takes a bf16 z1, the weights as bf16 rows
    #  (ops/rowmlp.py:Bf16Operands) and its own plan (plan_sa_bf16), and
    #  writes a bf16 out
    "lsdm_sa_fused": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P, _P,
                      _P),
    "lsdm_sa_fused_bf16": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P,
                           _P, _P),
    # (xyz1, xyz2, points1, points2, params[2L], widths[L], relu[L], L, B, N,
    #  S, D1, D2, plan, out, stream); the _bf16 entry
    #  (csrc/fp_fused_bf16.cu) takes bf16 points1, points2, the weights as
    #  bf16 rows and its own plan (plan_fp_bf16), and writes a bf16 out
    "lsdm_fp_fused": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
                      _P, _P),
    "lsdm_fp_fused_bf16": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _P, _P, _P),
    # (q, k, v, out, g, denom, B, L, S, H, dq, dk, dv, scratch, stream);
    # the _bf16 entry (csrc/rank1_attn_bwd_bf16.cu) takes bf16 q, k, v and
    # writes bf16 dq, dk, dv
    "lsdm_rank1_attn_bwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P,
                            _P, _P),
    "lsdm_rank1_attn_bwd_bf16": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P,
                                 _P, _P, _P),
    # (S) -> key tiles of one (cloud, head)
    "lsdm_rank1_attn_bwd_tiles": (_I,),
    # (xyz, new_xyz, base, B, N, S, C, radius2, nsample, centers a warp,
    #  out, idx, stream); the _bf16 entry (csrc/sg_fused_bf16.cu) takes a
    #  bf16 base, the warps a slab after the centers a warp
    #  (ops/sg_fused.py:select_gather_bf16_plan), and writes a bf16 out
    "lsdm_select_gather": (_P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P, _P, _P),
    "lsdm_select_gather_bf16": (_P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _P,
                                _P, _P),
    # (x, y, B, N, M, lanes a point, points a lane, min, argmin, stream)
    "lsdm_chamfer_nn": (_P, _P, _I, _I, _I, _I, _I, _P, _P, _P),
}

_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        GRAPH_LAUNCHES[name] = 0


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


def bf16_mode(compute_dtype: Optional[torch.dtype]) -> bool:
    """Whether a kernel that takes a compute dtype (K6-K9, as the JAX
    kernels' ``compute_dtype``) runs its bf16 mode: True for
    ``torch.bfloat16``, False for float32 (None or ``torch.float32``)."""
    if compute_dtype is None or compute_dtype == torch.float32:
        return False
    if compute_dtype == torch.bfloat16:
        return True
    raise ValueError(f"compute dtype {compute_dtype}: the kernels take float32 "
                     "or bfloat16")


def bf16_exact(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (to nearest even, as torch and XLA round) and
    widened to float32: an operand of a bf16 product, whose products are
    then exact in float32."""
    return t.to(torch.bfloat16).float()


def mode_matmul(a: torch.Tensor, b: torch.Tensor, bf16: bool) -> torch.Tensor:
    """``a @ b``; in the bf16 mode on operands rounded to bf16, summed in
    float32: the Pallas kernels' product at ``preferred_element_type``
    float32, as the plain versions compute it."""
    if not bf16:
        return a @ b
    return bf16_exact(a) @ bf16_exact(b)


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

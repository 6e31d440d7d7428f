"""The denoise chain (K6) and the denoise step (K9): CUDA kernels and plain
versions.

Replaces ``lsdm_tpu/ops/denoise_pallas.py:fused_denoise_chain``: the ENTIRE
T-step DDPM/DDIM sampling loop in one call, with the same inputs and
outputs.  Per step t (reference graph ``model/sdm.py:141-142,164-167,
204-212``):

  upsampling MLP on the step's (timestep, text) row e2_t (gelu x3)
  -> combine_extraction (gelu)                                [t only]
  x_t + cond_pcd -> input_process (sigmoid x4) -> output_process (gelu x2)
  -> x0 (optionally clipped to [-1, 1])                       [x_t too]
  x_{t-1} = c1 * x0 + c2 * x_t + c3 * noise_t

One coefficient table serves DDPM and DDIM (``models/sampling.py``).  The
CUDA version (``csrc/denoise_chain.cu``) splits the step at the bracket:
the t-only embedding (and its half of the first combination_extraction
layer) does not depend on the sample, so a first pass
(``csrc/denoise_tables.cu``) builds it for a chunk of steps at once as
pipelined batched FP32 GEMMs over the whole card, and a second
pass carries pairs of tiles of point rows through the chunk's steps on
clusters of two blocks, which hold the tail's weights in their shared
memory between them (half the layers each) for the whole chunk.
GELU is the exact erf form (the Pallas kernel approximates erf only
because Mosaic has no erf).  :func:`denoise_chain_tables` runs the first
pass alone, so a check can see its numerics, which the chain's output
all but hides.

K9 replaces ``lsdm_tpu/ops/denoise_pallas.py:fused_denoise_step``: ONE step
of that body per call, for the step-by-step sampler
(``sample_sdm(fused_step="step")``), which calls it T times from a host
loop.  Its CUDA version (``csrc/denoise_step.cu``) is two launches on the
stream: the scene's u2 table, then one block per tile of point rows that
carries its rows from u4 to the update.  The two plain versions share the
step body, :func:`denoise_step_plain`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from lsdm_tpu_torch import kernels

# Scratch of the kernel's first pass, in float32 elements (512 MiB): it
# holds the per-step tables of one chunk of steps.
CHAIN_SCRATCH_FLOATS = 1 << 27


class DenoiseStepParams(NamedTuple):
    """Weights of the per-step tail in the layout of the JAX
    ``DenoiseStepParams``: ``*_t`` members are ``weight.T`` (in, out),
    biases are (out, 1) columns for the upsampling layers and (1, out)
    rows elsewhere."""

    w_up0: torch.Tensor   # (128, 1)   upsampling_layer.0 weight (out, in=1)
    b_up0: torch.Tensor   # (128, 1)
    w_up2: torch.Tensor   # (512, 128)
    b_up2: torch.Tensor   # (512, 1)
    w_up4: torch.Tensor   # (N, 512)
    b_up4: torch.Tensor   # (N, 1)
    wc_t: torch.Tensor    # (2D, D)    combine_extraction.0
    bc: torch.Tensor      # (1, D)
    wp0_t: torch.Tensor   # (3, D/2)   input_process.pose_embedding.0
    bp0: torch.Tensor     # (1, D/2)
    wp2_t: torch.Tensor   # (D/2, D)
    bp2: torch.Tensor     # (1, D)
    wx0_t: torch.Tensor   # (2D, 1.5D) input_process.combination_extraction.0
    bx0: torch.Tensor     # (1, 1.5D)
    wx2_t: torch.Tensor   # (1.5D, D)
    bx2: torch.Tensor     # (1, D)
    wo0_t: torch.Tensor   # (D, D/2)   output_process.pose_final.0
    bo0: torch.Tensor     # (1, D/2)
    wo2_t: torch.Tensor   # (D/2, 3)
    bo2: torch.Tensor     # (1, 3)


def extract_step_params(model) -> DenoiseStepParams:
    """The per-step tail weights of a port ``SceneDiffusionModel``,
    detached, contiguous, in the kernel's layout."""
    up = model.upsampling_layer
    comb = model.combine_extraction[0]
    pose = model.input_process.pose_embedding
    cext = model.input_process.combination_extraction
    out = model.output_process.pose_final

    def t(lin):
        return lin.weight.detach().t().contiguous()

    def col(lin):
        return lin.bias.detach()[:, None].contiguous()

    def row(lin):
        return lin.bias.detach()[None, :].contiguous()

    return DenoiseStepParams(
        w_up0=up[0].weight.detach().contiguous(), b_up0=col(up[0]),
        w_up2=up[2].weight.detach().contiguous(), b_up2=col(up[2]),
        w_up4=up[4].weight.detach().contiguous(), b_up4=col(up[4]),
        wc_t=t(comb), bc=row(comb),
        wp0_t=t(pose[0]), bp0=row(pose[0]),
        wp2_t=t(pose[2]), bp2=row(pose[2]),
        wx0_t=t(cext[0]), bx0=row(cext[0]),
        wx2_t=t(cext[2]), bx2=row(cext[2]),
        wo0_t=t(out[0]), bo0=row(out[0]),
        wo2_t=t(out[2]), bo2=row(out[2]),
    )


def _emb_plain(e2: torch.Tensor, p: DenoiseStepParams) -> torch.Tensor:
    """The t-only embedding (..., N, D) of step rows e2 (..., 2D): the
    upsampling MLP, then combine_extraction."""
    e2 = e2[..., None, :]                                    # (..., 1, 2D)
    u0 = F.gelu(p.w_up0 * e2 + p.b_up0)                      # (..., 128, 2D)
    u2 = F.gelu(p.w_up2 @ u0 + p.b_up2)                      # (..., 512, 2D)
    u4 = F.gelu(p.w_up4 @ u2 + p.b_up4)                      # (..., N, 2D)
    return F.gelu(u4 @ p.wc_t + p.bc)                        # (..., N, D)


def denoise_step_plain(
    x: torch.Tensor,         # (B, N, 3) current sample
    noise: torch.Tensor,     # (B, N, 3) this step's gaussian draw
    cond_pcd: torch.Tensor,  # (B, N, 3)
    e2: torch.Tensor,        # (B, 2D) this step's (timestep, text) embedding
    coefs: torch.Tensor,     # (3,) [c1, c2, c3]
    p: DenoiseStepParams,
    clip_denoised: bool = False,
) -> torch.Tensor:
    """Plain version of K9: one step of the Pallas kernels' body as torch
    ops.  Returns the next sample (B, N, 3)."""
    emb = _emb_plain(e2, p)                                  # (B, N, D)
    h = torch.sigmoid((x + cond_pcd) @ p.wp0_t + p.bp0)
    h = torch.sigmoid(h @ p.wp2_t + p.bp2)
    h = torch.sigmoid(torch.cat([h, emb], dim=-1) @ p.wx0_t + p.bx0)
    h = torch.sigmoid(h @ p.wx2_t + p.bx2)
    h = F.gelu(h @ p.wo0_t + p.bo0)
    x0 = F.gelu(h @ p.wo2_t + p.bo2)
    if clip_denoised:
        x0 = x0.clamp(-1.0, 1.0)
    return coefs[0] * x0 + coefs[1] * x + coefs[2] * noise


def fused_denoise_step(
    x: torch.Tensor,         # (B, N, 3) current sample
    noise: torch.Tensor,     # (B, N, 3) this step's gaussian draw
    cond_pcd: torch.Tensor,  # (B, N, 3)
    e2: torch.Tensor,        # (B, 2D) this step's (timestep, text) embedding
    coefs: torch.Tensor,     # (3,) [c1, c2, c3], read on the device
    p: DenoiseStepParams,
    clip_denoised: bool = False,
) -> torch.Tensor:
    """K9: one DDPM/DDIM step of every scene, c1 * x0 + c2 * x + c3 * noise.
    Returns the next sample (B, N, 3) float32.  CUDA kernels for CUDA
    tensors (two launches, one call: one count in ``LAUNCHES``), plain
    version for CPU tensors.  A sampler that steps T times binds the
    weights once with :func:`make_denoise_step` instead."""
    step = make_denoise_step(p, x.shape[1], x.device, clip_denoised)
    return step(x, noise, cond_pcd, e2, coefs)


def make_denoise_step(p: DenoiseStepParams, N: int, device: torch.device,
                      clip_denoised: bool = False):
    """K9 with ``p`` and ``clip_denoised`` bound, for a loop over the
    steps: returns ``step(x, noise, cond_pcd, e2, coefs)``, which computes
    :func:`fused_denoise_step` of those arguments.  On a CUDA ``device``
    the weights (for N points) are checked and their addresses taken here,
    once, and the launches go to the stream that is current on ``device``
    now; each call checks its five data tensors only.  The returned step
    runs the plain version for CPU tensors."""
    plain = make_denoise_step_plain(p, N, device, clip_denoised)
    if device.type != "cuda":
        def step(x, noise, cond_pcd, e2, coefs):
            if not kernels.on_cpu(x, noise, cond_pcd, e2, coefs):
                raise ValueError(f"a denoise step bound on {device} was given "
                                 "CUDA tensors")
            return plain(x, noise, cond_pcd, e2, coefs)
        return step

    dims = _check(p, N, {}, device)
    _, D2, _, U2 = dims[:4]
    ptrs = _pointers(p)
    stream = kernels.stream(device)
    lib = kernels.load()

    def step(x, noise, cond_pcd, e2, coefs):
        if kernels.on_cpu(x, noise, cond_pcd, e2, coefs):
            return plain(x, noise, cond_pcd, e2, coefs)
        B = x.shape[0]
        for name, t, shape in (("x", x, (B, N, 3)), ("noise", noise, (B, N, 3)),
                               ("cond_pcd", cond_pcd, (B, N, 3)),
                               ("e2", e2, (B, D2)), ("coefs", coefs, (3,))):
            kernels.require(name, t, torch.float32, shape, device)
        if B > 65535:
            raise ValueError(f"the step kernels grid at most 65535 scenes, got {B}")
        scratch = torch.empty(B * U2 * D2, dtype=torch.float32, device=device)
        out = torch.empty_like(x)
        with torch.cuda.device(device):
            rc = lib.lsdm_denoise_step(
                x.data_ptr(), noise.data_ptr(), cond_pcd.data_ptr(),
                e2.data_ptr(), coefs.data_ptr(), ptrs, out.data_ptr(),
                scratch.data_ptr(), (ctypes.c_int * 9)(B, *dims),
                int(bool(clip_denoised)), stream)
        kernels.check(rc, "denoise_step")
        kernels.LAUNCHES["denoise_step"] += 1
        return out
    return step


def make_denoise_step_plain(p: DenoiseStepParams, N: int, device: torch.device,
                            clip_denoised: bool = False):
    """Plain version of :func:`make_denoise_step`, on any device."""
    return functools.partial(denoise_step_plain, p=p, clip_denoised=clip_denoised)


def denoise_chain_plain(
    x_init: torch.Tensor,     # (B, N, 3)
    noise_tab: torch.Tensor,  # (B, T, N, 3)
    cond_pcd: torch.Tensor,   # (B, N, 3)
    e2_tab: torch.Tensor,     # (B, T, 2D)
    coef_tab: torch.Tensor,   # (T, 3)
    p: DenoiseStepParams,
    clip_denoised: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K6: the Pallas kernel body as a loop of torch ops.
    Returns (final sample, input of the last step), both (B, N, 3)."""
    T = noise_tab.shape[1]
    x = x_init
    last_in = x_init
    for t in range(T):
        last_in = x
        x = denoise_step_plain(x, noise_tab[:, t], cond_pcd, e2_tab[:, t],
                               coef_tab[t], p, clip_denoised)
    return x, last_in


def fused_denoise_chain(
    x_init: torch.Tensor,     # (B, N, 3) initial noise image
    noise_tab: torch.Tensor,  # (B, T, N, 3) per-step gaussian draws
    cond_pcd: torch.Tensor,   # (B, N, 3)
    e2_tab: torch.Tensor,     # (B, T, 2D) per-step (timestep, text) embedding
    coef_tab: torch.Tensor,   # (T, 3) per-step [c1, c2, c3]
    p: DenoiseStepParams,
    clip_denoised: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6: the whole sampling loop.  Returns (final sample, input of the
    last step), both (B, N, 3) float32.  CUDA kernel for CUDA tensors,
    plain version for CPU tensors."""
    if kernels.on_cpu(x_init, noise_tab, cond_pcd, e2_tab, coef_tab, *p):
        return denoise_chain_plain(x_init, noise_tab, cond_pcd, e2_tab,
                                   coef_tab, p, clip_denoised)
    B, T, N, _ = noise_tab.shape
    dims = (B, T) + _check(p, N, {
        "x_init": (x_init, (B, N, 3)), "noise_tab": (noise_tab, (B, T, N, 3)),
        "cond_pcd": (cond_pcd, (B, N, 3)), "coef_tab": (coef_tab, (T, 3)),
        "e2_tab": (e2_tab, (B, T, p.wc_t.shape[0]))})
    tc = chain_chunk_steps(B, T, p)
    dev = x_init.device
    scratch = torch.empty(_weights_floats(dims) + B * tc * _per_step(dims),
                          dtype=torch.float32, device=dev)
    final = torch.empty_like(x_init)
    last_in = torch.empty_like(x_init)
    lib = kernels.load()
    with torch.cuda.device(dev):
        rc = lib.lsdm_denoise_chain(
            x_init.data_ptr(), noise_tab.data_ptr(), cond_pcd.data_ptr(),
            e2_tab.data_ptr(), coef_tab.data_ptr(), _pointers(p),
            final.data_ptr(), last_in.data_ptr(), scratch.data_ptr(),
            (ctypes.c_int * 11)(*dims[:10], tc),
            int(bool(clip_denoised)), kernels.stream(dev))
    kernels.check(rc, "denoise_chain")
    kernels.LAUNCHES["denoise_chain"] += 1
    return final, last_in


def chain_chunk_steps(B: int, T: int, p: DenoiseStepParams) -> int:
    """Steps per chunk of K6 for B scenes and T steps: as many as the first
    pass's tables fit in ``CHAIN_SCRATCH_FLOATS``, and no more than let the
    first pass grid its batch of B * tc GEMMs on gridDim.z <= 65535."""
    dims = (B, T, p.w_up4.shape[0], p.wc_t.shape[0], p.w_up0.shape[0],
            p.w_up2.shape[0], p.wc_t.shape[1], p.wp0_t.shape[1],
            p.wx0_t.shape[1], p.wo0_t.shape[1])
    return max(1, min(T, CHAIN_SCRATCH_FLOATS // (B * _per_step(dims)),
                      65535 // B))


def denoise_chain_tables_plain(e2_tab: torch.Tensor, p: DenoiseStepParams
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`denoise_chain_tables`."""
    emb = _emb_plain(e2_tab, p)
    D = p.wc_t.shape[1]
    return emb, emb @ p.wx0_t[D:] + p.bx0


def denoise_chain_tables(e2_tab: torch.Tensor, p: DenoiseStepParams
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6's first pass alone, for every step row of e2_tab (B, T, 2D):
    the embedding emb (B, T, N, D) and its half of the first
    combination_extraction layer, g = emb @ wx0_t[D:] + bx0
    (B, T, N, 1.5D).  CUDA kernels for CUDA tensors, plain version for
    CPU tensors."""
    if kernels.on_cpu(e2_tab, *p):
        return denoise_chain_tables_plain(e2_tab, p)
    B, T, _ = e2_tab.shape
    N = p.w_up4.shape[0]
    if B * T > 65535:
        raise ValueError(f"B * T = {B * T} tables exceed one grid (65535)")
    dims = (B, T) + _check(p, N, {"e2_tab": (e2_tab, (B, T, p.wc_t.shape[0]))})
    dev = e2_tab.device
    scratch = torch.empty(_weights_floats(dims) + B * T * _per_step(dims),
                          dtype=torch.float32, device=dev)
    lib = kernels.load()
    with torch.cuda.device(dev):
        rc = lib.lsdm_denoise_chain_tables(
            e2_tab.data_ptr(), _pointers(p), scratch.data_ptr(),
            (ctypes.c_int * 11)(*dims[:10], T), kernels.stream(dev))
    kernels.check(rc, "denoise_chain")
    kernels.LAUNCHES["denoise_chain"] += 1
    return _table_views(scratch, dims)


def _table_views(scratch: torch.Tensor, dims) -> Tuple[torch.Tensor, torch.Tensor]:
    """emb (B, T, N, D) and g (B, T, N, D15) in the scratch of
    ``lsdm_denoise_chain_tables`` (``csrc/denoise_tables.cuh``): the
    transposed weights, then u2, u4^T, emb^T and g of every (scene, step).
    emb is a transposed view of emb^T, whose rows are ``_ldn(N)`` long."""
    B, T, N, D2, _, U2, D, _, D15, _ = dims[:10]
    ldn, z = _ldn(N), B * T
    o_emb = _weights_floats(dims) + z * (U2 * D2 + D2 * ldn)
    o_g = o_emb + z * D * ldn
    emb = scratch[o_emb:o_g].view(B, T, D, ldn)[..., :N].transpose(-1, -2)
    return emb, scratch[o_g:o_g + z * N * D15].view(B, T, N, D15)


def _ldn(N: int) -> int:
    """Row length of pass 1's tables with a point column: N rounded up to
    4, so that every row starts on 16 bytes."""
    return (N + 3) // 4 * 4


def _per_step(dims) -> int:
    """Floats of the first pass's tables per (scene, step): u2, u4^T,
    emb^T, g (csrc/denoise_tables.cuh)."""
    _, _, N, D2, _, U2, D, _, D15, _ = dims[:10]
    return U2 * D2 + D2 * _ldn(N) + D * _ldn(N) + N * D15


def _weights_floats(dims) -> int:
    """Floats of the weights the first pass transposes once a call:
    w_up2^T (U0, U2) and w_up4^T (U2, ldn), ahead of the tables."""
    _, _, N, _, U0, U2 = dims[:6]
    return U0 * U2 + U2 * _ldn(N)


def _pointers(p: DenoiseStepParams):
    return (ctypes.c_void_p * len(p))(*[w.data_ptr() for w in p])


def _check(p: DenoiseStepParams, N: int, data: dict,
           device: Optional[torch.device] = None) -> Tuple[int, ...]:
    """Check the kernel's inputs (``data``: name -> (tensor, shape) of the
    step tensors, all on ``device``, by default that of the first) and
    return the dims {N, 2D, U0, U2, D, DH, D15, DH2} of
    ``csrc/denoise_chain.cu`` and ``csrc/denoise_step.cu``."""
    D2 = p.wc_t.shape[0]
    U0, U2 = p.w_up0.shape[0], p.w_up2.shape[0]
    D, DH, D15, DH2 = (p.wc_t.shape[1], p.wp0_t.shape[1], p.wx0_t.shape[1],
                       p.wo0_t.shape[1])
    shapes = {
        **data,
        "w_up0": (p.w_up0, (U0, 1)), "b_up0": (p.b_up0, (U0, 1)),
        "w_up2": (p.w_up2, (U2, U0)), "b_up2": (p.b_up2, (U2, 1)),
        "w_up4": (p.w_up4, (N, U2)), "b_up4": (p.b_up4, (N, 1)),
        "wc_t": (p.wc_t, (D2, D)), "bc": (p.bc, (1, D)),
        "wp0_t": (p.wp0_t, (3, DH)), "bp0": (p.bp0, (1, DH)),
        "wp2_t": (p.wp2_t, (DH, D)), "bp2": (p.bp2, (1, D)),
        "wx0_t": (p.wx0_t, (2 * D, D15)), "bx0": (p.bx0, (1, D15)),
        "wx2_t": (p.wx2_t, (D15, D)), "bx2": (p.bx2, (1, D)),
        "wo0_t": (p.wo0_t, (D, DH2)), "bo0": (p.bo0, (1, DH2)),
        "wo2_t": (p.wo2_t, (DH2, 3)), "bo2": (p.bo2, (1, 3)),
    }
    if device is None:
        device = next(iter(data.values()))[0].device
    for name, (t, shape) in shapes.items():
        kernels.require(name, t, torch.float32, shape, device)
    if "e2_tab" in data and data["e2_tab"][0].shape[1] < 1:
        raise ValueError("the chain needs at least one step")
    return N, D2, U0, U2, D, DH, D15, DH2

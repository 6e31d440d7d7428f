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
memory between them (half the layers each) for the whole chunk.  The bf16
mode's second pass is its own design (``csrc/denoise_chain_bf16.cu``):
one block holds the tail's bf16 weights, and warps carry tiles of 16
point rows through the six layers on ``mma.sync``, 4 or 8 warps a tile
as :func:`chain_bf16_plan` chooses.
GELU is the exact erf form (the Pallas kernel approximates erf only
because Mosaic has no erf).  :func:`denoise_chain_tables` runs the first
pass alone, so a check can see its numerics, which the chain's output
all but hides.

K9 replaces ``lsdm_tpu/ops/denoise_pallas.py:fused_denoise_step``: ONE step
of that body per call, for the step-by-step sampler
(``sample_sdm(fused_step="step")``).  Its CUDA version
(``csrc/denoise_step.cu``) is two launches on the stream: the scene's u2
table, then a cluster of blocks per tile of 32 point rows that carries its
rows from u4 to the update, each block a slice of every layer's columns
(:func:`step_plan` picks the cluster size).  Its bf16 mode is its own
design (``csrc/denoise_step_bf16.cu``), the same two launches on the bf16
tensor cores: u2^T as bf16 on ``mma.sync``, then one block per tile of 16,
32 or 64 point rows (:func:`step_bf16_plan`) that carries them through the
eight products on ``mma.sync``, every layer's weights streamed through one
ring from the bf16 copies of :class:`Bf16StepOperands`.  On CUDA the sampler captures
its T calls into one CUDA graph (:class:`DenoiseStepGraph`) and replays
it; on the CPU it loops on the host.  The two plain versions share the
step body, :func:`denoise_step_plain`.

``compute_dtype=torch.bfloat16`` is the Pallas kernels' bf16 mode (a bf16
``SDMConfig.dtype``): each product ``dot(a, b)`` takes both operands
rounded to bf16 and sums in float32 (``denoise_pallas.py:136-141``,
``:237-239``); u0, the biases, the activations (GELU, sigmoid, clip) and
the posterior update stay float32, and the first combination_extraction
layer rounds ``concat(p, emb)`` as a whole, so the CUDA version's split of
that layer takes bf16(emb).  Every input is float32, as the Pallas
wrappers cast them, so the mode is an argument and not the inputs' dtype.
The CUDA kernels' bf16 modes take the product weights rounded once
(:func:`bf16_step_params`; :func:`step_params` keeps them per model) and
round each activation where it becomes a product's operand; both run on
the bf16 tensor cores from bf16 copies of the weights made once per kept
weights: K6 (:class:`Bf16Operands`) its first pass on wgmma, keeping its
tables u0, u2 and u4^T as bf16 and handing emb^T to g's product in shared
memory, its second on mma.sync; K9 (:class:`Bf16StepOperands`) both
launches on mma.sync.  Their launches count as ``denoise_chain_bf16`` and
``denoise_step_bf16``.
"""

from __future__ import annotations

import ctypes
import functools
import time
import weakref
from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from lsdm_tpu_torch import kernels
from lsdm_tpu_torch.kernels import mode_matmul

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


def _tail_modules(model):
    return (model.upsampling_layer, model.combine_extraction[0],
            model.input_process.pose_embedding,
            model.input_process.combination_extraction,
            model.output_process.pose_final)


def step_params_key(model) -> Tuple:
    """What identifies the weights :func:`extract_step_params` takes from
    ``model`` as they stand: each parameter's storage and its version,
    which an in-place update (an optimizer step, ``load_state_dict``)
    advances.  A sampler keys what it builds from those weights by it."""
    return tuple((t.data_ptr(), t._version)
                 for m in _tail_modules(model) for t in m.parameters())


def extract_step_params(model) -> DenoiseStepParams:
    """The per-step tail weights of a port ``SceneDiffusionModel``,
    detached, contiguous, in the kernel's layout."""
    up, comb, pose, cext, out = _tail_modules(model)

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


# the weights that enter products, which the bf16 mode rounds to bf16
# (w_up0 scales e2 elementwise and stays float32, as do the biases)
PRODUCT_WEIGHTS = ("w_up2", "w_up4", "wc_t", "wp0_t", "wp2_t", "wx0_t",
                   "wx2_t", "wo0_t", "wo2_t")


class Bf16Operands(NamedTuple):
    """K6's weights in the bf16 mode: bf16 copies of the rounded product
    weights, in the layouts its kernels read.  Pass 1's four as A^T (K, M)
    or B (K, N) (``csrc/denoise_tables.cu``), each row padded with zeros to
    a multiple of 8 elements (16 bytes).  Pass 2's six, the tail's layers,
    as (out, k) rows, the B operand of ``mma.sync.m16n8k16.row.col``
    (``csrc/denoise_chain_bf16.cu``), padded with zeros to the widths the
    kernel is compiled for (``_TAIL_LAYERS``; k to 16 for wp0, out to 8 for
    wo2), each row an odd number of 16-byte chunks (:func:`_odd_row`)."""

    w2t: torch.Tensor  # (U0, U2 up to 8)  w_up2^T
    w4t: torch.Tensor  # (U2, N up to 8)   w_up4^T
    wc: torch.Tensor   # (2D, D up to 8)   wc_t
    wx: torch.Tensor   # (D, D15 up to 8)  wx0_t[D:], g's half of the layer
    wp0: torch.Tensor  # (64, 24)    wp0_t^T
    wp2: torch.Tensor  # (128, 72)   wp2_t^T
    wx0: torch.Tensor  # (192, 136)  wx0_t[:D]^T, the pose features' half
    wx2: torch.Tensor  # (128, 200)  wx2_t^T
    wo0: torch.Tensor  # (64, 136)   wo0_t^T
    wo2: torch.Tensor  # (8, 72)     wo2_t^T


_CAPS_TEXT = ("its pass 2 takes tails of DH <= 64, D <= 128, D15 <= 192, DH2 <= 64: "
              "the model's widths up to its pass 1's cap of D = 128; the float32 "
              "mode takes the model's D up to 136")
# each tail layer's weight (in (in, out) layout) and the k and out it is
# padded to: the widths K6's bf16 pass 2 is compiled for
# (csrc/denoise_chain_bf16.cu), the model's DH = D / 2, D15 = 1.5 D, DH2 =
# D / 2 at pass 1's cap of D = 128 (k of 3 to 16, out of 3 to 8)
_TAIL_LAYERS = (("wp0_t", 16, 64), ("wp2_t", 64, 128), ("wx0_t", 128, 192),
                ("wx2_t", 192, 128), ("wo0_t", 128, 64), ("wo2_t", 64, 8))


def _bf16_rows(w: torch.Tensor) -> torch.Tensor:
    """``w`` (rows, cols), bf16-exact, as bf16 with rows of ``cols``
    rounded up to 8 elements, zero-padded."""
    out = torch.zeros(w.shape[0], -(-w.shape[1] // 8) * 8, dtype=torch.bfloat16,
                      device=w.device)
    out[:, :w.shape[1]] = w
    return out


def _odd_row(k: int) -> int:
    """Row length (bf16 elements) of k, a multiple of 8, padded to an odd
    number of 16-byte chunks, so the eight rows of an ``ldmatrix`` read lie
    in eight different bank groups."""
    return k if (k // 8) % 2 else k + 8


def _bf16_tail(w_t: torch.Tensor, k_cap: int, n_cap: int) -> torch.Tensor:
    """A tail layer's weight ``w_t`` (k, out), bf16-exact, as bf16 (out, k)
    rows in pass 2's layout: (n_cap, _odd_row(k_cap)), zeros past (out,
    k)."""
    k, n = w_t.shape
    if k > k_cap or n > n_cap:
        raise ValueError(f"a tail layer of {k} -> {n} exceeds K6 bf16's "
                         f"{k_cap} -> {n_cap} ({_CAPS_TEXT})")
    out = torch.zeros(n_cap, _odd_row(k_cap), dtype=torch.bfloat16, device=w_t.device)
    out[:n, :k] = w_t.t()
    return out


class Bf16StepParams(DenoiseStepParams):
    """:class:`DenoiseStepParams` whose :data:`PRODUCT_WEIGHTS` are rounded
    to bf16 (float32 tensors): the operands of the kernels' bf16 mode, made
    by :func:`bf16_step_params`.  ``operands`` holds K6's bf16 copies of
    them (:class:`Bf16Operands`), ``step_operands`` K9's
    (:class:`Bf16StepOperands`), each made at its first use and kept with
    these weights."""

    @functools.cached_property
    def step_operands(self) -> "Bf16StepOperands":
        return _step_bf16_operands(self)

    @functools.cached_property
    def operands(self) -> Bf16Operands:
        D = self.wc_t.shape[1]
        tail = dict(zip(self._fields, self))
        tail["wx0_t"] = self.wx0_t[:D]
        return Bf16Operands(*map(_bf16_rows, (
            self.w_up2.t(), self.w_up4.t(), self.wc_t, self.wx0_t[D:])),
            *(_bf16_tail(tail[f], k, n) for f, k, n in _TAIL_LAYERS))


def bf16_step_params(p: DenoiseStepParams) -> Bf16StepParams:
    """``p`` with its product weights rounded to bf16 (to nearest even), as
    float32 contiguous tensors; ``p`` itself if it is already so."""
    if isinstance(p, Bf16StepParams):
        return p
    return Bf16StepParams(**{
        f: kernels.bf16_exact(w).contiguous() if f in PRODUCT_WEIGHTS else w
        for f, w in zip(p._fields, p)})


# K9 bf16 (csrc/denoise_step_bf16.cu) is compiled for these widths; a
# narrower model runs on operands padded with zeros, a wider one is refused
STEP_BF16_CAPS = {"U0": 128, "U2": 512, "D": 128, "DH": 64, "D15": 192, "DH2": 64}
_STEP_BF16_CAPS_TEXT = ("K9 bf16 takes D <= 128, DH <= 64, D15 <= 192, DH2 <= 64, "
                        "U0 <= 128 and U2 <= 512: the widths csrc/denoise_step_bf16.cu "
                        "is compiled for (the bf16 chain's cap of D = 128)")
# its packed float32 biases, each padded with zeros to its width
_STEP_BF16_BIASES = (("b_up2", 512), ("bc", 128), ("bp0", 64), ("bp2", 128),
                     ("bx0", 192), ("bx2", 128), ("bo0", 64), ("bo2", 8))
# its tail layers' weights (in (in, out) layout) as bf16 (out, k) rows of
# these (out, k), zeros past the model's (wx0_t apart: two halves)
_STEP_BF16_LAYERS = (("wc_t", 128, 256), ("wp0_t", 64, 16), ("wp2_t", 128, 64),
                     ("wx0_t", 192, 256), ("wx2_t", 128, 192), ("wo0_t", 64, 128),
                     ("wo2_t", 8, 64))


class Bf16StepOperands(NamedTuple):
    """K9's weights in the bf16 mode (``csrc/denoise_step_bf16.cu``): bf16
    copies of the rounded product weights as (out, k) rows, k contiguous
    (the B operand of ``mma.sync.m16n8k16.row.col``; w_up4's rows are the
    A operand of u4), each padded with zeros to the widths the kernel is
    compiled for (:data:`STEP_BF16_CAPS`), and the biases packed into one
    float32 vector.  The pose features' half of wx0 takes k 0 to D - 1 and
    emb's half k 128 to 127 + D, where the kernel keeps them.  What the
    tile kernel streams (w4 and the tail's seven) is cut into chunks of 64
    k, (chunks, out, 72): each chunk contiguous, its rows padded to 72
    (nine 16-byte pieces), as the kernel's ring stages hold them
    (:func:`_bf16_chunks`); w4's rows padded with zeros to a multiple of 64."""

    w2: torch.Tensor    # (512, 128)        w_up2
    w4: torch.Tensor    # (8, N up to 64, 72)  w_up4
    bias: torch.Tensor  # (1224,)           b_up2, bc, bp0, bp2, bx0, bx2, bo0, bo2
    wc: torch.Tensor    # (4, 128, 72)      wc_t^T (128, 256)
    wp0: torch.Tensor   # (1, 64, 72)       wp0_t^T (64, 16)
    wp2: torch.Tensor   # (1, 128, 72)      wp2_t^T (128, 64)
    wx0: torch.Tensor   # (4, 192, 72)      wx0_t^T (192, 256), halves at k 0 and 128
    wx2: torch.Tensor   # (3, 128, 72)      wx2_t^T (128, 192)
    wo0: torch.Tensor   # (2, 64, 72)       wo0_t^T (64, 128)
    wo2: torch.Tensor   # (1, 8, 72)        wo2_t^T (8, 64)


# k of a chunk of K9 bf16's streamed operands, and the padded row of one
STEP_BF16_CHUNK, STEP_BF16_CHUNK_ROW = 64, 72


def _bf16_chunks(w: torch.Tensor) -> torch.Tensor:
    """Rows ``w`` (n, k) as K9 bf16's chunks: (ceil(k / 64), n, 72) bf16,
    chunk c holding k [64 c, 64 c + 64) of every row, zeros past k and in
    each row's last 8."""
    n, k = w.shape
    c = -(-k // STEP_BF16_CHUNK)
    rows = torch.zeros(n, c * STEP_BF16_CHUNK, dtype=torch.bfloat16, device=w.device)
    rows[:, :k] = w
    out = torch.zeros(c, n, STEP_BF16_CHUNK_ROW, dtype=torch.bfloat16, device=w.device)
    out[..., :STEP_BF16_CHUNK] = rows.view(n, c, STEP_BF16_CHUNK).transpose(0, 1)
    return out


def _step_bf16_operands(p: DenoiseStepParams) -> Bf16StepOperands:
    """:class:`Bf16StepOperands` of ``p``, whose product weights are
    bf16-exact; raises ``ValueError`` past :data:`STEP_BF16_CAPS`."""
    D = p.wc_t.shape[1]
    widths = {"U0": p.w_up0.shape[0], "U2": p.w_up2.shape[0], "D": D,
              "DH": p.wp0_t.shape[1], "D15": p.wx0_t.shape[1], "DH2": p.wo0_t.shape[1]}
    over = {k: v for k, v in widths.items() if v > STEP_BF16_CAPS[k]}
    if over:
        raise ValueError(f"a model of widths {over} exceeds {_STEP_BF16_CAPS_TEXT}")

    def rows(w, n, k, at=0):
        out = torch.zeros(n, k, dtype=torch.bfloat16, device=w.device)
        out[:w.shape[0], at:at + w.shape[1]] = w
        return out

    tail = []
    for f, n, k in _STEP_BF16_LAYERS:
        w_t = getattr(p, f)
        if f == "wx0_t":  # the pose features' half at k 0, emb's at k 128
            w = rows(w_t[:D].t(), n, k)
            w[:, k // 2:k // 2 + D] = rows(w_t[D:].t(), n, D)
        else:
            w = rows(w_t.t(), n, k)
        tail.append(_bf16_chunks(w))
    bias = torch.zeros(sum(n for _, n in _STEP_BF16_BIASES), dtype=torch.float32,
                       device=p.bc.device)
    at = 0
    for f, n in _STEP_BF16_BIASES:
        b = getattr(p, f).reshape(-1)
        bias[at:at + b.numel()] = b
        at += n
    npad = -(-p.w_up4.shape[0] // 64) * 64
    return Bf16StepOperands(rows(p.w_up2, STEP_BF16_CAPS["U2"], STEP_BF16_CAPS["U0"]),
                            _bf16_chunks(rows(p.w_up4, npad, STEP_BF16_CAPS["U2"])),
                            bias, *tail)


# per model: (step_params_key, compute dtype) -> its DenoiseStepParams
_STEP_PARAMS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def step_params(model, compute_dtype: Optional[torch.dtype] = None
                ) -> DenoiseStepParams:
    """:func:`extract_step_params` of ``model`` for the kernels' mode in
    ``compute_dtype``, in the bf16 mode with the product weights rounded
    (:func:`bf16_step_params`): kept per model and made again when its
    weights change (:func:`step_params_key`), so a sampler rounds them once
    per model and not once per call."""
    bf16 = kernels.bf16_mode(compute_dtype)
    key = (step_params_key(model), bf16)
    kept = _STEP_PARAMS.get(model)
    if kept is None or kept[0] != key:
        p = extract_step_params(model)
        kept = (key, bf16_step_params(p) if bf16 else p)
        _STEP_PARAMS[model] = kept
    return kept[1]


def _emb_plain(e2: torch.Tensor, p: DenoiseStepParams,
               bf16: bool = False) -> torch.Tensor:
    """The t-only embedding (..., N, D) of step rows e2 (..., 2D): the
    upsampling MLP, then combine_extraction."""
    e2 = e2[..., None, :]                                     # (..., 1, 2D)
    u0 = F.gelu(p.w_up0 * e2 + p.b_up0)                       # (..., 128, 2D)
    u2 = F.gelu(mode_matmul(p.w_up2, u0, bf16) + p.b_up2)     # (..., 512, 2D)
    u4 = F.gelu(mode_matmul(p.w_up4, u2, bf16) + p.b_up4)     # (..., N, 2D)
    return F.gelu(mode_matmul(u4, p.wc_t, bf16) + p.bc)       # (..., N, D)


def denoise_step_plain(
    x: torch.Tensor,         # (B, N, 3) current sample
    noise: torch.Tensor,     # (B, N, 3) this step's gaussian draw
    cond_pcd: torch.Tensor,  # (B, N, 3)
    e2: torch.Tensor,        # (B, 2D) this step's (timestep, text) embedding
    coefs: torch.Tensor,     # (3,) [c1, c2, c3]
    p: DenoiseStepParams,
    clip_denoised: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Plain version of K9: one step of the Pallas kernels' body as torch
    ops, in ``compute_dtype``'s mode.  Returns the next sample (B, N, 3)."""
    bf16 = kernels.bf16_mode(compute_dtype)
    emb = _emb_plain(e2, p, bf16)                            # (B, N, D)
    h = torch.sigmoid(mode_matmul(x + cond_pcd, p.wp0_t, bf16) + p.bp0)
    h = torch.sigmoid(mode_matmul(h, p.wp2_t, bf16) + p.bp2)
    h = torch.sigmoid(mode_matmul(torch.cat([h, emb], dim=-1), p.wx0_t, bf16)
                      + p.bx0)
    h = torch.sigmoid(mode_matmul(h, p.wx2_t, bf16) + p.bx2)
    h = F.gelu(mode_matmul(h, p.wo0_t, bf16) + p.bo0)
    x0 = F.gelu(mode_matmul(h, p.wo2_t, bf16) + p.bo2)
    if clip_denoised:
        x0 = x0.clamp(-1.0, 1.0)
    return coefs[0] * x0 + coefs[1] * x + coefs[2] * noise


# K9's tile of point rows (csrc/denoise_step.cu: kTileRows) and the
# cluster sizes its host plan chooses from
STEP_TILE_ROWS = 32
STEP_CLUSTERS = (1, 2, 3, 4, 5, 6, 7, 8)
# a block's time with a cluster of C, as STEP_FIXED + 1 / C (in units of
# the C = 1 block's work): the share of a block's time that splitting the
# columns does not shrink (barriers, epilogues, the prologue), fitted to
# the sweep of every size at N = 1024, D = 128, b1-b8 on an H100
# (``profile_kernels.py --step_sweep``; PERF.md §6)
STEP_FIXED = 0.25


def step_plan(B: int, N: int, max_clusters: Mapping[int, int]) -> int:
    """Blocks a cluster of K9's tile kernel (1 to 8) for B scenes of N
    points, given ``max_clusters``: for each cluster size, the clusters of
    the kernel the device runs at once (:func:`step_occupancy`; 0 where it
    runs none).  The size that takes the least time by the waves it
    needs, ceil(tiles / max_clusters[C]), times a block's time,
    STEP_FIXED + 1 / C; ties to the smaller cluster.  More blocks a tile
    split each layer's columns finer, so a block's share of the work
    shrinks while its barriers and epilogues do not; and larger clusters
    fit the card's GPCs less well (on an H100 at the flagship width, 30
    clusters of 4, not 33).  There it picks the sweep's fastest size in
    each of its 8 cells: at N = 1024, 3 at b1, 2 at b2, b5 and b6, 1 at
    b3, b4, b7 and b8."""
    if B < 1 or N < 1:
        raise ValueError(f"step plan needs scenes and points, got {B} and {N}")
    sizes = [c for c in STEP_CLUSTERS if max_clusters.get(c, 0) > 0]
    if not sizes:
        raise ValueError(f"the device runs no cluster of K9's tile kernel: "
                         f"{dict(max_clusters)}")
    tiles = B * -(-N // STEP_TILE_ROWS)

    def cost(c):
        return -(-tiles // max_clusters[c]) * (STEP_FIXED + 1.0 / c)

    return min(sizes, key=lambda c: (cost(c), c))


@functools.lru_cache(maxsize=None)
def step_occupancy(dims: Tuple[int, ...], device_index: int) -> Dict[int, int]:
    """Clusters of K9's tile kernel that CUDA device ``device_index`` runs
    at once, for each size of ``STEP_CLUSTERS``, at the dims {N, 2D, U0,
    U2, D, DH, D15, DH2} (cudaOccupancyMaxActiveClusters, which the block's
    shared memory and the GPCs decide), asked once per dims and device."""
    lib = kernels.load()
    occupancy = {}
    with torch.cuda.device(device_index):
        for c in STEP_CLUSTERS:
            n = lib.lsdm_denoise_step_max_clusters((ctypes.c_int * 9)(1, *dims), c)
            kernels.check(-min(n, 0), "denoise_step")
            occupancy[c] = n
    return occupancy


# K9 bf16's tile kernel: m16 tiles a block (a block carries 16 MT point
# rows) it is compiled for
STEP_BF16_MTILES = (1, 2, 4)


def step_bf16_plan(B: int, N: int, max_blocks: Mapping[int, int]) -> int:
    """m16 tiles a block, mt, of K9 bf16's tile launch for B scenes of N
    points, whose grid is then (ceil(N / (16 mt)), B), given
    ``max_blocks``: for each of ``STEP_BF16_MTILES``, the blocks of that
    instance the device runs at once (:func:`step_bf16_occupancy`; 0 where
    it runs none).  The fewest waves of blocks, ceil(B tiles / max_blocks),
    then the fewest rows a block: every block streams the same weights and
    its scene's u2 from L2 whatever its rows, so a block of more rows costs
    little more while it saves a wave, and one of fewer rows spreads a
    small batch over more SMs."""
    if B < 1 or N < 1:
        raise ValueError(f"step plan needs scenes and points, got {B} and {N}")
    sizes = [mt for mt in STEP_BF16_MTILES if max_blocks.get(mt, 0) > 0]
    if not sizes:
        raise ValueError(f"the device runs no block of K9 bf16's tile kernel: "
                         f"{dict(max_blocks)}")

    def waves(mt):
        return -(-B * -(-N // (16 * mt)) // max_blocks[mt])

    return min(sizes, key=lambda m: (waves(m), m))


@functools.lru_cache(maxsize=None)
def step_bf16_occupancy(device_index: int) -> Dict[int, int]:
    """Blocks of K9 bf16's tile kernel that CUDA device ``device_index``
    runs at once, for each of ``STEP_BF16_MTILES`` (its occupancy an SM,
    which the block's shared memory decides, times the SMs), asked once
    per device."""
    lib = kernels.load()
    occupancy = {}
    with torch.cuda.device(device_index):
        for mt in STEP_BF16_MTILES:
            n = lib.lsdm_denoise_step_bf16_max_blocks(mt)
            kernels.check(-min(n, 0), "denoise_step_bf16")
            occupancy[mt] = n
    return occupancy


def col_slice(fout: int, cluster: int, rank: int) -> Tuple[int, int]:
    """Columns [lo, hi) of a layer of ``fout`` outputs that block ``rank``
    of a K9 cluster computes (``csrc/denoise_step.cu:col_slice``): slices
    of ceil(fout / cluster) rounded up to 4, the last short or empty."""
    per_rank = -(-fout // cluster)
    sl = -(-per_rank // 4) * 4 if cluster > 1 else fout
    lo = min(rank * sl, fout)
    return lo, min(lo + sl, fout)


def fused_denoise_step(
    x: torch.Tensor,         # (B, N, 3) current sample
    noise: torch.Tensor,     # (B, N, 3) this step's gaussian draw
    cond_pcd: torch.Tensor,  # (B, N, 3)
    e2: torch.Tensor,        # (B, 2D) this step's (timestep, text) embedding
    coefs: torch.Tensor,     # (3,) [c1, c2, c3], read on the device
    p: DenoiseStepParams,
    clip_denoised: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """K9: one DDPM/DDIM step of every scene, c1 * x0 + c2 * x + c3 * noise,
    in ``compute_dtype``'s mode.  Returns the next sample (B, N, 3)
    float32.  CUDA kernels for CUDA tensors (two launches, one call: one
    count in ``LAUNCHES``), plain version for CPU tensors.  A sampler that
    steps T times binds the weights once with :func:`make_denoise_step`
    instead, or captures the loop with :func:`make_denoise_step_loop`."""
    step = make_denoise_step(p, x.shape[1], x.device, clip_denoised,
                             compute_dtype)
    return step(x, noise, cond_pcd, e2, coefs)


class BoundStep:
    """K9's weights for N points on a CUDA device in the float32 mode,
    checked and their addresses taken once, with w_up4^T (the layout in
    which the tile kernel copies a tile's rows of w_up4) and the device's
    occupancy of its tile kernel, from which :meth:`plan` plans a launch.
    :class:`BoundStepBf16` is the bf16 mode, :func:`bind_step` binds the
    mode of a compute dtype.  ``name`` is the mode's count in
    ``kernels.LAUNCHES``."""

    name = "denoise_step"

    def __init__(self, p: DenoiseStepParams, N: int, device: torch.device,
                 clip_denoised: bool):
        self.dims = _check(p, N, {}, device)
        self.N, self.D2, self.U2 = N, self.dims[1], self.dims[3]
        self.device = device
        self.p = p
        self.clip = int(bool(clip_denoised))
        self.lib = kernels.load()
        self._bind(device.index if device.index is not None
                   else torch.cuda.current_device())

    def _bind(self, device_index: int) -> None:
        """The mode's weight addresses, u2 entry and tile occupancy."""
        self.w4t = self.p.w_up4.t().contiguous()
        self.ptrs = _pointers(self.p)
        self._u2 = self.lib.lsdm_denoise_step_u2
        self.occupancy = step_occupancy(self.dims, device_index)

    def plan(self, B: int) -> int:
        """The tile launch's plan for B scenes: blocks a cluster
        (:func:`step_plan`)."""
        return step_plan(B, self.N, self.occupancy)

    def check(self, x, noise, cond_pcd, e2, coefs) -> int:
        """Check one step's five data tensors; returns B."""
        B, N = x.shape[0], self.N
        for name, t, shape in (("x", x, (B, N, 3)), ("noise", noise, (B, N, 3)),
                               ("cond_pcd", cond_pcd, (B, N, 3)),
                               ("e2", e2, (B, self.D2)), ("coefs", coefs, (3,))):
            kernels.require(name, t, torch.float32, shape, self.device)
        if B > 65535:
            raise ValueError(f"the step kernels grid at most 65535 scenes, got {B}")
        return B

    def scratch(self, B: int) -> torch.Tensor:
        """u2 of B scenes, the scratch of one step: float32 (B, U2, 2D)."""
        return torch.empty(B * self.U2 * self.D2, dtype=torch.float32,
                           device=self.device)

    def launch(self, x, noise, cond_pcd, e2, coefs, out, scratch, stream) -> None:
        """One K9 call on ``stream`` (checked tensors; ``out`` (B, N, 3)):
        its two launches, counted once in ``kernels.LAUNCHES``, unless the
        stream is being captured, where no kernel runs."""
        self.launch_u2(e2, scratch, stream)
        self.launch_tiles(x, noise, cond_pcd, coefs, out, scratch, stream)
        if not torch.cuda.is_current_stream_capturing():
            kernels.LAUNCHES[self.name] += 1

    def launch_u2(self, e2, scratch, stream) -> None:
        """The first of a K9 call's two launches: u2 into scratch (not
        counted)."""
        with torch.cuda.device(self.device):
            rc = self._u2(e2.data_ptr(), self.ptrs, scratch.data_ptr(),
                          (ctypes.c_int * 9)(e2.shape[0], *self.dims), stream)
        kernels.check(rc, self.name)

    def launch_tiles(self, x, noise, cond_pcd, coefs, out, scratch, stream,
                     plan: Optional[int] = None) -> None:
        """The second launch of a K9 call, reading u2 from scratch (not
        counted), by ``plan`` (by default :meth:`plan`'s)."""
        B = x.shape[0]
        with torch.cuda.device(self.device):
            rc = self.lib.lsdm_denoise_step_tiles(
                x.data_ptr(), noise.data_ptr(), cond_pcd.data_ptr(), coefs.data_ptr(),
                self.ptrs, self.w4t.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                (ctypes.c_int * 9)(B, *self.dims), plan or self.plan(B), self.clip,
                stream)
        kernels.check(rc, self.name)


class BoundStepBf16(BoundStep):
    """:class:`BoundStep` in the bf16 mode (``csrc/denoise_step_bf16.cu``):
    the weights rounded (:func:`bf16_step_params`) and their bf16 copies
    (:class:`Bf16StepOperands`, which raise past the kernel's caps), kept
    alive here; the plan is m16 tiles a block and the scratch bf16."""

    name = "denoise_step_bf16"

    def __init__(self, p: DenoiseStepParams, N: int, device: torch.device,
                 clip_denoised: bool):
        super().__init__(bf16_step_params(p), N, device, clip_denoised)

    def _bind(self, device_index: int) -> None:
        self.ptrs = _step_bf16_pointers(self.p)
        self._u2 = self.lib.lsdm_denoise_step_bf16_u2
        self.occupancy = step_bf16_occupancy(device_index)

    def plan(self, B: int) -> int:
        """The tile launch's plan for B scenes: m16 tiles a block
        (:func:`step_bf16_plan`)."""
        return step_bf16_plan(B, self.N, self.occupancy)

    def scratch(self, B: int) -> torch.Tensor:
        """u2 of B scenes as bf16 u2^T (B, 256, 512) at the kernel's caps, in
        chunks of 64 columns with rows padded to 72 (B, 8, 256, 72)."""
        caps = STEP_BF16_CAPS
        return torch.empty(B * caps["U2"] // STEP_BF16_CHUNK * 2 * caps["D"]
                           * STEP_BF16_CHUNK_ROW, dtype=torch.bfloat16,
                           device=self.device)

    def launch_tiles(self, x, noise, cond_pcd, coefs, out, scratch, stream,
                     plan: Optional[int] = None) -> None:
        B = x.shape[0]
        with torch.cuda.device(self.device):
            rc = self.lib.lsdm_denoise_step_bf16_tiles(
                x.data_ptr(), noise.data_ptr(), cond_pcd.data_ptr(), coefs.data_ptr(),
                self.ptrs, out.data_ptr(), scratch.data_ptr(),
                (ctypes.c_int * 9)(B, *self.dims), plan or self.plan(B), self.clip,
                stream)
        kernels.check(rc, self.name)


def bind_step(p: DenoiseStepParams, N: int, device: torch.device,
              clip_denoised: bool = False,
              compute_dtype: Optional[torch.dtype] = None) -> BoundStep:
    """K9 bound in the mode of ``compute_dtype``: :class:`BoundStepBf16`
    for bf16, else :class:`BoundStep`."""
    mode = BoundStepBf16 if kernels.bf16_mode(compute_dtype) else BoundStep
    return mode(p, N, device, clip_denoised)


def make_denoise_step(p: DenoiseStepParams, N: int, device: torch.device,
                      clip_denoised: bool = False,
                      compute_dtype: Optional[torch.dtype] = None):
    """K9 with ``p``, ``clip_denoised`` and the mode of ``compute_dtype``
    bound, for a loop over the steps: returns ``step(x, noise, cond_pcd, e2,
    coefs)``, which computes :func:`fused_denoise_step` of those arguments.
    On a CUDA ``device`` the weights (for N points) are checked and their
    addresses taken here, once; each call checks its five data tensors only
    and launches on the stream that is current on ``device`` when it is
    called.  The returned step runs the plain version for CPU tensors."""
    plain = make_denoise_step_plain(p, N, device, clip_denoised, compute_dtype)
    if device.type != "cuda":
        def step(x, noise, cond_pcd, e2, coefs):
            if not kernels.on_cpu(x, noise, cond_pcd, e2, coefs):
                raise ValueError(f"a denoise step bound on {device} was given "
                                 "CUDA tensors")
            return plain(x, noise, cond_pcd, e2, coefs)
        return step

    bound = bind_step(p, N, device, clip_denoised, compute_dtype)

    def step(x, noise, cond_pcd, e2, coefs):
        if kernels.on_cpu(x, noise, cond_pcd, e2, coefs):
            return plain(x, noise, cond_pcd, e2, coefs)
        B = bound.check(x, noise, cond_pcd, e2, coefs)
        out = torch.empty_like(x)
        bound.launch(x, noise, cond_pcd, e2, coefs, out, bound.scratch(B),
                     kernels.stream(device))
        return out
    return step


def make_denoise_step_plain(p: DenoiseStepParams, N: int, device: torch.device,
                            clip_denoised: bool = False,
                            compute_dtype: Optional[torch.dtype] = None):
    """Plain version of :func:`make_denoise_step`, on any device."""
    return functools.partial(denoise_step_plain, p=p, clip_denoised=clip_denoised,
                             compute_dtype=compute_dtype)


class DenoiseStepGraph:
    """K9's T-step loop for B scenes of N points captured as ONE CUDA graph,
    the port's counterpart of the JAX sampler's ``lax.scan`` of the step
    inside ``jit``.  ``run(x_init, noise_tab, cond_pcd, e2_tab, coef_tab)``
    (noise_tab (T, B, N, 3), e2_tab (T, B, 2D), coef_tab (T, 3)) copies its
    arguments into the graph's static inputs, replays the graph and
    returns (final sample, input of the last step), both (B, N, 3).

    The sample ping-pongs between two static buffers; step t reads row t
    of each static table, the coefficients on the device, so nothing in
    the loop reads back from the card.  Each K9 call's u2 launch, which
    depends on the step's e2 row alone, is captured on a second stream
    into one of two scratch buffers, so it runs beside the tile launch of
    the step before (which leaves SMs free: 96 of 132 at b1) and waits
    only for the tile launch two steps back, which read that buffer; the
    tile launches follow each other on the capturing stream.  One K9 call
    runs outside the capture first (the library's load and the kernels'
    attributes are set there); it is the one the graph counts in
    ``kernels.LAUNCHES``, since no kernel runs while the stream is
    captured.  ``kernel_nodes`` (all kernel nodes, K9's u2 nodes, its tile
    nodes) is read from the captured graph itself, and ``calls``, its K9
    tile nodes, is what each replay adds to ``kernels.GRAPH_LAUNCHES``.
    ``capture_s`` and ``instantiate_s`` time the capture and the graph's
    instantiation apart.  A capture that fails raises: there is no host
    loop to fall back to.  ``compute_dtype`` bf16 captures K9's bf16 mode,
    counted as ``denoise_step_bf16``."""

    def __init__(self, p: DenoiseStepParams, B: int, N: int, T: int,
                 device: torch.device, clip_denoised: bool = False,
                 compute_dtype: Optional[torch.dtype] = None):
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, got {device}")
        if T < 1:
            raise ValueError("the step loop needs at least one step")
        bound = bind_step(p, N, device, clip_denoised, compute_dtype)
        self.T = T
        f32 = dict(dtype=torch.float32, device=device)
        self.x = torch.zeros(2, B, N, 3, **f32)
        self.noise = torch.zeros(T, B, N, 3, **f32)
        self.cond = torch.zeros(B, N, 3, **f32)
        self.e2 = torch.zeros(T, B, bound.D2, **f32)
        self.coef = torch.zeros(T, 3, **f32)
        scratch = (bound.scratch(B), bound.scratch(B))
        bound.check(self.x[0], self.noise[0], self.cond, self.e2[0], self.coef[0])
        bound.launch(self.x[0], self.noise[0], self.cond, self.e2[0],
                     self.coef[0], self.x[1], scratch[0], kernels.stream(device))
        torch.cuda.synchronize(device)
        side = torch.cuda.Stream(device)
        u2_done = [torch.cuda.Event() for _ in range(T)]
        tiles_done = [torch.cuda.Event() for _ in range(T)]
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        t0 = time.perf_counter()
        with torch.cuda.graph(graph):
            main = torch.cuda.current_stream(device)  # the capturing stream
            side.wait_stream(main)
            for t in range(T):
                with torch.cuda.stream(side):
                    if t >= 2:  # the tile launch that read this buffer
                        side.wait_event(tiles_done[t - 2])
                    bound.launch_u2(self.e2[t], scratch[t % 2], side.cuda_stream)
                    u2_done[t].record(side)
                main.wait_event(u2_done[t])
                bound.launch_tiles(self.x[t % 2], self.noise[t], self.cond,
                                   self.coef[t], self.x[(t + 1) % 2],
                                   scratch[t % 2], main.cuda_stream)
                tiles_done[t].record(main)
            main.wait_stream(side)
        self.capture_s = time.perf_counter() - t0
        counts = (ctypes.c_int * 3)()
        kernels.check(bound.lib.lsdm_graph_kernel_nodes(graph.raw_cuda_graph(),
                                                        counts), "denoise_step")
        self.kernel_nodes = tuple(counts)
        if self.kernel_nodes[1:] != (T, T):
            raise RuntimeError(f"the step graph holds K9 nodes {self.kernel_nodes} "
                               f"(all, u2, tiles), not {T} of each launch")
        self.calls = self.kernel_nodes[2]
        t0 = time.perf_counter()
        graph.instantiate()
        torch.cuda.synchronize(device)
        self.instantiate_s = time.perf_counter() - t0
        self.graph = graph
        self.bound = bound  # the weights the graph reads
        self.scratch = scratch
        self.replays = 0

    def run(self, x_init, noise_tab, cond_pcd, e2_tab, coef_tab
            ) -> Tuple[torch.Tensor, torch.Tensor]:
        self.x[0].copy_(x_init)
        self.noise.copy_(noise_tab)
        self.cond.copy_(cond_pcd)
        self.e2.copy_(e2_tab)
        self.coef.copy_(coef_tab)
        self.graph.replay()
        self.replays += 1
        kernels.GRAPH_LAUNCHES[self.bound.name] += self.calls
        T = self.T
        return self.x[T % 2].clone(), self.x[(T - 1) % 2].clone()

    __call__ = run  # the loop of make_denoise_step_loop


def _step_loop(step, x_init, noise_tab, cond_pcd, e2_tab, coef_tab):
    """The host loop of ``step`` over the T rows of the tables, carrying
    (x, last_in) as the JAX scan does."""
    final = last_in = x_init.contiguous()
    for nz, e2, coefs in zip(noise_tab.contiguous().unbind(0),
                             e2_tab.contiguous().unbind(0), coef_tab.unbind(0)):
        last_in = final
        final = step(final, nz, cond_pcd, e2, coefs)
    return final, last_in


def make_denoise_step_loop(p: DenoiseStepParams, B: int, N: int, T: int,
                           device: torch.device, clip_denoised: bool = False,
                           compute_dtype: Optional[torch.dtype] = None):
    """K9's T-step loop with ``p`` and the mode of ``compute_dtype`` bound:
    returns ``run(x_init, noise_tab, cond_pcd, e2_tab, coef_tab)`` ->
    (final sample, input of the last step), tables as
    :class:`DenoiseStepGraph` takes them.  On a CUDA ``device`` the T K9
    calls are captured into one CUDA graph (a :class:`DenoiseStepGraph`,
    which a sampler keeps and replays); on the CPU it is the host loop over
    :func:`make_denoise_step`, whose steps are the plain version."""
    if device.type == "cuda":
        return DenoiseStepGraph(p, B, N, T, device, clip_denoised, compute_dtype)
    return functools.partial(_step_loop, make_denoise_step(
        p, N, device, clip_denoised, compute_dtype))


def make_denoise_step_loop_plain(p: DenoiseStepParams, B: int, N: int, T: int,
                                 device: torch.device,
                                 clip_denoised: bool = False,
                                 compute_dtype: Optional[torch.dtype] = None):
    """Plain version of :func:`make_denoise_step_loop`, on any device: the
    host loop over :func:`denoise_step_plain`."""
    return functools.partial(_step_loop, make_denoise_step_plain(
        p, N, device, clip_denoised, compute_dtype))


def denoise_chain_plain(
    x_init: torch.Tensor,     # (B, N, 3)
    noise_tab: torch.Tensor,  # (B, T, N, 3)
    cond_pcd: torch.Tensor,   # (B, N, 3)
    e2_tab: torch.Tensor,     # (B, T, 2D)
    coef_tab: torch.Tensor,   # (T, 3)
    p: DenoiseStepParams,
    clip_denoised: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K6: the Pallas kernel body as a loop of torch ops,
    in ``compute_dtype``'s mode.  Returns (final sample, input of the last
    step), both (B, N, 3)."""
    T = noise_tab.shape[1]
    x = x_init
    last_in = x_init
    for t in range(T):
        last_in = x
        x = denoise_step_plain(x, noise_tab[:, t], cond_pcd, e2_tab[:, t],
                               coef_tab[t], p, clip_denoised, compute_dtype)
    return x, last_in


def fused_denoise_chain(
    x_init: torch.Tensor,     # (B, N, 3) initial noise image
    noise_tab: torch.Tensor,  # (B, T, N, 3) per-step gaussian draws
    cond_pcd: torch.Tensor,   # (B, N, 3)
    e2_tab: torch.Tensor,     # (B, T, 2D) per-step (timestep, text) embedding
    coef_tab: torch.Tensor,   # (T, 3) per-step [c1, c2, c3]
    p: DenoiseStepParams,
    clip_denoised: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6: the whole sampling loop, in ``compute_dtype``'s mode (float32
    inputs either way).  Returns (final sample, input of the last step),
    both (B, N, 3) float32.  CUDA kernel for CUDA tensors, plain version
    for CPU tensors."""
    if kernels.on_cpu(x_init, noise_tab, cond_pcd, e2_tab, coef_tab, *p):
        return denoise_chain_plain(x_init, noise_tab, cond_pcd, e2_tab,
                                   coef_tab, p, clip_denoised, compute_dtype)
    bf16 = kernels.bf16_mode(compute_dtype)
    if bf16:
        p = bf16_step_params(p)
    B, T, N, _ = noise_tab.shape
    dims = (B, T) + _check(p, N, {
        "x_init": (x_init, (B, N, 3)), "noise_tab": (noise_tab, (B, T, N, 3)),
        "cond_pcd": (cond_pcd, (B, N, 3)), "coef_tab": (coef_tab, (T, 3)),
        "e2_tab": (e2_tab, (B, T, p.wc_t.shape[0]))})
    tc = chain_chunk_steps(B, T, p, compute_dtype)
    dev = x_init.device
    scratch = torch.empty(_weights_floats(dims, bf16) + B * tc * _per_step(dims, bf16),
                          dtype=torch.float32, device=dev)
    final = torch.empty_like(x_init)
    last_in = torch.empty_like(x_init)
    lib = kernels.load()
    name = "denoise_chain_bf16" if bf16 else "denoise_chain"
    args = (x_init.data_ptr(), noise_tab.data_ptr(), cond_pcd.data_ptr(),
            e2_tab.data_ptr(), coef_tab.data_ptr(), _pointers(p, bf16),
            final.data_ptr(), last_in.data_ptr(), scratch.data_ptr(),
            (ctypes.c_int * 11)(*dims[:10], tc))
    with torch.cuda.device(dev):
        if bf16:
            rc = lib.lsdm_denoise_chain_bf16(*args, *chain_bf16_plan(B, N),
                                             int(bool(clip_denoised)),
                                             kernels.stream(dev))
        else:
            rc = lib.lsdm_denoise_chain(*args, int(bool(clip_denoised)),
                                        kernels.stream(dev))
    kernels.check(rc, name)
    kernels.LAUNCHES[name] += 1
    return final, last_in


# point rows a tile of K6 bf16's pass 2 (csrc/denoise_chain_bf16.cu)
CHAIN_BF16_ROWS = 16


def chain_bf16_plan(B: int, N: int, sms: int = kernels.SMS) -> Tuple[int, int]:
    """(warps a tile, tiles a block) of K6 bf16's pass 2 for B scenes of N
    points on ``sms`` SMs.  A block holds the tail's weights (143 KB of
    shared memory), so it runs alone on its SM; it takes the fewest tiles,
    up to 4, that put every tile in one wave, on 8 warps a tile where it
    holds one and 4 where it holds more (at most 16 warps a block).  A warp
    alone on a sub-partition waits on its own chain of loads, MMAs and
    activations, so more warps a tile win while the SMs outnumber the
    tiles, and more tiles a block once they do not.  On an NVIDIA H100 at N
    = 1024 it takes the fastest of the plans timed at each of B = 1 to 8
    and 16 (``profile_kernels.py --chain_sweep``, PERF.md §6): (8, 1) at b1
    and b2, (4, 2) at b3 and b4, (4, 3) at b5 and b6, (4, 4) from b7."""
    if B < 1 or N < 1:
        raise ValueError(f"the chain needs scenes and points, got {B} and {N}")
    tpb = min(4, -(-B * -(-N // CHAIN_BF16_ROWS) // sms))
    return (8 if tpb == 1 else 4), tpb


def chain_chunk_steps(B: int, T: int, p: DenoiseStepParams,
                      compute_dtype: Optional[torch.dtype] = None) -> int:
    """Steps per chunk of K6 for B scenes and T steps in ``compute_dtype``'s
    mode: as many as the first pass's tables fit in
    ``CHAIN_SCRATCH_FLOATS``, and no more than let the first pass grid its
    batch of B * tc GEMMs on gridDim.z <= 65535."""
    dims = (B, T, p.w_up4.shape[0], p.wc_t.shape[0], p.w_up0.shape[0],
            p.w_up2.shape[0], p.wc_t.shape[1], p.wp0_t.shape[1],
            p.wx0_t.shape[1], p.wo0_t.shape[1])
    per_step = _per_step(dims, kernels.bf16_mode(compute_dtype))
    return max(1, min(T, CHAIN_SCRATCH_FLOATS // (B * per_step), 65535 // B))


def denoise_chain_tables_plain(e2_tab: torch.Tensor, p: DenoiseStepParams,
                               compute_dtype: Optional[torch.dtype] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`denoise_chain_tables`."""
    bf16 = kernels.bf16_mode(compute_dtype)
    emb = _emb_plain(e2_tab, p, bf16)
    if bf16:  # emb's one consumer is a product, which rounds it
        emb = kernels.bf16_exact(emb)
    D = p.wc_t.shape[1]
    return emb, mode_matmul(emb, p.wx0_t[D:], bf16) + p.bx0


def denoise_chain_tables(e2_tab: torch.Tensor, p: DenoiseStepParams,
                         compute_dtype: Optional[torch.dtype] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6's first pass alone, for every step row of e2_tab (B, T, 2D):
    the embedding emb (B, T, N, D) and its half of the first
    combination_extraction layer, g = emb @ wx0_t[D:] + bx0
    (B, T, N, 1.5D); in the bf16 mode emb rounded to bf16 and g the
    product of bf16 operands.  CUDA kernels for CUDA tensors (counted under
    the chain's mode), plain version for CPU tensors."""
    if kernels.on_cpu(e2_tab, *p):
        return denoise_chain_tables_plain(e2_tab, p, compute_dtype)
    return _table_views(*_tables_scratch(e2_tab, p, compute_dtype),
                        kernels.bf16_mode(compute_dtype))


def _tables_scratch(e2_tab: torch.Tensor, p: DenoiseStepParams,
                    compute_dtype: Optional[torch.dtype] = None,
                    keep_emb: bool = True):
    """K6's first pass alone on CUDA tensors: (its scratch, the dims), the
    scratch laid out as ``csrc/denoise_tables.cuh`` says for the mode.
    ``keep_emb`` False leaves emb^T out of the bf16 mode's scratch, as the
    chain runs pass 1 (the float32 mode always keeps it)."""
    bf16 = kernels.bf16_mode(compute_dtype)
    if bf16:
        p = bf16_step_params(p)
    B, T, _ = e2_tab.shape
    N = p.w_up4.shape[0]
    if B * T > 65535:
        raise ValueError(f"B * T = {B * T} tables exceed one grid (65535)")
    dims = (B, T) + _check(p, N, {"e2_tab": (e2_tab, (B, T, p.wc_t.shape[0]))})
    dev = e2_tab.device
    scratch = torch.empty(_weights_floats(dims, bf16)
                          + B * T * _per_step(dims, bf16, keep_emb),
                          dtype=torch.float32, device=dev)
    lib = kernels.load()
    entry = (lib.lsdm_denoise_chain_tables_bf16 if bf16
             else lib.lsdm_denoise_chain_tables)
    name = "denoise_chain_bf16" if bf16 else "denoise_chain"
    with torch.cuda.device(dev):
        rc = entry(e2_tab.data_ptr(), _pointers(p, bf16), scratch.data_ptr(),
                   (ctypes.c_int * 11)(*dims[:10], int(keep_emb)),
                   kernels.stream(dev))
    kernels.check(rc, name)
    kernels.LAUNCHES[name] += 1
    return scratch, dims


def _table_views(scratch: torch.Tensor, dims, bf16: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """emb (B, T, N, D) and g (B, T, N, D15) in the scratch of
    ``lsdm_denoise_chain_tables`` (``csrc/denoise_tables.cuh``): in the
    float32 mode the transposed weights, then u2, u4^T, emb^T and g of every
    (scene, step); in the bf16 mode u0, u2 and u4^T (bf16), g, then emb^T
    (bf16, kept).  emb is read from emb^T, whose rows are ``_ldn(N, bf16)`` long:
    a transposed view in the float32 mode, widened from its bf16 table in
    the bf16 mode; g is a view, float32 in both."""
    B, T, N, D2, U0, U2, D, _, D15, _ = dims[:10]
    ldn, z = _ldn(N, bf16), B * T
    if bf16:
        o_g = z * ((U0 + U2) * D2 + D2 * ldn) // 2
        o_emb = o_g + z * N * D15
        embt = scratch[o_emb:o_emb + z * D * ldn // 2].view(torch.bfloat16)
    else:
        o_emb = _weights_floats(dims) + z * (U2 * D2 + D2 * ldn)
        o_g = o_emb + z * D * ldn
        embt = scratch[o_emb:o_g]
    emb = embt.view(B, T, D, ldn)[..., :N].transpose(-1, -2)
    return emb.float() if bf16 else emb, scratch[o_g:o_g + z * N * D15].view(B, T, N, D15)


def _ldn(N: int, bf16: bool = False) -> int:
    """Row length of pass 1's tables with a point column: N rounded up to
    4 floats, or to 8 bf16 in the bf16 mode, so that every row starts on
    16 bytes."""
    r = 8 if bf16 else 4
    return -(-N // r) * r


def _per_step(dims, bf16: bool = False, emb: bool = False) -> int:
    """Floats of the first pass's tables per (scene, step)
    (csrc/denoise_tables.cuh): u2, u4^T, emb^T and g in the float32 mode;
    u0, u2 and u4^T as bf16, two to a float, and g in the bf16 mode, and
    with ``emb`` emb^T (bf16) after them, which only pass 1 alone keeps."""
    _, _, N, D2, U0, U2, D, _, D15, _ = dims[:10]
    if bf16:
        ldn = _ldn(N, True)
        return ((U0 + U2) * D2 + (D2 + (D if emb else 0)) * ldn) // 2 + N * D15
    return U2 * D2 + D2 * _ldn(N) + D * _ldn(N) + N * D15


def _weights_floats(dims, bf16: bool = False) -> int:
    """Floats of the weights the first pass transposes once a call, ahead
    of the tables: w_up2^T (U0, U2) and w_up4^T (U2, ldn) in the float32
    mode; none in the bf16 mode, whose bf16 copies come transposed
    (:class:`Bf16Operands`)."""
    _, _, N, _, U0, U2 = dims[:6]
    return 0 if bf16 else U0 * U2 + U2 * _ldn(N)


def _pointers(p: DenoiseStepParams, operands: bool = False):
    """The addresses of ``p``'s 20 tensors, then, with ``operands``, those
    of its :class:`Bf16Operands` (``p`` a :class:`Bf16StepParams`): pass
    1's four, then pass 2's six."""
    ws = list(p) + (list(p.operands) if operands else [])
    return (ctypes.c_void_p * len(ws))(*[w.data_ptr() for w in ws])


def _step_bf16_pointers(p: Bf16StepParams):
    """The 13 addresses K9 bf16's C entries take (``csrc/denoise_step_bf16.cu``):
    w_up0, b_up0, then ``p.step_operands`` with b_up4 after w4."""
    ops = p.step_operands
    ws = (p.w_up0, p.b_up0, ops.w2, ops.w4, p.b_up4, ops.bias, *ops[3:])
    return (ctypes.c_void_p * len(ws))(*[w.data_ptr() for w in ws])


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

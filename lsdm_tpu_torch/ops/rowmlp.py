"""Launch plans of the row-MLP kernels K7 (``csrc/sa_fused.cu``) and K8
(``csrc/fp_fused.cu``), computed on the host and handed to the C entries.

Both kernels carry a tile of activation rows through a stage's dense
layers in shared memory (``csrc/rowmlp.cuh``).  A plan fixes, per stage:

- ``rows``: SA centres (each with ``nsample`` activation rows) or FP
  targets a cluster takes;
- ``cluster``: blocks of a thread-block cluster that share those rows.
  Rank ``r`` computes the columns :func:`col_slice` gives it of every
  layer and writes them into every peer's next input buffer (DSMEM), so
  each block reads only its slice of the weights;
- ``tiles``: per layer, which register tile (:data:`TILES`) the block's
  256 threads use (:func:`pick_tile`);
- the shared-memory layout: two activation buffers of ``cap0`` and
  ``cap1`` channels by ``ldm`` rows (channel-major), the weight ring, the
  SA max's partial results, the cloud and the selection.

:func:`plan_sa` and :func:`plan_fp` take rows and cluster from
:data:`MEASURED` for the flagship stages (``models/pointnet2.py``): the
fastest of every candidate on an H100, as ``python -m
lsdm_tpu_torch.profile_encode --sweep`` times them.  Other shapes follow
one rule (:func:`_rule`).  The C side recomputes what it needs from the
plan, checks it, and refuses one it cannot run with
``cudaErrorInvalidValue``: the wrapper then raises.

The kernels' bf16 modes (``compute_dtype=torch.bfloat16``) are their own
design on the bf16 tensor cores (``csrc/rowmma.cuh``, ``csrc/sa_fused_bf16.cu``,
``csrc/fp_fused_bf16.cu``) and take their own plans (:class:`PlanBf16`,
:func:`plan_sa_bf16`, :func:`plan_fp_bf16`) and caps
(:func:`sa_max_points_bf16`, :func:`fp_max_sources_bf16`): bf16 activation
rows, and weights from bf16 copies made once per model
(:class:`Bf16Operands`, kept per stage module by :func:`kept_bf16_operands`).

What the plans launch at b1 (9 clouds): sa1-sa4 288-1152 blocks, fp2
288, fp1 144, fp3 72 and fp4 36.  fp3 and fp4 fill fewer SMs because
more blocks ran slower in the sweep: each block of a cluster repeats its
tile's 3-NN and input gather, and narrower column slices take smaller
register tiles.  At 9 clouds fp3 ran 0.0932 ms on 72 blocks against
0.1009 and 0.1514 on 144 and 288 (32 targets on clusters of 2 and 4), and
fp4 0.0764 ms on 36 against 0.0771 on 72 (NVIDIA H100 80GB HBM3, 700 W).
``tests/test_torch_rowmlp.py`` pins these counts.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import weakref
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from lsdm_tpu_torch import kernels
from lsdm_tpu_torch.kernels import SMEM_MAX, SMS

THREADS = 256
STAGES = 3           # cp.async ring depth of the weight tiles
STAGE_FLOATS = 2048  # floats of one ring stage at most: BK x BN
SMEM_SM = 233_472    # shared memory of an SM (228 KB), 1 KB reserved a block
MAX_LAYERS = 8       # layers the kernel computes (csrc/rowmlp.cuh:kMaxLayers)
SA_ROWS = (1, 2, 4, 8)    # centres a cluster may take (nsample rows each)
FP_ROWS = (32, 64, 128)   # targets a cluster may take
CLUSTERS = (1, 2, 4)
# (rows a thread TM, columns a thread TN, warps down the rows WY) of each
# register tile: a warp's lanes are 8 x 4 threads, so the block tile is
# (WY * 8 * TM) x (8 / WY * 4 * TN).  The tiles some flagship plan takes
# (the same table is csrc/rowmlp.cuh:tile_tm/tile_tn/tile_wy).
TILES = ((8, 8, 2), (8, 8, 1), (8, 8, 4), (4, 8, 1), (4, 8, 2), (4, 8, 4),
         (4, 8, 8), (4, 4, 1), (4, 4, 2))

# (rows, cluster) of the flagship stages by cloud count (9 = batch 1):
# the fastest candidate of `profile_encode.py --sweep` on an NVIDIA H100
# 80GB HBM3 at 700 W.  A cloud count between takes the nearest's.
MEASURED: Dict[tuple, Dict[int, Tuple[int, int]]] = {
    ("sa", 1024, 1024, 32, (32, 32, 64)):
        {9: (8, 1), 18: (8, 1), 36: (8, 1), 72: (8, 1)},
    ("sa", 1024, 256, 32, (64, 64, 128)):
        {9: (4, 1), 18: (4, 1), 36: (4, 1), 72: (4, 1)},
    ("sa", 256, 64, 32, (128, 128, 256)):
        {9: (2, 2), 18: (2, 1), 36: (2, 1), 72: (2, 1)},
    ("sa", 64, 16, 32, (256, 256, 512)):
        {9: (1, 2), 18: (1, 2), 36: (1, 2), 72: (1, 1)},
    ("fp", 64, 16, (768, 256, 256)):
        {9: (32, 2), 18: (32, 2), 36: (32, 1), 72: (32, 2)},
    ("fp", 256, 64, (384, 256, 256)):
        {9: (64, 2), 18: (64, 1), 36: (32, 2), 72: (64, 1)},
    ("fp", 1024, 256, (320, 256, 128)):
        {9: (32, 1), 18: (32, 1), 36: (32, 1), 72: (32, 1)},
    ("fp", 1024, 1024, (128, 128, 128, 128, 128, 3)):
        {9: (64, 1), 18: (32, 1), 36: (64, 1), 72: (64, 1)},
}


def tile_dims(tile: int) -> Tuple[int, int, int]:
    """(BM, BN, BK) of a tile: block rows, block columns, ring depth."""
    tm, tn, wy = TILES[tile]
    bn = THREADS // 32 // wy * 4 * tn
    return wy * 8 * tm, bn, min(32, STAGE_FLOATS // bn)


def col_slice(fout: int, cluster: int, rank: int) -> Tuple[int, int]:
    """Columns [lo, hi) of a layer of ``fout`` outputs that cluster rank
    ``rank`` computes: slices of ceil(fout / cluster) rounded up to 4
    (16-byte weight copies), the last ones short or empty."""
    sl = (-(-fout // cluster) + 3) // 4 * 4 if cluster > 1 else fout
    lo = min(fout, rank * sl)
    return lo, min(fout, lo + sl)


def _round(x: int, m: int) -> int:
    return -(-x // m) * m


def pick_tile(m: int, cols: int) -> int:
    """The tile for a layer of ``m`` rows and ``cols`` columns: the least
    FMAs on padding, then the most outputs a thread (FMAs a shared-memory
    load), then the fewest padded rows (the buffers' height)."""
    def key(t):
        (bm, bn, _), (tm, tn, _) = tile_dims(t), TILES[t]
        return _round(m, bm) * _round(cols, bn), -tm * tn, _round(m, bm)
    return min(range(len(TILES)), key=key)


@dataclasses.dataclass(frozen=True)
class Plan:
    rows: int        # SA centres or FP targets a cluster takes
    m: int           # activation rows of a block: rows * nsample or rows
    cluster: int
    ldm: int         # row stride of the channel-major buffers (floats)
    cap0: int        # channels of buffer 0 (the input, layers 2, 4, ...)
    cap1: int        # channels of buffer 1
    ring: int        # floats of the weight ring
    red: int         # floats of the SA max's partial results (first the
                     # centre terms of layer 1)
    smem: int        # dynamic shared memory of a block, bytes
    tiles: Tuple[int, ...]
    grid: Tuple[int, int]  # (row tiles x cluster, clouds)

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]

    def ints(self) -> Tuple[int, ...]:
        """The plan as the C entries read it (csrc/rowmlp.cuh:Plan)."""
        return (self.rows, self.cluster, self.ldm, self.cap0, self.cap1,
                self.ring, self.red, self.smem, *self.tiles)


def _layout(m: int, rows: int, cluster: int, tile_rows: int, clouds: int,
            fins: Sequence[int], fouts: Sequence[int], caps: Tuple[int, int],
            red_groups: int, red_min: int, extra_floats: int) -> Plan:
    tiles, ring, ext = [], 0, m
    for fout in fouts:
        lo, hi = col_slice(fout, cluster, 0)
        t = pick_tile(m, hi - lo)
        bm, bn, bk = tile_dims(t)
        tiles.append(t)
        ring = max(ring, STAGES * bk * bn)
        ext = max(ext, _round(m, bm))
    # ldm = 4 (mod 32): the gathers' float4 stores of consecutive channels
    # fall on distinct banks
    ldm = _round(ext, 32) + 4
    red = red_min
    if red_groups:
        lo, hi = col_slice(fouts[-1], cluster, 0)
        red = max(red, red_groups * (hi - lo))
    red = _round(red, 4)
    smem = 4 * ((caps[0] + caps[1]) * ldm + ring + red + extra_floats)
    return Plan(rows, m, cluster, ldm, caps[0], caps[1], ring, red, smem,
                tuple(tiles), (tile_rows * cluster, clouds))


def _caps(stored: Sequence[int]) -> Tuple[int, int]:
    """Channels of the two ping-pong buffers for the widths stored in turn."""
    return max(stored[0::2]), max(stored[1::2], default=0)


def layout_sa(clouds: int, n: int, s: int, nsample: int,
              widths: Sequence[int], rows: int, cluster: int) -> Plan:
    """K7's plan with ``rows`` centres a cluster of ``cluster`` blocks:
    ``clouds`` clouds of ``n`` points, ``s`` centres, ``nsample`` rows a
    centre, layer widths ``widths`` = [F1, ..., FL] (F1 is layer 1's,
    gathered from Z1; the kernel computes F1 -> F2 ...)."""
    fins, fouts = list(widths[:-1]), list(widths[1:])
    if len(fouts) > MAX_LAYERS:
        raise ValueError(f"at most {MAX_LAYERS + 1} layers")
    m = rows * nsample
    # layer 1, then 2..L-1; L goes into the max (a one-layer MLP keeps 1).
    # red: the max's partial results, and before them the centre terms of
    # layer 1 (rows x F1); then the cloud (x, y, z, |p|^2) and the
    # selected indices
    return _layout(m, rows, cluster, -(-s // rows), clouds, fins, fouts,
                   _caps(list(widths[:-1]) or [widths[0]]),
                   rows if fouts else 0, rows * widths[0], 4 * n + m)


def layout_fp(clouds: int, n: int, s: int, widths: Sequence[int], rows: int,
              cluster: int) -> Plan:
    """K8's plan with ``rows`` targets a cluster of ``cluster`` blocks:
    ``clouds`` clouds of ``n`` targets and ``s`` sources, widths = [F0 =
    D1 + D2, F1, ..., FL]."""
    fins, fouts = list(widths[:-1]), list(widths[1:])
    if not fouts or len(fouts) > MAX_LAYERS:
        raise ValueError(f"1 to {MAX_LAYERS} layers")
    # the input and layers 1..L-1; then the sources, the 3-NN weights and
    # indices
    return _layout(rows, rows, cluster, -(-n // rows), clouds, fins, fouts,
                   _caps(widths[:-1]), 0, 0, 4 * s + 6 * rows)


@functools.lru_cache(maxsize=256)
def sa_max_points(nsample: int, widths: Sequence[int]) -> int:
    """The most points K7 stages for a stage of ``nsample`` rows a centre
    and layer widths ``widths`` (a tuple): the cloud (16 bytes a point)
    beside the buffers, ring and selection of its smallest plan (one centre
    a block, cluster 1) within SMEM_MAX.  At the flagship widths it is far
    above the 4096 points of ``--pcd_points 4096``.  Cached, as the plans
    are: the wrapper asks at every call."""
    return (SMEM_MAX - layout_sa(1, 0, 1, nsample, widths, 1, 1).smem) // 16


@functools.lru_cache(maxsize=256)
def fp_max_sources(widths: Sequence[int]) -> int:
    """The most sources K8 stages for layer widths ``widths`` = (F0, ...,
    FL): the source cloud beside its smallest plan (FP_ROWS[0] targets a
    block, cluster 1) within SMEM_MAX.  Cached, as :func:`sa_max_points`."""
    return (SMEM_MAX - layout_fp(1, 1, 0, widths, FP_ROWS[0], 1).smem) // 16


def _rule(plans, waves: int = 2):
    """Of ``plans`` (one a row count, ascending, cluster 1; :class:`Plan`s
    or :class:`PlanBf16`s): the most rows whose blocks still fit two to an
    SM and give every SM ``waves`` blocks, else the fewest rows.  More rows
    reuse each weight for more rows and amortise the cloud a block stages;
    two blocks an SM hide each other's prologue and barriers."""
    two = [p for p in plans
           if p.smem + 1024 <= SMEM_SM // 2 and p.blocks >= waves * SMS]
    return two[-1] if two else plans[0]


def _plan(layout, key, clouds, row_counts, useful) -> Plan:
    table = MEASURED.get(key)
    if table:  # the nearest measured cloud count's choice
        near = min(table, key=lambda c: abs(math.log(c / clouds)))
        return layout(*table[near])
    counts = [r for r in row_counts if useful(r)] or [row_counts[0]]
    cands = [p for p in (layout(r, 1) for r in counts) if p.smem <= SMEM_MAX]
    if not cands:  # the wrappers refuse such a cloud first, naming the cap
        raise ValueError("no launch plan fits the shared memory of a block")
    return _rule(cands)


@functools.lru_cache(maxsize=256)
def plan_sa(clouds: int, n: int, s: int, nsample: int,
            widths: Sequence[int]) -> Plan:
    """K7's plan (:func:`layout_sa`): rows and cluster from
    :data:`MEASURED`, else from :func:`_rule`.  Cached: the sampling path
    asks for the same few plans at every call."""
    widths = tuple(widths)
    return _plan(
        lambda r, c: layout_sa(clouds, n, s, nsample, widths, r, c),
        ("sa", n, s, nsample, widths), clouds, SA_ROWS,
        lambda r: (r == 1 or r // 2 < s) and r * nsample <= 512)


@functools.lru_cache(maxsize=256)
def plan_fp(clouds: int, n: int, s: int, widths: Sequence[int]) -> Plan:
    """K8's plan (:func:`layout_fp`), chosen as :func:`plan_sa`'s."""
    widths = tuple(widths)
    return _plan(lambda r, c: layout_fp(clouds, n, s, widths, r, c),
                 ("fp", n, s, widths), clouds, FP_ROWS,
                 lambda r: r == FP_ROWS[0] or r // 2 < n)


# --- the bf16 modes (csrc/rowmma.cuh) ---------------------------------------

BF16_MT = (2, 4, 8, 16)  # m16 tiles a pass the kernels are compiled for
BF16_STAGES = 3          # ring depth (csrc/rowmma.cuh:kStages)
BF16_NB = 64             # weight rows (output columns) of a ring chunk
BF16_KC = (16, 32, 64, 128)  # k of a ring chunk (csrc/rowmma.cuh:Plan.kc)
BF16_FP_ROWS = (32, 64)  # targets a block may take


def _r16(x: int) -> int:
    return _round(x, 16)


@dataclasses.dataclass(frozen=True)
class PlanBf16:
    """A launch plan of K7's or K8's bf16 mode: a block of 8 warps carries
    ``m`` activation rows through the layers in ``passes`` passes of 16
    ``mt`` rows (the warps stand mt / 2 down the rows by 16 / mt across a
    64-column weight chunk), the weights stream through a ring of
    ``BF16_STAGES`` chunks of 64 rows by ``kc`` k."""
    rows: int        # SA centres or FP targets a block takes
    m: int           # activation rows of a block: rows * nsample or rows
    mt: int          # m16 tiles a pass
    passes: int
    kc: int          # k of a ring chunk
    ld0: int         # row strides of the two bf16 buffers (8 mod 16)
    ld1: int
    red: int         # ints of the SA max by atomics (0: in registers)
    smem: int        # dynamic shared memory of a block, bytes
    grid: Tuple[int, int]  # (row tiles, clouds)

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]

    def ints(self) -> Tuple[int, ...]:
        """The plan as the C entries read it (csrc/rowmma.cuh:Plan)."""
        return (self.rows, self.mt, self.passes, self.kc, self.ld0, self.ld1,
                self.red, self.smem)


def layout_sa_bf16(clouds: int, n: int, s: int, nsample: int,
                   widths: Sequence[int], rows: int,
                   kc: Optional[int] = None) -> PlanBf16:
    """K7 bf16's plan with ``rows`` centres a block: ``clouds`` clouds of
    ``n`` points, ``s`` centres, ``nsample`` rows a centre, layer widths
    ``widths`` = [F1, ..., FL] (F1 gathered from Z1, the kernel computes F1
    -> F2 ...); ``kc``: the most k a weight chunk takes (default 64; the
    chunk takes the widest layer input rounded up, :func:`_kc`)."""
    fins = list(widths[:-1]) or [widths[0]]
    if len(widths) - 1 > MAX_LAYERS:
        raise ValueError(f"at most {MAX_LAYERS + 1} layers")
    m = rows * nsample
    regs = nsample <= 32 and nsample & (nsample - 1) == 0
    red = rows * widths[-1] if len(widths) > 1 and not regs else 0
    # the cloud (x, y, z, |p|^2), the centre terms, the max's partial
    # results, the selection
    extra = 4 * n + _round(rows * widths[0], 4) + _round(red, 4) + _round(m, 4)
    return _bf16_plan(m, rows, -(-s // rows), clouds, fins, len(widths) - 1,
                      red, extra, kc)


def layout_fp_bf16(clouds: int, n: int, s: int, widths: Sequence[int],
                   rows: int, kc: Optional[int] = None) -> PlanBf16:
    """K8 bf16's plan with ``rows`` targets a block: ``clouds`` clouds of
    ``n`` targets and ``s`` sources, widths = [F0 = D1 + D2, F1, ...,
    FL]; ``kc`` as :func:`layout_sa_bf16`'s."""
    if not 1 < len(widths) <= MAX_LAYERS + 1:
        raise ValueError(f"1 to {MAX_LAYERS} layers")
    # the sources, then the 3-NN weights and indices
    extra = 4 * s + 2 * _round(3 * rows, 4)
    return _bf16_plan(rows, rows, -(-n // rows), clouds, list(widths[:-1]),
                      len(widths) - 1, 0, extra, kc)


def _kc(fins: Sequence[int], most: int = 64) -> int:
    """The k of a weight chunk: the layers' widest input rounded up to a
    chunk size (:data:`BF16_KC`), at most ``most``."""
    return min(most, next((k for k in BF16_KC if k >= max(fins)), BF16_KC[-1]))


def _bf16_plan(m: int, rows: int, tiles: int, clouds: int,
               fins: Sequence[int], layers: int, red: int,
               extra_words: int, kc: Optional[int]) -> PlanBf16:
    mt = next((t for t in BF16_MT if 16 * t >= m), BF16_MT[-1])
    passes = -(-m // (16 * mt))
    rows_pad = 16 * mt * passes
    # buffer 0 holds the input and every other layer's input, buffer 1 the
    # rest: layer l reads fins[l] channels from buffer l % 2
    ld0 = _r16(max(fins[0::2])) + 8
    ld1 = _r16(max(fins[1::2], default=0)) + 8
    if kc is not None and kc not in BF16_KC:
        raise ValueError(f"a weight chunk takes k in {BF16_KC}, not {kc}")
    kc = _kc(fins, kc or 64) if layers else BF16_KC[0]
    ring = 2 * BF16_STAGES * BF16_NB * (kc + 8) if layers else 0
    smem = ring + 2 * rows_pad * (ld0 + ld1) + 4 * extra_words
    return PlanBf16(rows, m, mt, passes, kc, ld0, ld1, red, smem,
                    (tiles, clouds))


@functools.lru_cache(maxsize=256)
def sa_max_points_bf16(nsample: int, widths: Sequence[int]) -> int:
    """The most points K7's bf16 mode stages for a stage of ``nsample``
    rows a centre and layer widths ``widths`` (a tuple): the cloud (16
    bytes a point) beside its smallest plan (one centre a block) within
    SMEM_MAX."""
    return (SMEM_MAX - layout_sa_bf16(1, 0, 1, nsample, widths, 1).smem) // 16


@functools.lru_cache(maxsize=256)
def fp_max_sources_bf16(widths: Sequence[int]) -> int:
    """The most sources K8's bf16 mode stages for widths ``widths`` = (F0,
    ..., FL): the sources beside its smallest plan (BF16_FP_ROWS[0]
    targets a block) within SMEM_MAX."""
    return (SMEM_MAX - layout_fp_bf16(1, 1, 0, widths, BF16_FP_ROWS[0]).smem) // 16


def _plan_bf16(layout, row_counts) -> PlanBf16:
    """The rows by :func:`_rule` with one block an SM (the bf16 layers are
    short, so a block's fixed cost, staging its cloud, weighs more than a
    second wave's), then the chunks' k.  ``profile_encode.py --sweep
    --dtype bfloat16`` times every plan beside this choice (PERF.md §6)."""
    cands = [p for p in (layout(r, None) for r in row_counts) if p.smem <= SMEM_MAX]
    if not cands:  # the wrappers refuse such a cloud first, naming the cap
        raise ValueError("no launch plan fits the shared memory of a block")
    plan = _rule(cands, waves=1)
    # chunks of 128 k where a layer reads more than 64 channels and the
    # larger ring still leaves two blocks an SM, or the grid leaves SMs idle
    wide = layout(plan.rows, BF16_KC[-1])
    if wide.kc > plan.kc and wide.smem <= SMEM_MAX and (
            wide.smem + 1024 <= SMEM_SM // 2 or wide.blocks <= SMS):
        return wide
    return plan


def sa_rows_bf16(nsample: int) -> Tuple[int, ...]:
    """The centre counts K7's bf16 plans take: up to 256 rows a block (one
    pass), at least one centre."""
    return tuple(r for r in SA_ROWS if r == 1 or r * nsample <= 256)


@functools.lru_cache(maxsize=256)
def plan_sa_bf16(clouds: int, n: int, s: int, nsample: int,
                 widths: Sequence[int]) -> PlanBf16:
    """K7 bf16's plan (:func:`layout_sa_bf16`) by :func:`_rule_bf16`.
    Cached: the sampling path asks for the same few plans at every call."""
    widths = tuple(widths)
    return _plan_bf16(lambda r, kc: layout_sa_bf16(clouds, n, s, nsample, widths, r, kc),
                      [r for r in sa_rows_bf16(nsample) if r == 1 or r // 2 < s])


@functools.lru_cache(maxsize=256)
def plan_fp_bf16(clouds: int, n: int, s: int, widths: Sequence[int]) -> PlanBf16:
    """K8 bf16's plan (:func:`layout_fp_bf16`) by :func:`_rule_bf16`."""
    widths = tuple(widths)
    return _plan_bf16(lambda r, kc: layout_fp_bf16(clouds, n, s, widths, r, kc),
                      [r for r in BF16_FP_ROWS if r == BF16_FP_ROWS[0] or r // 2 < n])


class Bf16Operands(tuple):
    """A stage's folded layers with what K7's or K8's bf16 mode reads of
    them, made once per model.  As a tuple it is the stage's ``folded``:
    its (W' (F_{l-1}, F_l), b' (F_l,)) as ``ops/sa_fused.py:fold_conv_bn``
    folds them (float32, detached), so the wrappers and the plain versions
    take it where they take ``folded``.  ``weights``: each layer the kernel
    computes (K7: 2..L, K8: all) as the bf16 rows of W'^T, (F_l, F_{l-1})
    padded with zeros to (round16(F_l), round16(F_{l-1})), the B operand's
    (n, k) layout (the biases stay the float32 b'); for K7 also ``w1``, W1'
    rounded to bf16 (float32: the plain product of Z1), and ``w1x`` =
    ``w1[:3]``."""

    def __new__(cls, folded, weights, w1=None, w1x=None):
        self = super().__new__(cls, folded)
        self.weights, self.w1, self.w1x = tuple(weights), w1, w1x
        return self

    @property
    def biases(self) -> Tuple[torch.Tensor, ...]:
        """The kernel layers' float32 biases."""
        return tuple(b for _, b in self[len(self) - len(self.weights):])


def bf16_rows(w: torch.Tensor) -> torch.Tensor:
    """W (F_{l-1}, F_l) as bf16 rows of W^T, zero-padded to (round16(F_l),
    round16(F_{l-1}))."""
    fin, fout = w.shape
    out = torch.zeros(_r16(fout), _r16(fin), dtype=torch.bfloat16, device=w.device)
    out[:fout, :fin] = w.t()
    return out


def bf16_operands(folded, sa: bool) -> Bf16Operands:
    """:class:`Bf16Operands` of a stage's ``folded`` layers; ``sa``: K7's
    (layer 1 is the Z1 product outside the kernel)."""
    with torch.no_grad():
        folded = tuple((w.detach().contiguous(), b.detach().contiguous())
                       for w, b in folded)
        weights = tuple(bf16_rows(w) for w, _ in folded[1 if sa else 0:])
        if not sa:
            return Bf16Operands(folded, weights)
        w1 = kernels.bf16_exact(folded[0][0]).contiguous()
        return Bf16Operands(folded, weights, w1, w1[:3].contiguous())


def operands_key(modules: Sequence[nn.Module]) -> Tuple:
    """What identifies the weights a stage folds as they stand: each
    parameter's and buffer's (the BatchNorms' running statistics) storage
    and version, which an in-place update (an optimizer step,
    ``load_state_dict``, a train-mode forward's statistics) advances."""
    return tuple((t.data_ptr(), t._version)
                 for m in modules for t in (*m.parameters(), *m.buffers()))


# per stage module: (operands_key, its Bf16Operands)
_KEPT: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def kept_bf16_operands(owner: nn.Module, modules: Sequence[nn.Module],
                       fold: Callable[[], Sequence], sa: bool) -> Bf16Operands:
    """:func:`bf16_operands` of ``fold()``, kept per ``owner`` and made
    again when a weight or a BatchNorm statistic of ``modules`` changes
    (:func:`operands_key`): a sampler rounds them once per model, not once
    per call."""
    key = operands_key(modules)
    kept = _KEPT.get(owner)
    if kept is None or kept[0] != key:
        kept = (key, bf16_operands(fold(), sa))
        _KEPT[owner] = kept
    return kept[1]

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
from typing import Dict, Sequence, Tuple

from lsdm_tpu_torch.kernels import SMS

THREADS = 256
STAGES = 3           # cp.async ring depth of the weight tiles
STAGE_FLOATS = 2048  # floats of one ring stage at most: BK x BN
SMEM_MAX = 232_448   # dynamic shared memory a block may take on Hopper
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


def _rule(plans: Sequence[Plan]) -> Plan:
    """Of ``plans`` (one a row count, ascending, cluster 1): the most rows
    whose blocks still fit two to an SM and give every SM two, else the
    fewest rows.  More rows reuse each weight for more rows; two blocks an
    SM hide each other's prologue and barriers."""
    two = [p for p in plans
           if p.smem + 1024 <= SMEM_SM // 2 and p.blocks >= 2 * SMS]
    return two[-1] if two else plans[0]


def _plan(layout, key, clouds, row_counts, useful) -> Plan:
    table = MEASURED.get(key)
    if table:  # the nearest measured cloud count's choice
        near = min(table, key=lambda c: abs(math.log(c / clouds)))
        return layout(*table[near])
    counts = [r for r in row_counts if useful(r)] or [row_counts[0]]
    cands = [p for p in (layout(r, 1) for r in counts) if p.smem <= SMEM_MAX]
    if not cands:
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

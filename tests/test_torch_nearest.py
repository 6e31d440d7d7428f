"""K2 (3-NN) and K11 (chamfer nearest neighbour) as the Hopper kernel
computes them, on the CPU.

Both run the lane-split nearest-k scan of ``csrc/nearest.cuh``, which
cannot run here, so it is transcribed: blocks of 8 warps, each warp 32 / L
groups of L lanes, each group G targets; the sources stream through tiles
of 1024, lane r of a group reading sources r, r + L, ... of each tile and
keeping its own sorted top-K with strict < (the kernel's ``insert``); then
log2(L) butterfly levels merge the group's lists in (distance, index)
order (``merge_xor``: the bitonic half-cleaner against the partner's list,
then a sorting network).  The distance is the kernel's, its FMA of -2 (q.x)
and the add after it rounded once.

The transcription is held index for index and bit for bit against the
JAX kernels in interpret mode (``three_nn_pallas``, ``_directed_min_sqdist``)
on clouds on a dyadic grid, where every product and sum is exact and so
every distance is the same bits however it is computed, with ties placed
between lanes (duplicates 1 and 33 apart), between tiles and across a tile
edge; with S not a multiple of 32, S < L, k = 1, 2, 3 and clouds larger
than one tile.  On random clouds, where the JAX kernels' XLA dot products
round otherwise, it is held bit for bit against the port's plain versions
(``three_nn_plain``, ``directed_nn_plain``) and index for index against
JAX.  The host plans (``three_nn_plan``, ``chamfer_nn_plan``) are checked
to cover every shape the kernels take.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsdm_tpu.ops.ballquery_pallas import three_nn_pallas
from lsdm_tpu.ops.chamfer_pallas import _directed_min_sqdist
from lsdm_tpu_torch import kernels
from lsdm_tpu_torch.ops import ballquery, chamfer

WARPS = 8     # csrc/nearest.cuh: kWarps
TILE = 1024   # csrc/nearest.cuh: kTile
NONE = np.iinfo(np.int32).max  # kNone: an empty slot's index
LANES = (1, 2, 4, 8, 16, 32)
GROUPS = (4, 2, 1)
FP_STAGES = ((64, 16), (256, 64), (1024, 256), (1024, 1024))  # fp4..fp1 (targets, sources)
F = np.float32


def _fma(a, b, c):
    """__fmaf_rn: a b + c rounded once (float32 products and the sums met
    here are exact in float64)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(F)


def kernel_distance(q, x, chamfer_form):
    """(B, N, S) distances of targets q (B, N, 3) to sources x (B, S, 3) as
    ``nearest.cuh:distance`` computes them."""
    q, x = q.astype(F), x.astype(F)
    qq = (q[..., 0] * q[..., 0] + q[..., 1] * q[..., 1]) + q[..., 2] * q[..., 2]
    xx = (x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]) + x[..., 2] * x[..., 2]
    a, b = q[:, :, None, :], x[:, None, :, :]
    dot = (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]
    two = np.full(dot.shape, -2.0, dtype=F)
    if chamfer_form:  # (|q|^2 + |x|^2) - 2 (q.x)
        return _fma(two, dot, qq[:, :, None] + xx[:, None, :])
    return _fma(two, dot, np.broadcast_to(qq[:, :, None], dot.shape)) + xx[:, None, :]


def _before(da, ia, db, ib):
    return (da < db) | ((da == db) & (ia < ib))


def lane_scan(d, K, lanes):
    """Each lane's list after the scan: (B, N, L, K) distances and indices.
    Lane r reads sources r, r + L, ... of every tile of TILE, in order, and
    inserts with strict < on the distance (``TopK::insert``)."""
    B, N, S = d.shape
    ld = np.full((B, N, lanes, K), np.inf, dtype=F)
    li = np.full((B, N, lanes, K), NONE, dtype=np.int64)
    for base in range(0, S, TILE):
        cnt = min(TILE, S - base)
        for j in range(cnt):
            r = j % lanes
            v, cur_d, cur_i = d[:, :, base + j], ld[:, :, r], li[:, :, r]
            gate = v < cur_d[..., K - 1]
            lt = v[..., None] < cur_d  # (B, N, K)
            new_d, new_i = cur_d.copy(), cur_i.copy()
            for m in range(K - 1, 0, -1):  # from the top, as the kernel
                up = lt[..., m - 1]
                new_d[..., m] = np.where(lt[..., m], np.where(up, cur_d[..., m - 1], v),
                                         cur_d[..., m])
                new_i[..., m] = np.where(lt[..., m], np.where(up, cur_i[..., m - 1], base + j),
                                         cur_i[..., m])
            new_d[..., 0] = np.where(lt[..., 0], v, cur_d[..., 0])
            new_i[..., 0] = np.where(lt[..., 0], base + j, cur_i[..., 0])
            ld[:, :, r] = np.where(gate[..., None], new_d, cur_d)
            li[:, :, r] = np.where(gate[..., None], new_i, cur_i)
    return ld, li


def _exchange(d, i, a, b):
    swap = _before(d[..., b], i[..., b], d[..., a], i[..., a])
    da, db, ia, ib = d[..., a].copy(), d[..., b].copy(), i[..., a].copy(), i[..., b].copy()
    d[..., a], i[..., a] = np.where(swap, db, da), np.where(swap, ib, ia)
    d[..., b], i[..., b] = np.where(swap, da, db), np.where(swap, ia, ib)


def butterfly(ld, li):
    """The group's lists after log2(L) levels of ``merge_xor``; every lane
    of the group must hold the same list."""
    B, N, lanes, K = ld.shape
    off = 1
    while off < lanes:
        partner = np.arange(lanes) ^ off
        od, oi = ld[:, :, partner][..., ::-1], li[:, :, partner][..., ::-1]
        mine = _before(ld, li, od, oi)  # mine ascending, the partner's descending
        ld, li = np.where(mine, ld, od), np.where(mine, li, oi)
        if K == 2:
            _exchange(ld, li, 0, 1)
        if K == 3:
            for a, b in ((0, 1), (1, 2), (0, 1)):
                _exchange(ld, li, a, b)
        off *= 2
    assert (ld == ld[:, :, :1]).all() and (li == li[:, :, :1]).all()
    return ld[:, :, 0], li[:, :, 0]


def writers(n, lanes, group):
    """How many lanes of the kernel's grid write each of n targets: lane g %
    L of the group holding target g of its G (the kernel's last loop)."""
    per_block = WARPS * 32 // lanes * group
    blocks = -(-n // per_block)
    block, warp, lane, g = np.meshgrid(np.arange(blocks), np.arange(WARPS),
                                       np.arange(32), np.arange(group), indexing="ij")
    t = (block * WARPS + warp) * (32 // lanes * group) + lane // lanes * group + g
    write = (g % lanes == lane % lanes) & (t < n)
    return np.bincount(t[write], minlength=n)


def nearest_scan(q, x, K, lanes, group, chamfer_form):
    """The kernel's (distances, indices), (B, N, K), for targets q against
    sources x with ``lanes`` lanes a target and ``group`` targets a lane."""
    assert (writers(q.shape[1], lanes, group) == 1).all()
    return butterfly(*lane_scan(kernel_distance(q, x, chamfer_form), K, lanes))


def k2_scan(q, x, k, lanes):
    """K2's outputs: the first k of the kernel's 3 pairs (one target a
    lane)."""
    d, i = nearest_scan(q, x, 3, lanes, 1, False)
    return d[..., :k], i[..., :k].astype(np.int32)


def k11_scan(q, x, lanes, group=1):
    """K11's outputs: max(d, 0) and the index of the kernel's one pair."""
    d, i = nearest_scan(q, x, 1, lanes, group, True)
    return np.maximum(d[..., 0], F(0)), i[..., 0].astype(np.int32)


def _grid(seed, b, n, step=0.25, span=8):
    """Points on a dyadic grid: every product and sum of a distance is
    exact in float32, and equal distances abound."""
    rs = np.random.RandomState(seed)
    return (rs.randint(-span, span + 1, size=(b, n, 3)) * step).astype(F)


def _dup(x, pairs):
    """x with source a copied to source b for each (a, b)."""
    x = x.copy()
    for a, b in pairs:
        x[:, b] = x[:, a]
    return x


# (targets, sources, k, duplicated source pairs): ties between lanes (1 and
# 33 apart), between tiles and across the tile edge; S not a multiple of
# 32; S < L; clouds past one tile
K2_CASES = [
    (64, 64, 3, ((0, 1), (2, 35), (5, 38), (40, 41))),
    (40, 45, 3, ((3, 4), (10, 43))),                    # S = 45
    (16, 2, 2, ()),                                     # S < L at L >= 4
    (16, 3, 1, ((0, 2),)),
    (48, 7, 2, ((1, 6),)),
    (32, 1100, 3, ((5, 1029), (1023, 1024), (7, 40), (300, 1099))),  # two tiles
    (24, 2100, 3, ((0, 1024), (1024, 2048), (1023, 2047), (9, 42))),  # three tiles
]


@pytest.mark.parametrize("n,s,k,dups", K2_CASES)
def test_k2_scan_matches_pallas_bit_for_bit(n, s, k, dups):
    q = _grid(n, 2, n)
    x = _dup(_grid(s + 1, 2, s), dups)
    q[:, :len(dups)] = x[:, [a for a, _ in dups]] + 0.25  # targets beside the ties
    wd, wi = (np.asarray(a) for a in three_nn_pallas(jnp.asarray(q), jnp.asarray(x), k,
                                                     interpret=True))
    pd, pi = ballquery.three_nn_plain(torch.from_numpy(q), torch.from_numpy(x), k)
    np.testing.assert_array_equal(pi.numpy(), wi)
    np.testing.assert_array_equal(pd.numpy().view(np.int32), wd.view(np.int32))
    for lanes in LANES:
        got_d, got_i = k2_scan(q, x, k, lanes)
        np.testing.assert_array_equal(got_i, wi, err_msg=f"L={lanes}")
        np.testing.assert_array_equal(got_d.view(np.int32), wd.view(np.int32),
                                      err_msg=f"L={lanes}")


# (points of x, points of y, duplicated pairs of y): N, M multiples of 128,
# as the JAX kernel takes them
K11_CASES = [
    (128, 128, ((0, 1), (2, 35), (64, 97))),
    (256, 1152, ((5, 1029), (1023, 1024), (100, 133), (1151, 1150))),  # two tiles
    (128, 2176, ((0, 1024), (1024, 2048), (1023, 2175))),            # three tiles
]


@pytest.mark.parametrize("n,m,dups", K11_CASES)
def test_k11_scan_matches_pallas_bit_for_bit(n, m, dups):
    y = _dup(_grid(m + 3, 2, m), dups)
    x = _grid(n + 5, 2, n)
    x[:, :len(dups)] = y[:, [a for a, _ in dups]]  # exact hits: 0 and its ties
    x[:, len(dups):2 * len(dups)] = y[:, [a for a, _ in dups]] - 0.25
    wm, wa = (np.asarray(a) for a in _directed_min_sqdist(jnp.asarray(x), jnp.asarray(y),
                                                          True))
    pm, pa = chamfer.directed_nn_plain(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_array_equal(pa.numpy(), wa)
    np.testing.assert_array_equal(pm.numpy().view(np.int32), wm.view(np.int32))
    for lanes in LANES:
        got_m, got_a = k11_scan(x, y, lanes)
        np.testing.assert_array_equal(got_a, wa, err_msg=f"L={lanes}")
        np.testing.assert_array_equal(got_m.view(np.int32), wm.view(np.int32),
                                      err_msg=f"L={lanes}")


@pytest.mark.parametrize("n,s", [(64, 64), (100, 37), (96, 1100)])
def test_scans_on_random_clouds_match_the_plain_versions_bit_for_bit(n, s):
    """Off the grid the distances round: the kernel's FMA form must give
    the plain versions' separately rounded bits.  With s == n the sources
    are the targets (fp1), whose nearest distances are noise around 0."""
    rs = np.random.RandomState(n + s)
    q = rs.randn(2, n, 3).astype(F)
    x = q.copy() if s == n else rs.randn(2, s, 3).astype(F)
    pd, pi = ballquery.three_nn_plain(torch.from_numpy(q), torch.from_numpy(x), 3)
    pm, pa = chamfer.directed_nn_plain(torch.from_numpy(q), torch.from_numpy(x))
    for lanes, group in ((1, 4), (4, 2), (16, 1), (32, 1)):
        got_d, got_i = k2_scan(q, x, 3, lanes)
        np.testing.assert_array_equal(got_i, pi.numpy())
        np.testing.assert_array_equal(got_d.view(np.int32), pd.numpy().view(np.int32))
        got_m, got_a = k11_scan(q, x, lanes, group)
        np.testing.assert_array_equal(got_a, pa.numpy())
        np.testing.assert_array_equal(got_m.view(np.int32), pm.numpy().view(np.int32))
    if n % 128 == 0 and s % 128 == 0:  # the JAX kernel's shapes: same argmin
        _, wa = _directed_min_sqdist(jnp.asarray(q), jnp.asarray(x), True)
        np.testing.assert_array_equal(pa.numpy(), np.asarray(wa))
    _, wi = three_nn_pallas(jnp.asarray(q), jnp.asarray(x), 3, interpret=True)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(wi))


def test_merge_keeps_the_k_smallest_of_any_two_lists():
    """One butterfly level against a brute-force merge, on lists that tie
    in distance and hold empty slots (inf, kNone)."""
    rs = np.random.RandomState(0)
    for K in (1, 2, 3):
        for _ in range(200):
            pairs = []
            for _lane in range(2):
                d = rs.choice([0.0, 0.5, 1.0, np.inf], size=K).astype(F)
                i = rs.choice(64, size=K, replace=False).astype(np.int64)
                i[d == np.inf] = NONE
                order = np.lexsort((i, d))
                pairs.append((d[order], i[order]))
            if len(set(pairs[0][1]) & set(pairs[1][1]) - {NONE}):
                continue  # two lanes never hold one source
            ld = np.stack([p[0] for p in pairs])[None, None]
            li = np.stack([p[1] for p in pairs])[None, None]
            gd, gi = butterfly(ld, li)
            d = np.concatenate([p[0] for p in pairs])
            i = np.concatenate([p[1] for p in pairs])
            order = np.lexsort((i, d))[:K]
            np.testing.assert_array_equal(gd[0, 0], d[order])
            np.testing.assert_array_equal(gi[0, 0], i[order])


def _reference_plan(clouds, n, s, groups, min_warps, max_lanes=32, max_sources=None):
    """The plan rule by enumeration: the first G of ``groups``, then the
    fewest lanes, among the plans the kernel takes whose lanes read at
    least NEAREST_MIN_SOURCES sources, that launch ``min_warps`` warps an SM
    with no lane reading more than ``max_sources``; else the most lanes
    allowed at the last G."""
    enough = min_warps * kernels.SMS
    allowed = [l for l in LANES if l <= max_lanes
               and (l == 1 or l * ballquery.NEAREST_MIN_SOURCES <= s)]
    for g in groups:
        for l in allowed:
            if (ballquery.nearest_warps(clouds, n, l, g) >= enough
                    and (max_sources is None or s <= l * max_sources)):
                return l, g
    return allowed[-1], groups[-1]


def test_nearest_plans_cover_every_shape():
    """Every (clouds, targets, sources) gets lanes a target and targets a
    lane that the kernel instantiates, by each kernel's rule: K2 the fewest
    lanes (one target a lane), at most THREE_NN_MAX_LANES, for
    THREE_NN_WARPS warps an SM with at most THREE_NN_MAX_SOURCES sources a
    lane; K11 four, two or one points a lane, then the fewest lanes, for
    CHAMFER_NN_WARPS warps an SM.  Every target is written by one lane and
    the grid fits."""
    sizes = (1, 2, 3, 4, 7, 16, 31, 33, 64, 100, 256, 1000, 1024, 4096, 20000)
    for clouds in (1, 2, 6, 9, 54, 64, 72, 1000, 65535):
        for n in sizes:
            for s in sizes:
                k2 = ballquery.three_nn_plan(clouds, n, s), 1
                assert k2 == _reference_plan(
                    clouds, n, s, (1,), ballquery.THREE_NN_WARPS,
                    ballquery.THREE_NN_MAX_LANES, ballquery.THREE_NN_MAX_SOURCES)
                k11 = chamfer.chamfer_nn_plan(clouds, n, s)
                assert k11 == _reference_plan(clouds, n, s, GROUPS,
                                              chamfer.CHAMFER_NN_WARPS)
                for lanes, group in (k2, k11):
                    assert lanes in LANES and group in GROUPS
                    assert lanes == 1 or lanes * ballquery.NEAREST_MIN_SOURCES <= s
                    assert -(-n // (WARPS * 32 // lanes * group)) < 2 ** 31
    # the flagship shapes, as the sweep chose them (PERF.md §6)
    assert [ballquery.three_nn_plan(9, n, s) for n, s in FP_STAGES] == [4, 8, 8, 8]
    assert [ballquery.three_nn_plan(54, n, s) for n, s in FP_STAGES] == [4, 4, 1, 2]
    assert chamfer.chamfer_nn_plan(64, 1024, 1024) == (8, 4)
    assert chamfer.chamfer_nn_plan(6, 1024, 1024) == (32, 2)
    for n in (1, 5, 33, 100, 257, 1024, 3000):
        for lanes in LANES:
            for group in GROUPS:
                assert (writers(n, lanes, group) == 1).all()
    for bad in ((0, 4, 4), (4, 0, 4), (4, 4, 0)):
        with pytest.raises(ValueError):
            ballquery.three_nn_plan(*bad)

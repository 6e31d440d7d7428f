"""The launch plans of K7 and K8 (``lsdm_tpu_torch/ops/rowmlp.py``), on
the CPU: no GPU is needed to check what a plan asks of the card.

For every flagship stage (``models/pointnet2.py``: sa1-sa4 with nsample
32, fp4-fp1 with fp1 carrying the head and conv2) at b1 (9 clouds) and b8
(72 clouds), and for the ragged shapes of ``tests/test_torch_cuda.py``: the
shared memory fits a block, the cluster divides the grid, and a numpy
model of the kernels' loops (``csrc/rowmlp.cuh:dense_tiles``: blocks,
cluster ranks, column slices, block tiles, the threads' register tiles)
covers every (cloud, row, column) of every layer exactly once.
"""

import dataclasses

import numpy as np
import pytest

from lsdm_tpu_torch.ops import rowmlp

NSAMPLE = 32
# (points, centres, widths F1..FL)
SA_STAGES = {"sa1": (1024, 1024, (32, 32, 64)),
             "sa2": (1024, 256, (64, 64, 128)),
             "sa3": (256, 64, (128, 128, 256)),
             "sa4": (64, 16, (256, 256, 512))}
# (targets, sources, widths F0..FL)
FP_STAGES = {"fp4": (64, 16, (768, 256, 256)),
             "fp3": (256, 64, (384, 256, 256)),
             "fp2": (1024, 256, (320, 256, 128)),
             "fp1": (1024, 1024, (128, 128, 128, 128, 128, 3))}
CLOUDS = {"b1": 9, "b8": 72}
# blocks a plan promises at b1 where the card has more SMs than that
# (ops/rowmlp.py's docstring gives the reasons)
B1_BLOCKS = {"fp3": 72, "fp4": 36}


def _plan(stage, clouds):
    if stage in SA_STAGES:
        n, s, widths = SA_STAGES[stage]
        return rowmlp.plan_sa(clouds, n, s, NSAMPLE, widths), s, NSAMPLE, widths
    n, s, widths = FP_STAGES[stage]
    return rowmlp.plan_fp(clouds, n, s, widths), n, 1, widths


def _coverage(plan, clouds, items, group, fouts):
    """Per layer, how often the kernels' loops compute each (cloud, row,
    column): a block (x, cloud) is rank x % cluster of the cluster that
    takes items [x // cluster * rows, + rows), group rows an item."""
    counts = [np.zeros((clouds, items * group, f), np.int64) for f in fouts]
    for x in range(plan.grid[0]):
        rank = x % plan.cluster
        i0 = x // plan.cluster * plan.rows
        m = min(plan.rows, items - i0) * group
        assert m > 0
        for layer, fout in enumerate(fouts):
            tile = plan.tiles[layer]
            tm, tn, wy = rowmlp.TILES[tile]
            bm, bn, _ = rowmlp.tile_dims(tile)
            warps = rowmlp.THREADS // 32
            assert bm == wy * 8 * tm and bn == warps // wy * 4 * tn
            assert -(-m // bm) * bm <= plan.ldm  # the rows a tile reads
            lo, hi = rowmlp.col_slice(fout, plan.cluster, rank)
            for n0 in range(lo, hi, bn):
                for m0 in range(0, m, bm):
                    for tid in range(rowmlp.THREADS):
                        lane, warp = tid % 32, tid // 32
                        # csrc/rowmlp.cuh:dense_tiles' first row and column
                        ty = warp % wy * 8 * tm + 4 * (lane % 8)
                        tx = warp // wy * 4 * tn + 4 * (lane // 8)
                        rows = [ty + i if i < 4 else ty + 4 * tm + i - 4
                                for i in range(tm)]
                        cols = [tx + j if j < 4 else tx + 2 * tn + j - 4
                                for j in range(tn)]
                        r = np.array([m0 + q for q in rows])
                        c = np.array([n0 + q for q in cols])
                        r, c = r[r < m], c[c < hi]
                        counts[layer][:, i0 * group + r[:, None], c[None, :]] += 1
    return counts


@pytest.mark.parametrize("batch", sorted(CLOUDS))
@pytest.mark.parametrize("stage", sorted(SA_STAGES) + sorted(FP_STAGES))
def test_flagship_plan_fits_and_covers_every_output_once(stage, batch):
    clouds = CLOUDS[batch]
    plan, items, group, widths = _plan(stage, clouds)
    assert plan.smem <= rowmlp.SMEM_MAX == 232_448
    assert plan.grid[0] % plan.cluster == 0
    assert plan.grid == (-(-items // plan.rows) * plan.cluster, clouds)
    assert plan.ldm % 32 == 4 and plan.ldm >= plan.m == plan.rows * group
    assert len(plan.tiles) == len(widths) - 1
    # the coverage is the same for every cloud: model one, scale the grid
    one = dataclasses.replace(plan, grid=(plan.grid[0], 1))
    for counts in _coverage(one, 1, items, group, widths[1:]):
        assert (counts == 1).all()
    if batch == "b1":
        assert plan.blocks >= B1_BLOCKS.get(stage, rowmlp.SMS)


@pytest.mark.parametrize("kind,shape", [
    # the card tests' ragged SA cases: (points, centres, nsample, widths)
    ("sa", (64, 13, 16, (8, 8, 16))),
    ("sa", (37, 5, 8, (8, 8))),
    ("sa", (100, 24, 32, (8, 16, 16, 24))),
    ("sa", (64, 16, 32, (8, 256, 256, 512))),
    ("sa", (50, 7, 8, (8, 67, 20))),
    ("sa", (30, 3, 5, (12, 10))),
    # FP: (targets, sources, widths)
    ("fp", (64, 2, (16, 8, 16))),
    ("fp", (50, 50, (10, 16, 8, 3))),
    ("fp", (40, 16, (768, 256, 256))),
    ("fp", (33, 7, (10, 12))),
    ("fp", (45, 11, (67, 36, 5))),
])
@pytest.mark.parametrize("cluster", [0, 2, 4])
def test_ragged_plan_covers_every_output_once(kind, shape, cluster):
    # the plan's rows, on the plan's cluster or a forced one
    if kind == "sa":
        n, s, ns, widths = shape
        plan, items, group = rowmlp.plan_sa(1, n, s, ns, widths), s, ns
        if cluster:
            plan = rowmlp.layout_sa(1, n, s, ns, widths, plan.rows, cluster)
    else:
        n, s, widths = shape
        plan, items, group = rowmlp.plan_fp(1, n, s, widths), n, 1
        if cluster:
            plan = rowmlp.layout_fp(1, n, s, widths, plan.rows, cluster)
    assert plan.smem <= rowmlp.SMEM_MAX
    assert plan.grid[0] % plan.cluster == 0
    if cluster:
        assert plan.cluster == cluster
    for counts in _coverage(plan, 1, items, group, widths[1:]):
        assert (counts == 1).all()


@pytest.mark.parametrize("fout,cluster", [(3, 1), (3, 2), (256, 4), (130, 4),
                                          (512, 2), (67, 4), (20, 8)])
def test_column_slices_partition_the_layer(fout, cluster):
    seen = []
    for rank in range(cluster):
        lo, hi = rowmlp.col_slice(fout, cluster, rank)
        assert (lo % 4 == 0 or lo == fout) and lo <= hi
        seen += range(lo, hi)
    assert seen == list(range(fout))


def test_plans_refuse_what_no_block_holds():
    with pytest.raises(ValueError):  # 9 kernel layers
        rowmlp.plan_fp(1, 64, 16, (16,) * 10)
    with pytest.raises(ValueError):  # a 4096-wide input of 32 rows: 540 KB
        rowmlp.plan_fp(1, 64, 16, (4096, 4096, 8))


@pytest.mark.parametrize("stage", sorted(SA_STAGES) + sorted(FP_STAGES))
def test_flagship_plans_take_the_measured_rows_and_cluster(stage):
    if stage in SA_STAGES:
        n, s, widths = SA_STAGES[stage]
        key, plan = ("sa", n, s, NSAMPLE, widths), rowmlp.plan_sa
        args = (n, s, NSAMPLE, widths)
    else:
        n, s, widths = FP_STAGES[stage]
        key, plan = ("fp", n, s, widths), rowmlp.plan_fp
        args = (n, s, widths)
    table = rowmlp.MEASURED[key]
    for clouds, (rows, cluster) in table.items():
        p = plan(clouds, *args)
        assert (p.rows, p.cluster) == (rows, cluster)
    # a cloud count between takes the nearest measured one's choice
    p = plan(64, *args)
    assert (p.rows, p.cluster) == table[72]


def test_other_shapes_follow_the_rule():
    # cluster 1; the most rows whose blocks fit two to an SM and give
    # every SM two: 64 centres of 32 rows in 9 clouds make 576 blocks of
    # one centre, 288 of two, 144 of four
    p = rowmlp.plan_sa(9, 256, 64, 32, (64, 64, 64))
    assert (p.rows, p.cluster, p.blocks) == (2, 1, 288)
    # one cloud: no row count gives 264 blocks, so the fewest rows
    p = rowmlp.plan_fp(1, 200, 50, (40, 24, 8))
    assert (p.rows, p.cluster, p.blocks) == (32, 1, 7)


@pytest.mark.parametrize("m,cols,tile", [
    (256, 32, 6),    # sa1's layer 2: 256 x 32 exactly, 4 x 8 a thread
    (256, 64, 2),    # sa1's layer 3: 256 x 64, 8 x 8 a thread
    (32, 3, 7),      # conv2 on 32 rows: the least padding, fewest rows
    (64, 3, 8),
    (32, 256, 3),
])
def test_pick_tile_pads_least_then_loads_least(m, cols, tile):
    assert rowmlp.pick_tile(m, cols) == tile

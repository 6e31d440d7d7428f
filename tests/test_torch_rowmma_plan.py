"""The bf16 modes of K7 and K8 on the CPU: their launch plans
(``ops/rowmlp.py:plan_sa_bf16`` / ``plan_fp_bf16``) and the bf16 weight
copies a bf16 model keeps per stage (``rowmlp.kept_bf16_operands``).

For every flagship stage at b1 (9 clouds) and b8 (72 clouds), and for the
ragged shapes of the card tests: a numpy model of the kernels' loops
(``csrc/rowmma.cuh:run_layer``: blocks, passes, the warps' 32-row groups
and column slices of each 64-column weight chunk, their valid n8 tiles)
covers every (row, column) of every layer exactly once, the plan fits a
block's shared memory, and K7's max in registers (``store_max``) stores
every (centre, column) once.  The caps are no lower than the float32
design's.  The kept copies are the folded weights rounded to bf16, made
once across forwards and made again when a weight or a BatchNorm
statistic changes.
"""

import numpy as np
import pytest
import torch

from lsdm_tpu_torch.models.pointnet2 import (
    Conv1x1, PointNetFeaturePropagation, PointNetSetAbstraction, bn_train, fold_head,
    fold_mlp)
from lsdm_tpu_torch.ops import rowmlp
from lsdm_tpu_torch.ops.sa_fused import fold_conv_bn

from test_torch_rowmlp import CLOUDS, FP_STAGES, NSAMPLE, SA_STAGES

# the float32 design's caps at the flagship widths, which the bf16 mode took
# before its own design: points at sa1-sa4, sources at fp4-fp1
F32_SA_CAPS = {"sa1": 12_392, "sa2": 11_800, "sa3": 10_616, "sa4": 8_248}
F32_FP_CAPS = {"fp4": 3_728, "fp3": 7_184, "fp2": 7_760, "fp1": 10_640}


def _plan(stage, clouds):
    if stage in SA_STAGES:
        n, s, widths = SA_STAGES[stage]
        return rowmlp.plan_sa_bf16(clouds, n, s, NSAMPLE, widths), s, NSAMPLE, widths
    n, s, widths = FP_STAGES[stage]
    return rowmlp.plan_fp_bf16(clouds, n, s, widths), n, 1, widths


def _warps(plan):
    """(wm, wn, NJ) of each of the 8 warps (csrc/rowmma.cuh:run_layer)."""
    wmn = plan.mt // 2
    wn_count = 8 // wmn
    nj = rowmlp.BF16_NB // 8 // wn_count
    return [(w % wmn, w // wmn, nj) for w in range(8)]


def _coverage(plan, items, group, fouts):
    """Per layer, how often the kernels' loops compute each (row, column)
    of one cloud: block x takes items [x rows, + rows), group rows an item;
    a layer of fout outputs runs its columns up to round16(fout)."""
    counts = [np.zeros((items * group, f), np.int64) for f in fouts]
    for x in range(plan.grid[0]):
        i0 = x * plan.rows
        m = min(plan.rows, items - i0) * group
        assert 0 < m <= 16 * plan.mt * plan.passes
        for layer, fout in enumerate(fouts):
            np_ = -(-fout // 16) * 16
            for p in range(plan.passes):
                for n0 in range(0, np_, rowmlp.BF16_NB):
                    for wm, wn, nj_max in _warps(plan):
                        row0 = 16 * plan.mt * p + 32 * wm
                        c0 = n0 + 8 * nj_max * wn
                        nj = max(0, min(nj_max, (np_ - c0) // 8))
                        rows = np.arange(row0, row0 + 32)
                        cols = np.arange(c0, c0 + 8 * nj)
                        rows, cols = rows[rows < m], cols[cols < fout]
                        counts[layer][i0 * group + rows[:, None], cols[None, :]] += 1
    return counts


def _max_stores(plan, items, ns, fout):
    """How often K7's max in registers (csrc/rowmma.cuh:store_max) stores
    each (centre, column): per warp and lane, its rows' centres after the
    shuffles, stored by the lanes whose g has no bit below the rows a
    centre spans among a column's 8 lanes."""
    counts = np.zeros((items, fout), np.int64)
    lanes = min(ns, 8)
    np_ = -(-fout // 16) * 16
    for x in range(plan.grid[0]):
        i0 = x * plan.rows
        nq = min(plan.rows, items - i0)
        for p in range(plan.passes):
            for n0 in range(0, np_, rowmlp.BF16_NB):
                for wm, wn, nj_max in _warps(plan):
                    row0 = 16 * plan.mt * p + 32 * wm
                    c0 = n0 + 8 * nj_max * wn
                    nj = max(0, min(nj_max, (np_ - c0) // 8))
                    for j in range(nj):
                        for lane in range(32):
                            g, t = lane >> 2, lane & 3
                            n = c0 + 8 * j + 2 * t
                            if g & (lanes - 1) or n >= fout:
                                continue
                            for m in range(2):
                                for h in range(2):
                                    if (ns >= 16 and h) or (ns == 32 and m):
                                        continue
                                    centre = (row0 + 16 * m + g + 8 * h) // ns
                                    if centre >= nq:
                                        continue
                                    for q in range(2):
                                        if n + q < fout:
                                            counts[i0 + centre, n + q] += 1
    return counts


@pytest.mark.parametrize("batch", sorted(CLOUDS))
@pytest.mark.parametrize("stage", sorted(SA_STAGES) + sorted(FP_STAGES))
def test_bf16_flagship_plan_fits_and_covers_every_output_once(stage, batch):
    clouds = CLOUDS[batch]
    plan, items, group, widths = _plan(stage, clouds)
    assert plan.smem <= rowmlp.SMEM_MAX == 232_448
    assert plan.grid == (-(-items // plan.rows), clouds)
    assert plan.m == plan.rows * group <= 16 * plan.mt * plan.passes
    assert plan.ld0 % 16 == 8 and plan.ld1 % 16 == 8 and plan.kc in rowmlp.BF16_KC
    # a weight chunk spans the widest layer input, rounded up, or 64 or 128 k
    assert plan.kc >= min(64, -(-max(widths[:-1]) // 16) * 16)
    # every layer reads its input, rounded up to 16, from its buffer
    for layer, fin in enumerate(widths[:-1]):
        assert -(-fin // 16) * 16 + 8 <= (plan.ld1 if layer % 2 else plan.ld0)
    for counts in _coverage(plan, items, group, widths[1:]):
        assert (counts == 1).all()
    if stage in SA_STAGES:  # nsample 32: the max in registers, no atomics
        assert plan.red == 0
        assert (_max_stores(plan, items, NSAMPLE, widths[-1]) == 1).all()


@pytest.mark.parametrize("kind,shape", [
    # the card tests' ragged SA cases: (points, centres, nsample, widths)
    ("sa", (64, 13, 16, (8, 8, 16))),
    ("sa", (37, 5, 8, (8, 8))),
    ("sa", (100, 24, 32, (8, 16, 16, 24))),
    ("sa", (100, 37, 16, (8, 64, 67, 20))),
    ("sa", (50, 7, 8, (8, 12, 10, 3))),
    ("sa", (30, 3, 5, (12, 10))),
    ("sa", (600, 2, 300, (8, 16, 24))),   # two passes of 256 rows
    # FP: (targets, sources, widths)
    ("fp", (64, 2, (16, 8, 16))),
    ("fp", (50, 50, (10, 16, 8, 3))),
    ("fp", (40, 16, (768, 256, 256))),
    ("fp", (45, 11, (67, 36, 5))),
])
def test_bf16_ragged_plan_covers_every_output_once(kind, shape):
    if kind == "sa":
        n, s, ns, widths = shape
        plan, items, group = rowmlp.plan_sa_bf16(1, n, s, ns, widths), s, ns
    else:
        n, s, widths = shape
        plan, items, group = rowmlp.plan_fp_bf16(1, n, s, widths), n, 1
    assert plan.smem <= rowmlp.SMEM_MAX
    for counts in _coverage(plan, items, group, widths[1:]):
        assert (counts == 1).all()
    if kind == "sa":
        regs = ns <= 32 and ns & (ns - 1) == 0
        assert plan.red == (0 if regs else plan.rows * widths[-1])
        if regs:
            assert (_max_stores(plan, items, ns, widths[-1]) == 1).all()


@pytest.mark.parametrize("ns", [1, 2, 4, 8, 16, 32])
def test_bf16_max_in_registers_stores_each_centre_once(ns):
    widths = (8, 24, 40)
    for rows in rowmlp.sa_rows_bf16(ns):
        plan = rowmlp.layout_sa_bf16(1, 64, 4 * rows + 1, ns, widths, rows)
        assert (_max_stores(plan, 4 * rows + 1, ns, widths[-1]) == 1).all()


def test_bf16_caps_are_no_lower_than_the_float32_designs():
    for stage, (_, _, widths) in SA_STAGES.items():
        cap = rowmlp.sa_max_points_bf16(NSAMPLE, widths)
        assert cap >= F32_SA_CAPS[stage] == rowmlp.sa_max_points(NSAMPLE, widths)
        plan = rowmlp.layout_sa_bf16(1, cap, 1, NSAMPLE, widths, 1)
        assert plan.smem <= rowmlp.SMEM_MAX < plan.smem + 16
        # the rule's plan at the cap fits too (its wider chunks only where
        # they fit)
        assert rowmlp.plan_sa_bf16(1, cap, 16, NSAMPLE, widths).smem <= rowmlp.SMEM_MAX
    for stage, (_, _, widths) in FP_STAGES.items():
        cap = rowmlp.fp_max_sources_bf16(widths)
        assert cap >= F32_FP_CAPS[stage] == rowmlp.fp_max_sources(widths)
        plan = rowmlp.layout_fp_bf16(1, 1, cap, widths, rowmlp.BF16_FP_ROWS[0])
        assert plan.smem <= rowmlp.SMEM_MAX < plan.smem + 16
        assert rowmlp.plan_fp_bf16(1, 64, cap, widths).smem <= rowmlp.SMEM_MAX


def _randomize(module, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for t in module.parameters():
            t.copy_(torch.randn(t.shape, generator=g) * 0.3)
        for bn in module.modules():
            if isinstance(bn, torch.nn.BatchNorm1d):
                bn.running_mean.copy_(torch.randn(bn.num_features, generator=g) * 0.1)
                bn.running_var.copy_(torch.rand(bn.num_features, generator=g) + 0.5)


def _stages():
    bf = torch.bfloat16
    sa = PointNetSetAbstraction(16, 0.6, 8, 3 + 8, (20, 24), impl="fused", dtype=bf)
    fp = PointNetFeaturePropagation(13, (16, 12), impl="fused", dtype=bf)
    _randomize(sa, 0)
    _randomize(fp, 1)
    return sa, fp


def _head(seed):
    """The backbone's head modules (conv1, bn1, conv2) that fp1 carries."""
    conv1, bn1, conv2 = Conv1x1(12, 12, 1), torch.nn.BatchNorm1d(12), Conv1x1(12, 3, 1)
    for m in (conv1, bn1, conv2):
        _randomize(m, seed)
    return conv1, bn1, conv2


def _inputs(seed=3):
    g = torch.Generator().manual_seed(seed)
    xyz = torch.rand(2, 32, 3, generator=g)
    return xyz, torch.randn(2, 32, 8, generator=g)


def _run_sa(sa):
    xyz, feats = _inputs()
    return sa(xyz, feats)[1]


def _run_fp(fp, head):
    xyz, feats = _inputs()
    return fp(xyz, xyz[:, :8].contiguous(), feats[..., :5].contiguous(),
              feats[:, :8].contiguous(), head=head)


def test_bf16_operands_are_the_folded_weights_rounded_and_padded():
    sa, fp = _stages()
    head = _head(2)
    _run_sa(sa.eval())
    _run_fp(fp.eval(), head)
    ops_sa = rowmlp._KEPT[sa][1]
    ops_fp = rowmlp._KEPT[fp][1]
    want_sa = [fold_conv_bn(c, b) for c, b in zip(sa.mlp_convs, sa.mlp_bns)]
    want_fp = fold_mlp(fp) + fold_head(*head)
    for ops, want, sa_ in ((ops_sa, want_sa, True), (ops_fp, want_fp, False)):
        assert isinstance(ops, rowmlp.Bf16Operands) and len(ops) == len(want)
        for (w, b), (ww, wb) in zip(ops, want):  # the folded layers, detached
            assert not w.requires_grad and torch.equal(w, ww.detach())
            assert torch.equal(b, wb.detach())
        for got, (w, _) in zip(ops.weights, want[1 if sa_ else 0:]):
            fin, fout = w.shape
            assert got.dtype == torch.bfloat16
            assert got.shape == (-(-fout // 16) * 16, -(-fin // 16) * 16)
            assert torch.equal(got[:fout, :fin].float(), w.detach().t().to(torch.bfloat16).float())
            assert not got[fout:].any() and not got[:, fin:].any()  # zero padding
        assert ops.biases == tuple(b for _, b in ops[1 if sa_ else 0:])
    exact = want_sa[0][0].detach().to(torch.bfloat16).float()
    assert torch.equal(ops_sa.w1, exact) and torch.equal(ops_sa.w1x, exact[:3])


def test_bf16_operands_are_made_once_and_again_when_the_weights_move(monkeypatch):
    sa, fp = _stages()
    head = _head(4)
    made = []
    real = rowmlp.bf16_operands
    monkeypatch.setattr(rowmlp, "bf16_operands",
                        lambda folded, sa_: made.append(sa_) or real(folded, sa_))
    sa.eval(), fp.eval()
    with torch.no_grad():
        first = _run_sa(sa), _run_fp(fp, head)
        again = _run_sa(sa), _run_fp(fp, head)
    assert made == [True, False]  # once across two forwards
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    kept = rowmlp._KEPT[sa][1], rowmlp._KEPT[fp][1]

    # an in-place weight update (as an optimizer step makes)
    with torch.no_grad():
        sa.mlp_convs[1].weight.add_(0.5)
        head[2].weight.add_(0.5)   # the head fp1 carries counts too
        moved = _run_sa(sa), _run_fp(fp, head)
    assert made == [True, False] * 2
    assert not any(torch.equal(a, b) for a, b in zip(first, moved))
    assert rowmlp._KEPT[sa][1] is not kept[0] and rowmlp._KEPT[fp][1] is not kept[1]

    # load_state_dict copies into the same storage: the version moves
    sa.load_state_dict({k: v.clone() for k, v in sa.state_dict().items()})
    fp.load_state_dict(fp.state_dict())
    with torch.no_grad():
        _run_sa(sa), _run_fp(fp, head)
    assert made == [True, False] * 3

    # a train-mode forward moves the BatchNorms' running statistics
    sa.train()
    _run_sa(sa)
    sa.eval()
    bn_train(head[1], torch.randn(40, 12))  # as the backbone's train forward
    with torch.no_grad():
        _run_sa(sa), _run_fp(fp, head)
    assert made == [True, False] * 4
    with torch.no_grad():
        _run_sa(sa), _run_fp(fp, head)
    assert made == [True, False] * 4

"""K10 (the train select-gather) on the CPU: its plan, its shared-memory
cap, and a transcription of its gather's walk against the plain version.

``csrc/sg_fused.cu`` writes each center's (nsample, C) slab as 16-byte
stores: up to 3 floats one a lane before the slab's first 16-byte
boundary, then float4s, lane l taking float4s l, l + 32, ..., whose
(slot, column) position it advances 128 elements a step by one add and
one compare, then up to 3 floats after the last.  The transcription below
runs that walk lane by lane, with slabs at every offset mod 4 from a
16-byte boundary, and must write every element once with the plain
version's value.
"""

import numpy as np
import pytest
import torch

from lsdm_tpu_torch import kernels
from lsdm_tpu_torch.ops import ballquery, sg_fused


def _walk(slots, cloud, q, c, start):
    """The elements of one slab as csrc/sg_fused.cu writes them: slab
    element e sits at float offset start + e from a 16-byte boundary.
    Returns the slab and how often each element was written."""
    nsample = len(slots)
    total = nsample * c
    slab = np.zeros(total, np.float32)
    writes = np.zeros(total, np.int64)

    def value(k, cc):
        v = cloud[slots[k], cc]
        return np.float32(v - q[cc]) if cc < 3 else v

    def put(e, v):
        slab[e] = v
        writes[e] += 1

    head = min((-start) % 4, total)
    body = (total - head) >> 2
    k_step, c_step = 128 // c, 128 - (128 // c) * c
    for lane in range(32):
        if lane < head:
            put(lane, value(0, lane))
        k_lane = 4 * lane // c  # once a kernel, not a slab
        c_lane = 4 * lane - k_lane * c
        k, cc = k_lane, c_lane + head
        if cc >= c:
            cc, k = cc - c, k + 1
        for v in range(lane, body, 32):
            kk, ce = k, cc
            for i in range(4):
                put(head + 4 * v + i, value(kk, ce))
                ce += 1
                if ce == c:
                    ce, kk = 0, kk + 1
            k, cc = k + k_step, cc + c_step
            if cc >= c:
                cc, k = cc - c, k + 1
        if lane < total - head - 4 * body:
            put(total - 1 - lane, value(nsample - 1, c - 1 - lane))
    return slab, writes


@pytest.mark.parametrize("c", [3, 6, 67, 131, 259])
@pytest.mark.parametrize("nsample", [1, 31, 32, 64])
def test_gather_walk_equals_the_plain_version(c, nsample):
    rs = np.random.RandomState(c * 100 + nsample)
    n, s = 80, 7
    xyz = torch.from_numpy(rs.rand(1, n, 3).astype(np.float32))
    new_xyz = xyz[:, :s].clone()
    new_xyz[0, 3] = 50.0  # an empty ball: all n - 1
    base = torch.cat([xyz, torch.from_numpy(rs.randn(1, n, c - 3).astype(np.float32))],
                     -1)
    want, idx = sg_fused.select_gather_plain(0.3, nsample, xyz, new_xyz, base)
    cloud = base[0].numpy()
    for q in range(s):
        # the slab of center q of a freshly allocated output starts q * nsample
        # * c floats past a 16-byte boundary; every start mod 4 is also tried
        for start in {q * nsample * c % 4, 0, 1, 2, 3}:
            slab, writes = _walk(idx[0, q].numpy(), cloud, new_xyz[0, q].numpy(),
                                 c, start)
            assert (writes == 1).all(), (q, start)
            np.testing.assert_array_equal(slab, want[0, q].reshape(-1).numpy())


@pytest.mark.parametrize("nsample", [1, 32, 64, 128])
@pytest.mark.parametrize("queries", [1, 2, 4])
def test_select_gather_cap_is_the_shared_memory_boundary(nsample, queries):
    cap = sg_fused.select_gather_max_points(nsample, queries)
    assert cap % sg_fused.SG_ROUND_POINTS == 0
    assert sg_fused.select_gather_smem(cap, nsample, queries) <= kernels.SMEM_MAX
    assert sg_fused.select_gather_smem(cap + 1, nsample, queries) > kernels.SMEM_MAX
    # K1's cloud alone takes 14,464 points; K10 gives up what its slots need
    assert cap <= ballquery.BALL_MAX_POINTS
    assert cap >= 4096 + 8192  # far past the port's largest --pcd_points


def test_select_gather_cap_at_the_train_flagship():
    # sa1-sa4's 32 samples: 14,336 points at 4 centers a warp, 14,464 at 1
    assert sg_fused.select_gather_max_points(32, 4) == 14336
    assert sg_fused.select_gather_max_points(32, 1) == 14464


@pytest.mark.parametrize("clouds", [9, 54, 72])
def test_select_gather_plan(clouds):
    # sa1's small slabs take K1's plan; sa2-sa4's large slabs one center a warp
    slabs = [32 * c for c in (6, 67, 131, 259)]
    got = [sg_fused.select_gather_plan(clouds, s, slab)
           for s, slab in zip((1024, 256, 64, 16), slabs)]
    assert got == [ballquery.ball_query_plan(clouds, 1024), 1, 1, 1]
    assert got[0] == {9: 2, 54: 4, 72: 4}[clouds]


def test_select_gather_wrapper_on_cpu_takes_clouds_past_the_old_cap():
    # the plain version has no cap; the CUDA wrapper's cap is the kernel's
    rs = np.random.RandomState(0)
    xyz = torch.from_numpy(rs.rand(1, 9000, 3).astype(np.float32))
    new_xyz = xyz[:, :4].contiguous()
    kernels.reset_launches()
    got, idx = sg_fused.select_gather_kernel(0.05, 8, xyz, new_xyz, xyz)
    want, widx = sg_fused.select_gather_plain(0.05, 8, xyz, new_xyz, xyz)
    assert torch.equal(idx, widx) and torch.equal(got, want)
    assert kernels.LAUNCHES["select_gather"] == 0

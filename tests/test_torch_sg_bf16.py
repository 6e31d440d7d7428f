"""K10's bf16 mode (``csrc/sg_fused_bf16.cu``) on the CPU: a transcription
of its gather, a source row at a time, and its launch plan.

The kernel writes each center's (nsample, C) slab of bf16 values as
16-byte stores: lane l of part p (of the P warps a slab) takes chunks
32 p + l, + 32 P, ... of the slab's aligned body, 8 values each from
(slot k, column c), walked without division.  It copies each chunk a
piece at a time, a piece being the values that lie in one source row:
the one or two aligned 16-byte blocks of base that hold the piece,
shifted into place by word selects and a funnel shift (``shift_in``),
the pieces merged by position, the center's bf16 coordinates subtracted
from a row's first three values by one packed bf16x2 subtraction
(``center_at``, ``sub.rn.bf16x2``).  Where C >= 8 a chunk holds at most
two pieces, loaded together (``load_pieces``, ``assemble``); where C < 8
(a chunk across up to three slots) it is read one value a load.  The transcription below runs that walk lane
by lane on the words the kernel holds, for slabs at every offset mod 8
from a 16-byte boundary, clouds at several offsets, C = 3, 6, 67, 131,
259 and 1, 2 or 8 warps a slab: every (slot, column) is read once, every
value written once, every 16-byte store aligned, and the slab equals the
plain version's bit for bit.  The packed subtraction, which rounds the
exact difference once, is held to the float32 difference rounded to bf16
(the plain version's) on pairs of bf16 values at every exponent gap.
"""

import math
import struct

import numpy as np
import pytest
import torch

from lsdm_tpu_torch import kernels
from lsdm_tpu_torch.ops import ballquery, sg_fused

M32 = 0xFFFFFFFF


def _words(vals):
    """8 bf16 bit patterns as the 4 little-endian 32-bit words of a block."""
    return [int(vals[2 * i]) | (int(vals[2 * i + 1]) << 16) for i in range(4)]


def _funnel_r(lo, hi, sh):
    """__funnelshift_r(lo, hi, sh) for sh in {0, 16}."""
    return ((hi << 32 | lo) >> sh) & M32


def shift_in(a, b, u):
    """csrc/sg_fused_bf16.cu:shift_in on blocks a, b (4 words each)."""
    w = list(a) + (list(b) if u & 8 else list(a))
    if u & 4:
        w = w[2:] + w[6:]
    if u & 2:
        w = w[1:] + w[7:]
    return [_funnel_r(w[i], w[i + 1], (u & 1) * 16) for i in range(4)]


def center_at(c01, c2, p):
    """csrc/sg_fused_bf16.cu:center_at: the three coordinates at values p,
    p + 1, p + 2, zero elsewhere."""
    u = 8 - p
    w = [c01, c2, 0, 0, 0, 0, 0, 0] if u & 8 else [0, 0, 0, 0, c01, c2, 0, 0]
    if u & 4:
        w = w[2:] + w[6:]
    if u & 2:
        w = w[1:] + w[7:]
    return [_funnel_r(w[i], w[i + 1], (u & 1) * 16) for i in range(4)]


def _bf16_of_bits(bits):
    return torch.tensor(np.array(bits, np.uint16).view(np.int16)).view(torch.bfloat16)


def _bits_of_bf16(t):
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


def _round_bf16(x):
    """float64 values rounded once to bf16 (nearest even), as bit patterns."""
    m, e = np.frexp(x)
    r = np.ldexp(np.rint(np.ldexp(m, 8)), e - 8)  # 8 significant bits
    return _bits_of_bf16(torch.from_numpy(r.astype(np.float32)).bfloat16())


def _float(bits):
    """A bf16 bit pattern's value."""
    return struct.unpack("<f", struct.pack("<I", (bits & 0xFFFF) << 16))[0]


def _bits(x):
    """The bf16 pattern of x, a float of at most 8 significant bits."""
    return struct.unpack("<I", struct.pack("<f", x))[0] >> 16


def sub_bf16x2(a, b):
    """sub.rn.bf16x2: per half, the exact difference rounded once to 8
    significant bits, nearest even (Python's round)."""
    out = 0
    for sh in (0, 16):
        d = _float(a >> sh) - _float(b >> sh)  # exact in float64 here
        m, e = math.frexp(d)
        out |= _bits(math.ldexp(round(math.ldexp(m, 8)), e - 8)) << sh
    return out


def walk(mem, cloud_at, slots, c, q, slab_at, split):
    """One slab as the kernel writes it.  ``mem`` holds the cloud's bf16
    bits from element ``cloud_at``; the slab starts ``slab_at`` values past
    a 16-byte boundary.  Returns the slab's bits, how often each value was
    written and how often each (slot, column) was read."""
    slots = [int(i) for i in slots]
    nsample = len(slots)
    total = nsample * c
    slab = np.zeros(total, np.uint16)
    writes = np.zeros(total, np.int64)
    reads = np.zeros((nsample, c), np.int64)
    qb = _bits_of_bf16(torch.tensor(q, dtype=torch.float32).bfloat16())
    c01, c2 = int(qb[0]) | int(qb[1]) << 16, int(qb[2])
    qf = _bf16_of_bits(qb).float().numpy()

    def value(k, cc):  # one value of the head or tail
        reads[k, cc] += 1
        v = _bf16_of_bits([mem[cloud_at + slots[k] * c + cc]]).float().numpy()[0]
        if cc < 3:
            v = np.float32(v - qf[cc])
        return _bits_of_bf16(torch.tensor([v]).bfloat16())[0]

    def put(at, bits):
        slab[at] = bits
        writes[at] += 1

    def blocks(src, ln):
        """The aligned block(s) holding values src .. src + ln - 1, and the
        offset of src in the first."""
        blk, at = src & ~7, src & 7
        x = _words(mem[blk:blk + 8])
        return x, (_words(mem[blk + 8:blk + 16]) if at + ln > 8 else x), at

    def merge_from(o, r, e):
        return [r[i] if 2 * i >= e else
                (o[i] & 0xFFFF) | (r[i] & 0xFFFF0000) if 2 * i + 1 == e
                else o[i] for i in range(4)]

    def two_pieces(k, cs):
        """load_pieces + assemble (C >= 8): the rest of slot k's row, then
        the start of slot k + 1's, the center at each row's first values."""
        ln = min(8, c - cs)
        xa, ya, at_a = blocks(cloud_at + slots[k] * c + cs, ln)
        o = shift_in(xa, ya, 8 + at_a)
        reads[k, cs:cs + ln] += 1
        if ln < 8:
            xb, yb, at_b = blocks(cloud_at + slots[k + 1] * c, 8 - ln)
            o = merge_from(o, shift_in(xb, yb, 8 + at_b - ln), ln)
            reads[k + 1, :8 - ln] += 1
        m = center_at(c01, c2, -cs if cs < 3 else ln)
        if c < 11:
            m2 = center_at(c01, c2, ln if cs < 3 else 8)
            m = [a | b for a, b in zip(m, m2)]
        return [sub_bf16x2(a, b) for a, b in zip(o, m)]

    def per_value(k, cs):
        """C < 8: one value a load (the head's and tail's rule), packed."""
        vals = []
        for _ in range(8):
            vals.append(int(value(k, cs)))
            cs += 1
            if cs == c:
                cs, k = 0, k + 1
        return [vals[2 * i] | vals[2 * i + 1] << 16 for i in range(4)]

    head = min((-slab_at) % 8, total)
    body = (total - head) // 8
    tail = total - head - 8 * body
    for part in range(split):
        for lane in range(32):
            if part == 0 and lane < head:
                put(lane, value(lane // c, lane % c))
            if part == 0 and lane < tail:
                at = total - 1 - lane
                put(at, value(at // c, at % c))
            first = 8 * (32 * part + lane)
            k, cc = first // c, first % c + head
            k_step, c_step = 256 * split // c, 256 * split % c
            while cc >= c:
                cc, k = cc - c, k + 1
            for v in range(32 * part + lane, body, 32 * split):
                assert (slab_at + head + 8 * v) % 8 == 0  # a 16-byte store
                o = (two_pieces if c >= 8 else per_value)(k, cc)
                for i in range(4):
                    put(head + 8 * v + 2 * i, o[i] & 0xFFFF)
                    put(head + 8 * v + 2 * i + 1, o[i] >> 16)
                k, cc = k + k_step, cc + c_step
                if cc >= c:
                    cc, k = cc - c, k + 1
    return slab, writes, reads


@pytest.mark.parametrize("c", [3, 6, 67, 131, 259])
@pytest.mark.parametrize("nsample", [1, 31, 32])
def test_row_copy_equals_the_plain_version(c, nsample):
    rs = np.random.RandomState(c * 100 + nsample)
    n, s = 48, 3
    xyz = torch.from_numpy(rs.rand(1, n, 3).astype(np.float32))
    new_xyz = xyz[:, :s].clone()
    new_xyz[0, 2] = 50.0  # an empty ball: all n - 1
    base = torch.cat([xyz, torch.from_numpy(rs.randn(1, n, c - 3).astype(np.float32))],
                     -1).bfloat16()
    want, idx = sg_fused.select_gather_plain(0.4, nsample, xyz, new_xyz, base)
    bits = _bits_of_bf16(base[0]).reshape(-1)
    for q in range(s):
        for cloud_at, slab_at, split in ((0, 0, 1), (3, 5, 2), (5, 1, 8), (0, 7, 1),
                                         (6, 3, 1), (1, 2, 8)):
            mem = np.zeros(cloud_at + bits.size + 16, np.uint16)
            mem[cloud_at:cloud_at + bits.size] = bits
            slab, writes, reads = walk(mem, cloud_at, idx[0, q].numpy(), c,
                                       new_xyz[0, q].numpy(), slab_at, split)
            assert (writes == 1).all(), (q, cloud_at, slab_at, split)
            assert (reads == 1).all(), (q, cloud_at, slab_at, split)
            np.testing.assert_array_equal(slab, _bits_of_bf16(want[0, q]).reshape(-1))


def test_packed_subtraction_is_the_float32_difference_rounded():
    """sub.rn.bf16x2 rounds the exact difference of two bf16 values once;
    the plain version rounds their float32 difference to bf16.  The same
    bits at every exponent gap 0-40 and at halfway cases."""
    rs = np.random.RandomState(1)
    a = torch.from_numpy(rs.randn(3000).astype(np.float32)).bfloat16().double().numpy()
    gaps = rs.randint(0, 41, 3000)
    b = a * np.ldexp(1.0, -gaps) * rs.choice([-1.0, 1.0, 0.999, 1.001], 3000)
    b = torch.from_numpy(b).float().bfloat16().double().numpy()
    a = np.concatenate([a, [1.0, 1.0, 256.0, -3.0]])
    b = np.concatenate([b, [2.0 ** -9, 3 * 2.0 ** -9, 0.5, 2.0 ** -30]])
    f32 = _bits_of_bf16(torch.from_numpy((a.astype(np.float32) - b.astype(np.float32)))
                        .bfloat16())
    np.testing.assert_array_equal(_round_bf16(a - b), f32)


@pytest.mark.parametrize("clouds", [1, 9, 54, 72])
def test_bf16_plan_at_the_flagship(clouds):
    """sa1 takes the float32 mode's plan; sa2-sa4 one center a warp, and
    where the centers are too few to fill the card, 2-8 warps a slab,
    each warp at least one chunk a lane; the plan's block fits shared
    memory at the float32 mode's cap, which it keeps."""
    stages = list(zip((1024, 256, 64, 16), (6, 67, 131, 259)))
    for s, c in stages:
        slab = 32 * c
        queries, split = sg_fused.select_gather_bf16_plan(clouds, s, slab)
        if slab <= sg_fused.SG_SELECT_SLAB:
            assert (queries, split) == (sg_fused.select_gather_plan(clouds, s, slab), 1)
        else:
            assert queries == 1 and split in (1, 2, 4, 8)
            assert split == 1 or clouds * s * split // 2 < sg_fused.SG_BF16_FILL
            assert slab // 8 >= 32 * split  # a chunk a lane at least
        cap = sg_fused.select_gather_max_points(32, queries)
        assert cap >= 14336
        assert sg_fused.select_gather_smem(cap, 32, queries) <= kernels.SMEM_MAX
    plans = [sg_fused.select_gather_bf16_plan(clouds, s, 32 * c) for s, c in stages]
    # the sweep's fastest, or within 2% of it (profile_kernels.py --sg_sweep)
    assert plans[1:] == {1: [(1, 8), (1, 8), (1, 8)], 9: [(1, 1), (1, 4), (1, 8)],
                         54: [(1, 1), (1, 1), (1, 4)], 72: [(1, 1), (1, 1), (1, 2)]}[clouds]


@pytest.mark.parametrize("s,slab", [(1, 32 * 259), (5, 64 * 6), (700, 32 * 67),
                                    (3, 8 * 3), (40, 31 * 67)])
def test_bf16_plan_is_one_the_kernel_takes(s, slab):
    queries, split = sg_fused.select_gather_bf16_plan(2, s, slab)
    assert queries in (1, 2, 4) and split in (1, 2, 4, 8)
    assert split == 1 or queries == 1


def test_bf16_wrapper_on_cpu_is_the_plain_version():
    rs = np.random.RandomState(0)
    xyz = torch.from_numpy(rs.rand(2, 300, 3).astype(np.float32))
    new_xyz = xyz[:, :40].contiguous()
    base = torch.cat([xyz, torch.from_numpy(rs.randn(2, 300, 64).astype(np.float32))],
                     -1).bfloat16()
    kernels.reset_launches()
    got, idx = sg_fused.select_gather_kernel(0.3, 32, xyz, new_xyz, base)
    want, widx = sg_fused.select_gather_plain(0.3, 32, xyz, new_xyz, base)
    assert got.dtype == torch.bfloat16
    assert torch.equal(idx, widx) and torch.equal(got, want)
    assert torch.equal(idx, ballquery.query_ball_point_plain(0.3, 32, xyz, new_xyz))
    assert kernels.LAUNCHES["select_gather_bf16"] == 0

"""K1 (ball query) as the Hopper kernel computes it, on the CPU.

The CUDA kernel cannot run here, so its scan (``csrc/ballquery.cu``) is
transcribed: a block of 4 warps of 1, 2 or 4 queries, rounds of 128
points (lane l reads points base + 32 p + l, p < 4) over the cloud padded
with NaN points, one vote a query a round on "any point of the round in
radius", a ballot a point slot in a round with a hit, a query that stops
at ``nsample`` and a warp that stops when all of its queries have.  The
transcription is held against ``query_ball_point_pallas`` in interpret
mode, index for index, on balls that fill, balls that do not and an
empty ball, with ``nsample == N`` and ``N`` not a multiple of 32; and the
host's launch plan (``ops/ballquery.py:ball_query_plan``) is checked to
cover every shape the kernel takes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsdm_tpu.ops.ballquery_pallas import query_ball_point_pallas
from lsdm_tpu_torch import kernels
from lsdm_tpu_torch.ops import ballquery

POINTS_PER_LANE = 4  # csrc/ballquery.cu: kPointsPerLane
WARPS = 4            # csrc/ballquery.cu: kBallWarps
ROUND = 32 * POINTS_PER_LANE


def k1_scan(radius, nsample, xyz, new_xyz, per_warp):
    """K1's indices (B, S, nsample) as the kernel finds them: the distance
    bits of ``square_distance`` (the kernel's ``sq_dist``), the scan order
    and bookkeeping of ``ball_query_kernel`` with ``per_warp`` queries a
    warp.  Also returns the rounds the warps ran, for the early stop."""
    warps = WARPS
    B, N, _ = xyz.shape
    S = new_xyz.shape[1]
    r2 = np.float32(ballquery._radius2(radius))
    npad = -(-N // ROUND) * ROUND
    d = np.full((B, S, npad), np.nan, dtype=np.float32)  # NaN points: never in
    d[:, :, :N] = ballquery.square_distance(
        torch.from_numpy(new_xyz), torch.from_numpy(xyz)).numpy()
    out = np.full((B, S, nsample), -1, dtype=np.int32)
    lanes = np.arange(32)
    rounds = 0
    per_block = warps * per_warp
    for b in range(B):
        for block in range(-(-S // per_block)):
            for warp in range(warps):
                q0 = (block * warps + warp) * per_warp
                if q0 >= S:
                    continue
                qs = [q0 + t for t in range(per_warp)]
                count = [0 if q < S else nsample for q in qs]
                first = [-1] * per_warp
                for base in range(0, npad, ROUND):
                    if all(c >= nsample for c in count):
                        break
                    rounds += 1
                    for t, q in enumerate(qs):
                        if count[t] >= nsample:
                            continue
                        dq = d[b, q, base:base + ROUND].reshape(POINTS_PER_LANE, 32)
                        if not (dq <= r2).any():  # the vote
                            continue
                        for p in range(POINTS_PER_LANE):
                            inside = dq[p] <= r2  # the ballot
                            if not inside.any():
                                continue
                            i0 = base + 32 * p
                            if first[t] < 0:
                                first[t] = i0 + int(np.argmax(inside))
                            pos = count[t] + np.cumsum(inside) - inside  # popc(mask & lower)
                            keep = inside & (pos < nsample)
                            out[b, q, pos[keep]] = i0 + lanes[keep]
                            count[t] += int(inside.sum())
                for t, q in enumerate(qs):
                    if q < S:
                        fill = N - 1 if first[t] < 0 else first[t]
                        out[b, q, count[t]:] = fill
    return out, rounds


def _cloud(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("n,s,radius,nsample", [
    (64, 64, 1.0, 32),     # balls fill: the first nsample in index order
    (100, 13, 0.5, 16),    # partly filled; N not a multiple of 32
    (37, 6, 0.3, 37),      # nsample == N
    (300, 40, 0.2, 32),    # three rounds, most balls short of nsample
    (256, 64, 2.5, 8),     # balls fill in the first round: the early stop
    (129, 9, 0.4, 32),     # one point past a round; 9 queries, ragged blocks
    (33, 17, 0.6, 5),      # one point past a ballot slot; few samples
])
@pytest.mark.parametrize("per_warp", [1, 2, 4])
def test_k1_scan_order_matches_pallas(n, s, radius, nsample, per_warp):
    xyz = _cloud(n, 2, n, 3)
    new_xyz = _cloud(s + 100, 2, s, 3)
    new_xyz[0, 0] = 50.0  # a ball with no point in it: all n - 1
    want = np.asarray(query_ball_point_pallas(
        radius, nsample, jnp.asarray(xyz), jnp.asarray(new_xyz), interpret=True))
    got, _ = k1_scan(radius, nsample, xyz, new_xyz, per_warp)
    np.testing.assert_array_equal(got, want)
    assert (got[0, 0] == n - 1).all()
    plain = ballquery.query_ball_point_plain(
        radius, nsample, torch.from_numpy(xyz), torch.from_numpy(new_xyz))
    np.testing.assert_array_equal(plain.numpy(), want)


@pytest.mark.parametrize("per_warp", [1, 4])
def test_k1_warps_stop_once_their_balls_are_full(per_warp):
    """Where every ball fills in the first round, each warp runs one round
    of the 8 a 1024-point cloud has; where none does, all 8."""
    xyz = _cloud(0, 1, 1024, 3)
    full, rounds = k1_scan(100.0, 32, xyz, xyz[:, :64].copy(), per_warp)
    assert rounds == 64 // per_warp
    assert (full[0] == np.arange(32)).all()
    _, rounds = k1_scan(1e-3, 32, xyz, xyz[:, :64].copy() + 50.0, per_warp)
    assert rounds == 8 * 64 // per_warp


def test_ball_query_plan_covers_every_shape():
    """Every (clouds, queries) gets 1, 2 or 4 queries a warp: four where
    they leave 24 warps an SM, two where those leave 16, else one."""
    sizes = (1, 2, 3, 4, 5, 7, 8, 9, 15, 16, 17, 33, 63, 64, 65, 100, 255, 256,
             257, 1000, 1024, 1025, 3072)
    sms = kernels.SMS
    for clouds in (1, 2, 9, 14, 15, 54, 72, 133, 1000, 65535):
        for s in sizes:
            per_warp = ballquery.ball_query_plan(clouds, s)
            assert per_warp in (1, 2, 4)
            blocks = -(-s // (WARPS * per_warp))
            assert blocks * WARPS * per_warp >= s and clouds * blocks < 2 ** 31
            warps = {q: clouds * -(-s // q) for q in (1, 2, 4)}
            assert (per_warp == 4) == (warps[4] >= 24 * sms), (clouds, s)
            if per_warp < 4:
                assert (per_warp == 2) == (warps[2] >= 16 * sms), (clouds, s)
    # the flagship stages: 1024, 256, 64, 16 queries at 9 and 54 clouds
    assert [ballquery.ball_query_plan(9, s) for s in (1024, 256, 64, 16)] == [
        2, 1, 1, 1]
    assert [ballquery.ball_query_plan(54, s) for s in (1024, 256, 64, 16)] == [
        4, 4, 1, 1]
    for bad in ((0, 16), (9, 0)):
        with pytest.raises(ValueError):
            ballquery.ball_query_plan(*bad)

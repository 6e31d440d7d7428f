// K1's staged multi-query ball scan, shared by the ball query (K1,
// ballquery.cu) and the train select-gather (K10, sg_fused.cu), so that
// both select their indices with the same code.
//
// A block of kWarps warps stages its cloud once (stage_points: {x, y, z,
// |x|^2} float4s, padded with NaN points, which no ball holds) and serves
// its warps' queries from it; a warp serves Q queries (1, 2 or 4, from the
// host plan, ops/ballquery.py:ball_query_plan) from every point it reads.
// In a round each lane reads kPointsPerLane points (one 16-byte shared
// load each; lane l takes points base + 32 p + l, so each of the warp's
// loads is contiguous and each ballot covers 32 consecutive points) and
// computes their distances (pointdist.cuh's sq_dist) to every query of the
// warp, folding "in radius" into one predicate a query.  One vote a query
// then skips a round in which its ball got nothing; a round with a hit
// takes a ballot a point slot, and __popc gives each in-radius point its
// slot, in index order, so the first nsample in-radius indices come out
// ascending.  A query stops taking points once nsample are found, and the
// warp once all of its queries have.  Empty slots repeat the first index;
// a row with no point in radius is all n - 1, the Pallas kernel's
// clip(n, 0, n - 1).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pointdist.cuh"

namespace ballscan {

constexpr int kPointsPerLane = 4;    // points a lane reads a round
constexpr int kRoundPoints = 32 * kPointsPerLane;  // points a warp reads a round
constexpr int kWarps = 4;            // warps a block
constexpr size_t kSmemMax = 232448;  // dynamic shared memory of a block

// Stage cloud (n, 3) into shared memory as {x, y, z, |p|^2} float4s, with
// NaN points from n to np, whose distances compare false (one 16-byte load
// a point; pointdist.cuh's stage_cloud serves the other kernels).  A thread
// issues the loads of kStageLoads points before it stores any, so a block
// of one warp stages 256 points in one round trip to memory, not 8.
constexpr int kStageLoads = 8;
__device__ __forceinline__ void stage_points(const float* __restrict__ cloud,
                                             int n, int np, float4* s) {
  for (int i0 = threadIdx.x; i0 < np; i0 += kStageLoads * blockDim.x) {
    float a[kStageLoads][3];
#pragma unroll
    for (int u = 0; u < kStageLoads; ++u) {
      const int i = i0 + u * blockDim.x;
      a[u][0] = a[u][1] = a[u][2] = NAN;
      if (i < n) {
        a[u][0] = cloud[3 * i];
        a[u][1] = cloud[3 * i + 1];
        a[u][2] = cloud[3 * i + 2];
      }
    }
#pragma unroll
    for (int u = 0; u < kStageLoads; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < np) {
        s[i] = make_float4(a[u][0], a[u][1], a[u][2],
                           sq_norm(a[u][0], a[u][1], a[u][2]));
      }
    }
  }
}

// The Q queries of one warp (warp-uniform): coordinates, squared norms,
// points taken so far and the first in-radius index.
template <int Q>
struct Queries {
  float c0[Q], c1[Q], c2[Q], cc[Q];
  int count[Q], first[Q];
};

// Queries q0 .. q0 + Q - 1 of cloud b of new_xyz (B, s, 3).  A query past
// s starts full, so it takes no point and writes nothing.  Called before
// the staging, so the coordinates' loads wait with the cloud's.
template <int Q>
__device__ __forceinline__ void load_queries(Queries<Q>& qs,
                                             const float* __restrict__ new_xyz,
                                             int b, int s, int q0,
                                             int nsample) {
#pragma unroll
  for (int t = 0; t < Q; ++t) {
    qs.c0[t] = qs.c1[t] = qs.c2[t] = 0.0f;
    qs.count[t] = nsample;
    qs.first[t] = -1;
    if (q0 + t < s) {
      const float* qp = new_xyz + ((size_t)b * s + q0 + t) * 3;
      qs.c0[t] = qp[0];
      qs.c1[t] = qp[1];
      qs.c2[t] = qp[2];
      qs.count[t] = 0;
    }
  }
}

// The scan of the staged cloud pts (np points, n of them real) for the
// warp's queries: query t's first nsample in-radius indices, then its
// fill, into row(t)[0 .. nsample), for every query t with q0 + t < s.
// Called by whole warps, after the staging's barrier.
template <int Q, typename Row>
__device__ __forceinline__ void scan(Queries<Q>& qs, const float4* pts, int n,
                                     int np, int s, int q0, float radius2,
                                     int nsample, Row row) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < Q; ++t) qs.cc[t] = sq_norm(qs.c0[t], qs.c1[t], qs.c2[t]);
  const unsigned lower = (1u << lane) - 1u;  // lanes below this one

  for (int base = 0; base < np; base += kRoundPoints) {
    bool done = true;
#pragma unroll
    for (int t = 0; t < Q; ++t) done = done && qs.count[t] >= nsample;
    if (done) break;
    float d[Q][kPointsPerLane];
    bool hit[Q];
#pragma unroll
    for (int p = 0; p < kPointsPerLane; ++p) {
      const float4 x = pts[base + p * 32 + lane];
#pragma unroll
      for (int t = 0; t < Q; ++t) {
        d[t][p] = sq_dist(qs.c0[t], qs.c1[t], qs.c2[t], qs.cc[t], x.x, x.y,
                          x.z, x.w);
        hit[t] = (p > 0 && hit[t]) || d[t][p] <= radius2;
      }
    }
#pragma unroll
    for (int t = 0; t < Q; ++t) {
      if (qs.count[t] >= nsample || !__any_sync(0xffffffffu, hit[t])) continue;
      int32_t* r = row(t);
#pragma unroll
      for (int p = 0; p < kPointsPerLane; ++p) {
        const bool in = d[t][p] <= radius2;
        const unsigned mask = __ballot_sync(0xffffffffu, in);
        if (mask == 0u) continue;
        const int i0 = base + p * 32;
        if (qs.first[t] < 0) qs.first[t] = i0 + __ffs(mask) - 1;
        const int pos = qs.count[t] + __popc(mask & lower);
        if (in && pos < nsample) r[pos] = i0 + lane;
        qs.count[t] += __popc(mask);
      }
    }
  }
#pragma unroll
  for (int t = 0; t < Q; ++t) {
    if (q0 + t >= s) continue;
    int32_t* r = row(t);
    const int fill = qs.first[t] < 0 ? n - 1 : qs.first[t];
    for (int j = qs.count[t] + lane; j < nsample; j += 32) r[j] = fill;
  }
}

}  // namespace ballscan

// Ball query (K1) and 3-NN selection (K2) for Hopper.
//
// Replaces lsdm_tpu/ops/ballquery_pallas.py: query_ball_point_pallas and
// three_nn_pallas.  Plain versions: lsdm_tpu_torch/ops/ballquery.py.
//
// Both kernels select integer indices from the squared distance
// (-2 (q.x) + |q|^2) + |x|^2 (pointdist.cuh's sq_dist; nearest.cuh's
// distance<false> for 3-NN), whose products and sums are rounded as the
// plain version's separate torch ops round them, so kernel and plain
// version produce the same bits and the same indices.
//
// What bounds them on an H100: neither moves much memory (a 1024-point
// cloud is 12 KB; the outputs are at most 54 x 1024 x 32 int32) nor does
// much arithmetic (9 x 1024 x 1024 distances at sa1).  They are bound by
// instruction issue, latency and launch: the distance's products and sums
// are rounded on their own, so they issue as about eight instructions a
// pair (chip_smoke.py: DIST_INSTRS).  Both read their clouds from
// shared memory, so the scans read no device memory after the staging.
//
// Ball query: a block stages its cloud once (stage_points: {x, y, z,
// |x|^2} float4s, padded with NaN points, which no ball holds) and serves
// its warps' queries from it.  The host plan (ops/ballquery.py:
// ball_query_plan) picks the queries a warp (1, 2 or 4) so the card holds
// enough warps to hide a round's latency.  A block is kBallWarps = 4
// warps: a cloud is 12-48 KB and staging it is a small part of a block's
// time, so wider blocks ran no faster and left a 9-cloud grid unevenly
// spread over the SMs (PERF.md, the block-width sweep).  A warp
// serves kQueriesPerWarp queries from every point it reads: in a
// round each lane reads kPointsPerLane points (one 16-byte shared load
// each; lane l takes points base + 32 p + l, so each of the warp's loads
// is contiguous and each ballot covers 32 consecutive points) and
// computes their distances to every query of the warp, folding "in
// radius" into one predicate a query (the compare's OR form): about ten
// instructions a (query, point) pair by count, where one query a warp
// issued ~25.  One vote a query then skips a round in which its ball got
// nothing, as most rounds do at the SA radii on the seeded clouds; a round
// with a hit takes a ballot a point slot, and __popc gives each in-radius
// point its slot, in index order, so the first nsample in-radius indices
// come out ascending.  A query stops taking points once nsample are
// found, and the warp once all of its queries have (the Pallas kernel
// instead runs nsample min-passes over the whole row).  Empty slots
// repeat the first index; a row with no point in radius is all n-1, the
// Pallas kernel's clip(n, 0, n-1).
//
// 3-NN: the lane-split nearest-k scan of nearest.cuh with K = 3 (the
// first k <= 3 pairs written): a group of lanes splits each target's
// sources, the source cloud streams through shared tiles, and the lanes'
// top-3 lists merge in (distance, index) order, which is lax.top_k(-d)
// order.
//
// The ball query stages its whole cloud: np x 16 bytes, above 48 KB only
// by opting in to more dynamic shared memory, up to the 227 KB a block may
// take on Hopper (kBallSmemMax): 14,464 points (ops/ballquery.py:
// BALL_MAX_POINTS).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "nearest.cuh"
#include "pointdist.cuh"

namespace {

constexpr int kPointsPerLane = 4;    // points a lane reads a round
constexpr int kRoundPoints = 32 * kPointsPerLane;  // points a warp reads a round
constexpr int kBallWarps = 4;        // warps a block
constexpr size_t kBallSmemMax = 232448;  // dynamic shared memory of a block

// Stage cloud (n, 3) into shared memory as {x, y, z, |p|^2} float4s, with
// NaN points from n to np, whose distances compare false: K1's own layout
// (one 16-byte load a point); pointdist.cuh's stage_cloud serves the others.
// A thread issues the loads of kStageLoads points before it stores any, so
// a block of one warp stages 256 points in one round trip to memory, not 8.
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

// kQueriesPerWarp: 1, 2 or 4 queries served from each point a warp reads.
template <int kQueriesPerWarp>
__global__ void __launch_bounds__(kBallWarps * 32)
ball_query_kernel(const float* __restrict__ xyz,
                  const float* __restrict__ new_xyz, int n, int np, int s,
                  float radius2, int nsample, int32_t* __restrict__ out) {
  extern __shared__ float4 pts[];
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = (blockIdx.x * kBallWarps + warp) * kQueriesPerWarp;
  // per query (warp-uniform): a query past s starts full, so it takes no
  // point and writes nothing; its coordinates are read before the staging,
  // so their loads wait with the cloud's
  float c0[kQueriesPerWarp], c1[kQueriesPerWarp], c2[kQueriesPerWarp],
      cc[kQueriesPerWarp];
  int count[kQueriesPerWarp], first[kQueriesPerWarp];
#pragma unroll
  for (int t = 0; t < kQueriesPerWarp; ++t) {
    c0[t] = c1[t] = c2[t] = 0.0f;
    count[t] = nsample;
    first[t] = -1;
    if (q0 + t < s) {
      const float* qp = new_xyz + ((size_t)b * s + q0 + t) * 3;
      c0[t] = qp[0];
      c1[t] = qp[1];
      c2[t] = qp[2];
      count[t] = 0;
    }
  }
  stage_points(xyz + (size_t)b * n * 3, n, np, pts);
  __syncthreads();
  if (q0 >= s) return;  // whole warp leaves together
#pragma unroll
  for (int t = 0; t < kQueriesPerWarp; ++t) cc[t] = sq_norm(c0[t], c1[t], c2[t]);
  const unsigned lower = (1u << lane) - 1u;  // lanes below this one

  for (int base = 0; base < np; base += kRoundPoints) {
    bool done = true;
#pragma unroll
    for (int t = 0; t < kQueriesPerWarp; ++t) done = done && count[t] >= nsample;
    if (done) break;
    float d[kQueriesPerWarp][kPointsPerLane];
    bool hit[kQueriesPerWarp];
#pragma unroll
    for (int p = 0; p < kPointsPerLane; ++p) {
      const float4 x = pts[base + p * 32 + lane];
#pragma unroll
      for (int t = 0; t < kQueriesPerWarp; ++t) {
        d[t][p] = sq_dist(c0[t], c1[t], c2[t], cc[t], x.x, x.y, x.z, x.w);
        hit[t] = (p > 0 && hit[t]) || d[t][p] <= radius2;
      }
    }
#pragma unroll
    for (int t = 0; t < kQueriesPerWarp; ++t) {
      if (count[t] >= nsample || !__any_sync(0xffffffffu, hit[t])) continue;
      int32_t* row = out + ((size_t)b * s + q0 + t) * nsample;
#pragma unroll
      for (int p = 0; p < kPointsPerLane; ++p) {
        const bool in = d[t][p] <= radius2;
        const unsigned mask = __ballot_sync(0xffffffffu, in);
        if (mask == 0u) continue;
        const int i0 = base + p * 32;
        if (first[t] < 0) first[t] = i0 + __ffs(mask) - 1;
        const int pos = count[t] + __popc(mask & lower);
        if (in && pos < nsample) row[pos] = i0 + lane;
        count[t] += __popc(mask);
      }
    }
  }
#pragma unroll
  for (int t = 0; t < kQueriesPerWarp; ++t) {
    if (q0 + t >= s) continue;
    int32_t* row = out + ((size_t)b * s + q0 + t) * nsample;
    const int fill = first[t] < 0 ? n - 1 : first[t];
    for (int j = count[t] + lane; j < nsample; j += 32) row[j] = fill;
  }
}

template <int kQueriesPerWarp>
cudaError_t launch_ball_query(const float* xyz, const float* new_xyz, int b,
                              int n, int s, float radius2, int nsample,
                              int32_t* out, cudaStream_t stream) {
  const int per_block = kBallWarps * kQueriesPerWarp;
  const int np = (n + kRoundPoints - 1) / kRoundPoints * kRoundPoints;
  const dim3 grid((s + per_block - 1) / per_block, b);
  const size_t smem = sizeof(float4) * (size_t)np;
  if (smem > kBallSmemMax) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {  // above the default, only by opting in
    const cudaError_t err = cudaFuncSetAttribute(
        ball_query_kernel<kQueriesPerWarp>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  ball_query_kernel<kQueriesPerWarp><<<grid, kBallWarps * 32, smem, stream>>>(
      xyz, new_xyz, n, np, s, radius2, nsample, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// xyz (B, N, 3), new_xyz (B, S, 3) float32 -> out (B, S, nsample) int32;
// queries a warp (1, 2 or 4) from the host plan.
int lsdm_ball_query(const float* xyz, const float* new_xyz, int b, int n, int s,
                    float radius2, int nsample, int queries_per_warp,
                    int32_t* out, void* stream) {
  if (b <= 0 || s <= 0 || n <= 0 || nsample <= 0) return 0;
  if (b > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (queries_per_warp) {
    case 1:
      return (int)launch_ball_query<1>(xyz, new_xyz, b, n, s, radius2, nsample,
                                       out, st);
    case 2:
      return (int)launch_ball_query<2>(xyz, new_xyz, b, n, s, radius2, nsample,
                                       out, st);
    case 4:
      return (int)launch_ball_query<4>(xyz, new_xyz, b, n, s, radius2, nsample,
                                       out, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// xyz1 (B, N, 3) targets, xyz2 (B, S, 3) sources -> dist, idx (B, N, k),
// k <= 3; `lanes` lanes a target, one target a lane, from the host plan
// (ops/ballquery.py:three_nn_plan).
int lsdm_three_nn(const float* xyz1, const float* xyz2, int b, int n, int s,
                  int k, int lanes, float* dist, int32_t* idx, void* stream) {
  if (b <= 0 || n <= 0) return 0;
  if (k < 1 || k > 3 || k > s) return (int)cudaErrorInvalidValue;
  return (int)nearest::launch<3, false>(xyz1, xyz2, b, n, s, k, lanes, 1, dist,
                                        idx, (cudaStream_t)stream);
}

const char* lsdm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

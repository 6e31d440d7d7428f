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
// Ball query: K1's staged multi-query scan (ballscan.cuh, which the train
// select-gather K10 shares): a block of kWarps = 4 warps stages its cloud
// once and serves its warps' queries from it, 1, 2 or 4 queries a warp
// from the host plan (ops/ballquery.py:ball_query_plan), so the card holds
// enough warps to hide a round's latency.  A cloud is 12-48 KB and staging
// it is a small part of a block's time, so wider blocks ran no faster and
// left a 9-cloud grid unevenly spread over the SMs (PERF.md, the
// block-width sweep).  In a round a warp issues about ten instructions a
// (query, point) pair by count, where one query a warp issued ~25; one
// vote a query skips a round in which its ball got nothing, as most rounds
// do at the SA radii on the seeded clouds.  (The Pallas kernel instead
// runs nsample min-passes over the whole row.)
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

#include "ballscan.cuh"
#include "nearest.cuh"

namespace {

using ballscan::kRoundPoints;
constexpr int kBallWarps = ballscan::kWarps;  // warps a block
constexpr size_t kBallSmemMax = ballscan::kSmemMax;

// kQueriesPerWarp: 1, 2 or 4 queries served from each point a warp reads.
template <int kQueriesPerWarp>
__global__ void __launch_bounds__(kBallWarps * 32)
ball_query_kernel(const float* __restrict__ xyz,
                  const float* __restrict__ new_xyz, int n, int np, int s,
                  float radius2, int nsample, int32_t* __restrict__ out) {
  extern __shared__ float4 pts[];
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int q0 = (blockIdx.x * kBallWarps + warp) * kQueriesPerWarp;
  ballscan::Queries<kQueriesPerWarp> qs;
  ballscan::load_queries(qs, new_xyz, b, s, q0, nsample);
  ballscan::stage_points(xyz + (size_t)b * n * 3, n, np, pts);
  __syncthreads();
  if (q0 >= s) return;  // whole warp leaves together
  ballscan::scan(qs, pts, n, np, s, q0, radius2, nsample, [&](int t) {
    return out + ((size_t)b * s + q0 + t) * nsample;
  });
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

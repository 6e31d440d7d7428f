// Ball query (K1) and 3-NN selection (K2) for Hopper.
//
// Replaces lsdm_tpu/ops/ballquery_pallas.py: query_ball_point_pallas and
// three_nn_pallas.  Plain versions: lsdm_tpu_torch/ops/ballquery.py.
//
// Both kernels select integer indices from the squared distance
// (-2 (q.x) + |q|^2) + |x|^2 of pointdist.cuh, whose products and sums are
// each rounded on their own in the order of the plain version's separate
// torch ops, so kernel and plain version produce the same bits and the
// same indices.
//
// What bounds them on an H100: neither moves much memory (a 1024-point
// cloud is 12 KB; the outputs are at most 9 x 1024 x 32 int32) nor does
// much arithmetic (9 x 1024 x 1024 distances at sa1).  They are bound by
// latency and instruction issue.  The design keeps each cloud in shared
// memory (structure of arrays plus the precomputed |x|^2), so the scans
// read no device memory after the staging, and gives every warp (ball
// query) or thread (3-NN) independent rows, so the 132 SMs have enough
// warps in flight: sa1 alone is 9 x 1024 / 8 = 1152 blocks.
//
// Ball query: one warp per query row.  The warp scans the cloud in
// 32-point chunks in index order; __ballot_sync + __popc give each
// in-radius point its slot, so the first nsample in-radius indices come
// out in ascending order, and the scan stops once nsample are found
// (the Pallas kernel instead runs nsample min-passes over the whole row).
// Empty slots repeat the first index; a row with no point in radius is
// all n-1, the Pallas kernel's clip(n, 0, n-1).
//
// 3-NN: one thread per target; a sorted insert with strict < keeps the k
// smallest distances with ties to the lowest index (the scan visits
// sources in ascending index order), which is lax.top_k(-d) order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pointdist.cuh"

namespace {

constexpr int kBallWarps = 8;       // query rows per block
constexpr int kNnThreads = 256;     // targets per block

__global__ void __launch_bounds__(kBallWarps * 32)
ball_query_kernel(const float* __restrict__ xyz,
                  const float* __restrict__ new_xyz, int n, int s,
                  float radius2, int nsample, int32_t* __restrict__ out) {
  extern __shared__ float smem[];
  const int b = blockIdx.y;
  stage_cloud(xyz + (size_t)b * n * 3, n, smem);
  __syncthreads();
  const float* sx = smem;
  const float* sy = smem + n;
  const float* sz = smem + 2 * n;
  const float* sxx = smem + 3 * n;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kBallWarps + warp;
  if (q >= s) return;  // whole warp leaves together
  const float* qp = new_xyz + ((size_t)b * s + q) * 3;
  const float q0 = qp[0], q1 = qp[1], q2 = qp[2];
  const float qq = sq_norm(q0, q1, q2);
  int32_t* row = out + ((size_t)b * s + q) * nsample;
  const unsigned lower = (1u << lane) - 1u;  // lanes below this one

  int count = 0;   // warp-uniform
  int first = -1;  // warp-uniform
  for (int base = 0; base < n && count < nsample; base += 32) {
    const int i = base + lane;
    bool in = false;
    if (i < n) in = sq_dist(q0, q1, q2, qq, sx[i], sy[i], sz[i], sxx[i]) <= radius2;
    const unsigned mask = __ballot_sync(0xffffffffu, in);
    if (mask == 0u) continue;
    if (first < 0) first = base + __ffs(mask) - 1;
    const int pos = count + __popc(mask & lower);
    if (in && pos < nsample) row[pos] = i;
    count += __popc(mask);
  }
  const int fill = first < 0 ? n - 1 : first;
  for (int j = count + lane; j < nsample; j += 32) row[j] = fill;
}

__global__ void __launch_bounds__(kNnThreads)
three_nn_kernel(const float* __restrict__ xyz1, const float* __restrict__ xyz2,
                int n, int s, int k, float* __restrict__ dist,
                int32_t* __restrict__ idx) {
  extern __shared__ float smem[];
  const int b = blockIdx.y;
  stage_cloud(xyz2 + (size_t)b * s * 3, s, smem);
  __syncthreads();
  const float* sx = smem;
  const float* sy = smem + s;
  const float* sz = smem + 2 * s;
  const float* sxx = smem + 3 * s;

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* qp = xyz1 + ((size_t)b * n + i) * 3;
  const float q0 = qp[0], q1 = qp[1], q2 = qp[2];
  const float qq = sq_norm(q0, q1, q2);
  float bd0 = INFINITY, bd1 = INFINITY, bd2 = INFINITY;
  int bi0 = 0, bi1 = 0, bi2 = 0;
  for (int j = 0; j < s; ++j) {
    const float d = sq_dist(q0, q1, q2, qq, sx[j], sy[j], sz[j], sxx[j]);
    if (d < bd2) {  // strict: an equal distance keeps the earlier index
      if (d < bd1) {
        bd2 = bd1; bi2 = bi1;
        if (d < bd0) {
          bd1 = bd0; bi1 = bi0;
          bd0 = d; bi0 = j;
        } else {
          bd1 = d; bi1 = j;
        }
      } else {
        bd2 = d; bi2 = j;
      }
    }
  }
  float* drow = dist + ((size_t)b * n + i) * k;
  int32_t* irow = idx + ((size_t)b * n + i) * k;
  drow[0] = bd0; irow[0] = bi0;
  if (k > 1) { drow[1] = bd1; irow[1] = bi1; }
  if (k > 2) { drow[2] = bd2; irow[2] = bi2; }
}

}  // namespace

extern "C" {

// xyz (B, N, 3), new_xyz (B, S, 3) float32 -> out (B, S, nsample) int32.
int lsdm_ball_query(const float* xyz, const float* new_xyz, int b, int n, int s,
                    float radius2, int nsample, int32_t* out, void* stream) {
  if (b <= 0 || s <= 0 || n <= 0 || nsample <= 0) return 0;
  const dim3 grid((s + kBallWarps - 1) / kBallWarps, b);
  const size_t smem = sizeof(float) * 4 * (size_t)n;
  ball_query_kernel<<<grid, kBallWarps * 32, smem, (cudaStream_t)stream>>>(
      xyz, new_xyz, n, s, radius2, nsample, out);
  return (int)cudaGetLastError();
}

// xyz1 (B, N, 3) targets, xyz2 (B, S, 3) sources -> dist, idx (B, N, k), k <= 3.
int lsdm_three_nn(const float* xyz1, const float* xyz2, int b, int n, int s,
                  int k, float* dist, int32_t* idx, void* stream) {
  if (b <= 0 || n <= 0) return 0;
  if (k < 1 || k > 3 || k > s) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kNnThreads - 1) / kNnThreads, b);
  const size_t smem = sizeof(float) * 4 * (size_t)s;
  three_nn_kernel<<<grid, kNnThreads, smem, (cudaStream_t)stream>>>(
      xyz1, xyz2, n, s, k, dist, idx);
  return (int)cudaGetLastError();
}

const char* lsdm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

// Ball query + neighbourhood gather (K10), the train-mode select-gather of
// a SetAbstraction stage, for Hopper.
//
// Replaces lsdm_tpu/ops/sg_fused_pallas.py:_sg_call (behind
// select_gather_grouped, ball_impl="sg").  Plain version:
// lsdm_tpu_torch/ops/sg_fused.py:select_gather_plain.
//
// For every center q of new_xyz (B, S, 3) over the cloud xyz (B, N, 3):
//   idx[b, q, :]        = the first nsample in-radius point indices in
//                         index order, empty slots repeating the first, a
//                         ball with no point in it all N - 1 (K1's rule,
//                         and the Pallas kernel's clip(N, 0, N - 1));
//   out[b, q, k, c]     = base[b, idx[b, q, k], c] - (c < 3 ? q_c : 0),
// base (B, N, C) being the stage's [xyz, features] columns.  The output is
// (B, S, K, C) directly: the Pallas kernel's K-major layout was a Mosaic
// workaround.  The backward is plain torch (an index_add over idx).
//
// Selection is K1's (csrc/ballquery.cu): one warp per center, the cloud
// staged in shared memory, __ballot_sync + __popc over 32-point chunks in
// index order, the distance of pointdist.cuh with its separately rounded
// products and sums, so the indices equal K1's and the plain version's.
// The warp keeps its nsample indices in shared memory and then copies the
// K rows of base it selected into its (K, C) output slab, one float per
// lane per step over the slab's K x C elements: consecutive lanes write
// consecutive addresses, and each row of base is read contiguously.
//
// What bounds it on an H100: the bytes of the output, B S K C floats
// (247 MB over sa1-sa4 at the training flagship, 54 clouds of 1024
// points); the rows of base are re-read from L2 (a stage's base is at most
// 54 x 256 x 259 floats, 14 MB, inside the 50 MB L2).

#include <cuda_runtime.h>
#include <stdint.h>

#include "pointdist.cuh"

namespace {

constexpr int kSgWarps = 8;  // centers per block

__global__ void __launch_bounds__(kSgWarps * 32)
select_gather_kernel(const float* __restrict__ xyz,
                     const float* __restrict__ new_xyz,
                     const float* __restrict__ base, int n, int s, int c,
                     float radius2, int nsample, float* __restrict__ out,
                     int32_t* __restrict__ idx) {
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
  int* slots = reinterpret_cast<int*>(smem + 4 * n) + warp * nsample;
  const int q = blockIdx.x * kSgWarps + warp;
  if (q >= s) return;  // whole warp leaves together
  const float* qp = new_xyz + ((size_t)b * s + q) * 3;
  const float q0 = qp[0], q1 = qp[1], q2 = qp[2];
  const float qq = sq_norm(q0, q1, q2);
  const unsigned lower = (1u << lane) - 1u;  // lanes below this one

  int count = 0;   // warp-uniform
  int first = -1;  // warp-uniform
  for (int start = 0; start < n && count < nsample; start += 32) {
    const int i = start + lane;
    bool in = false;
    if (i < n) in = sq_dist(q0, q1, q2, qq, sx[i], sy[i], sz[i], sxx[i]) <= radius2;
    const unsigned mask = __ballot_sync(0xffffffffu, in);
    if (mask == 0u) continue;
    if (first < 0) first = start + __ffs(mask) - 1;
    const int pos = count + __popc(mask & lower);
    if (in && pos < nsample) slots[pos] = i;
    count += __popc(mask);
  }
  const int fill = first < 0 ? n - 1 : first;
  for (int j = count + lane; j < nsample; j += 32) slots[j] = fill;
  __syncwarp();

  const size_t row = (size_t)b * s + q;
  for (int j = lane; j < nsample; j += 32) idx[row * nsample + j] = slots[j];
  const float* cloud = base + (size_t)b * n * c;
  float* slab = out + row * nsample * c;
  const int total = nsample * c;
  for (int e = lane; e < total; e += 32) {
    const int kk = e / c;
    const int cc = e - kk * c;
    float val = cloud[(size_t)slots[kk] * c + cc];
    if (cc < 3) val = __fsub_rn(val, cc == 0 ? q0 : (cc == 1 ? q1 : q2));
    slab[e] = val;
  }
}

}  // namespace

extern "C" {

// xyz (B, N, 3), new_xyz (B, S, 3), base (B, N, C) float32 ->
// out (B, S, nsample, C) float32, idx (B, S, nsample) int32.
int lsdm_select_gather(const float* xyz, const float* new_xyz,
                       const float* base, int b, int n, int s, int c,
                       float radius2, int nsample, float* out, int32_t* idx,
                       void* stream) {
  if (b <= 0 || s <= 0 || n <= 0 || nsample <= 0) return 0;
  if (c < 3 || b > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 4 * (size_t)n +
                      sizeof(int) * (size_t)kSgWarps * nsample;
  cudaError_t err = cudaFuncSetAttribute(
      select_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s + kSgWarps - 1) / kSgWarps, b);
  select_gather_kernel<<<grid, kSgWarps * 32, smem, (cudaStream_t)stream>>>(
      xyz, new_xyz, base, n, s, c, radius2, nsample, out, idx);
  return (int)cudaGetLastError();
}

}  // extern "C"

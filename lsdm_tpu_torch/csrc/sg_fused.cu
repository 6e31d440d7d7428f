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
// What bounds it on an H100: the bytes of the output, B S K C floats
// (247 MB over sa1-sa4 at the training flagship, 54 clouds of 1024
// points), a write-once stream far larger than the 50 MB L2; the rows of
// base are re-read from L2 (a stage's base is at most 54 x 256 x 259
// floats, 14 MB).
//
// Selection is K1's, from the same code (ballscan.cuh): a block of 4
// warps stages its cloud once as float4s and each warp serves 1, 2 or 4
// centers (the host plan, ops/sg_fused.py:select_gather_plan) from every
// point it reads, with the distance of pointdist.cuh, so the indices equal
// K1's and the plain version's.  Each warp keeps its centers' nsample
// indices in shared memory behind the cloud, then writes each center's
// idx row and its (nsample, C) output slab.  A slab is written as 16-byte
// streaming stores (st.global.cs: the output is not read again by this
// kernel, and evicting it first keeps base in L2): lane l takes the
// float4s l, l + 32, ... of the slab's 16-byte-aligned body, whose
// (slot, column) position it advances by 128 elements a step with one add
// and one compare, no division; the up to 3 floats before the first
// 16-byte boundary (a slab is aligned only where its row * nsample * C is
// a multiple of 4) and after the last are written one float a lane.
//
// The cloud is staged whole, np x 16 bytes beside 16 x Q x nsample of
// index slots, above 48 KB only by opting in: the wrapper's cap
// (ops/sg_fused.py:select_gather_max_points) is what fits kSmemMax.
//
// The bf16 mode (the JAX kernel's compute_dtype=bfloat16) is its own
// source, csrc/sg_fused_bf16.cu: the same scan, its gather a source row at
// a time.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ballscan.cuh"

namespace {

using ballscan::kRoundPoints;
using ballscan::kWarps;

// kQueriesPerWarp: 1, 2 or 4 centers a warp.
template <int kQueriesPerWarp>
__global__ void __launch_bounds__(kWarps * 32)
select_gather_kernel(const float* __restrict__ xyz,
                     const float* __restrict__ new_xyz,
                     const float* __restrict__ base, int n, int np, int s,
                     int c, float radius2, int nsample,
                     float* __restrict__ out, int32_t* __restrict__ idx) {
  constexpr int Q = kQueriesPerWarp;
  constexpr int kVec = 4;  // values a 16-byte store carries
  extern __shared__ float4 pts[];
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = (blockIdx.x * kWarps + warp) * Q;
  ballscan::Queries<Q> qs;
  ballscan::load_queries(qs, new_xyz, b, s, q0, nsample);
  ballscan::stage_points(xyz + (size_t)b * n * 3, n, np, pts);
  __syncthreads();
  if (q0 >= s) return;  // whole warp leaves together
  int32_t* slots = reinterpret_cast<int32_t*>(pts + np) + warp * Q * nsample;
  ballscan::scan(qs, pts, n, np, s, q0, radius2, nsample,
                 [&](int t) { return slots + t * nsample; });
  __syncwarp();

  // the gather's walk: lane l's first 16 bytes of a 16-byte-aligned body
  // start at element kVec l, slot k0 column c0; a step is 32 kVec elements
  const int k_lane = kVec * lane / c, c_lane = kVec * lane - k_lane * c;
  const int k_step = 32 * kVec / c, c_step = 32 * kVec - k_step * c;
  const int total = nsample * c;
  const float* cloud = base + (size_t)b * n * c;
#pragma unroll
  for (int t = 0; t < Q; ++t) {
    if (q0 + t >= s) break;
    const int32_t* sl = slots + t * nsample;
    const size_t row = (size_t)b * s + q0 + t;
    for (int j = lane; j < nsample; j += 32) idx[row * nsample + j] = sl[j];
    const float q_0 = qs.c0[t], q_1 = qs.c1[t], q_2 = qs.c2[t];
    auto value = [&](int k, int cc) {
      const float v = cloud[(size_t)sl[k] * c + cc];
      return cc < 3 ? __fsub_rn(v, cc == 0 ? q_0 : cc == 1 ? q_1 : q_2) : v;
    };
    float* slab = out + row * total;
    // values before the slab's first 16-byte boundary
    int head = (int)((((uintptr_t)0 - (uintptr_t)slab) & 15) / sizeof(float));
    head = head < total ? head : total;
    if (lane < head) __stcs(slab + lane, value(lane / c, lane % c));
    const int body = (total - head) / kVec;  // 16-byte stores
    int k = k_lane, cc = c_lane + head;
    while (cc >= c) cc -= c, ++k;
    float4* dst = reinterpret_cast<float4*>(slab + head);
    for (int v = lane; v < body; v += 32) {
      float e[kVec];
      int kk = k, ce = cc;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        e[i] = value(kk, ce);
        if (++ce == c) ce = 0, ++kk;
      }
      __stcs(dst + v, make_float4(e[0], e[1], e[2], e[3]));
      k += k_step;
      cc += c_step;
      if (cc >= c) cc -= c, ++k;
    }
    // values after the body
    const int tail = total - head - kVec * body;
    if (lane < tail) {
      const int at = total - 1 - lane;
      __stcs(slab + at, value(at / c, at % c));
    }
  }
}

template <int kQueriesPerWarp>
cudaError_t launch_select_gather(const float* xyz, const float* new_xyz,
                                 const float* base, int b, int n, int s, int c,
                                 float radius2, int nsample, float* out,
                                 int32_t* idx, cudaStream_t stream) {
  const int per_block = kWarps * kQueriesPerWarp;
  const int np = (n + kRoundPoints - 1) / kRoundPoints * kRoundPoints;
  const size_t smem = sizeof(float4) * (size_t)np +
                      sizeof(int32_t) * (size_t)per_block * nsample;
  if (smem > ballscan::kSmemMax) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {  // above the default, only by opting in
    const cudaError_t err = cudaFuncSetAttribute(
        select_gather_kernel<kQueriesPerWarp>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((s + per_block - 1) / per_block, b);
  select_gather_kernel<kQueriesPerWarp><<<grid, kWarps * 32, smem, stream>>>(
      xyz, new_xyz, base, n, np, s, c, radius2, nsample, out, idx);
  return cudaGetLastError();
}

int select_gather(const float* xyz, const float* new_xyz, const float* base,
                  int b, int n, int s, int c, float radius2, int nsample,
                  int queries_per_warp, float* out, int32_t* idx, void* stream) {
  if (b <= 0 || s <= 0 || n <= 0 || nsample <= 0) return 0;
  if (c < 3 || b > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (queries_per_warp) {
    case 1:
      return (int)launch_select_gather<1>(xyz, new_xyz, base, b, n, s, c,
                                          radius2, nsample, out, idx, st);
    case 2:
      return (int)launch_select_gather<2>(xyz, new_xyz, base, b, n, s, c,
                                          radius2, nsample, out, idx, st);
    case 4:
      return (int)launch_select_gather<4>(xyz, new_xyz, base, b, n, s, c,
                                          radius2, nsample, out, idx, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// xyz (B, N, 3), new_xyz (B, S, 3), base (B, N, C) float32 ->
// out (B, S, nsample, C) float32, idx (B, S, nsample) int32; centers a
// warp (1, 2 or 4) from the host plan.
int lsdm_select_gather(const float* xyz, const float* new_xyz,
                       const float* base, int b, int n, int s, int c,
                       float radius2, int nsample, int queries_per_warp,
                       float* out, int32_t* idx, void* stream) {
  return select_gather(xyz, new_xyz, base, b, n, s, c, radius2, nsample,
                       queries_per_warp, out, idx, stream);
}

}  // extern "C"

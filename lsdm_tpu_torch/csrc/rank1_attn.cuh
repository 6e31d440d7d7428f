// Device code shared by the rank-1 attention kernels: the forward (K4,
// rank1_attn.cu) and its backward (K5, rank1_attn_bwd.cu).
//
// One definition of each pair's exponential, so that the row denominators
// K4 keeps and the weights K5 recomputes from them come from the same
// instruction sequence, and of the warp reduction both use to sum per-row
// partials across the lanes that hold the keys.
//
// Both kernels have a bf16 mode (the JAX kernels' compute_dtype=bfloat16,
// lsdm_tpu/ops/attn_pallas.py:43-56 and :86-134): q, k and v are bf16 in
// memory and read as float32, and each softmax weight w = e / Z is rounded
// to bf16 (round to nearest even) before every product, by bf16_weight,
// the same sequence in both kernels, so the backward differentiates the
// weights the forward used.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace rank1 {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// The bf16 mode's weight: e times the row's 1 / Z (rz = __frcp_rn(Z)),
// rounded to bf16 to nearest even, as a float.
__device__ __forceinline__ float bf16_weight(float e, float rz) {
  return __bfloat162float(__float2bfloat16_rn(__fmul_rn(e, rz)));
}

constexpr int kRowTile = 8;  // rows whose partials are reduced together
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The base-2 argument of the weight exp(q k - m): q k - m rounded as the
// plain version rounds it (two roundings, never an FMA), times log2(e).
// ex2_approx of it is one SFU instruction.
__device__ __forceinline__ float pair_arg(float q, float k, float m) {
  return __fmul_rn(__fsub_rn(__fmul_rn(q, k), m), kLog2e);
}

// The warp's sums of acc[0..7]: each step of the reduce-scatter halves the
// rows a lane carries (a lane with bit 4, 3, 2 set keeps the upper half),
// so lane `lane` ends with the sum of row row_of_lane(lane); lanes with
// (lane & 3) == 0 hold the eight rows once each.  The lanes are added in a
// fixed tree: pairs by lane bit 4, then 3, 2, 1, 0.
__device__ __forceinline__ float reduce_rows(float (&acc)[kRowTile], int lane) {
  const bool up16 = lane & 16, up8 = lane & 8, up4 = lane & 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = up16 ? acc[i] : acc[i + 4];
    const float keep = up16 ? acc[i + 4] : acc[i];
    acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = up8 ? acc[i] : acc[i + 2];
    const float keep = up8 ? acc[i + 2] : acc[i];
    acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  const float send = up4 ? acc[0] : acc[1];
  const float keep = up4 ? acc[1] : acc[0];
  float r = keep + __shfl_xor_sync(0xffffffffu, send, 4);
  r += __shfl_xor_sync(0xffffffffu, r, 2);
  r += __shfl_xor_sync(0xffffffffu, r, 1);
  return r;
}

// The row of a tile whose sum reduce_rows leaves on `lane`.
__device__ __forceinline__ int row_of_lane(int lane) {
  return ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1);
}

// max(k) and min(k) over the s keys of head hh of cloud b (k is (B, S, H)),
// for every thread of a block of kThreads; red_max and red_min hold
// kThreads / 32 floats of shared memory.  Ends with a block barrier.  The
// row maximum of a rank-1 row is q max(k) for q >= 0 and q min(k)
// otherwise, exactly the largest rounded logit: rounding is monotonic.
template <int kThreads, typename T>
__device__ __forceinline__ void key_range(const T* __restrict__ k, int b,
                                          int s, int h, int hh, float* red_max,
                                          float* red_min, float& kmax,
                                          float& kmin) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  kmax = -INFINITY;
  kmin = INFINITY;
  for (int j = tid; j < s; j += kThreads) {
    const float kj = to_f32(k[((size_t)b * s + j) * h + hh]);
    kmax = fmaxf(kmax, kj);
    kmin = fminf(kmin, kj);
  }
  for (int off = 16; off > 0; off >>= 1) {
    kmax = fmaxf(kmax, __shfl_xor_sync(0xffffffffu, kmax, off));
    kmin = fminf(kmin, __shfl_xor_sync(0xffffffffu, kmin, off));
  }
  if (lane == 0) {
    red_max[warp] = kmax;
    red_min[warp] = kmin;
  }
  __syncthreads();
  kmax = red_max[0];
  kmin = red_min[0];
  for (int w = 1; w < kThreads / 32; ++w) {
    kmax = fmaxf(kmax, red_max[w]);
    kmin = fminf(kmin, red_min[w]);
  }
}

}  // namespace rank1

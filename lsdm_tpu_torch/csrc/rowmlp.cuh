// Dense layers over rows of activations held in shared memory, shared by
// the fused SetAbstraction (sa_fused.cu) and FeaturePropagation
// (fp_fused.cu) stage kernels.
//
// A block holds a tile of activation rows in shared memory, row-major with
// a row stride `ld` that is a multiple of 4 floats.  Each warp computes
// 32 output columns (one per lane) of kRowChunk rows at a time: per four
// input channels it reads each row's four inputs with one 16-byte
// shared-memory load that all lanes share (they differ only in the
// column), the four weights of its column from global memory (coalesced
// across the warp, L1/L2 resident: the largest layer is 512 KB), and
// issues 4 x kRowChunk FMAs.  Every dot product is one FMA chain over the
// input channels in ascending order; the bias is added after the sum and
// ReLU applied last, as the TPU kernels do.

#pragma once

#include <cuda_runtime.h>

constexpr int kMlpThreads = 256;
constexpr int kMlpWarps = kMlpThreads / 32;
constexpr int kRowChunk = 16;   // rows a warp carries through one weight pass
constexpr int kMaxLayers = 8;
// Shared memory a block aims to stay under, so two blocks fit on an SM.
constexpr size_t kSmemBudget = 112 * 1024;
constexpr size_t kSmemMax = 227 * 1024;

struct MlpLayers {
  const float* w[kMaxLayers];  // (fin, fout) row-major, BatchNorm folded in
  const float* b[kMaxLayers];  // (fout,)
  int fout[kMaxLayers];
  int relu[kMaxLayers];        // 1: ReLU after the bias, 0: none
  int n;
};

__host__ __device__ __forceinline__ int pad4(int x) {
  return (x + 3) & ~3;
}

// acc[t] = sum_i in[t * ld + i] * w[i * fout + j], t < kRowChunk.
// Reads kRowChunk rows of `in`, valid or not: the caller allocates them.
__device__ __forceinline__ void dot_rows(
    const float* in, int ld, int fin, const float* __restrict__ w, int fout,
    int j, float (&acc)[kRowChunk]) {
#pragma unroll
  for (int t = 0; t < kRowChunk; ++t) acc[t] = 0.0f;
  const int fin4 = fin & ~3;
  int i = 0;
  for (; i < fin4; i += 4) {
    const float w0 = __ldg(w + (size_t)i * fout + j);
    const float w1 = __ldg(w + (size_t)(i + 1) * fout + j);
    const float w2 = __ldg(w + (size_t)(i + 2) * fout + j);
    const float w3 = __ldg(w + (size_t)(i + 3) * fout + j);
#pragma unroll
    for (int t = 0; t < kRowChunk; ++t) {
      const float4 a = *reinterpret_cast<const float4*>(in + t * ld + i);
      acc[t] = fmaf(a.x, w0, acc[t]);
      acc[t] = fmaf(a.y, w1, acc[t]);
      acc[t] = fmaf(a.z, w2, acc[t]);
      acc[t] = fmaf(a.w, w3, acc[t]);
    }
  }
  for (; i < fin; ++i) {
    const float wv = __ldg(w + (size_t)i * fout + j);
#pragma unroll
    for (int t = 0; t < kRowChunk; ++t) acc[t] = fmaf(in[t * ld + i], wv, acc[t]);
  }
}

// out[r * ld_out + j] = act(in[r] . w[:, j] + b[j]) for rows r < m.
// `out` may be shared or global memory.
__device__ inline void dense_rows(const float* in, int ld_in, int fin,
                                  const float* __restrict__ w,
                                  const float* __restrict__ b, int fout,
                                  int relu, float* out, int ld_out, int m) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cgs = (fout + 31) >> 5;
  const int rgs = (m + kRowChunk - 1) / kRowChunk;
  for (int item = warp; item < rgs * cgs; item += kMlpWarps) {
    const int rg = item / cgs;
    const int j = (item - rg * cgs) * 32 + lane;
    if (j >= fout) continue;
    float acc[kRowChunk];
    dot_rows(in + (size_t)rg * kRowChunk * ld_in, ld_in, fin, w, fout, j, acc);
    const float bj = __ldg(b + j);
#pragma unroll
    for (int t = 0; t < kRowChunk; ++t) {
      const int r = rg * kRowChunk + t;
      if (r < m) {
        const float v = __fadd_rn(acc[t], bj);
        out[(size_t)r * ld_out + j] = relu ? fmaxf(v, 0.0f) : v;
      }
    }
  }
}

// out[g * fout + j] = max over k < K of relu(in[g * K + k] . w[:, j] + b[j])
// for groups g < groups: a last ReLU layer followed by a max over each
// group's K rows, without storing the layer.
__device__ inline void dense_relu_max(const float* in, int ld, int fin,
                                      const float* __restrict__ w,
                                      const float* __restrict__ b, int fout,
                                      int K, int groups, float* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cgs = (fout + 31) >> 5;
  for (int item = warp; item < groups * cgs; item += kMlpWarps) {
    const int g = item / cgs;
    const int j = (item - g * cgs) * 32 + lane;
    if (j >= fout) continue;
    const float bj = __ldg(b + j);
    float best = 0.0f;  // every candidate is a ReLU output, >= 0
    for (int k0 = 0; k0 < K; k0 += kRowChunk) {
      float acc[kRowChunk];
      dot_rows(in + ((size_t)g * K + k0) * ld, ld, fin, w, fout, j, acc);
#pragma unroll
      for (int t = 0; t < kRowChunk; ++t)
        if (k0 + t < K) best = fmaxf(best, fmaxf(__fadd_rn(acc[t], bj), 0.0f));
    }
    out[(size_t)g * fout + j] = best;
  }
}

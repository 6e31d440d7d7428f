// Device code of the denoise step (K9, denoise_step.cu): the activations,
// which the denoise chain (K6, denoise_chain.cu) shares, and the dense
// layer over a block's tile of kRows point rows, its activations in shared
// memory.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace denoise {

// torch's nn.GELU(): the exact erf form
__device__ __forceinline__ float gelu(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

constexpr int kRows = 8;   // point rows per block
constexpr int kCols = 128;  // output columns per pass of dense_rows

// Where dense_rows finds the bias of output o at row r.
enum RowBias {
  kPerOut = 0,     // bias[o], global memory
  kPerOutRow = 1,  // bias[o * kRows + r], shared memory
  kPerRow = 2,     // bias[r], shared memory
};

// out[o][r] = act(sum_k in[k][r] * w[k][o] + bias) for the block's kRows
// rows, with a block of kSplit * kCols threads.  in/out: shared memory,
// k-major ([k][kRows]); w: (k_dim, out_dim) row-major, so a warp's weight
// loads are contiguous.  Thread t handles column o0 + t % kCols; part
// t / kCols sums the k congruent to it modulo kSplit (kSplit parts keep
// kSplit times the weight reads in flight), and parts 1.. leave their
// partials in red ([kSplit - 1][kCols][kRows]), which part 0 adds in
// order.  The k loop is unrolled kUnroll times, so as many reads are
// issued before their first use.  Ends with a block barrier: out is ready
// for every thread.
template <bool kGelu, int kBias, int kSplit = 2, int kUnroll = 4>
__device__ __forceinline__ void dense_rows(const float* __restrict__ w,
                                           const float* bias, const float* in,
                                           int k_dim, float* out, int out_dim,
                                           float* red) {
  static_assert(kRows == 8, "two float4 reads per k");
  const int col = threadIdx.x % kCols;
  const int part = threadIdx.x / kCols;
  for (int o0 = 0; o0 < out_dim; o0 += kCols) {
    const int o = o0 + col;
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
    if (o < out_dim) {
#pragma unroll kUnroll
      for (int k = part; k < k_dim; k += kSplit) {
        const float wv = __ldg(w + (size_t)k * out_dim + o);
        const float4 lo = *reinterpret_cast<const float4*>(in + k * kRows);
        const float4 hi = *reinterpret_cast<const float4*>(in + k * kRows + 4);
        acc[0] = fmaf(lo.x, wv, acc[0]);
        acc[1] = fmaf(lo.y, wv, acc[1]);
        acc[2] = fmaf(lo.z, wv, acc[2]);
        acc[3] = fmaf(lo.w, wv, acc[3]);
        acc[4] = fmaf(hi.x, wv, acc[4]);
        acc[5] = fmaf(hi.y, wv, acc[5]);
        acc[6] = fmaf(hi.z, wv, acc[6]);
        acc[7] = fmaf(hi.w, wv, acc[7]);
      }
      if (part > 0) {
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          red[((part - 1) * kCols + col) * kRows + r] = acc[r];
      }
    }
    __syncthreads();
    if (part == 0 && o < out_dim) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float b = kBias == kPerOutRow ? bias[o * kRows + r]
                        : kBias == kPerRow  ? bias[r]
                                            : __ldg(bias + o);
        float v = acc[r];
#pragma unroll
        for (int q = 0; q < kSplit - 1; ++q) v += red[(q * kCols + col) * kRows + r];
        v += b;
        out[o * kRows + r] = kGelu ? gelu(v) : sigmoid(v);
      }
    }
    __syncthreads();
  }
}

}  // namespace denoise

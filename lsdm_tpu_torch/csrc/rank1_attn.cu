// Rank-1-head multi-head attention, forward (K4), for Hopper.
//
// Replaces lsdm_tpu/ops/attn_pallas.py:rank1_mha_pallas.  Plain version:
// lsdm_tpu_torch/ops/attn.py:rank1_mha_plain.
//
// The SDM's pcd_attention has embed_dim == num_heads == 12, so every head
// is one scalar: per cloud b, query row l and head h,
//   out[b, l, h] = sum_s softmax_s(q[b, l, h] * k[b, s, h]) * v[b, s, h]
// (scale 1/sqrt(1) = 1, float32).  The composed path writes the logits and
// the softmax weights, two (B, 12, L, S) float32 planes (453 MB each at
// batch 1, L = S = 1024), to device memory; here they never exist.  The
// training forward also keeps each row's denominator Z = sum_s e (an
// optional (B, H, L) output), from which the backward (K5,
// csrc/rank1_attn_bwd.cu) gets every softmax weight with one exponential.
//
// What bounds it on an H100: the B x H x L x S exponentials on the
// special-function units, 16 a clock per SM (1.13e8 at a b1 sample: >=
// 0.027 ms at 1.98 GHz; 6.8e8 at the training batch of 54 clouds: >= 0.163
// ms); it moves only q, k, v and out.  So the design spends as few issued
// instructions on each (row, key) pair as it can, about as many as the SFU
// takes cycles for the exponential, which K5's layout shows how to do:
//
// - A block owns (cloud, head, 128 query rows), so a b1 sample's 9
//   clouds x 12 heads of 1024 rows launch 864 blocks, six to seven an SM.
//   The rows' q and their maximum m = q max(k) or q min(k) (exact:
//   rounding is monotonic) sit in shared memory and are read as
//   broadcasts.
// - Each of the 256 threads holds 4 keys' k and v in registers (1024 keys
//   a chunk; more keys take more chunks, the last one masked) and sweeps
//   the rows.  A pair costs q k - m rounded as the plain version rounds it,
//   times log2(e), one ex2.approx (rank1_attn.cuh, the same sequence K5
//   uses), an add into the row's sum e and an FMA into its sum e v: six
//   instructions, no compensated sums.
// - A thread's partials of 8 rows are reduced across the warp by K5's
//   reduce-scatter, each warp's row totals go to shared memory (added over
//   the chunks), and the block adds its 8 warps in order: a shallow tree
//   of 4 + 5 + 7 adds at 1024 keys, where the kernel before it ran
//   1024-term Kahan sums, about as accurate and without their 8
//   instructions a pair.  No atomics: the same bits from run to run.
// out = (sum e v) / (sum e), the denominator sum e.

#include <cuda_runtime.h>
#include <math.h>

#include "rank1_attn.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 4;                     // keys a thread holds
constexpr int kChunk = kThreads * kKeys;     // keys a block holds at once
constexpr int kRows = 128;                   // query rows a block
constexpr int kRowTile = rank1::kRowTile;

// kMasked: the last key chunk is ragged; a missing key's argument is -inf,
// so its e is 0 and it adds nothing.
template <bool kMasked>
__global__ void __launch_bounds__(kThreads)
rank1_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, int l, int s, int h,
                  float* __restrict__ out, float* __restrict__ denom) {
  __shared__ float2 rows[kRows];  // q, m
  __shared__ float red_e[kWarps][kRows], red_v[kWarps][kRows];
  __shared__ float red_max[kWarps], red_min[kWarps];
  const int tile = blockIdx.x, hh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  float kmax, kmin;
  rank1::key_range<kThreads>(k, b, s, h, hh, red_max, red_min, kmax, kmin);
  const int r0 = tile * kRows;
  const int nr = min(kRows, l - r0);
  const int rp = (nr + kRowTile - 1) / kRowTile * kRowTile;
  // padded rows (nr <= i < rp) hold q = m = 0: computed, never stored
  for (int i = tid; i < rp; i += kThreads) {
    float2 r = make_float2(0.0f, 0.0f);
    if (i < nr) {
      const float qv = q[((size_t)b * l + r0 + i) * h + hh];
      r = make_float2(qv, qv >= 0.0f ? __fmul_rn(qv, kmax) : __fmul_rn(qv, kmin));
    }
    rows[i] = r;
  }
  __syncthreads();

  const int rsel = rank1::row_of_lane(lane);
  for (int c0 = 0; c0 < s; c0 += kChunk) {
    float kk[kKeys], vv[kKeys];
    bool ok[kKeys];
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const int key = c0 + j * kThreads + tid;
      ok[j] = !kMasked || key < s;
      kk[j] = ok[j] ? k[((size_t)b * s + key) * h + hh] : 0.0f;
      vv[j] = ok[j] ? v[((size_t)b * s + key) * h + hh] : 0.0f;
    }
    for (int rt = 0; rt < rp; rt += kRowTile) {
      float ae[kRowTile], av[kRowTile];
#pragma unroll
      for (int r = 0; r < kRowTile; ++r) {
        const float2 rd = rows[rt + r];
        float se = 0.0f, sv = 0.0f;
#pragma unroll
        for (int j = 0; j < kKeys; ++j) {
          float arg = rank1::pair_arg(rd.x, kk[j], rd.y);
          if (kMasked && !ok[j]) arg = -INFINITY;
          const float e = rank1::ex2_approx(arg);
          // the first key starts each sum (0 + e and fmaf(e, v, 0) would
          // round to the same values, one instruction later)
          se = j == 0 ? e : se + e;
          sv = j == 0 ? __fmul_rn(e, vv[j]) : fmaf(e, vv[j], sv);
        }
        ae[r] = se;
        av[r] = sv;
      }
      const float te = rank1::reduce_rows(ae, lane);
      const float tv = rank1::reduce_rows(av, lane);
      if ((lane & 3) == 0) {
        const int i = rt + rsel;
        red_e[warp][i] = c0 == 0 ? te : red_e[warp][i] + te;
        red_v[warp][i] = c0 == 0 ? tv : red_v[warp][i] + tv;
      }
    }
  }
  __syncthreads();

  for (int i = tid; i < nr; i += kThreads) {
    float se = red_e[0][i], sv = red_v[0][i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      se += red_e[w][i];
      sv += red_v[w][i];
    }
    out[((size_t)b * l + r0 + i) * h + hh] = __fdiv_rn(sv, se);
    if (denom != nullptr) denom[((size_t)b * h + hh) * l + r0 + i] = se;
  }
}

}  // namespace

extern "C" {

// q (B, L, H), k and v (B, S, H), float32 -> out (B, L, H) and, unless
// denom is null, each row's sum of exp(q k - max) as denom (B, H, L).
int lsdm_rank1_attn(const float* q, const float* k, const float* v, int b,
                    int l, int s, int h, float* out, float* denom,
                    void* stream) {
  if (b <= 0 || l <= 0 || h <= 0) return 0;
  if (s < 1 || b > 65535 || h > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((l + kRows - 1) / kRows, h, b);
  const cudaStream_t st = (cudaStream_t)stream;
  if (s % kChunk != 0) {
    rank1_attn_kernel<true><<<grid, kThreads, 0, st>>>(q, k, v, l, s, h, out,
                                                       denom);
  } else {
    rank1_attn_kernel<false><<<grid, kThreads, 0, st>>>(q, k, v, l, s, h, out,
                                                        denom);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

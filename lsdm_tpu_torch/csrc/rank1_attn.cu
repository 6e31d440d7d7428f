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
//
// bf16 mode (the JAX kernel's compute_dtype=bfloat16, attn_pallas.py:43-56):
// q, k and v are bf16 in memory, half the bytes, read as float32, and every
// weight w = e / Z is rounded to bf16 before its product with v, the sum
// of the products accumulating in float32; the output and the denominators
// stay float32.  The function needs one exponential a pair, so the same
// SFU bound as the float32 mode (0.163 ms at 54 clouds), but a weight
// needs its row's Z first, before any product.  Where a row's keys fit in
// one chunk (S <= kChunk = 1024, every SDM shape) the block therefore
// takes one row tile (kRowTile = 8 rows) at a time: each thread keeps the
// tile's e for its 4 keys in registers (32 floats), sums them per row and
// reduces the rows across the warp as the float32 mode does, one block
// barrier, then each lane adds row (lane & 7)'s 8 warp partials in order
// 0..7 (the float32 mode's order, so the denominators are the same bits),
// takes its reciprocal and hands it to the warp by shuffles, and the
// thread forms bf16(e / Z) v from its registers with one FMA a pair
// (rank1_attn.cuh's bf16_weight, which K5 shares).  One exponential a
// pair, one barrier a row tile (16 a block).  More keys than one chunk
// keep two sweeps: the first sums e as the float32 mode does, the second
// recomputes each e and adds bf16(e / Z) v, two exponentials a pair.
// Registers (ptxas, sm_90a): the one-sweep instances 64, the two-sweep
// bf16 ones 40 and 44, the float32 ones 40; no spills.  On an H100 the one
// sweep took the bf16 mode from 0.5555 to ~0.39 ms at 54 clouds with
// denominators, below SDPA's bf16 forward (PERF.md section 6, PR 16).

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "rank1_attn.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 4;                     // keys a thread holds
constexpr int kChunk = kThreads * kKeys;     // keys a block holds at once
constexpr int kRows = 128;                   // query rows a block
constexpr int kRowTile = rank1::kRowTile;

// This thread's keys of the chunk from c0: k and v, and whether each exists.
template <bool kMasked, typename T>
__device__ __forceinline__ void load_keys(const T* __restrict__ k,
                                          const T* __restrict__ v, int b,
                                          int s, int h, int hh, int c0,
                                          float (&kk)[kKeys],
                                          float (&vv)[kKeys],
                                          bool (&ok)[kKeys]) {
#pragma unroll
  for (int j = 0; j < kKeys; ++j) {
    const int key = c0 + j * kThreads + threadIdx.x;
    ok[j] = !kMasked || key < s;
    kk[j] = ok[j] ? rank1::to_f32(k[((size_t)b * s + key) * h + hh]) : 0.0f;
    vv[j] = ok[j] ? rank1::to_f32(v[((size_t)b * s + key) * h + hh]) : 0.0f;
  }
}

// The exponential of a pair: e = exp(q k - m) by one ex2.approx; a missing
// key's argument is -inf, so its e is 0 and it adds nothing.
template <bool kMasked>
__device__ __forceinline__ float pair_exp(float2 rd, float kj, bool ok) {
  float arg = rank1::pair_arg(rd.x, kj, rd.y);
  if (kMasked && !ok) arg = -INFINITY;
  return rank1::ex2_approx(arg);
}

// kMasked: the last key chunk is ragged.  T: float (the float32 mode) or
// __nv_bfloat16 (the bf16 mode).  kOneSweep (bf16 mode, S <= kChunk): each
// pair's exponential computed once and kept in registers until its row's
// Z is known.
template <bool kMasked, typename T, bool kOneSweep = false>
__global__ void __launch_bounds__(kThreads)
rank1_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, int l, int s, int h,
                  float* __restrict__ out, float* __restrict__ denom) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  __shared__ float2 rows[kRows];  // q, m
  __shared__ float rz[kBf16 ? kRows : 1];  // bf16 mode: each row's 1 / Z
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
      const float qv = rank1::to_f32(q[((size_t)b * l + r0 + i) * h + hh]);
      r = make_float2(qv, qv >= 0.0f ? __fmul_rn(qv, kmax) : __fmul_rn(qv, kmin));
    }
    rows[i] = r;
  }
  __syncthreads();

  const int rsel = rank1::row_of_lane(lane);
  float kk[kKeys], vv[kKeys];
  bool ok[kKeys];
  if constexpr (kOneSweep) {
    static_assert(kBf16, "one sweep is the bf16 mode's");
    load_keys<kMasked>(k, v, b, s, h, hh, 0, kk, vv, ok);
    for (int rt = 0; rt < rp; rt += kRowTile) {
      float e[kRowTile][kKeys], ae[kRowTile];
#pragma unroll
      for (int r = 0; r < kRowTile; ++r) {
        const float2 rd = rows[rt + r];
#pragma unroll
        for (int j = 0; j < kKeys; ++j) {
          e[r][j] = pair_exp<kMasked>(rd, kk[j], ok[j]);
          ae[r] = j == 0 ? e[r][j] : ae[r] + e[r][j];
        }
      }
      const float te = rank1::reduce_rows(ae, lane);
      if ((lane & 3) == 0) red_e[warp][rt + rsel] = te;
      __syncthreads();  // the tile's partials of every warp
      // lane: row (lane & 7) of the tile, its warps added in order
      const int ri = rt + (lane & 7);
      float z = red_e[0][ri];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) z += red_e[w][ri];
      if (denom != nullptr && warp == 0 && lane < kRowTile && ri < nr)
        denom[((size_t)b * h + hh) * l + r0 + ri] = z;
      const float rzl = __frcp_rn(z);
      float av[kRowTile];
#pragma unroll
      for (int r = 0; r < kRowTile; ++r) {
        const float rzr = __shfl_sync(0xffffffffu, rzl, r);
        float sv = 0.0f;
#pragma unroll
        for (int j = 0; j < kKeys; ++j)
          sv = fmaf(rank1::bf16_weight(e[r][j], rzr), vv[j], sv);
        av[r] = sv;
      }
      const float tv = rank1::reduce_rows(av, lane);
      if ((lane & 3) == 0) red_v[warp][rt + rsel] = tv;
    }
  } else if constexpr (kBf16) {
    // first sweep: the denominators, summed as the float32 mode sums them
    for (int c0 = 0; c0 < s; c0 += kChunk) {
      load_keys<kMasked>(k, v, b, s, h, hh, c0, kk, vv, ok);
      for (int rt = 0; rt < rp; rt += kRowTile) {
        float ae[kRowTile];
#pragma unroll
        for (int r = 0; r < kRowTile; ++r) {
          const float2 rd = rows[rt + r];
          float se = 0.0f;
#pragma unroll
          for (int j = 0; j < kKeys; ++j) {
            const float e = pair_exp<kMasked>(rd, kk[j], ok[j]);
            se = j == 0 ? e : se + e;
          }
          ae[r] = se;
        }
        const float te = rank1::reduce_rows(ae, lane);
        if ((lane & 3) == 0) {
          const int i = rt + rsel;
          red_e[warp][i] = c0 == 0 ? te : red_e[warp][i] + te;
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < rp; i += kThreads) {
      float se = red_e[0][i];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) se += red_e[w][i];
      rz[i] = __frcp_rn(se);
      if (denom != nullptr && i < nr)
        denom[((size_t)b * h + hh) * l + r0 + i] = se;
    }
    __syncthreads();
  }
  if constexpr (!kOneSweep) {  // the float32 mode; the bf16 mode's second sweep
    for (int c0 = 0; c0 < s; c0 += kChunk) {
      load_keys<kMasked>(k, v, b, s, h, hh, c0, kk, vv, ok);
      for (int rt = 0; rt < rp; rt += kRowTile) {
        float ae[kRowTile], av[kRowTile];
#pragma unroll
        for (int r = 0; r < kRowTile; ++r) {
          const float2 rd = rows[rt + r];
          const float rzr = kBf16 ? rz[rt + r] : 0.0f;
          float se = 0.0f, sv = 0.0f;
#pragma unroll
          for (int j = 0; j < kKeys; ++j) {
            const float e = pair_exp<kMasked>(rd, kk[j], ok[j]);
            if constexpr (kBf16) {
              // bf16(e / Z) v is exact in float32: one FMA adds it
              sv = fmaf(rank1::bf16_weight(e, rzr), vv[j], sv);
            } else {
              // the first key starts each sum (0 + e and fmaf(e, v, 0) would
              // round to the same values, one instruction later)
              se = j == 0 ? e : se + e;
              sv = j == 0 ? __fmul_rn(e, vv[j]) : fmaf(e, vv[j], sv);
            }
          }
          ae[r] = se;
          av[r] = sv;
        }
        const float tv = rank1::reduce_rows(av, lane);
        const float te = kBf16 ? 0.0f : rank1::reduce_rows(ae, lane);
        if ((lane & 3) == 0) {
          const int i = rt + rsel;
          if (!kBf16) red_e[warp][i] = c0 == 0 ? te : red_e[warp][i] + te;
          red_v[warp][i] = c0 == 0 ? tv : red_v[warp][i] + tv;
        }
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
    if constexpr (kBf16) {
      out[((size_t)b * l + r0 + i) * h + hh] = sv;
    } else {
      out[((size_t)b * l + r0 + i) * h + hh] = __fdiv_rn(sv, se);
      if (denom != nullptr) denom[((size_t)b * h + hh) * l + r0 + i] = se;
    }
  }
}

template <typename T>
int launch_rank1_attn(const T* q, const T* k, const T* v, int b, int l, int s,
                      int h, float* out, float* denom, void* stream) {
  if (b <= 0 || l <= 0 || h <= 0) return 0;
  if (s < 1 || b > 65535 || h > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((l + kRows - 1) / kRows, h, b);
  const cudaStream_t st = (cudaStream_t)stream;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (s <= kChunk) {  // one sweep: every key of a row in one chunk
      if (s < kChunk)
        rank1_attn_kernel<true, T, true><<<grid, kThreads, 0, st>>>(
            q, k, v, l, s, h, out, denom);
      else
        rank1_attn_kernel<false, T, true><<<grid, kThreads, 0, st>>>(
            q, k, v, l, s, h, out, denom);
      return (int)cudaGetLastError();
    }
  }
  if (s % kChunk != 0) {
    rank1_attn_kernel<true, T><<<grid, kThreads, 0, st>>>(q, k, v, l, s, h, out,
                                                          denom);
  } else {
    rank1_attn_kernel<false, T><<<grid, kThreads, 0, st>>>(q, k, v, l, s, h,
                                                           out, denom);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, L, H), k and v (B, S, H), float32 -> out (B, L, H) and, unless
// denom is null, each row's sum of exp(q k - max) as denom (B, H, L).
int lsdm_rank1_attn(const float* q, const float* k, const float* v, int b,
                    int l, int s, int h, float* out, float* denom,
                    void* stream) {
  return launch_rank1_attn(q, k, v, b, l, s, h, out, denom, stream);
}

// The bf16 mode: q, k, v bf16, out and denom float32, as above.
int lsdm_rank1_attn_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                         const __nv_bfloat16* v, int b, int l, int s, int h,
                         float* out, float* denom, void* stream) {
  return launch_rank1_attn(q, k, v, b, l, s, h, out, denom, stream);
}

}  // extern "C"

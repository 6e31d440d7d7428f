// Rank-1-head multi-head attention, backward (K5), for Hopper.
//
// Replaces lsdm_tpu/ops/attn_pallas.py:_rank1_mha_bwd_pallas (the VJP of
// rank1_mha_train, whose forward is K4, csrc/rank1_attn.cu).  Plain
// version: lsdm_tpu_torch/ops/attn.py:rank1_mha_bwd_plain.
//
// Per cloud b and head h (one scalar per head, scale 1), with
// w[l, s] = softmax_s(q[l] k[s]), out[l] = sum_s w v[s], the cotangent g
// and D[l] = g[l] out[l]:
//   dq[l] = sum_s w[l, s] (g[l] v[s] - D[l]) k[s]
//   dk[s] = sum_l w[l, s] (g[l] v[s] - D[l]) q[l]
//   dv[s] = sum_l w[l, s] g[l]
// The (L, S) plane of w is recomputed and never stored.
//
// One pass.  The forward (K4) saves each row's softmax denominator
// Z = sum_s e, e = exp(q k - m), as flash attention saves its
// log-sum-exp, so every weight is known from its own pair, w = e / Z, the
// row max m from max(k) / min(k) as in K4 (exact: rounding is monotonic).
// A block owns (cloud, head, 1024 keys); each of its 256 threads holds 4
// keys in registers and sweeps every row, which the block stages in
// shared memory ({q, m, g, D} and {q / Z, g / Z}, read as broadcasts).
// Per (row, key) pair: q k - m rounded as the plain version rounds it,
// times log2(e), one ex2.approx on the SFU for e (rank1_attn.cuh: the
// sequence by which K4 sums the denominators it saves), g v - D rounded as the
// plain version rounds it, p = e (g v - D), and three FFMAs: p (q / Z)
// into dk and e (g / Z) into dv (the key's, in registers), p k into the
// row's dq partial, which is divided by Z once a row.  Nine FP32
// instructions and one SFU exponential a pair, where the two-pass kernel
// before it took two expf sequences and four Kahan sums.  Z stays out of
// the exponent: folded in as - log2 Z, its rounding at |log2 Z| up to 10
// would cost each weight up to 3e-7 of relative error; as a factor of the
// row's constants it costs one rounding, and the exponent's argument is
// small where the weight is large.  The dq partials of a tile of 8 rows are reduced across the warp
// by a reduce-scatter (3 halving shuffle steps, then 2 butterflies: 9
// shuffles for 8 rows), each warp's per-row total goes to shared memory,
// and the block adds its 8 warps in order.  (8 warps of 4 keys a thread
// ran faster than 4 warps of 8 keys on an H100, PERF.md: more warps in
// flight hide more of the SFU's and the FP32 chains' latency.)  dk and dv are summed in
// groups of 32 rows, the groups then in sequence: no compensation in the
// inner loop.  Where S exceeds one block's 1024 keys, each block writes
// its dq partial to a (tiles, B, H, L) scratch and a second short pass
// adds the tiles in order.  No atomics: the result is the same bits from
// run to run.
//
// What bounds it on an H100: the B x H x L x S exponentials on the
// special-function units, 16 a clock per SM (6.8e8 at the training
// flagship, 54 clouds of 1024 points, 12 heads: >= 0.163 ms at 1.98
// GHz), and, at nine FP32 instructions beside each, the instruction-issue
// rate, about as slow.  The inputs and outputs are ~13 MB.
//
// bf16 mode (the JAX backward's compute_dtype=bfloat16, attn_pallas.py:
// 86-134 and its custom VJP's casts, :191-196): q, k and v are bf16 in
// memory and read as float32; the recomputed weight is rounded to bf16,
// w = bf16(e / Z) by rank1_attn.cuh's bf16_weight (K4's sequence, so the
// weights are the ones K4 multiplied v by), before every contraction:
// p = w (g v - D), dq += p k, dk += p q, dv += w g, no division by Z after
// it.  D = g out stays float32, and dq, dk and dv are stored as bf16,
// rounded to nearest even once from their float32 sums.

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "rank1_attn.cuh"

namespace {

constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kKeysPerThread = 4;
constexpr int kKeysPerBlock = kBwdThreads * kKeysPerThread;
constexpr int kRowTile = rank1::kRowTile;
constexpr int kRowGroup = 32;  // rows summed into dk, dv before the running sum

// kMasked: the last key tile is ragged.  A missing key holds k = v = 0 and
// its base-2 argument is clamped to 0, so its e stays finite and its dq
// contribution p * 0 is 0; its dk and dv are not stored.  (A real key's
// argument is <= 0 anyway: q k <= m.)  T: float (the float32 mode) or
// __nv_bfloat16 (the bf16 mode), the type of q, k, v, dq, dk and dv.
template <bool kMasked, typename T>
__global__ void __launch_bounds__(kBwdThreads)
rank1_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ out,
                 const float* __restrict__ g, const float* __restrict__ denom,
                 int l, int lp, int s, int h, T* __restrict__ dq,
                 T* __restrict__ dk, T* __restrict__ dv,
                 float* __restrict__ part) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ float4 rows[];  // lp x {q, m, g, D}
  // lp x {q/Z, g/Z}; in the bf16 mode lp x {1/Z, unused}
  float2* rows_n = reinterpret_cast<float2*>(rows + lp);
  float* red = reinterpret_cast<float*>(rows_n + lp);     // kBwdWarps x lp
  __shared__ float red_max[kBwdWarps], red_min[kBwdWarps];
  const int tile = blockIdx.x, hh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  float kmax, kmin;
  rank1::key_range<kBwdThreads>(k, b, s, h, hh, red_max, red_min, kmax, kmin);
  // padded rows (l <= i < lp) have g = D = 0: they add nothing
  for (int i = tid; i < lp; i += kBwdThreads) {
    float4 r = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float2 rn = make_float2(0.0f, 0.0f);
    if (i < l) {
      const size_t at = ((size_t)b * l + i) * h + hh;
      const float qv = rank1::to_f32(q[at]), gv = g[at];
      const float z = denom[((size_t)b * h + hh) * l + i];
      r = make_float4(qv, qv >= 0.0f ? __fmul_rn(qv, kmax) : __fmul_rn(qv, kmin),
                      gv, __fmul_rn(gv, out[at]));
      rn = kBf16 ? make_float2(__frcp_rn(z), 0.0f)
                 : make_float2(__fdiv_rn(qv, z), __fdiv_rn(gv, z));
    }
    rows[i] = r;
    rows_n[i] = rn;
  }

  float kk[kKeysPerThread], vv[kKeysPerThread];
  float dks[kKeysPerThread], dvs[kKeysPerThread];
  const int key0 = tile * kKeysPerBlock + tid;
#pragma unroll
  for (int j = 0; j < kKeysPerThread; ++j) {
    const int key = key0 + j * kBwdThreads;
    const bool ok = !kMasked || key < s;
    kk[j] = ok ? rank1::to_f32(k[((size_t)b * s + key) * h + hh]) : 0.0f;
    vv[j] = ok ? rank1::to_f32(v[((size_t)b * s + key) * h + hh]) : 0.0f;
    dks[j] = 0.0f;
    dvs[j] = 0.0f;
  }
  __syncthreads();

  const int rsel = rank1::row_of_lane(lane);
  for (int r0 = 0; r0 < lp; r0 += kRowGroup) {
    float dkg[kKeysPerThread], dvg[kKeysPerThread];
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) dkg[j] = dvg[j] = 0.0f;
    const int r1 = min(r0 + kRowGroup, lp);
    for (int rt = r0; rt < r1; rt += kRowTile) {
      float acc[kRowTile];
#pragma unroll
      for (int r = 0; r < kRowTile; ++r) {
        const float4 rd = rows[rt + r];  // q, m, g, D
        const float2 rn = rows_n[rt + r];  // q / Z, g / Z (bf16 mode: 1 / Z)
        float a = 0.0f;
#pragma unroll
        for (int j = 0; j < kKeysPerThread; ++j) {
          float arg = rank1::pair_arg(rd.x, kk[j], rd.y);
          if (kMasked) arg = fminf(arg, 0.0f);
          const float e = rank1::ex2_approx(arg);
          if constexpr (kBf16) {
            const float w = rank1::bf16_weight(e, rn.x);
            const float p = __fmul_rn(w, __fsub_rn(__fmul_rn(rd.z, vv[j]), rd.w));
            a = fmaf(p, kk[j], a);
            dkg[j] = fmaf(p, rd.x, dkg[j]);
            dvg[j] = fmaf(w, rd.z, dvg[j]);
          } else {
            const float p = __fmul_rn(e, __fsub_rn(__fmul_rn(rd.z, vv[j]), rd.w));
            a = fmaf(p, kk[j], a);
            dkg[j] = fmaf(p, rn.x, dkg[j]);
            dvg[j] = fmaf(e, rn.y, dvg[j]);
          }
        }
        acc[r] = a;
      }
      const float sum = rank1::reduce_rows(acc, lane);
      if ((lane & 3) == 0) red[warp * lp + rt + rsel] = sum;
    }
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) {
      dks[j] += dkg[j];
      dvs[j] += dvg[j];
    }
  }

#pragma unroll
  for (int j = 0; j < kKeysPerThread; ++j) {
    const int key = key0 + j * kBwdThreads;
    if (kMasked && key >= s) continue;
    const size_t at = ((size_t)b * s + key) * h + hh;
    rank1::store(dk + at, dks[j]);
    rank1::store(dv + at, dvs[j]);
  }
  __syncthreads();
  for (int i = tid; i < l; i += kBwdThreads) {
    float t = red[i];
    for (int w = 1; w < kBwdWarps; ++w) t += red[w * lp + i];
    if (!kBf16) t = __fdiv_rn(t, denom[((size_t)b * h + hh) * l + i]);
    if (part == nullptr) {
      rank1::store(dq + ((size_t)b * l + i) * h + hh, t);
    } else {
      part[(((size_t)tile * gridDim.z + b) * h + hh) * l + i] = t;
    }
  }
}

// dq from the key tiles' partials, added in tile order.
template <typename T>
__global__ void rank1_bwd_dq_kernel(const float* __restrict__ part, int tiles,
                                    int bsz, int l, int h,
                                    T* __restrict__ dq) {
  const size_t n = (size_t)bsz * l * h;
  const size_t stride = (size_t)bsz * h * l;  // one tile's partials
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    const int hh = (int)(e % h);
    const size_t bl = e / h;
    const int i = (int)(bl % l);
    const size_t b = bl / l;
    const size_t at = (b * h + hh) * l + i;
    float t = part[at];
    for (int tt = 1; tt < tiles; ++tt) t += part[tt * stride + at];
    rank1::store(dq + e, t);
  }
}

template <typename T>
int launch_rank1_attn_bwd(const T* q, const T* k, const T* v, const float* out,
                          const float* g, const float* denom, int b, int l,
                          int s, int h, T* dq, T* dk, T* dv, float* scratch,
                          void* stream) {
  if (b <= 0 || l <= 0 || h <= 0 || s <= 0) return 0;
  if (b > 65535 || h > 65535) return (int)cudaErrorInvalidValue;
  const int lp = (l + kRowTile - 1) / kRowTile * kRowTile;
  const size_t smem = sizeof(float) * (size_t)lp * (4 + 2 + kBwdWarps);
  const int tiles = (s + kKeysPerBlock - 1) / kKeysPerBlock;
  const bool masked = s % kKeysPerBlock != 0;
  float* part = tiles > 1 ? scratch : nullptr;
  if (tiles > 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(tiles, h, b);
  cudaError_t err;
  if (masked) {
    err = cudaFuncSetAttribute(rank1_bwd_kernel<true, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    rank1_bwd_kernel<true, T><<<grid, kBwdThreads, smem, st>>>(
        q, k, v, out, g, denom, l, lp, s, h, dq, dk, dv, part);
  } else {
    err = cudaFuncSetAttribute(rank1_bwd_kernel<false, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    rank1_bwd_kernel<false, T><<<grid, kBwdThreads, smem, st>>>(
        q, k, v, out, g, denom, l, lp, s, h, dq, dk, dv, part);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || tiles == 1) return (int)err;
  const size_t n = (size_t)b * l * h;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  rank1_bwd_dq_kernel<T><<<blocks, 256, 0, st>>>(part, tiles, b, l, h, dq);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Key tiles of one (cloud, head): the scratch holds (tiles, B, H, L)
// floats where this is above 1, none otherwise.
int lsdm_rank1_attn_bwd_tiles(int s) {
  return (s + kKeysPerBlock - 1) / kKeysPerBlock;
}

// q, out, g (B, L, H), k and v (B, S, H), denom (B, H, L) the forward's
// row sums of exp(q k - max), float32 -> dq (B, L, H), dk and dv
// (B, S, H); scratch: (tiles, B, H, L) float32 where there is more than
// one key tile, else unused (may be null).
int lsdm_rank1_attn_bwd(const float* q, const float* k, const float* v,
                        const float* out, const float* g, const float* denom,
                        int b, int l, int s, int h, float* dq, float* dk,
                        float* dv, float* scratch, void* stream) {
  return launch_rank1_attn_bwd(q, k, v, out, g, denom, b, l, s, h, dq, dk, dv,
                               scratch, stream);
}

// The bf16 mode: q, k, v and dq, dk, dv bf16; out, g, denom and the
// scratch float32, as above.
int lsdm_rank1_attn_bwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                             const __nv_bfloat16* v, const float* out,
                             const float* g, const float* denom, int b, int l,
                             int s, int h, __nv_bfloat16* dq,
                             __nv_bfloat16* dk, __nv_bfloat16* dv,
                             float* scratch, void* stream) {
  return launch_rank1_attn_bwd(q, k, v, out, g, denom, b, l, s, h, dq, dk, dv,
                               scratch, stream);
}

}  // extern "C"

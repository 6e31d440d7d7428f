// Rank-1-head multi-head attention, backward (K5), bf16 mode, on the bf16
// tensor cores of Hopper.
//
// Replaces lsdm_tpu/ops/attn_pallas.py:_rank1_mha_bwd_pallas at
// compute_dtype=bfloat16 (:86-134; the custom VJP's casts, :191-196).
// Plain version: lsdm_tpu_torch/ops/attn.py:rank1_mha_bwd_plain on bf16
// q, k, v.  The float32 mode is csrc/rank1_attn_bwd.cu.
//
// Per cloud b and head h (one scalar per head, scale 1), with the weights
// w[l, s] = bf16(e / Z) of the forward (K4: e = exp(q k - m) by
// rank1_attn.cuh's pair_arg and ex2_approx, Z its saved row denominator),
// the cotangent g and D[l] = g[l] out[l]:
//   dq[l] = sum_s w (g[l] v[s] - D[l]) k[s]
//   dk[s] = sum_l w (g[l] v[s] - D[l]) q[l]
//   dv[s] = sum_l w g[l]
// Split by linearity, every sum is the bf16 plane W times a few vectors:
//   dq[l] = g[l] sum_s w (v k)[s] - D[l] sum_s w k[s]
//   dk[s] = v[s] sum_l w (g q)[l] - sum_l w (D q)[l]
//   dv[s] = sum_l w g[l]
// Every weight is a bf16 value and k, v are bf16, so these products run
// on mma.sync.m16n8k16 (bf16 operands, float32 sums) once each vector is
// an exact sum of bf16 parts: v k, a product of two bf16 values (at most
// 16 significant bits), is two parts; g, g q and D q (float32, g q and
// D q rounded once) are three (8 + 8 + 8 bits).  So the B operands hold
// the vectors exactly, and the sums differ from the plain version's only
// in their order (and the one rounding of g q and D q).
//
// Layout.  A block owns (key tile of 1024 keys, head, cloud), as the
// float32 mode; each of its 16 warps owns 64 keys (four m16 key tiles) and
// sweeps every row in 16-row tiles.  For a (row tile, key tile) a lane
// computes its 8 weights straight into the A fragment (one ex2.approx a
// pair: the exponentials are the SFU bound, so none is computed twice),
// packs them two to a cvt.rn.bf16x2.f32, and
//   - one mma with the key tile's B (columns v k hi, v k lo, k; built from
//     the lane's own four keys, held in registers for the whole sweep)
//     adds the tile's dq sums, carried across the warp's four key tiles;
//   - four movmatrix.trans turn the A fragment into W^T's, and two mma with
//     the row tile's B (columns g, g q, D q in three parts each; staged in
//     shared memory once a row chunk, read by one ldmatrix.x4.trans) add to
//     the key tile's dk and dv sums, which stay in registers over all rows.
// Per pair that leaves pair_arg's three FP32 instructions, the SFU's
// exponential, one multiply by 1 / Z and half a packed conversion.
// Rows are staged in chunks of 256 (their q, m, 1 / Z, g, D and split
// columns), so shared memory does not grow with L.  After a chunk, each
// warp's dq sums of a row are combined, g (vk hi + vk lo) - D k, one value a
// row a warp, and the block adds its 16 warps in order.  Where S exceeds
// 1024 keys, each block writes its dq partial to the (tiles, B, H, L)
// scratch and a second short pass adds the tiles in order.  No atomics: the
// same bits from run to run.  dq, dk and dv are stored as bf16, rounded to
// nearest even once from their float32 sums.
//
// What bounds it on an H100: the B x H x L x S exponentials on the
// special-function units, 16 a clock per SM (6.8e8 at the training
// flagship, 54 clouds of 1024 points, 12 heads: >= 0.163 ms at 1.98 GHz);
// the instructions a pair now issue (~6) fit beside the SFU's 8 clocks a
// warp instruction.  The products are 3 mma a 256-pair tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "denoise_mma.cuh"
#include "rank1_attn.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kKeyTiles = 4;  // m16 key tiles a warp
constexpr int kKeysPerWarp = 16 * kKeyTiles;
// keys a block: the float32 mode's, so lsdm_rank1_attn_bwd_tiles serves both
constexpr int kKeysPerBlock = kWarps * kKeysPerWarp;
static_assert(kKeysPerBlock == 1024, "the scratch's key tiles are 1024 keys");
constexpr int kChunk = 256;  // rows staged at once
// bf16 a staged row of split columns: 16 used; a 48-byte stride puts the
// eight rows of an ldmatrix on distinct banks
constexpr int kSplitStride = 24;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// x as three bf16 values whose sum is x exactly (the parts of a float32
// number: 8 + 8 + 8 significant bits; each difference is exact in float32)
__device__ __forceinline__ void split3(float x, float& p0, float& p1, float& p2) {
  p0 = bf16_round(x);
  const float r = __fsub_rn(x, p0);
  p1 = bf16_round(r);
  p2 = bf16_round(__fsub_rn(r, p1));
}

// the transpose of an 8 x 8 bf16 fragment across the warp
__device__ __forceinline__ uint32_t transpose8(uint32_t a) {
  uint32_t d;
  asm("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(d) : "r"(a));
  return d;
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// e / Z of row {q, m, 1 / Z, .} and key k before its bf16 rounding: K4's
// sequence (rank1_attn.cuh), so that the packed rounding gives K4's weight
template <bool kMasked>
__device__ __forceinline__ float weight(const float4& row, float k) {
  float arg = rank1::pair_arg(row.x, k, row.y);
  if (kMasked) arg = fminf(arg, 0.0f);
  return __fmul_rn(rank1::ex2_approx(arg), row.z);
}

// kMasked: the last key tile is ragged.  A missing key holds k = v = 0 and
// its base-2 argument is clamped to 0, so its weight stays finite; its dq
// columns are 0 and its dk and dv are not stored.  Padded rows hold
// 1 / Z = 0 (weight 0) and zero columns.
template <bool kMasked>
__global__ void __launch_bounds__(kThreads, 1)
rank1_bwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const float* __restrict__ out, const float* __restrict__ g,
                      const float* __restrict__ denom, int l, int s, int h,
                      __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, float* __restrict__ part) {
  __shared__ float4 rows[kChunk];    // q, m, 1 / Z, g
  __shared__ float rows_d[kChunk];   // D = g out
  // columns 0-5: g, g q, D q (parts 1 and 2 each), 8, 10, 12: their part 3
  __shared__ __align__(16) __nv_bfloat16 split[kChunk][kSplitStride];
  __shared__ float red[kWarps][kChunk];  // each warp's dq sum of a row
  __shared__ float red_max[kWarps], red_min[kWarps];
  const int tile = blockIdx.x, hh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int quad = lane & 3, grp = lane >> 2;

  float kmax, kmin;
  rank1::key_range<kThreads>(k, b, s, h, hh, red_max, red_min, kmax, kmin);

  // key tile t of the warp: this lane's keys key0 + 16 t + 2 quad + {0, 1,
  // 8, 9}, those of its A fragment and of dq's B fragment
  const int key0 = tile * kKeysPerBlock + warp * kKeysPerWarp;
  const bool live = !kMasked || key0 < s;  // warp-uniform
  float kk[kKeyTiles][4];
  uint32_t bq[kKeyTiles][2];  // dq's B: column grp of {vk hi, vk lo, k, 0...}
  float acc[kKeyTiles][2][4];  // dk, dv sums: keys grp, grp + 8; columns 2 quad, +1
#pragma unroll
  for (int t = 0; t < kKeyTiles; ++t) {
    float col[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = key0 + 16 * t + 2 * quad + (j & 1) + (j >> 1) * 8;
      const bool ok = !kMasked || key < s;
      const size_t at = ((size_t)b * s + key) * h + hh;
      const float kf = ok ? rank1::to_f32(k[at]) : 0.0f;
      const float vf = ok ? rank1::to_f32(v[at]) : 0.0f;
      const float vk = __fmul_rn(vf, kf);  // exact: 8 x 8 significant bits
      const float hi = bf16_round(vk);
      kk[t][j] = kf;
      col[j] = grp == 0 ? hi : grp == 1 ? __fsub_rn(vk, hi) : grp == 2 ? kf : 0.0f;
    }
    bq[t][0] = denoise::pack(col[0], col[1]);
    bq[t][1] = denoise::pack(col[2], col[3]);
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[t][0][i] = acc[t][1][i] = 0.0f;
  }

  for (int c0 = 0; c0 < l; c0 += kChunk) {
    const int here = min(kChunk, l - c0);
    const int row_tiles = (here + 15) / 16;
    __syncthreads();  // the last chunk's rows and sums are read
    if (tid < 16 * row_tiles) {
      float4 r4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float d = 0.0f;
      uint4 lo = make_uint4(0u, 0u, 0u, 0u), hi = lo;
      if (c0 + tid < l) {
        const size_t at = ((size_t)b * l + c0 + tid) * h + hh;
        const float qv = rank1::to_f32(q[at]), gv = g[at];
        const float z = denom[((size_t)b * h + hh) * l + c0 + tid];
        d = __fmul_rn(gv, out[at]);
        r4 = make_float4(qv, qv >= 0.0f ? __fmul_rn(qv, kmax) : __fmul_rn(qv, kmin),
                         __frcp_rn(z), gv);
        float g0, g1, g2, x0, x1, x2, y0, y1, y2;
        split3(gv, g0, g1, g2);
        split3(__fmul_rn(gv, qv), x0, x1, x2);
        split3(__fmul_rn(d, qv), y0, y1, y2);
        lo = make_uint4(denoise::pack(g0, g1), denoise::pack(x0, x1),
                        denoise::pack(y0, y1), 0u);
        hi = make_uint4(denoise::pack(g2, 0.0f), denoise::pack(x2, 0.0f),
                        denoise::pack(y2, 0.0f), 0u);
      }
      rows[tid] = r4;
      rows_d[tid] = d;
      *reinterpret_cast<uint4*>(&split[tid][0]) = lo;
      *reinterpret_cast<uint4*>(&split[tid][8]) = hi;
    }
    __syncthreads();
    for (int rt = 0; rt < row_tiles; ++rt) {
      const int r = 16 * rt + grp;
      if (!live) {
        if (quad == 0) red[warp][r] = red[warp][r + 8] = 0.0f;
        continue;
      }
      const float4 ra = rows[r], rb = rows[r + 8];
      uint32_t bf[4];  // the row tile's B: columns 0-7, then 8-15
      ldsm_x4_trans(bf, denoise::smem_u32(&split[16 * rt + (lane & 15)][(lane >> 4) * 8]));
      float dqs[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int t = 0; t < kKeyTiles; ++t) {
        const uint32_t a[4] = {
            denoise::pack(weight<kMasked>(ra, kk[t][0]), weight<kMasked>(ra, kk[t][1])),
            denoise::pack(weight<kMasked>(rb, kk[t][0]), weight<kMasked>(rb, kk[t][1])),
            denoise::pack(weight<kMasked>(ra, kk[t][2]), weight<kMasked>(ra, kk[t][3])),
            denoise::pack(weight<kMasked>(rb, kk[t][2]), weight<kMasked>(rb, kk[t][3]))};
        denoise::mma(dqs, a, bq[t][0], bq[t][1]);
        const uint32_t at[4] = {transpose8(a[0]), transpose8(a[2]), transpose8(a[1]),
                                transpose8(a[3])};
        denoise::mma(acc[t][0], at, bf[0], bf[1]);
        denoise::mma(acc[t][1], at, bf[2], bf[3]);
      }
      // quad 0 holds columns vk hi, vk lo of rows r and r + 8; quad 1 column k
      const float kr = __shfl_down_sync(0xffffffffu, dqs[0], 1);
      const float kr8 = __shfl_down_sync(0xffffffffu, dqs[2], 1);
      if (quad == 0) {
        red[warp][r] = __fsub_rn(__fmul_rn(ra.w, dqs[0] + dqs[1]), __fmul_rn(rows_d[r], kr));
        red[warp][r + 8] =
            __fsub_rn(__fmul_rn(rb.w, dqs[2] + dqs[3]), __fmul_rn(rows_d[r + 8], kr8));
      }
    }
    __syncthreads();
    for (int i = tid; i < here; i += kThreads) {
      float t = red[0][i];
      for (int w = 1; w < kWarps; ++w) t += red[w][i];
      if (part == nullptr) {
        dq[((size_t)b * l + c0 + i) * h + hh] = __float2bfloat16_rn(t);
      } else {
        part[(((size_t)tile * gridDim.z + b) * h + hh) * l + c0 + i] = t;
      }
    }
  }

  if (!live) return;
  // columns 2 quad, +1 and 8 + 2 quad: quad 0 holds dv's three parts,
  // quad 1 those of sum w (g q), quad 2 those of sum w (D q)
#pragma unroll
  for (int t = 0; t < kKeyTiles; ++t) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float sum = acc[t][0][2 * half] + (acc[t][0][2 * half + 1] + acc[t][1][2 * half]);
      const float dqk = __shfl_down_sync(0xffffffffu, sum, 1);  // quad 2 -> quad 1
      const int key = key0 + 16 * t + grp + 8 * half;
      if ((kMasked && key >= s) || quad > 1) continue;
      const size_t at = ((size_t)b * s + key) * h + hh;
      if (quad == 0) {
        dv[at] = __float2bfloat16_rn(sum);
      } else {
        dk[at] = __float2bfloat16_rn(
            __fsub_rn(__fmul_rn(rank1::to_f32(v[at]), sum), dqk));
      }
    }
  }
}

// dq from the key tiles' partials, added in tile order, rounded to bf16.
__global__ void rank1_bwd_bf16_dq_kernel(const float* __restrict__ part, int tiles,
                                         int bsz, int l, int h,
                                         __nv_bfloat16* __restrict__ dq) {
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
    dq[e] = __float2bfloat16_rn(t);
  }
}

}  // namespace

extern "C" {

// The bf16 mode: q, k, v (bf16) and out, g (float32) (B, L, H) / (B, S,
// H), denom (B, H, L) the forward's row sums -> bf16 dq (B, L, H), dk and
// dv (B, S, H); scratch: (tiles, B, H, L) float32 where there is more than
// one key tile of 1024 (lsdm_rank1_attn_bwd_tiles), else unused (may be
// null).
int lsdm_rank1_attn_bwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                             const __nv_bfloat16* v, const float* out,
                             const float* g, const float* denom, int b, int l,
                             int s, int h, __nv_bfloat16* dq,
                             __nv_bfloat16* dk, __nv_bfloat16* dv,
                             float* scratch, void* stream) {
  if (b <= 0 || l <= 0 || h <= 0 || s <= 0) return 0;
  if (b > 65535 || h > 65535) return (int)cudaErrorInvalidValue;
  const int tiles = (s + kKeysPerBlock - 1) / kKeysPerBlock;
  float* part = tiles > 1 ? scratch : nullptr;
  if (tiles > 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(tiles, h, b);
  if (s % kKeysPerBlock != 0) {
    rank1_bwd_bf16_kernel<true><<<grid, kThreads, 0, st>>>(
        q, k, v, out, g, denom, l, s, h, dq, dk, dv, part);
  } else {
    rank1_bwd_bf16_kernel<false><<<grid, kThreads, 0, st>>>(
        q, k, v, out, g, denom, l, s, h, dq, dk, dv, part);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || tiles == 1) return (int)err;
  const size_t n = (size_t)b * l * h;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  rank1_bwd_bf16_dq_kernel<<<blocks, 256, 0, st>>>(part, tiles, b, l, h, dq);
  return (int)cudaGetLastError();
}

}  // extern "C"

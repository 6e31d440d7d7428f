// The bf16 row-MLP engine of K7's and K8's bf16 modes (sa_fused_bf16.cu,
// fp_fused_bf16.cu): dense layers over a block's activation rows, kept in
// shared memory as bf16, on the bf16 tensor cores.
//
// The TPU kernels at compute_dtype=bfloat16 round each product's operands
// to bf16 and sum in float32 (sa_fused_pallas.py, fp_fused_pallas.py).
// Here every layer is mma.sync.m16n8k16 bf16 x bf16 -> float32
// (denoise_mma.cuh), and its epilogue adds the float32 bias (__fadd_rn),
// applies the activation and rounds to bf16 (nearest even) where the next
// product reads the value.
//
// - Activations: bf16 rows in two ping-pong buffers, row-major, the A
//   operand by ldmatrix.x4.  A row's stride (plan.ld0, plan.ld1) is 8 bf16
//   past a multiple of 16, an odd number of 16-byte pieces, so the eight
//   rows an ldmatrix reads fall in eight bank groups.  A layer reads its
//   input up to its width rounded to 16, and those padding columns hold
//   zeros (0 x NaN would be NaN): the gathers write them, and each epilogue
//   writes its layer's padding columns from zero weights and biases.
// - Weights: bf16 copies made once per model (ops/rowmlp.py:Bf16Operands):
//   layer l's W' as (out, in) rows, both rounded up to 16 with zeros, the B
//   operand's (n, k) layout.  They stream through a ring of kStages chunks
//   of kNB rows (output columns) by plan.kc k, filled by cp.async, which
//   every warp of the block reads.  The ring runs on across the layers, so
//   a layer's first chunks arrive during the previous layer's last products
//   and epilogue, and the block's first ones during its prologue.  One
//   block barrier a chunk.
// - Warps: a pass over a layer takes 16 plan.mt rows (mt = 2, 4, 8 or 16
//   m16 tiles); the 8 warps stand mt / 2 down the rows, 32 rows each, by
//   16 / mt across a chunk's 64 columns, mt / 2 n8 tiles each, so a warp
//   owns whole 32-row groups: K7 takes its max over a centre's rows in
//   registers where nsample divides 32.  A warp issues mt MMAs a k step
//   for 2 + mt / 4 ldmatrix loads.  Rows past 16 mt run in further passes
//   (plan.passes), each streaming the weights again.
//
// What bounds the layers on an H100: their products at the tensor cores'
// rate (the flagship's 7.25 GFLOP of K7 layers 2..L at 9 clouds take 7.3 us
// at 989 TFLOP/s); the kernels' float32 prologue (staging, selection,
// gather) is the rest of their time.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "denoise_mma.cuh"

namespace rowmma {

using bf16 = __nv_bfloat16;
using denoise::copy16;
using denoise::copy_commit;
using denoise::copy_wait;
using denoise::ldsm_x2;
using denoise::ldsm_x4;
using denoise::mma;
using denoise::pack;
using denoise::smem_u32;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLayers = 8;   // layers a kernel computes
constexpr int kStages = 3;      // depth of the weight ring
constexpr int kNB = 64;         // weight rows (output columns) of a chunk
constexpr int kMaxKC = 128;     // k of a chunk at most
constexpr size_t kSmemMax = 232448;  // dynamic shared memory of a block

__host__ __device__ constexpr int round16(int x) { return (x + 15) / 16 * 16; }
__host__ __device__ constexpr int round4(int x) { return (x + 3) / 4 * 4; }

// A launch plan, as ops/rowmlp.py:PlanBf16.ints() lays it out.
struct Plan {
  int rows;    // SA centres or FP targets a block
  int mt;      // m16 tiles a pass: 2, 4, 8 or 16
  int passes;  // passes of 16 mt rows over each layer
  int kc;      // k of a ring chunk: 16, 32, 64 or 128
  int ld0, ld1;  // row strides of buffers 0 and 1, bf16, 8 (mod 16)
  int red;     // ints of K7's max by atomics (0 where it takes registers)
  int smem;    // dynamic shared memory of a block, bytes
};

inline Plan read_plan(const int* v) {
  return Plan{v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7]};
}

struct Layers {
  const bf16* w[kMaxLayers];   // (round16(fout), round16(fin)) bf16, zero-padded
  const float* b[kMaxLayers];  // (fout,)
  int fin[kMaxLayers];
  int fout[kMaxLayers];
  int relu[kMaxLayers];        // 1: ReLU after the bias, 0: none
  int n;
};

__host__ __device__ inline int rows_pad(const Plan& p) { return 16 * p.mt * p.passes; }
__host__ __device__ inline int ring_bytes(const Plan& p, const Layers& L) {
  return L.n > 0 ? 2 * kStages * kNB * (p.kc + 8) : 0;
}
// bytes of the ring and the two buffers, which open the shared memory; the
// kernel's own regions follow
__host__ __device__ inline size_t engine_bytes(const Plan& p, const Layers& L) {
  return (size_t)ring_bytes(p, L) + 2 * (size_t)rows_pad(p) * (p.ld0 + p.ld1);
}

__host__ __device__ inline bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// True when the plan can carry m rows a block through the layers, `first`
// channels gathered into buffer 0 before them, with `extra_words` 4-byte
// words of the kernel's own after the engine's regions.
inline bool plan_ok(const Plan& p, const Layers& L, int m, int first,
                    long long extra_words) {
  if (p.rows < 1 || (p.mt != 2 && p.mt != 4 && p.mt != 8 && p.mt != 16) ||
      p.passes < 1 || rows_pad(p) < m ||
      (p.kc != 16 && p.kc != 32 && p.kc != 64 && p.kc != 128) ||
      p.ld0 % 16 != 8 || p.ld1 % 16 != 8 || p.red < 0 || L.n < 0 || L.n > kMaxLayers || round16(first) + 8 > p.ld0)
    return false;
  for (int l = 0; l < L.n; ++l) {
    if (L.fin[l] < 1 || L.fout[l] < 1 || !aligned16(L.w[l])) return false;
    if (round16(L.fin[l]) + 8 > (l & 1 ? p.ld1 : p.ld0)) return false;
  }
  return engine_bytes(p, L) + 4 * (size_t)extra_words == (size_t)p.smem &&
         (size_t)p.smem <= kSmemMax;
}

// Launches `kernel` with the plan's dynamic shared memory.
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), dim3 grid, const Plan& p,
                   cudaStream_t st, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, (size_t)p.smem, st>>>(args...);
  return cudaGetLastError();
}

// The weight chunks of every layer in the order the layers read them:
// layer l, pass p, 64 rows from n0 = 64 nb, k from k0 = kc kq.
struct Ring {
  bf16* base;
  const Layers& L;
  int kc, passes;
  int l = 0, p = 0, nb = 0, kq = 0;  // the chunk filled next
  int next = 0;                      // its place in the sequence

  __device__ __forceinline__ bf16* stage(int g) const {
    return base + (g % kStages) * kNB * (kc + 8);
  }
  // Each thread's share of the next chunk's 16-byte pieces, zeros past the
  // layer's padded rows or k; nothing past the last layer.
  __device__ __forceinline__ void fill() {
    if (l >= L.n) return;
    const int kp = round16(L.fin[l]), np = round16(L.fout[l]), pieces = kc / 8;
    const bf16* w = L.w[l];
    bf16* dst = stage(next);
    for (int e = threadIdx.x; e < kNB * pieces; e += kThreads) {
      const int r = e / pieces, q = e - r * pieces;
      const int n = nb * kNB + r, k = kq * kc + 8 * q;
      const bool ok = n < np && k < kp;
      copy16(dst + r * (kc + 8) + 8 * q, ok ? w + (size_t)n * kp + k : w, ok);
    }
    ++next;
    if (++kq * kc >= kp) {
      kq = 0;
      if (++nb * kNB >= np) {
        nb = 0;
        if (++p == passes) p = 0, ++l;
      }
    }
  }
};

// c[m][j] += A @ W^T over one chunk: the warp's two m16 tiles of A (lane
// address `a` at the chunk's first k, rows `lda` bf16 apart) and its first
// nj (<= NJ) n8 tiles of the stage (lane address `w`, rows `ldw` apart),
// for `ks` k16 steps, four unrolled at a time.  One ldmatrix.x4 feeds two
// n tiles (lanes 0-15 address tile j's rows at k and k + 8, lanes 16-31
// tile j + 1's).
template <int NJ>
__device__ __forceinline__ void mma_chunk(float (&c)[2][NJ][4], uint32_t a, int lda,
                                          uint32_t w, int ldw, int ks, int nj) {
#pragma unroll 4
  for (int k = 0; k < ks; ++k) {
    uint32_t af[2][4];
    ldsm_x4(af[0], a + 32 * k);
    ldsm_x4(af[1], a + 32u * lda + 32 * k);
    if constexpr (NJ == 1) {
      uint32_t b0, b1;
      ldsm_x2(b0, b1, w + 32 * k);
      mma(c[0][0], af[0], b0, b1);
      mma(c[1][0], af[1], b0, b1);
    } else {
#pragma unroll
      for (int j = 0; j < NJ; j += 2) {
        if (j >= nj) break;
        uint32_t bf[4];
        ldsm_x4(bf, w + 16u * j * ldw + 32 * k);
        mma(c[0][j], af[0], bf[0], bf[1]);
        mma(c[1][j], af[1], bf[0], bf[1]);
        if (j + 1 < nj) {
          mma(c[0][j + 1], af[0], bf[2], bf[3]);
          mma(c[1][j + 1], af[1], bf[2], bf[3]);
        }
      }
    }
  }
}

// Layer l over the block's rows: for each pass and each chunk of 64 output
// columns, its k chunks from the ring (g counts them), A from `in` (rows
// `ld` bf16 apart), then epi(c, row0, c0, nj) with the warp's accumulators
// c[m][j][e] of row row0 + 16 m + lane / 4 + 8 (e >> 1) and column c0 + 8 j
// + 2 (lane % 4) + (e & 1), of which the first nj n8 tiles lie within the
// layer's padded width.
template <int MT, typename Epi>
__device__ __forceinline__ void run_layer(Ring& ring, int& g, const Layers& L, int l,
                                          const bf16* in, int ld, const Plan& p,
                                          Epi epi) {
  constexpr int WM = MT / 2, WN = kWarps / WM, NJ = kNB / 8 / WN;
  static_assert(WM * WN == kWarps && 8 * NJ * WN == kNB, "the warps tile a pass");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % WM, wn = warp / WM;
  const int kp = round16(L.fin[l]), np = round16(L.fout[l]), ldw = p.kc + 8;
  const uint32_t w_lane = 2 * ((8 * NJ * wn + (lane & 7) + ((lane >> 4) << 3)) * ldw +
                               (((lane >> 3) & 1) << 3));
  for (int pass = 0; pass < p.passes; ++pass) {
    const int row0 = 16 * MT * pass + 32 * wm;
    const uint32_t a_lane =
        smem_u32(in) + 2 * ((row0 + (lane & 15)) * ld + ((lane >> 4) << 3));
    for (int n0 = 0; n0 < np; n0 += kNB) {
      const int c0 = n0 + 8 * NJ * wn;  // the warp's first column
      const int nj = max(0, min(NJ, (np - c0) / 8));
      float c[2][NJ][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) c[m][j][e] = 0.0f;
      for (int k0 = 0; k0 < kp; k0 += p.kc, ++g) {
        copy_wait<kStages - 2>();  // this thread's copies of chunk g landed
        __syncthreads();           // everyone's; chunk g - 1's stage is free
        ring.fill();               // chunk g + kStages - 1
        copy_commit();             // an empty group past the end keeps the count
        if (nj > 0)
          mma_chunk<NJ>(c, a_lane + 2 * k0, ld, smem_u32(ring.stage(g)) + w_lane, ldw,
                        min(p.kc, kp - k0) / 16, nj);
      }
      epi(c, row0, c0, nj);
    }
  }
}

// act(c + bias), rounded to bf16, into rows of `out` (`ld` bf16 apart);
// columns at or past fout take zeros: the next layer's k padding.
template <int NJ>
__device__ __forceinline__ void store_rows(const float (&c)[2][NJ][4],
                                           const float* __restrict__ bias, int fout,
                                           int relu, bf16* out, int ld, int row0, int c0,
                                           int nj) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    if (j >= nj) break;
    const int n = c0 + 8 * j + 2 * t;
    const float bn[2] = {n < fout ? __ldg(bias + n) : 0.0f,
                         n + 1 < fout ? __ldg(bias + n + 1) : 0.0f};
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float y = __fadd_rn(c[m][j][e], bn[e & 1]);
        v[e] = n + (e & 1) < fout ? (relu ? fmaxf(y, 0.0f) : y) : 0.0f;
      }
      bf16* o = out + (size_t)(row0 + 16 * m + g) * ld + n;
      *reinterpret_cast<uint32_t*>(o) = pack(v[0], v[1]);
      *reinterpret_cast<uint32_t*>(o + 8 * ld) = pack(v[2], v[3]);
    }
  }
}

// act(c + bias) as bf16 into device memory: out[r * fout + n] for rows r <
// rows and columns n < fout.
template <int NJ>
__device__ __forceinline__ void store_global(const float (&c)[2][NJ][4],
                                             const float* __restrict__ bias, int fout,
                                             int relu, bf16* __restrict__ out, int rows,
                                             int row0, int c0, int nj) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    if (j >= nj) break;
    const int n = c0 + 8 * j + 2 * t;
    if (n >= fout) continue;
    const bool pair = n + 1 < fout;
    const float b0 = __ldg(bias + n), b1 = pair ? __ldg(bias + n + 1) : 0.0f;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + 16 * m + g + 8 * h;
        if (r >= rows) continue;
        float v0 = __fadd_rn(c[m][j][2 * h], b0), v1 = __fadd_rn(c[m][j][2 * h + 1], b1);
        if (relu) v0 = fmaxf(v0, 0.0f), v1 = fmaxf(v1, 0.0f);
        bf16* o = out + (size_t)r * fout + n;
        if (pair && (fout & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
        } else {
          o[0] = __float2bfloat16_rn(v0);
          if (pair) o[1] = __float2bfloat16_rn(v1);
        }
      }
  }
}

// K7's last layer into the max over each centre's ns rows, ns a power of
// two up to 32, so a warp's 32 rows hold whole centres: relu(c + bias) of
// the thread's rows of a centre, then __shfl_xor over the lanes that hold
// the centre's other rows in its columns; the lane of the centre's first
// row stores each of its outputs once as bf16, out[centre * ldo + n] for
// centres < centres.  Rounding is monotone and commutes with the max.
template <int NJ>
__device__ __forceinline__ void store_max(const float (&c)[2][NJ][4],
                                          const float* __restrict__ bias, int fout,
                                          bf16* __restrict__ out, int ldo, int centres,
                                          int ns, int row0, int c0, int nj) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int lanes = ns < 8 ? ns : 8;  // a centre's rows among the 8 of a column
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    if (j >= nj) break;
    const int n = c0 + 8 * j + 2 * t;
    const float bn[2] = {n < fout ? __ldg(bias + n) : 0.0f,
                         n + 1 < fout ? __ldg(bias + n + 1) : 0.0f};
    float v[2][2][2];  // [m tile][row g or g + 8][column n or n + 1]
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[m][e >> 1][e & 1] = fmaxf(__fadd_rn(c[m][j][e], bn[e & 1]), 0.0f);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (ns >= 16)  // rows g and g + 8 share a centre
        v[0][0][q] = fmaxf(v[0][0][q], v[0][1][q]), v[1][0][q] = fmaxf(v[1][0][q], v[1][1][q]);
      if (ns == 32) v[0][0][q] = fmaxf(v[0][0][q], v[1][0][q]);  // and both m tiles
    }
    for (int off = 4; off < 4 * lanes; off <<= 1)
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int q = 0; q < 2; ++q)
            v[m][h][q] = fmaxf(v[m][h][q], __shfl_xor_sync(0xffffffffu, v[m][h][q], off));
    if ((g & (lanes - 1)) != 0 || n >= fout) continue;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if ((ns >= 16 && h) || (ns == 32 && m)) continue;  // held by h = 0, m = 0
        const int centre = (row0 + 16 * m + g + 8 * h) / ns;
        if (centre >= centres) continue;
        bf16* o = out + (size_t)centre * ldo + n;
        o[0] = __float2bfloat16_rn(v[m][h][0]);
        if (n + 1 < fout) o[1] = __float2bfloat16_rn(v[m][h][1]);
      }
  }
}

// K7's last layer into the max for any other ns: a shared atomicMax on the
// bits of the non-negative relu(c + bias) of rows r < m, red[(r / ns) *
// fout + n], rounded to bf16 when the layer is done.
template <int NJ>
__device__ __forceinline__ void store_atomic(const float (&c)[2][NJ][4],
                                             const float* __restrict__ bias, int fout,
                                             int* red, int m, int ns, int row0, int c0,
                                             int nj) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    if (j >= nj) break;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int n = c0 + 8 * j + 2 * t + q;
      if (n >= fout) continue;
      const float bn = __ldg(bias + n);
#pragma unroll
      for (int mm = 0; mm < 2; ++mm)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + 16 * mm + g + 8 * h;
          if (r < m)
            atomicMax(red + (r / ns) * fout + n,
                      __float_as_int(fmaxf(__fadd_rn(c[mm][j][2 * h + q], bn), 0.0f)));
        }
    }
  }
}

// Eight bf16 (16 bytes, p on 16 bytes) from device memory as floats.
__device__ __forceinline__ void load8(const bf16* p, float (&x)[8]) {
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x, x[2 * i + 1] = f.y;
  }
}

// buf[r * ld + c] for rows r < rows_pad and channels c < round16(chans),
// eight channels a 16-byte store, rounded to bf16: f8(r, c0, x) sets x[i]
// for the channels c0 + i < chans of a row r < rows; every other entry is
// zero (the padding).  Consecutive threads take consecutive pieces of a
// row, so f8's loads stay coalesced; four items a pass, their loads issued
// before the first store.
template <typename F8>
__device__ __forceinline__ void fill_rows(bf16* buf, int ld, int rows, int rows_pad,
                                          int chans, F8 f8) {
  constexpr int kItems = 4;
  const int groups = round16(chans) / 8, total = rows_pad * groups;
  for (int e0 = threadIdx.x; e0 < total; e0 += kItems * kThreads) {
    uint4 v[kItems];
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int e = e0 + u * kThreads;
      const int r = e / groups, c0 = 8 * (e - r * groups);
      float x[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      if (e < total && r < rows && c0 < chans) f8(r, c0, x);
      v[u] = make_uint4(pack(x[0], x[1]), pack(x[2], x[3]), pack(x[4], x[5]),
                        pack(x[6], x[7]));
    }
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int e = e0 + u * kThreads;
      if (e >= total) break;
      const int r = e / groups, c0 = 8 * (e - r * groups);
      *reinterpret_cast<uint4*>(buf + (size_t)r * ld + c0) = v[u];
    }
  }
}

}  // namespace rowmma

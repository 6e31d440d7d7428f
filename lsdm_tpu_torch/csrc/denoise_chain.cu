// The whole-loop denoise chain (K6) for Hopper.
//
// Replaces lsdm_tpu/ops/denoise_pallas.py: fused_denoise_chain, with the
// same inputs and outputs.  Plain version: lsdm_tpu_torch/ops/denoise.py.
//
// Per step t of T (weights as in DenoiseStepParams, activations float32):
//   u0  = gelu(w_up0 (x) e2_t + b_up0)        (128, 2D)   \
//   u2  = gelu(w_up2 @ u0 + b_up2)            (512, 2D)    | t only
//   u4  = gelu(w_up4 @ u2 + b_up4)            (N, 2D)      |
//   emb = gelu(u4 @ wc_t + bc)                (N, D)      /
//   x0  = output_process(input_process(x_t + cond_pcd, emb))   per row
//   x_{t-1} = (c1 x0 + c2 x_t) + c3 noise_t                    per row
//
// The TPU kernel runs this on a sequential (B, T) grid, one program per
// scene.  Carried over literally that is B blocks: one SM of 132 at batch
// 1.  What the loop needs is less: everything that does not depend on the
// sample can be computed ahead, and given that every point row runs its
// T-step recurrence alone.  So the kernel is two hand-written passes per
// chunk of steps:
//
//   pass 1: the t-only part of every step of the chunk, as batched GEMMs
//     over (scene, step) with bias and exact-erf GELU fused into the
//     epilogue (128x128x16 tiles in shared memory, 8x8 outputs a thread):
//     the embedding, and the embedding's half of the first
//     combination_extraction layer, g = emb @ wx0_t[D:] + bx0 (the layer
//     reads concat(pose features, emb), so its product splits in two).
//     About 0.42 GFLOP a step at the flagship width: bound by FP32 FMA
//     throughput, and it fills the card.
//   pass 2: one block per (scene, tile of 8 point rows) carries its rows
//     through the chunk's steps: six (8 x K) @ (K x OUT) layers with the
//     activations in shared memory, then the posterior update.  Rows never
//     exchange data, so blocks need no synchronisation between them; N =
//     1024 gives 128 blocks.  The weights (264 KB) do not fit in shared
//     memory and stream from L2 every step, so the pass is bound by the
//     latency of those reads: 256 threads, the two halves of the block
//     summing alternate k of each layer, keep twice the reads in flight.
//
// The sample is carried in the output buffer from chunk to chunk.  The
// chunk length comes from the caller, which sizes the scratch (the tables
// of one chunk).  Every product is a hand-written FMA loop: no cuBLAS.
//
// lsdm_denoise_chain_tables runs pass 1 alone, so a check can hold its
// tables against a plain computation: the chain's final sample barely
// moves with pass 1's rounding (the sigmoid layers of pass 2 damp it), so
// it cannot show whether pass 1 computes in exact float32.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "denoise_rows.cuh"

namespace {

using namespace denoise;

enum { kNoBias = 0, kBiasRow = 1, kBiasCol = 2 };

// ---------------------------------------------------------------- pass 1
// u0[z][i][j] = gelu(w[i] * e2[b][t0 + tt][j] + bias[i]), z = b * tc + tt
__global__ void upsample0_kernel(const float* __restrict__ e2, int t_total,
                                 int t0, int tc, int d2,
                                 const float* __restrict__ w,
                                 const float* __restrict__ bias, int rows,
                                 int nb, float* __restrict__ u0) {
  const size_t per = (size_t)rows * d2;
  const size_t total = (size_t)nb * tc * per;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const size_t z = e / per;
    const int rem = (int)(e - z * per);
    const int i = rem / d2, j = rem - i * d2;
    const int b = (int)(z / tc), tt = (int)(z - (size_t)b * tc);
    const float v = e2[((size_t)b * t_total + t0 + tt) * d2 + j];
    u0[e] = gelu(w[i] * v + bias[i]);
  }
}

constexpr int kGemmBM = 128, kGemmBN = 128, kGemmBK = 16, kGemmThreads = 256;

// C[z] (M x N) = act(A[z] (M x K) @ B[z] (K x N) + bias), row-major, with
// batch strides sA/sB/sC (0 = shared by the batch).  Thread (ty, tx) of
// 16 x 16 owns rows {ty*4 + i, 64 + ty*4 + i} and columns {tx*4 + j,
// 64 + tx*4 + j}, i, j < 4, so its shared-memory reads are float4s.
__global__ void __launch_bounds__(kGemmThreads)
gemm_bias_act_kernel(const float* __restrict__ A, int lda, long long sA,
                     const float* __restrict__ B, int ldb, long long sB,
                     float* __restrict__ C, int ldc, long long sC,
                     const float* __restrict__ bias, int bias_mode, int gelu_act,
                     int M, int N, int K) {
  __shared__ __align__(16) float As[kGemmBK][kGemmBM + 4];  // A tile, k-major
  __shared__ __align__(16) float Bs[kGemmBK][kGemmBN];
  const long long z = blockIdx.z;
  A += z * sA;
  B += z * sB;
  C += z * sC;
  const int m0 = blockIdx.y * kGemmBM, n0 = blockIdx.x * kGemmBN;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kGemmBK) {
#pragma unroll
    for (int l = 0; l < (kGemmBM * kGemmBK) / kGemmThreads; ++l) {
      const int e = tid + l * kGemmThreads;
      const int r = e / kGemmBK, c = e % kGemmBK;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? A[(size_t)gm * lda + gk] : 0.0f;
    }
#pragma unroll
    for (int l = 0; l < (kGemmBK * kGemmBN) / kGemmThreads; ++l) {
      const int e = tid + l * kGemmThreads;
      const int r = e / kGemmBN, c = e % kGemmBN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[r][c] = (gk < K && gn < N) ? B[(size_t)gk * ldb + gn] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGemmBK; ++kk) {
      const float4 a_lo = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a_hi = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b_lo = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b_hi = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float a[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w,
                          a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      const float b[8] = {b_lo.x, b_lo.y, b_lo.z, b_lo.w,
                          b_hi.x, b_hi.y, b_hi.z, b_hi.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (gn >= N) continue;
      float v = acc[i][j];
      if (bias_mode == kBiasRow) v += bias[gm];
      else if (bias_mode == kBiasCol) v += bias[gn];
      C[(size_t)gm * ldc + gn] = gelu_act ? gelu(v) : v;
    }
  }
}

cudaError_t gemm(cudaStream_t st, const float* A, int lda, long long sA,
                 const float* B, int ldb, long long sB, float* C, int ldc,
                 long long sC, const float* bias, int bias_mode, int gelu_act,
                 int M, int N, int K, int batch) {
  const dim3 grid((N + kGemmBN - 1) / kGemmBN, (M + kGemmBM - 1) / kGemmBM,
                  batch);
  gemm_bias_act_kernel<<<grid, kGemmThreads, 0, st>>>(
      A, lda, sA, B, ldb, sB, C, ldc, sC, bias, bias_mode, gelu_act, M, N, K);
  return cudaGetLastError();
}

// Dimensions of a call, from the caller's dims array (see the entry
// points below).
struct ChainDims {
  int B, T, N, D2, U0, U2, D, DH, D15, DH2, TC;
};

// Pass 1 for steps [t0, t0 + tc) of every scene: fills the chunk's tables
// u0 (B*tc, U0, 2D), u2 (B*tc, U2, 2D), u4 (B*tc, N, 2D), emb (B*tc, N, D)
// and g (B*tc, N, D15), one after the other from scratch.  Returns g.
cudaError_t chain_tables(cudaStream_t st, const ChainDims& d, const float* e2,
                         const float* const* w, float* scratch, int t0,
                         int tc, float** g_out) {
  const int nz = d.B * tc;
  float* u0 = scratch;
  float* u2 = u0 + (size_t)nz * d.U0 * d.D2;
  float* u4 = u2 + (size_t)nz * d.U2 * d.D2;
  float* emb = u4 + (size_t)nz * d.N * d.D2;
  float* g = emb + (size_t)nz * d.N * d.D;
  *g_out = g;
  const float *w_up0 = w[0], *b_up0 = w[1], *w_up2 = w[2], *b_up2 = w[3],
              *w_up4 = w[4], *b_up4 = w[5], *wc = w[6], *bc = w[7],
              *wx0 = w[12], *bx0 = w[13];
  cudaError_t err;
  const size_t n_u0 = (size_t)nz * d.U0 * d.D2;
  const int blocks0 = (int)((n_u0 + 255) / 256 < 8192 ? (n_u0 + 255) / 256 : 8192);
  upsample0_kernel<<<blocks0, 256, 0, st>>>(e2, d.T, t0, tc, d.D2, w_up0,
                                            b_up0, d.U0, d.B, u0);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = gemm(st, w_up2, d.U0, 0, u0, d.D2, (long long)d.U0 * d.D2, u2,
                  d.D2, (long long)d.U2 * d.D2, b_up2, kBiasRow, 1, d.U2,
                  d.D2, d.U0, nz)))
    return err;
  if ((err = gemm(st, w_up4, d.U2, 0, u2, d.D2, (long long)d.U2 * d.D2, u4,
                  d.D2, (long long)d.N * d.D2, b_up4, kBiasRow, 1, d.N, d.D2,
                  d.U2, nz)))
    return err;
  if ((err = gemm(st, u4, d.D2, (long long)d.N * d.D2, wc, d.D, 0, emb, d.D,
                  (long long)d.N * d.D, bc, kBiasCol, 1, d.N, d.D, d.D2, nz)))
    return err;
  // g = emb @ wx0_t[D:2D] + bx0, no activation (pass 2 adds the rest)
  return gemm(st, emb, d.D, (long long)d.N * d.D, wx0 + (size_t)d.D * d.D15,
              d.D15, 0, g, d.D15, (long long)d.N * d.D15, bx0, kBiasCol, 0,
              d.N, d.D15, d.D, nz);
}

// ---------------------------------------------------------------- pass 2
// (kRows, kCols and dense_rows: denoise_rows.cuh)
constexpr int kStepThreads = 2 * kCols;  // dense_rows' default two k parts
struct TailWeights {
  const float *wp0, *bp0, *wp2, *bp2, *wx0, *bx0, *wx2, *bx2, *wo0, *bo0,
      *wo2, *bo2;
};

// Steps [t0, t0 + tc) of the loop for one tile of kRows rows of scene
// blockIdx.y.  g holds the chunk's table emb @ wx0_t[D:] + bx0, shape
// (B * tc, n, d15).  x_in and x_out are the same buffer after the first
// chunk: each thread reads its element at the start and writes it at the
// end.
__global__ void __launch_bounds__(kStepThreads)
chain_steps_kernel(const float* x_in, float* x_out,
                   float* __restrict__ last_in, const float* __restrict__ noise,
                   const float* __restrict__ cpcd, const float* __restrict__ g,
                   const float* __restrict__ coef, TailWeights w, int n, int d,
                   int dh, int d15, int dh2, int t_total, int t0, int tc,
                   int clip) {
  extern __shared__ __align__(16) float chain_smem[];
  // every buffer is a multiple of kRows floats long: float4-aligned
  float* xt = chain_smem;          // [kRows][3] the carried sample
  float* xin = xt + 3 * kRows;     // [3][kRows] x_t + cond_pcd
  float* p1 = xin + 3 * kRows;     // [dh][kRows]
  float* p2 = p1 + dh * kRows;     // [d][kRows]
  float* gb = p2 + d * kRows;      // [d15][kRows] this step's rows of g
  float* h1 = gb + d15 * kRows;    // [d15][kRows]
  float* h2 = h1 + d15 * kRows;    // [d][kRows]
  float* h3 = h2 + d * kRows;      // [dh2][kRows]
  float* x0 = h3 + dh2 * kRows;    // [3][kRows]
  float* red = x0 + 3 * kRows;     // [kCols][kRows] partial sums

  const int b = blockIdx.y;
  const int r0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  // threads tid < 3 * kRows own one (row, coordinate) of the sample
  const int my_r = tid / 3, my_c = tid % 3, my_row = r0 + my_r;
  const bool owner = tid < 3 * kRows;
  const bool valid = owner && my_row < n;
  const size_t my_off = ((size_t)b * n + my_row) * 3 + my_c;

  if (owner) xt[tid] = valid ? x_in[my_off] : 0.0f;
  __syncthreads();
  for (int tt = 0; tt < tc; ++tt) {
    const int t = t0 + tt;
    if (owner) {
      const float xv = xt[tid];
      if (valid && t == t_total - 1) last_in[my_off] = xv;
      xin[my_c * kRows + my_r] = valid ? xv + cpcd[my_off] : 0.0f;
    }
    const float* grow = g + ((size_t)(b * tc + tt) * n + r0) * d15;
    for (int e = tid; e < kRows * d15; e += blockDim.x) {
      const int r = e / d15, j = e - r * d15;
      gb[j * kRows + r] = (r0 + r < n) ? grow[(size_t)r * d15 + j] : 0.0f;
    }
    __syncthreads();
    dense_rows<false, kPerOut>(w.wp0, w.bp0, xin, 3, p1, dh, red);
    dense_rows<false, kPerOut>(w.wp2, w.bp2, p1, dh, p2, d, red);
    // the pose-feature half of combination_extraction.0 (wx0_t rows < d)
    dense_rows<false, kPerOutRow>(w.wx0, gb, p2, d, h1, d15, red);
    dense_rows<false, kPerOut>(w.wx2, w.bx2, h1, d15, h2, d, red);
    dense_rows<true, kPerOut>(w.wo0, w.bo0, h2, d, h3, dh2, red);
    dense_rows<true, kPerOut>(w.wo2, w.bo2, h3, dh2, x0, 3, red);
    if (owner) {
      float x0v = x0[my_c * kRows + my_r];
      if (clip) x0v = fminf(fmaxf(x0v, -1.0f), 1.0f);
      const float nz =
          valid ? noise[(((size_t)b * t_total + t) * n + my_row) * 3 + my_c]
                : 0.0f;
      const float* cf = coef + (size_t)t * 3;
      xt[tid] = (cf[0] * x0v + cf[1] * xt[tid]) + cf[2] * nz;
    }
    __syncthreads();
  }
  if (valid) x_out[my_off] = xt[tid];
}

}  // namespace

extern "C" {

// x_init, cond_pcd (B, N, 3); noise (B, T, N, 3); e2 (B, T, 2D); coef
// (T, 3); w: the 20 DenoiseStepParams pointers in field order; final,
// last_in (B, N, 3) outputs; scratch: B * tc * (U0*2D + U2*2D + N*2D + N*D
// + N*D15) floats; dims = {B, T, N, 2D, U0, U2, D, DH, D15, DH2, tc} with
// DH, D15 the widths of input_process's layers 0 and 2 and DH2 that of
// output_process's layer 0.  Returns cudaErrorInvalidValue for shapes the
// kernel does not take (2D != 2 * D, or more than 48 KB of pass-2 shared
// memory: D up to about 200).
int lsdm_denoise_chain(const float* x_init, const float* noise,
                       const float* cpcd, const float* e2, const float* coef,
                       const float* const* w, float* final_x, float* last_in,
                       float* scratch, const int* dims, int clip,
                       void* stream) {
  const ChainDims d{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5],
                    dims[6], dims[7], dims[8], dims[9], dims[10]};
  const size_t smem =
      sizeof(float) * kRows *
      (size_t)(3 + 3 + d.DH + d.D + d.D15 + d.D15 + d.D + d.DH2 + 3 + kCols);
  if (d.B <= 0 || d.T <= 0 || d.TC <= 0 || d.D2 != 2 * d.D || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const TailWeights tail{w[8],  w[9],  w[10], w[11], w[12], w[13],
                         w[14], w[15], w[16], w[17], w[18], w[19]};
  cudaError_t err;
  for (int t0 = 0; t0 < d.T; t0 += d.TC) {
    const int tc = d.TC < d.T - t0 ? d.TC : d.T - t0;
    float* g;
    if ((err = chain_tables(st, d, e2, w, scratch, t0, tc, &g))) return (int)err;
    const dim3 grid((d.N + kRows - 1) / kRows, d.B);
    chain_steps_kernel<<<grid, kStepThreads, smem, st>>>(
        t0 == 0 ? x_init : final_x, final_x, last_in, noise, cpcd, g, coef,
        tail, d.N, d.D, d.DH, d.D15, d.DH2, d.T, t0, tc, clip);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

// Pass 1 alone over all T steps (one chunk): afterwards scratch, of
// B * T * (U0*2D + U2*2D + N*2D + N*D + N*D15) floats, holds the tables
// u0, u2, u4, emb, g of every (scene, step) in that order.  Arguments as
// for lsdm_denoise_chain; dims[10] is ignored.
int lsdm_denoise_chain_tables(const float* e2, const float* const* w,
                              float* scratch, const int* dims, void* stream) {
  const ChainDims d{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5],
                    dims[6], dims[7], dims[8], dims[9], dims[1]};
  if (d.B <= 0 || d.T <= 0 || d.D2 != 2 * d.D) return (int)cudaErrorInvalidValue;
  float* g;
  return (int)chain_tables((cudaStream_t)stream, d, e2, w, scratch, 0, d.T, &g);
}

}  // extern "C"

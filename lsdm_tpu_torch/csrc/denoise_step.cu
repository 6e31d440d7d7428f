// One denoise step (K9) for Hopper.
//
// Replaces lsdm_tpu/ops/denoise_pallas.py: fused_denoise_step, with the
// same inputs and output.  Plain version: lsdm_tpu_torch/ops/denoise.py:
// denoise_step_plain.  For every scene b (weights as in DenoiseStepParams,
// activations float32):
//   u0  = gelu(w_up0 (x) e2_b + b_up0)        (128, 2D)   \
//   u2  = gelu(w_up2 @ u0 + b_up2)            (512, 2D)    | t only
//   u4  = gelu(w_up4 @ u2 + b_up4)            (N, 2D)      |
//   emb = gelu(u4 @ wc_t + bc)                (N, D)      /
//   x0  = output_process(input_process(x + cond_pcd, emb))    per row
//   out = (c1 x0 + c2 x) + c3 noise                            per row
//
// The TPU kernel runs one program per scene: B blocks, one SM of 132 at
// batch 1.  The chain kernel (K6) hoists the t-only part of a chunk of
// steps into batched GEMMs, but a step alone has nothing to batch: u4 at
// batch 1 is 16 tiles of 128 x 128.  What a step needs is less: only u2
// is shared by all the rows of a scene; every row of u4, and from there
// of emb and of the rest, depends on its own row of w_up4 alone.  So the
// C entry makes two launches on the stream:
//
//   1. step_u2_kernel: u2 of every scene, one block per (32 x 32 tile of
//      u2, scene), 128 blocks a scene; each block recomputes the u0
//      columns it needs (u0 is an outer product: cheaper to recompute than
//      to read).  33.5 MFLOP a scene.
//   2. step_rows_kernel: one block per (tile of 8 point rows, scene), 128
//      blocks a scene at N = 1024, carries its rows from their w_up4 rows
//      through u4, emb and the x-dependent layers to the update, the
//      activations in shared memory (dense_rows of denoise_rows.cuh).
//      Each block reads all of u2 (512 KB a scene) and the
//      tail weights (264 KB) from L2, and the reads' latency bounds it: at
//      batch 1 an SM holds one block, so the block is 512 threads, four
//      parts of each layer's k keeping four times the reads in flight
//      (kStepUnroll below).
//
// Both launches together are one denoise_step call.  About 0.555 GFLOP a
// step and scene at the flagship width, 0.42 of it in u4: the step is
// bound by the FP32 FMA rate (the weights, 2.7 MB, take ~0.8 us at HBM
// rate).  Every product is a hand-written FMA loop: no cuBLAS.  The
// coefficients are read from the device ([c1, c2, c3], a row of the
// sampler's (T, 3) table), so a step needs no host synchronisation.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "denoise_rows.cuh"

namespace {

using namespace denoise;

// step_rows_kernel runs each dense layer with kSplit parts of its k
// (dense_rows): four where the grid fills the SMs at most twice (batch 1
// and 2: 128 or 256 blocks of 512 threads, four times the weight reads in
// flight), two beyond, where more blocks already share each SM.  Its k
// loops unroll kStepUnroll times, again for more reads in flight.
constexpr int kStepUnroll = 8;

constexpr int kU2Tile = 32;  // rows and columns of u2 per block
constexpr int kU2K = 128;    // u0 rows per shared-memory chunk (all of them)
constexpr int kU2Threads = 256;

// u2[b] (U2, 2D) = gelu(w_up2 @ u0_b + b_up2), u0_b = gelu(w_up0 (x) e2_b
// + b_up0).  Block (x, y, b) owns columns 32x..32x+31 and rows
// 32y..32y+31; thread (ty, tx) of 8 x 32 owns rows ty*4..ty*4+3 of column
// tx, so a warp reads one weight row (a broadcast) and 32 consecutive u0
// columns.
__global__ void __launch_bounds__(kU2Threads)
step_u2_kernel(const float* __restrict__ e2, const float* __restrict__ w_up0,
               const float* __restrict__ b_up0,
               const float* __restrict__ w_up2,
               const float* __restrict__ b_up2, int d2, int u0_dim,
               int u2_dim, float* __restrict__ u2) {
  __shared__ float u0s[kU2K][kU2Tile];
  __shared__ float ws[kU2Tile][kU2K + 1];
  const int b = blockIdx.z;
  const int j0 = blockIdx.x * kU2Tile, i0 = blockIdx.y * kU2Tile;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const float* e2b = e2 + (size_t)b * d2;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int k0 = 0; k0 < u0_dim; k0 += kU2K) {
    for (int e = threadIdx.x; e < kU2K * kU2Tile; e += kU2Threads) {
      const int kk = e / kU2Tile, jj = e - kk * kU2Tile;
      const int k = k0 + kk, j = j0 + jj;
      u0s[kk][jj] = (k < u0_dim && j < d2)
                        ? gelu(w_up0[k] * e2b[j] + b_up0[k]) : 0.0f;
    }
    for (int e = threadIdx.x; e < kU2Tile * kU2K; e += kU2Threads) {
      const int ii = e / kU2K, kk = e - ii * kU2K;
      const int i = i0 + ii, k = k0 + kk;
      ws[ii][kk] = (i < u2_dim && k < u0_dim)
                       ? w_up2[(size_t)i * u0_dim + k] : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kU2K; ++kk) {
      const float a = u0s[kk][tx];
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] = fmaf(ws[ty * 4 + q][kk], a, acc[q]);
    }
    __syncthreads();
  }
  const int j = j0 + tx;
  if (j >= d2) return;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int i = i0 + ty * 4 + q;
    if (i < u2_dim) u2[((size_t)b * u2_dim + i) * d2 + j] = gelu(acc[q] + b_up2[i]);
  }
}

struct StepWeights {
  const float *w_up4, *b_up4, *wc, *bc, *wp0, *bp0, *wp2, *bp2, *wx0, *bx0,
      *wx2, *bx2, *wo0, *bo0, *wo2, *bo2;
};

struct StepDims {
  int B, N, D2, U0, U2, D, DH, D15, DH2;
  // rows of the shared region that holds the w_up4 tile, then p1, h1,
  // h2 and h3
  __host__ __device__ int region() const {
    const int tail = DH + D15 + D + DH2;
    return U2 > tail ? U2 : tail;
  }
  __host__ size_t smem(int split) const {
    return sizeof(float) * kRows *
           (size_t)(region() + D2 + 2 * D + 3 + 3 + 1 + (split - 1) * kCols);
  }
};

// The step for one tile of kRows point rows of scene blockIdx.y, with
// kSplit * kCols threads.  u2: the scene's (U2, 2D) table from
// step_u2_kernel.
template <int kSplit>
__global__ void __launch_bounds__(kSplit * kCols)
step_rows_kernel(const float* __restrict__ x, const float* __restrict__ noise,
                 const float* __restrict__ cpcd, const float* __restrict__ u2,
                 const float* __restrict__ coef, StepWeights w, StepDims d,
                 int clip, float* __restrict__ out) {
  extern __shared__ __align__(16) float step_smem[];
  // every buffer is a multiple of kRows floats long: float4-aligned
  float* wt = step_smem;                      // [U2][kRows] w_up4 rows, k-major
  float* p1 = step_smem;                      // [DH][kRows] (after u4)
  float* h1 = p1 + d.DH * kRows;              // [D15][kRows]
  float* h2 = h1 + d.D15 * kRows;             // [D][kRows]
  float* h3 = h2 + d.D * kRows;               // [DH2][kRows]
  float* u4 = step_smem + d.region() * kRows;  // [2D][kRows]
  float* cat = u4 + d.D2 * kRows;             // [2D][kRows] pose features | emb
  float* xin = cat + 2 * d.D * kRows;         // [3][kRows] x + cond_pcd
  float* x0 = xin + 3 * kRows;                // [3][kRows]
  float* brow = x0 + 3 * kRows;               // [kRows] b_up4 of the rows
  float* red = brow + kRows;  // [kSplit - 1][kCols][kRows] partial sums

  const int b = blockIdx.y;
  const int r0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  // threads tid < 3 * kRows own one (row, coordinate) of the sample
  const int my_r = tid / 3, my_c = tid % 3, my_row = r0 + my_r;
  const bool owner = tid < 3 * kRows;
  const bool valid = owner && my_row < d.N;
  const size_t my_off = ((size_t)b * d.N + my_row) * 3 + my_c;

  float xv = 0.0f;
  if (owner) {
    xv = valid ? x[my_off] : 0.0f;
    xin[my_c * kRows + my_r] = valid ? xv + cpcd[my_off] : 0.0f;
  }
  for (int e = tid; e < kRows * d.U2; e += kSplit * kCols) {
    const int r = e / d.U2, k = e - r * d.U2;
    wt[k * kRows + r] =
        (r0 + r < d.N) ? w.w_up4[(size_t)(r0 + r) * d.U2 + k] : 0.0f;
  }
  if (tid < kRows) brow[tid] = (r0 + tid < d.N) ? w.b_up4[r0 + tid] : 0.0f;
  __syncthreads();

  constexpr int S = kSplit, U = kStepUnroll;
  // the t-only part, for the tile's rows: u4, then emb into cat[D:]
  dense_rows<true, kPerRow, S, U>(u2 + (size_t)b * d.U2 * d.D2, brow, wt, d.U2,
                               u4, d.D2, red);
  dense_rows<true, kPerOut, S, U>(w.wc, w.bc, u4, d.D2, cat + d.D * kRows, d.D,
                               red);
  // the x-dependent part: input_process (pose features into cat[:D]),
  // combination_extraction on concat(pose features, emb), output_process
  dense_rows<false, kPerOut, S, U>(w.wp0, w.bp0, xin, 3, p1, d.DH, red);
  dense_rows<false, kPerOut, S, U>(w.wp2, w.bp2, p1, d.DH, cat, d.D, red);
  dense_rows<false, kPerOut, S, U>(w.wx0, w.bx0, cat, 2 * d.D, h1, d.D15, red);
  dense_rows<false, kPerOut, S, U>(w.wx2, w.bx2, h1, d.D15, h2, d.D, red);
  dense_rows<true, kPerOut, S, U>(w.wo0, w.bo0, h2, d.D, h3, d.DH2, red);
  dense_rows<true, kPerOut, S, U>(w.wo2, w.bo2, h3, d.DH2, x0, 3, red);
  if (valid) {
    float x0v = x0[my_c * kRows + my_r];
    if (clip) x0v = fminf(fmaxf(x0v, -1.0f), 1.0f);
    out[my_off] = (coef[0] * x0v + coef[1] * xv) + coef[2] * noise[my_off];
  }
}

}  // namespace

extern "C" {

// x, noise, cpcd (B, N, 3); e2 (B, 2D); coef (3,) on the device; w: the 20
// DenoiseStepParams pointers in field order; out (B, N, 3); scratch: B *
// U2 * 2D floats (u2); dims = {B, N, 2D, U0, U2, D, DH, D15, DH2} with DH,
// D15 the widths of input_process's layers 0 and 2 and DH2 that of
// output_process's layer 0.  Returns cudaErrorInvalidValue for shapes the
// kernels do not take (2D != 2 * D, B > 65535, or more shared memory than
// a block can have).
int lsdm_denoise_step(const float* x, const float* noise, const float* cpcd,
                      const float* e2, const float* coef,
                      const float* const* w, float* out, float* scratch,
                      const int* dims, int clip, void* stream) {
  const StepDims d{dims[0], dims[1], dims[2], dims[3], dims[4],
                   dims[5], dims[6], dims[7], dims[8]};
  static int sms = 0;  // the device's SM count, read once
  cudaError_t err;
  if (!sms) {
    int dev;
    if ((err = cudaGetDevice(&dev)) ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)))
      return (int)err;
  }
  const dim3 grid2((d.N + kRows - 1) / kRows, d.B);
  const bool four = (long long)grid2.x * grid2.y <= 2 * sms;
  const size_t smem = d.smem(four ? 4 : 2);
  if (d.B <= 0 || d.B > 65535 || d.N <= 0 || d.D2 != 2 * d.D ||
      smem > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  auto rows = four ? step_rows_kernel<4> : step_rows_kernel<2>;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(rows,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)))
    return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid1((d.D2 + kU2Tile - 1) / kU2Tile,
                   (d.U2 + kU2Tile - 1) / kU2Tile, d.B);
  step_u2_kernel<<<grid1, kU2Threads, 0, st>>>(e2, w[0], w[1], w[2], w[3],
                                               d.D2, d.U0, d.U2, scratch);
  if ((err = cudaGetLastError())) return (int)err;
  const StepWeights sw{w[4],  w[5],  w[6],  w[7],  w[8],  w[9],
                       w[10], w[11], w[12], w[13], w[14], w[15],
                       w[16], w[17], w[18], w[19]};
  rows<<<grid2, (four ? 4 : 2) * kCols, smem, st>>>(x, noise, cpcd, scratch,
                                                    coef, sw, d, clip, out);
  return (int)cudaGetLastError();
}

}  // extern "C"

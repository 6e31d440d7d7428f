// K6's first pass for Hopper: the t-only tables of a chunk of denoise steps.
//
// Replaces the t-only part of lsdm_tpu/ops/denoise_pallas.py:278
// fused_denoise_chain, whose chain body computes u0 to emb at :252-255 (and
// the embedding's half of the first combination_extraction layer inside
// its step).  Plain version: lsdm_tpu_torch/ops/denoise.py:
// denoise_chain_tables_plain.  Per (scene, step) z of a chunk, at N points
// and width D (U0 = 128, U2 = 512), each product with its bias:
//
//   u2    = gelu(w_up2 @ u0 + b_up2)         (U2, 2D), K = U0
//           u0 = gelu(w_up0 (x) e2_z + b_up0) (U0, 2D), never stored
//   u4^T  = gelu(u2^T @ w_up4^T + b_up4)     (2D, N),  K = U2
//   emb^T = gelu(wc_t^T @ u4^T + bc)         (D, N),   K = 2D
//   g     = emb @ wx0_t[D:] + bx0            (N, 1.5D), K = D
//
// At N = 1024, D = 128 that is 209.7 M FMA a step: 6.26 ms a T = 1000
// sample at b1 at the H100's 67 TFLOP/s FP32 rate, against ~1.6 ms for the
// tables' bytes at 3.35 TB/s.  So the pass is bound by FP32 FMA
// throughput.  Every product is an FMA loop in exact float32: no TF32, no
// tensor cores, no cuBLAS.
//
// The design is one GEMM kernel, C[z] = act(A[z] @ B[z] + bias), batched
// over z on gridDim.z and built to keep the FMA units fed:
// - Operands arrive in the orientation the inner loop reads as float4s:
//   A transposed (k-major, A^T (K, M)) and B as it is (K, N).  Each
//   product's epilogue writes its table in the orientation the next one
//   reads (u4 and emb are computed transposed), and the two weights needed
//   transposed (w_up2, w_up4) are transposed once a call into the scratch.
// - A ring of kStages = 3 stages of 32-deep k tiles in dynamic shared
//   memory, filled by 16-byte cp.async.cg copies (the zero-fill form masks
//   ragged M, N and K), with one __syncthreads a k tile: while the FMAs
//   run on tile k, tiles k + 1 and k + 2 are in flight.
// - Each thread owns 8 x 8 outputs (two float4 column groups of two float4
//   row groups) and loads its A and B fragments of the next k slice from
//   shared memory while its FMAs run on the current one.
// - Tile shapes per product (BM x BN): 128 x 128, and a 96-column tile
//   where it wastes fewer columns (g is 1.5 D = 192 wide: two 96-column
//   tiles, none on padding).
// - The epilogue adds the row or column bias, applies the exact-erf GELU
//   in registers and writes float4s.
// - u0 is an outer product, so the u2 product's B producer computes its
//   tile as it fills a stage instead of reading a table: no u0 launch and
//   no u0 table.
//
// Registers a thread (nvcc -Xptxas -v, sm_90a; no spills) and dynamic
// shared memory a block, two blocks an SM:
//   128 x 128: 256 threads, 117 registers (120 with u0), 98,304 bytes
//   128 x 96:  192 threads, 123 registers (139 with u0), 86,016 bytes
// On an H100 at N = 1024, D = 128 the pass runs at 36 TFLOP/s, 54% of the
// FP32 peak, a little ahead of cuBLAS's four products without the GELUs
// (PERF.md §6).
//
// The bf16 mode (the TPU kernel at compute_dtype=bfloat16, its dot() at
// denoise_pallas.py:237-239) is the same GEMM with kBf16: the weights come
// rounded to bf16 from the wrapper, u0 is rounded as the producer makes
// it, and u2, u4^T and emb^T are rounded in the epilogue after their bias
// and GELU, since their only consumers are products that round them; g
// stays float32 (pass 2 adds it before its sigmoid).  Each output is still
// one float32 FMA chain, over bf16-exact operands.

#include <cuda_runtime.h>
#include <stdint.h>

#include "denoise_rows.cuh"  // gelu
#include "denoise_tables.cuh"

namespace denoise {
namespace {

enum { kBiasRow = 1, kBiasCol = 2 };
constexpr int kBK = 32, kStages = 3;

__host__ __device__ inline int up4(int v) { return (v + 3) & ~3; }

// One 16-byte copy from global to shared memory, of which the first
// `bytes` come from src and the rest are zeros.
__device__ __forceinline__ void copy16_async(float* dst, const float* src,
                                             int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// C (M, N), row stride ldc = act(A @ B + bias) for each z, from A^T (K, M)
// and B (K, N), row-major; s* are the batch strides (0: shared by every
// z).  With kUp0 there is no B: B[k][n] = gelu(w0[k] * e2_z[n] + b0[k]),
// e2_z the row (b * t_total + t0 + tt) of e2, z = b * tc + tt.
struct GemmArgs {
  const float* at;
  long long sa;
  const float* b;
  long long sb;
  float* c;
  long long sc;
  int lda, ldb, ldc;
  const float* bias;
  int bias_mode, act;
  int M, N, K;
  const float *e2, *w0, *b0;
  int t_total, t0, tc;
};

// Thread (ty, tx) of (BM / 8) x (BN / 8) owns rows {ty*4 + i, BM/2 + ty*4
// + i} and columns {tx*4 + j, BN/2 + tx*4 + j}, i, j < 4: its fragment
// reads are four float4s a k, and a warp's span two or three float4s of A
// (broadcast) and 12 or 16 consecutive ones of B.  Its k loop was measured
// against others on an H100 (PERF.md §6): 16-deep tiles in four stages,
// one block an SM with more registers, and warps of 4 x 8 threads (four
// shared-memory wavefronts a slice instead of six) all ran slower.
template <int BM, int BN, bool kUp0, bool kBf16>
__global__ void __launch_bounds__((BM / 8) * (BN / 8), 2)
gemm_bias_act(GemmArgs g) {
  constexpr int TX = BN / 8, THREADS = (BM / 8) * TX;
  constexpr int A_STAGE = kBK * BM, B_STAGE = kBK * BN;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                      // [stage][k][BM]
  float* Bs = smem + kStages * A_STAGE;  // [stage][k][BN]
  const long long z = blockIdx.z;
  const float* at = g.at + z * g.sa;
  const float* bg = kUp0 ? nullptr : g.b + z * g.sb;
  float* c = g.c + z * g.sc;
  const float* e_row = nullptr;
  if (kUp0) {
    const int b = (int)(z / g.tc), tt = (int)(z - (long long)b * g.tc);
    e_row = g.e2 + ((size_t)b * g.t_total + g.t0 + tt) * g.N;
  }
  const int M = g.M, N = g.N, K = g.K;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;

  // Stage s <- k tile [k0, k0 + kBK): copies in flight (or, for kUp0's B,
  // computed and stored now; the barrier before its use orders it).
  auto fill = [&](int s, int k0) {
    float* as = As + s * A_STAGE;
#pragma unroll
    for (int e = tid; e < kBK * BM / 4; e += THREADS) {
      const int k = e / (BM / 4), m = 4 * (e - k * (BM / 4));
      const int gk = k0 + k, gm = m0 + m;
      const int left = gk < K ? M - gm : 0;
      const int bytes = left >= 4 ? 16 : left > 0 ? 4 * left : 0;
      copy16_async(as + k * BM + m, bytes ? at + (size_t)gk * g.lda + gm : at,
                   bytes);
    }
    float* bs = Bs + s * B_STAGE;
#pragma unroll
    for (int e = tid; e < kBK * BN / 4; e += THREADS) {
      const int k = e / (BN / 4), n = 4 * (e - k * (BN / 4));
      const int gk = k0 + k, gn = n0 + n;
      if (kUp0) {
        float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (gk < K) {
          const float w = __ldg(g.w0 + gk), bias = __ldg(g.b0 + gk);
#pragma unroll
          for (int j = 0; j < 4; ++j)  // torch's rounding: product, then sum
            if (gn + j < N) {
              v[j] = gelu(__fadd_rn(__fmul_rn(w, __ldg(e_row + gn + j)), bias));
              if constexpr (kBf16) v[j] = bf16r(v[j]);
            }
        }
        *reinterpret_cast<float4*>(bs + k * BN + n) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else {
        const int left = gk < K ? N - gn : 0;
        const int bytes = left >= 4 ? 16 : left > 0 ? 4 * left : 0;
        copy16_async(bs + k * BN + n,
                     bytes ? bg + (size_t)gk * g.ldb + gn : bg, bytes);
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  const int tiles = (K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles) fill(s, s * kBK);
    copy_commit();
  }
  for (int kt = 0; kt < tiles; ++kt) {
    copy_wait<kStages - 2>();  // this thread's copies of tile kt landed
    __syncthreads();           // everyone's; and the stage of kt - 1 is free
    const int next = kt + kStages - 1;
    if (next < tiles) fill(next % kStages, next * kBK);
    copy_commit();  // an empty group past the end keeps the count
    const float* as = As + (kt % kStages) * A_STAGE + ty * 4;
    const float* bs = Bs + (kt % kStages) * B_STAGE + tx * 4;
    float a[2][8], b[2][8];
    auto frag = [&](int kk, float(&fa)[8], float(&fb)[8]) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + kk * BM);
      const float4 a1 = *reinterpret_cast<const float4*>(as + kk * BM + BM / 2);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * BN);
      const float4 b1 = *reinterpret_cast<const float4*>(bs + kk * BN + BN / 2);
      fa[0] = a0.x, fa[1] = a0.y, fa[2] = a0.z, fa[3] = a0.w;
      fa[4] = a1.x, fa[5] = a1.y, fa[6] = a1.z, fa[7] = a1.w;
      fb[0] = b0.x, fb[1] = b0.y, fb[2] = b0.z, fb[3] = b0.w;
      fb[4] = b1.x, fb[5] = b1.y, fb[6] = b1.z, fb[7] = b1.w;
    };
    auto fmas = [&](const float(&fa)[8], const float(&fb)[8]) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(fa[i], fb[j], acc[i][j]);
    };
    frag(0, a[0], b[0]);
    // two slices an iteration, the loop kept rolled: unrolled over the
    // tile's 32 slices it ran 5% slower on an H100 (PERF.md §6)
#pragma unroll 1
    for (int kk = 0; kk < kBK; kk += 2) {  // slices kk and kk + 1
      frag(kk + 1, a[1], b[1]);
      fmas(a[0], b[0]);
      if (kk + 2 < kBK) frag(kk + 2, a[0], b[0]);
      fmas(a[1], b[1]);
    }
  }

  // the epilogue: bias, activation, float4 stores where four columns fit
  const bool vec = (g.ldc & 3) == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + (i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + (i - 4));
    if (gm >= M) continue;
    const float rb = g.bias_mode == kBiasRow ? __ldg(g.bias + gm) : 0.0f;
    float* row = c + (size_t)gm * g.ldc;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gn = n0 + h * (BN / 2) + tx * 4;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float bias = g.bias_mode == kBiasCol
                               ? (gn + j < N ? __ldg(g.bias + gn + j) : 0.0f)
                               : rb;
        v[j] = acc[i][4 * h + j] + bias;
        if (g.act) v[j] = gelu(v[j]);
        if constexpr (kBf16)
          if (g.act) v[j] = bf16r(v[j]);
      }
      if (vec && gn + 4 <= N) {
        *reinterpret_cast<float4*>(row + gn) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gn + j < N) row[gn + j] = v[j];
      }
    }
  }
}

template <int BM, int BN, bool kUp0, bool kBf16>
cudaError_t launch(cudaStream_t st, const GemmArgs& a, int nz) {
  constexpr int threads = (BM / 8) * (BN / 8);
  constexpr int smem = (int)sizeof(float) * kStages * kBK * (BM + BN);
  cudaError_t err = cudaFuncSetAttribute(
      gemm_bias_act<BM, BN, kUp0, kBf16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  const dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM, nz);
  gemm_bias_act<BM, BN, kUp0, kBf16><<<grid, threads, smem, st>>>(a);
  return cudaGetLastError();
}

// The tile shape of a product: 96 columns where they waste fewer padded
// columns than 128 (ties take 128).
template <bool kBf16>
cudaError_t gemm(cudaStream_t st, const GemmArgs& a, int nz, bool up0) {
  const bool narrow = (a.N + 95) / 96 * 96 - a.N < (a.N + 127) / 128 * 128 - a.N;
  if (up0)
    return narrow ? launch<128, 96, true, kBf16>(st, a, nz)
                  : launch<128, 128, true, kBf16>(st, a, nz);
  return narrow ? launch<128, 96, false, kBf16>(st, a, nz)
                : launch<128, 128, false, kBf16>(st, a, nz);
}

cudaError_t gemm(cudaStream_t st, const GemmArgs& a, int nz, bool up0,
                 bool bf16) {
  return bf16 ? gemm<true>(st, a, nz, up0) : gemm<false>(st, a, nz, up0);
}

// dst (cols, ldd) = src (rows, cols)^T, zeros in the columns rows..ldd-1
__global__ void transpose_kernel(const float* __restrict__ src, int rows,
                                 int cols, float* __restrict__ dst, int ldd) {
  __shared__ float t[32][33];
  const int r0 = blockIdx.y * 32, c0 = blockIdx.x * 32;
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int r = r0 + i, col = c0 + threadIdx.x;
    t[i][threadIdx.x] = r < rows && col < cols ? src[(size_t)r * cols + col] : 0.0f;
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int col = c0 + i, r = r0 + threadIdx.x;
    if (col < cols && r < ldd) dst[(size_t)col * ldd + r] = t[threadIdx.x][i];
  }
}

cudaError_t transpose(cudaStream_t st, const float* src, int rows, int cols,
                      float* dst, int ldd) {
  const dim3 grid((cols + 31) / 32, (ldd + 31) / 32);
  transpose_kernel<<<grid, dim3(32, 8), 0, st>>>(src, rows, cols, dst, ldd);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

TablesLayout tables_layout(const ChainDims& d) {
  TablesLayout L;
  L.ldn = up4(d.N);
  L.w2t = 0;
  L.w4t = (size_t)d.U0 * d.U2;
  L.tables = L.w4t + (size_t)d.U2 * L.ldn;
  L.u2 = (size_t)d.U2 * d.D2;
  L.u4t = (size_t)d.D2 * L.ldn;
  L.embt = (size_t)d.D * L.ldn;
  L.g = (size_t)d.N * d.D15;
  return L;
}

cudaError_t tables_check(const ChainDims& d, const float* const* w,
                         const float* scratch) {
  const bool ok = d.N > 0 && d.U0 > 0 && d.U2 > 0 && d.D > 0 && d.D % 4 == 0 &&
                  d.D15 % 4 == 0 && d.U2 % 4 == 0 && aligned16(w[6]) &&
                  aligned16(w[12]) && aligned16(scratch);
  return ok ? cudaSuccess : cudaErrorInvalidValue;
}

cudaError_t transpose_weights(cudaStream_t st, const ChainDims& d,
                              const float* const* w, float* scratch) {
  const TablesLayout L = tables_layout(d);
  cudaError_t err = transpose(st, w[2], d.U2, d.U0, scratch + L.w2t, d.U2);
  if (err) return err;
  return transpose(st, w[4], d.N, d.U2, scratch + L.w4t, L.ldn);
}

cudaError_t chain_tables(cudaStream_t st, const ChainDims& d, const float* e2,
                         const float* const* w, float* scratch, int t0, int tc,
                         bool bf16, float** g_out) {
  const TablesLayout L = tables_layout(d);
  const int nz = d.B * tc;
  float* u2 = scratch + L.tables;
  float* u4t = u2 + (size_t)nz * L.u2;
  float* embt = u4t + (size_t)nz * L.u4t;
  float* g = embt + (size_t)nz * L.embt;
  *g_out = g;
  const float *w_up0 = w[0], *b_up0 = w[1], *b_up2 = w[3], *b_up4 = w[5],
              *wc = w[6], *bc = w[7], *wx0 = w[12], *bx0 = w[13];
  cudaError_t err;
  // u2 = gelu(w_up2 @ u0 + b_up2), u0 made in the B producer
  GemmArgs a{};
  a.at = scratch + L.w2t, a.lda = d.U2;
  a.c = u2, a.ldc = d.D2, a.sc = (long long)L.u2;
  a.bias = b_up2, a.bias_mode = kBiasRow, a.act = 1;
  a.M = d.U2, a.N = d.D2, a.K = d.U0;
  a.e2 = e2, a.w0 = w_up0, a.b0 = b_up0, a.t_total = d.T, a.t0 = t0, a.tc = tc;
  if ((err = gemm(st, a, nz, true, bf16))) return err;
  // u4^T = gelu(u2^T @ w_up4^T + b_up4)
  a = GemmArgs{};
  a.at = u2, a.lda = d.D2, a.sa = (long long)L.u2;
  a.b = scratch + L.w4t, a.ldb = L.ldn;
  a.c = u4t, a.ldc = L.ldn, a.sc = (long long)L.u4t;
  a.bias = b_up4, a.bias_mode = kBiasCol, a.act = 1;
  a.M = d.D2, a.N = d.N, a.K = d.U2;
  if ((err = gemm(st, a, nz, false, bf16))) return err;
  // emb^T = gelu(wc_t^T @ u4^T + bc)
  a = GemmArgs{};
  a.at = wc, a.lda = d.D;
  a.b = u4t, a.ldb = L.ldn, a.sb = (long long)L.u4t;
  a.c = embt, a.ldc = L.ldn, a.sc = (long long)L.embt;
  a.bias = bc, a.bias_mode = kBiasRow, a.act = 1;
  a.M = d.D, a.N = d.N, a.K = d.D2;
  if ((err = gemm(st, a, nz, false, bf16))) return err;
  // g = emb @ wx0_t[D:2D] + bx0, no activation (pass 2 adds the rest)
  a = GemmArgs{};
  a.at = embt, a.lda = L.ldn, a.sa = (long long)L.embt;
  a.b = wx0 + (size_t)d.D * d.D15, a.ldb = d.D15;
  a.c = g, a.ldc = d.D15, a.sc = (long long)L.g;
  a.bias = bx0, a.bias_mode = kBiasCol, a.act = 0;
  a.M = d.N, a.N = d.D15, a.K = d.D;
  return gemm(st, a, nz, false, bf16);
}

}  // namespace denoise

namespace {

int chain_tables_entry(const float* e2, const float* const* w, float* scratch,
                       const int* dims, void* stream, bool bf16) {
  using namespace denoise;
  const ChainDims d{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5],
                    dims[6], dims[7], dims[8], dims[9], dims[1]};
  if (d.B <= 0 || d.T <= 0 || d.D2 != 2 * d.D) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if ((err = tables_check(d, w, scratch))) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  if ((err = transpose_weights(st, d, w, scratch))) return (int)err;
  float* g;
  return (int)chain_tables(st, d, e2, w, scratch, 0, d.T, bf16, &g);
}

}  // namespace

extern "C" {

// Pass 1 alone over all T steps (one chunk): afterwards scratch, of
// U0*U2 + U2*ldn + B*T*(U2*2D + 2D*ldn + D*ldn + N*D15) floats (ldn = N
// rounded up to 4), holds w_up2^T, w_up4^T and the tables u2, u4^T, emb^T,
// g of every (scene, step) in that order (denoise_tables.cuh).  Arguments
// as for lsdm_denoise_chain; dims[10] is ignored.  Returns
// cudaErrorInvalidValue for shapes pass 1 does not take.
int lsdm_denoise_chain_tables(const float* e2, const float* const* w,
                              float* scratch, const int* dims, void* stream) {
  return chain_tables_entry(e2, w, scratch, dims, stream, false);
}

// The same in the bf16 mode, the weights rounded to bf16 by the caller.
int lsdm_denoise_chain_tables_bf16(const float* e2, const float* const* w,
                                   float* scratch, const int* dims,
                                   void* stream) {
  return chain_tables_entry(e2, w, scratch, dims, stream, true);
}

}  // extern "C"

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
// The bf16 mode (the TPU kernel at compute_dtype=bfloat16, whose dot()
// rounds both operands to bf16 and sums in float32, denoise_pallas.py:
// 237-239) is another design, built for Hopper's bf16 tensor cores.  Its
// products are 0.42 GFLOP a step: 0.424 ms a T = 1000 sample at b1 at the
// H100's 989 TFLOP/s, where the FMA design above (36 TFLOP/s) takes 27
// times that.  On the tensor cores three other costs come to the fore, of
// about the same size each and hardly overlapped (PERF.md section 6, PR
// 16): the tables' traffic to device memory (stored float32, u2, u4^T,
// emb^T and g would move ~5.0 GB at b1, ~1.5 ms at 3.35 TB/s), the reads of
// the shared operands from L2 (each 128-point tile re-reads its step's
// u2), and the 0.56 M exact-erf GELUs a step, ~30 instructions each.  So:
// - Every operand is bf16 in memory, which changes no value, since every
//   one is bf16-exact: the weights come as bf16 copies made once per model
//   by the wrapper (ops/denoise.py:Bf16Operands: w_up2^T, w_up4^T, wc_t and
//   wx0_t[D:], rows padded to 8 elements, so nothing is transposed a call),
//   and each activation is rounded after its bias and GELU as before.  g
//   stays float32: pass 2 adds it before its sigmoid.  emb^T never goes to
//   device memory in the chain: g's product takes it from shared memory.
//   The tables then move ~2.5 GB at b1 (0.75 ms at 3.35 TB/s).
// - Every product runs on wgmma.m64n64k16 (bf16 x bf16 -> float32), both
//   operands read from shared memory as 128-byte-swizzled MN-major atoms
//   (64 columns of 32 k rows; the layout the k-major tables already have),
//   filled by 16-byte cp.async copies whose zero-fill form masks ragged M,
//   N and K.  A ring of 4 stages, 2 k tiles loaded ahead, each tile's
//   products left running while the next tile's loads are issued.  Blocks
//   of two warpgroups, 64 accumulators a thread, two blocks an SM, so one
//   block's GELU epilogue runs beside the other's products.
// - Four launches a chunk: u0_kernel makes u0 once a (scene, step) (the
//   FMA design's producer made it once per row tile of u2, four times);
//   gemm_gelu_kernel makes u2 and then u4^T on 128 x 128 tiles, staged in
//   shared memory and stored in 16-byte row chunks; emb_g_kernel makes, for
//   128 points, emb^T's columns (kept in shared memory as bf16 atoms, g's A
//   operand) and then g's rows, stored as float32 straight from the
//   accumulators (a row's four lanes write one 32-byte sector).
// - Each epilogue adds the row or column bias and applies the erf GELU on
//   the float32 accumulators, then rounds.
// Measured against other designs on an H100 (PERF.md section 6, PR 16):
// FMA-era mma.sync with ldmatrix (bound by shared-memory reads), one fused
// u4^T -> emb^T -> g kernel (one block an SM: its phases never overlap),
// and the same on 64-point tiles (u2 read twice as often) were all slower.
// Registers (ptxas, sm_90a): u0_kernel 32, gemm_gelu_kernel 122,
// emb_g_kernel 128 (its cap at two blocks an SM), no spills; shared memory
// 64 KB (gemm) and 96 KB (emb_g) a block.  On an H100 at 700 W the pass
// takes 2.84 ms at b1 (148 TFLOP/s), below its four products as bf16
// baddbmm (3.01 ms), whose GELUs and u0 it computes besides.

#include <cuda_bf16.h>
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
template <int BM, int BN, bool kUp0>
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

template <int BM, int BN, bool kUp0>
cudaError_t launch(cudaStream_t st, const GemmArgs& a, int nz) {
  constexpr int threads = (BM / 8) * (BN / 8);
  constexpr int smem = (int)sizeof(float) * kStages * kBK * (BM + BN);
  cudaError_t err = cudaFuncSetAttribute(
      gemm_bias_act<BM, BN, kUp0>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  const dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM, nz);
  gemm_bias_act<BM, BN, kUp0><<<grid, threads, smem, st>>>(a);
  return cudaGetLastError();
}

// The tile shape of a product: 96 columns where they waste fewer padded
// columns than 128 (ties take 128).
cudaError_t gemm(cudaStream_t st, const GemmArgs& a, int nz, bool up0) {
  const bool narrow = (a.N + 95) / 96 * 96 - a.N < (a.N + 127) / 128 * 128 - a.N;
  if (up0)
    return narrow ? launch<128, 96, true>(st, a, nz)
                  : launch<128, 128, true>(st, a, nz);
  return narrow ? launch<128, 96, false>(st, a, nz)
                : launch<128, 128, false>(st, a, nz);
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

// ------------------------------------------------------------ the bf16 mode

using bf16 = __nv_bfloat16;

constexpr int kThreadsWg = 256;  // two warpgroups in every bf16 kernel
constexpr int kStagesWg = 4;     // ring stages of kBK-deep k tiles
constexpr int kAheadWg = 2;      // k tiles loaded ahead of the one in use
constexpr int kPadC = 8;         // elements past a row of a staged out tile

__host__ __device__ inline int up8(int v) { return (v + 7) & ~7; }

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// u0[z] = bf16(gelu(w_up0 (x) e2_z + b_up0)), (U0, 2D) row-major, e2_z the
// row (b * t_total + t0 + tt) of e2, z = b * tc + tt: made once a (scene,
// step), 8 values a thread.
__global__ void __launch_bounds__(kThreadsWg)
u0_kernel(const float* __restrict__ e2, const float* __restrict__ w0,
          const float* __restrict__ b0, bf16* __restrict__ u0, int U0, int D2,
          int t_total, int t0, int tc) {
  const long long z = blockIdx.y;
  const int b = (int)(z / tc), tt = (int)(z - (long long)b * tc);
  const float* e = e2 + ((size_t)b * t_total + t0 + tt) * D2;
  bf16* out = u0 + z * U0 * D2;
  const int per_row = D2 / 8;
  for (int c = blockIdx.x * kThreadsWg + threadIdx.x; c < U0 * per_row;
       c += gridDim.x * kThreadsWg) {
    const int k = c / per_row, n = 8 * (c - k * per_row);
    const float w = __ldg(w0 + k), bias = __ldg(b0 + k);
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)  // torch's rounding: product, then sum
      v[j] = gelu(__fadd_rn(__fmul_rn(w, __ldg(e + n + j)), bias));
    *reinterpret_cast<uint4*>(out + (size_t)k * D2 + n) =
        make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                   pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  }
}

// ---- the products, on wgmma
//
// Operands lie k-major in shared memory as 128-byte swizzle atoms of
// GMMA's MN-major layout: an atom holds 64 consecutive columns (m or n) of
// `rows` k rows, each k row one 128-byte line whose 16-byte chunks sit at
// chunk ^ (k & 7); atoms follow each other.  Every product is m64n64k16
// on one atom of A and one of B, so a descriptor's two strides are both
// the 1024 bytes from one 8-row group of k to the next.

template <int ROWS>
__device__ __forceinline__ int atom_off(int k, int ch) {  // elements
  return (ch >> 3) * ROWS * 64 + k * 64 + (((ch & 7) ^ (k & 7)) << 3);
}

__device__ __forceinline__ uint64_t gmma_desc(const bf16* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr >> 4) & 0x3FFFull) | (64ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64 x 64, float32, this warpgroup's) += A (64 x 16) @ B (16 x 64), both
// bf16 MN-major ("transposed") in shared memory
__device__ __forceinline__ void wgmma_64x64(float (&d)[32], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// kBK rows x (8 * chunks) columns from global row-major (ld; rows past
// `rows`, columns past `cols` zero-filled) into atoms of kBK rows.
__device__ __forceinline__ void fill_atoms(bf16* st, const bf16* src, int ld,
                                           int k0, int rows, int cols,
                                           int chunks) {
  for (int e = threadIdx.x; e < kBK * chunks; e += kThreadsWg) {
    const int k = e / chunks, ch = e - k * chunks;
    const int left = k0 + k < rows ? cols - 8 * ch : 0;
    const int bytes = left >= 8 ? 16 : left > 0 ? 2 * left : 0;
    copy16_async(reinterpret_cast<float*>(st + atom_off<kBK>(k, ch)),
                 reinterpret_cast<const float*>(
                     bytes ? src + (size_t)(k0 + k) * ld + 8 * ch : src),
                 bytes);
  }
}

// A k-major operand of a wgmma loop: from global (g, ld; its `cols`
// columns, `atoms` of 64 of them in a ring stage, zero past K) through the
// ring, or (g null; A only) a smem tile s of atoms of `rows` k rows holding
// every k (zero past K).
struct Operand {
  const bf16* g;
  int ld, cols, atoms;
  const bf16* s;
  int rows;
};

// acc += A @ B over k < K for this warpgroup's m64 slice mi of A and the
// NS n64 slices of B (from global): NS m64n64k16 products a 16-deep k
// step, the same count in every warpgroup (a wgmma under a branch would be
// serialized).  The ring: kStagesWg stages of `stage` elements, the global
// operands' atoms of kBK rows each (A's first), kAheadWg tiles loaded
// ahead; each tile's products run on while the next tile's barrier and
// loads are issued (one wgmma group left in flight), so a stage is
// refilled two tiles after its products were issued, when they are done.
// Returns after a block barrier: the ring is free again.
template <int NS>
__device__ __forceinline__ void wgmma_loop(float (&acc)[NS][32], int mi,
                                           const Operand& A, const Operand& B,
                                           int K, bf16* ring, int stage) {
  static_assert(kStagesWg >= kAheadWg + 2, "a stage in use, one draining");
  const int a_part = A.g ? A.atoms * kBK * 64 : 0;
  auto fill = [&](int s, int k0) {
    bf16* st = ring + s * stage;
    if (A.g) fill_atoms(st, A.g, A.ld, k0, K, A.cols, 8 * A.atoms);
    fill_atoms(st + a_part, B.g, B.ld, k0, K, B.cols, 8 * B.atoms);
  };
  const int tiles = (K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kAheadWg; ++s) {
    if (s < tiles) fill(s, s * kBK);
    copy_commit();
  }
  for (int kt = 0; kt < tiles; ++kt) {
    copy_wait<kAheadWg - 1>();  // this thread's copies of tile kt landed
    fence_async_smem();         // its writes, seen by the tensor cores
    __syncthreads();            // everyone's; older tiles' products are done
    const int next = kt + kAheadWg;
    if (next < tiles) fill(next % kStagesWg, next * kBK);
    copy_commit();  // an empty group past the end keeps the count
    const bf16* st = ring + (kt % kStagesWg) * stage;
    const bf16* as = A.g ? st + mi * kBK * 64 : A.s + (mi * A.rows + kt * kBK) * 64;
    const bf16* bs = st + a_part;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16)
#pragma unroll
      for (int j = 0; j < NS; ++j)
        wgmma_64x64(acc[j], gmma_desc(as + kk * 64),
                    gmma_desc(bs + j * kBK * 64 + kk * 64));
    wgmma_commit();
    wgmma_wait<1>();  // tile kt - 1's products done; kt's run on
  }
  wgmma_wait<0>();
  copy_wait<0>();
  __syncthreads();
}

// Row (in this warpgroup's m64 slice) and column (in n64 slice j) of
// accumulator r of this thread: the m64nNk16 fragment, warp q of the
// warpgroup holding rows 16 q .. 16 q + 15.
__device__ __forceinline__ int wg_row(int r) {
  const int t = threadIdx.x;
  return 16 * ((t >> 5) & 3) + ((t & 31) >> 2) + 8 * ((r >> 1) & 1);
}
__device__ __forceinline__ int wg_col(int j, int r) {
  return 64 * j + 8 * (r >> 2) + 2 * (threadIdx.x & 3);
}

template <int NS>
__device__ __forceinline__ void zero_acc(float (&acc)[NS][32]) {
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int r = 0; r < 32; ++r) acc[j][r] = 0.0f;
}

constexpr int kWgTile = 128;           // 128 x 128 tiles, 2 warpgroups
constexpr int kWgStage = kBK * 64 * 4;  // 4 atoms: 16 KB
constexpr int kGemmSmem = 2 * kStagesWg * kWgStage;
static_assert(2 * kWgTile * (kWgTile + kPadC) <= kGemmSmem, "the staged tile");

// C[z] = bf16(gelu(A[z] @ B[z] + bias)), (M, N) row-major with rows of ldc
// (whole 16-byte chunks: ldc >= N rounded up to 8), from A^T (K, M) and B
// (K, N) bf16 row-major (s*: batch strides, 0 shared), the bias by row
// (per m) or by column (per n): u2 and u4^T.
struct GemmArgs16 {
  const bf16 *a, *b;
  long long sa, sb;
  int lda, ldb;
  const float* bias;
  int bias_by_row;
  bf16* c;
  long long sc;
  int ldc, M, N, K;
};

// On 128 x 128 tiles of two warpgroups (rows 64 w ..), two blocks an SM.
__global__ void __launch_bounds__(kThreadsWg, 2) gemm_gelu_kernel(GemmArgs16 t) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  const long long z = blockIdx.z;
  const int m0 = blockIdx.y * kWgTile, n0 = blockIdx.x * kWgTile;
  const int w = threadIdx.x >> 7;
  float acc[2][32];
  zero_acc(acc);
  const Operand A{t.a + z * t.sa + m0, t.lda, t.M - m0, 2, nullptr, 0};
  const Operand B{t.b + z * t.sb + n0, t.ldb, t.N - n0, 2, nullptr, 0};
  wgmma_loop(acc, w, A, B, t.K, ring, kWgStage);
  bf16* cs = ring;  // [128][128 + kPadC]
  constexpr int CP = kWgTile + kPadC;
#pragma unroll
  for (int r = 0; r < 32; r += 2) {
    const int m = 64 * w + wg_row(r);
    const float rb = t.bias_by_row && m0 + m < t.M ? __ldg(t.bias + m0 + m) : 0.0f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = wg_col(j, r), n = n0 + c;
      const float b0 = t.bias_by_row ? rb : n < t.N ? __ldg(t.bias + n) : 0.0f;
      const float b1 = t.bias_by_row ? rb : n + 1 < t.N ? __ldg(t.bias + n + 1) : 0.0f;
      *reinterpret_cast<uint32_t*>(cs + m * CP + c) =
          pack_bf16(gelu(acc[j][r] + b0), gelu(acc[j][r + 1] + b1));
    }
  }
  __syncthreads();
  bf16* out = t.c + z * t.sc;
  for (int e = threadIdx.x; e < kWgTile * kWgTile / 8; e += kThreadsWg) {
    const int r = e / (kWgTile / 8), gm = m0 + r;
    const int gn = n0 + 8 * (e - r * (kWgTile / 8));
    if (gm < t.M && gn < t.N)
      *reinterpret_cast<uint4*>(out + (size_t)gm * t.ldc + gn) =
          *reinterpret_cast<const uint4*>(cs + r * CP + (gn - n0));
  }
}

cudaError_t gemm_gelu(cudaStream_t st, const GemmArgs16& a, int nz) {
  cudaError_t err = cudaFuncSetAttribute(
      gemm_gelu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmem);
  if (err) return err;
  const dim3 grid((a.N + kWgTile - 1) / kWgTile, (a.M + kWgTile - 1) / kWgTile, nz);
  gemm_gelu_kernel<<<grid, kThreadsWg, kGemmSmem, st>>>(a);
  return cudaGetLastError();
}

// emb^T's columns and g's rows for 128 points [n0, n0 + 128) of z, two
// warpgroups, two blocks an SM: emb^T = bf16(gelu(wc_t^T @ u4^T + bc)) (D
// x 128, K = 2D; warpgroup w rows 64 w ..) kept in shared memory as g's A
// operand (and stored when asked, for pass 1 alone), then g = emb @
// wx0_t[D:2D] + bx0 (128 x D15, K = D; warpgroup w points 64 w ..), float32
// straight from the accumulators, a row's four lanes one 32-byte sector.
// D <= 128, D15 <= 192.
constexpr int kEgN3 = 3;  // g's n64 slices: D15 <= 192
constexpr int kEgSmem = 2 * (kStagesWg * kWgStage + kWgTile * kWgTile);

struct EmbGArgs {
  const bf16 *u4t, *wc, *wx;
  long long su4;        // u4^T (2D, ldn) per z
  int ldn, ldwc, ldwx;  // rows of the wc_t, wx0_t[D:] copies
  const float *bc, *bx0;
  bf16* embt;  // (D, ldn) per z, or null: not stored
  float* g;    // (N, D15) per z
  long long sg;
  int N, D2, D, D15;
};

__global__ void __launch_bounds__(kThreadsWg, 2) emb_g_kernel(EmbGArgs t) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  bf16* es = ring + kStagesWg * kWgStage;  // 2 atoms of 128 rows
  const long long z = blockIdx.y;
  const int n0 = blockIdx.x * kWgTile, w = threadIdx.x >> 7;
  {
    float acc[2][32];
    zero_acc(acc);
    const Operand A{t.wc, t.ldwc, t.D, 2, nullptr, 0};
    const Operand B{t.u4t + z * t.su4 + n0, t.ldn, t.N - n0, 2, nullptr, 0};
    wgmma_loop(acc, w, A, B, t.D2, ring, kWgStage);
    bf16* eg = t.embt ? t.embt + z * (long long)t.D * t.ldn : nullptr;
#pragma unroll
    for (int r = 0; r < 32; r += 2) {
      const int d = 64 * w + wg_row(r);
      const bool live = d < t.D;  // rows past D: zero k rows of g's
      const float bias = live ? __ldg(t.bc + d) : 0.0f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = wg_col(j, r);
        const uint32_t v = pack_bf16(live ? gelu(acc[j][r] + bias) : 0.0f,
                                     live ? gelu(acc[j][r + 1] + bias) : 0.0f);
        *reinterpret_cast<uint32_t*>(es + atom_off<kWgTile>(d, c >> 3) + (c & 7)) = v;
        if (eg && live && n0 + c < t.N) {  // ldn even: pairs on 4 bytes
          bf16* p = eg + (size_t)d * t.ldn + n0 + c;
          if (n0 + c + 1 < t.N)
            *reinterpret_cast<uint32_t*>(p) = v;
          else
            *p = __ushort_as_bfloat16((unsigned short)(v & 0xffffu));
        }
      }
    }
  }
  {
    float acc[kEgN3][32];
    zero_acc(acc);
    const Operand A{nullptr, 0, 0, 0, es, kWgTile};
    const Operand B{t.wx, t.ldwx, t.D15, kEgN3, nullptr, 0};
    wgmma_loop(acc, w, A, B, t.D, ring, kWgStage);
    float* gz = t.g + z * t.sg;
#pragma unroll
    for (int j = 0; j < kEgN3; ++j)
#pragma unroll
      for (int r = 0; r < 32; r += 2) {
        const int c = wg_col(j, r), n = n0 + 64 * w + wg_row(r);
        if (c < t.D15 && n < t.N)  // D15 % 4 == 0: pairs stay in the row
          *reinterpret_cast<float2*>(gz + (size_t)n * t.D15 + c) =
              make_float2(acc[j][r] + __ldg(t.bx0 + c),
                          acc[j][r + 1] + __ldg(t.bx0 + c + 1));
      }
  }
}

// Pass 1 in the bf16 mode for steps [t0, t0 + tc): u0, u2 and u4^T (bf16
// tables), then g (float32) and, if keep_emb, emb^T (bf16), from the bf16
// operand copies w[20..23].
cudaError_t chain_tables_bf16(cudaStream_t st, const ChainDims& d,
                              const float* e2, const float* const* w,
                              float* scratch, int t0, int tc, bool keep_emb,
                              float** g_out) {
  const TablesLayout L = tables_layout(d, true);
  const int nz = d.B * tc;
  bf16* u0 = reinterpret_cast<bf16*>(scratch + L.tables);
  bf16* u2 = u0 + 2 * (size_t)nz * L.u0;
  bf16* u4t = u2 + 2 * (size_t)nz * L.u2;
  float* g = reinterpret_cast<float*>(u4t + 2 * (size_t)nz * L.u4t);
  bf16* embt = reinterpret_cast<bf16*>(g + (size_t)nz * L.g);
  *g_out = g;
  cudaError_t err;
  const int u0_blocks = (d.U0 * d.D2 / 8 + kThreadsWg - 1) / kThreadsWg;
  u0_kernel<<<dim3(u0_blocks, nz), kThreadsWg, 0, st>>>(
      e2, w[0], w[1], u0, d.U0, d.D2, d.T, t0, tc);
  if ((err = cudaGetLastError())) return err;
  GemmArgs16 p{};  // u2 = gelu(w_up2 @ u0 + b_up2)
  p.a = reinterpret_cast<const bf16*>(w[20]), p.lda = up8(d.U2);
  p.b = u0, p.sb = 2 * (long long)L.u0, p.ldb = d.D2;
  p.bias = w[3], p.bias_by_row = 1;
  p.c = u2, p.sc = 2 * (long long)L.u2, p.ldc = d.D2;
  p.M = d.U2, p.N = d.D2, p.K = d.U0;
  if ((err = gemm_gelu(st, p, nz))) return err;
  p = GemmArgs16{};  // u4^T = gelu(u2^T @ w_up4^T + b_up4)
  p.a = u2, p.sa = 2 * (long long)L.u2, p.lda = d.D2;
  p.b = reinterpret_cast<const bf16*>(w[21]), p.ldb = L.ldn;
  p.bias = w[5], p.bias_by_row = 0;
  p.c = u4t, p.sc = 2 * (long long)L.u4t, p.ldc = L.ldn;
  p.M = d.D2, p.N = d.N, p.K = d.U2;
  if ((err = gemm_gelu(st, p, nz))) return err;
  EmbGArgs a{};
  a.u4t = u4t, a.su4 = 2 * (long long)L.u4t, a.ldn = L.ldn;
  a.wc = reinterpret_cast<const bf16*>(w[22]), a.ldwc = up8(d.D);
  a.wx = reinterpret_cast<const bf16*>(w[23]), a.ldwx = up8(d.D15);
  a.bc = w[7], a.bx0 = w[13];
  a.embt = keep_emb ? embt : nullptr;
  a.g = g, a.sg = (long long)L.g;
  a.N = d.N, a.D2 = d.D2, a.D = d.D, a.D15 = d.D15;
  if ((err = cudaFuncSetAttribute(emb_g_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kEgSmem)))
    return err;
  emb_g_kernel<<<dim3((d.N + kWgTile - 1) / kWgTile, nz), kThreadsWg, kEgSmem,
                 st>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

TablesLayout tables_layout(const ChainDims& d, bool bf16) {
  TablesLayout L;
  if (bf16) {  // no weights; u0, u2, u4^T bf16 (two a float), g, emb^T bf16
    L.ldn = up8(d.N);
    L.w2t = L.w4t = L.tables = 0;
    L.u0 = (size_t)d.U0 * d.D2 / 2;
    L.u2 = (size_t)d.U2 * d.D2 / 2;
    L.u4t = (size_t)d.D2 * L.ldn / 2;
    L.embt = (size_t)d.D * L.ldn / 2;
    L.g = (size_t)d.N * d.D15;
    return L;
  }
  L.ldn = up4(d.N);
  L.u0 = 0;
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
                         const float* scratch, bool bf16) {
  bool ok = d.N > 0 && d.U0 > 0 && d.U2 > 0 && d.D > 0 && d.D % 4 == 0 &&
            d.D15 % 4 == 0 && d.U2 % 4 == 0 && aligned16(w[6]) &&
            aligned16(w[12]) && aligned16(scratch);
  if (bf16) {  // emb_g_kernel's tile: D <= 128, D15 <= 192
    ok = ok && d.D <= kWgTile && d.D15 <= 64 * kEgN3;
    for (int i = 20; i < 24; ++i) ok = ok && aligned16(w[i]);
  }
  return ok ? cudaSuccess : cudaErrorInvalidValue;
}

cudaError_t transpose_weights(cudaStream_t st, const ChainDims& d,
                              const float* const* w, float* scratch) {
  const TablesLayout L = tables_layout(d, false);
  cudaError_t err = transpose(st, w[2], d.U2, d.U0, scratch + L.w2t, d.U2);
  if (err) return err;
  return transpose(st, w[4], d.N, d.U2, scratch + L.w4t, L.ldn);
}

cudaError_t chain_tables(cudaStream_t st, const ChainDims& d, const float* e2,
                         const float* const* w, float* scratch, int t0, int tc,
                         bool bf16, bool keep_emb, float** g_out) {
  if (bf16)
    return chain_tables_bf16(st, d, e2, w, scratch, t0, tc, keep_emb, g_out);
  const TablesLayout L = tables_layout(d, false);
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
  if ((err = gemm(st, a, nz, true))) return err;
  // u4^T = gelu(u2^T @ w_up4^T + b_up4)
  a = GemmArgs{};
  a.at = u2, a.lda = d.D2, a.sa = (long long)L.u2;
  a.b = scratch + L.w4t, a.ldb = L.ldn;
  a.c = u4t, a.ldc = L.ldn, a.sc = (long long)L.u4t;
  a.bias = b_up4, a.bias_mode = kBiasCol, a.act = 1;
  a.M = d.D2, a.N = d.N, a.K = d.U2;
  if ((err = gemm(st, a, nz, false))) return err;
  // emb^T = gelu(wc_t^T @ u4^T + bc)
  a = GemmArgs{};
  a.at = wc, a.lda = d.D;
  a.b = u4t, a.ldb = L.ldn, a.sb = (long long)L.u4t;
  a.c = embt, a.ldc = L.ldn, a.sc = (long long)L.embt;
  a.bias = bc, a.bias_mode = kBiasRow, a.act = 1;
  a.M = d.D, a.N = d.N, a.K = d.D2;
  if ((err = gemm(st, a, nz, false))) return err;
  // g = emb @ wx0_t[D:2D] + bx0, no activation (pass 2 adds the rest)
  a = GemmArgs{};
  a.at = embt, a.lda = L.ldn, a.sa = (long long)L.embt;
  a.b = wx0 + (size_t)d.D * d.D15, a.ldb = d.D15;
  a.c = g, a.ldc = d.D15, a.sc = (long long)L.g;
  a.bias = bx0, a.bias_mode = kBiasCol, a.act = 0;
  a.M = d.N, a.N = d.D15, a.K = d.D;
  return gemm(st, a, nz, false);
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
  if ((err = tables_check(d, w, scratch, bf16))) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  if (!bf16 && (err = transpose_weights(st, d, w, scratch))) return (int)err;
  float* g;
  return (int)chain_tables(st, d, e2, w, scratch, 0, d.T, bf16, dims[10] != 0, &g);
}

}  // namespace

extern "C" {

// Pass 1 alone over all T steps (one chunk): afterwards scratch, of
// U0*U2 + U2*ldn + B*T*(U2*2D + 2D*ldn + D*ldn + N*D15) floats (ldn = N
// rounded up to 4), holds w_up2^T, w_up4^T and the tables u2, u4^T, emb^T,
// g of every (scene, step) in that order (denoise_tables.cuh).  Arguments
// as for lsdm_denoise_chain, but dims[10]: 1 keeps emb^T in the scratch, 0
// does not, as the chain runs pass 1 (the bf16 mode; the float32 mode
// always keeps it).  Returns
// cudaErrorInvalidValue for shapes pass 1 does not take.
int lsdm_denoise_chain_tables(const float* e2, const float* const* w,
                              float* scratch, const int* dims, void* stream) {
  return chain_tables_entry(e2, w, scratch, dims, stream, false);
}

// The same in the bf16 mode: w holds the 20 weights rounded to bf16 by the
// caller, then the bf16 operand copies w_up2^T (U0, U2p), w_up4^T (U2,
// ldn), wc_t (2D, Dp) and wx0_t[D:] (D, D15p), rows padded with zeros to
// U2p, ldn, Dp, D15p: U2, N, D, D15 rounded up to 8 (ldn = N rounded up to
// 8 in this mode).  The scratch, of B*T*((U0*2D + U2*2D + 2D*ldn + K*D*ldn)
// / 2 + N*D15) floats, K = dims[10], holds the bf16 tables u0, u2 and u4^T,
// the float32 g, then (K = 1) emb^T of every (scene, step).  Shapes past D
// = 128, D15 = 192 return cudaErrorInvalidValue.
int lsdm_denoise_chain_tables_bf16(const float* e2, const float* const* w,
                                   float* scratch, const int* dims,
                                   void* stream) {
  return chain_tables_entry(e2, w, scratch, dims, stream, true);
}

}  // extern "C"

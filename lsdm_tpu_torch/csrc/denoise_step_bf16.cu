// One denoise step (K9) in the bf16 mode, on the bf16 tensor cores.
//
// Replaces, at compute_dtype=bfloat16, lsdm_tpu/ops/denoise_pallas.py:
// fused_denoise_step, whose dot() rounds both operands to bf16 and sums in
// float32 (:136-141).  Plain version: lsdm_tpu_torch/ops/denoise.py:
// denoise_step_plain(..., compute_dtype=torch.bfloat16).  The float32 mode
// is denoise_step.cu.  For every scene b and point row, each product on
// operands rounded to bf16 and summed in float32:
//   u0  = gelu(w_up0 (x) e2_b + b_up0)               (128, 2D), rounded
//   u2  = gelu(w_up2 @ u0 + b_up2)                   (512, 2D), rounded
//   u4  = gelu(w_up4[row] @ u2 + b_up4[row])         2D
//   emb = gelu(u4 @ wc_t + bc)                       D
//   p   = sigmoid(sigmoid(bf16(x + cond_pcd) wp0 + bp0) wp2 + bp2)   D
//   h   = sigmoid(sigmoid(concat(p, emb) wx0 + bx0) wx2 + bx2)       D
//   x0  = gelu(gelu(h wo0 + bo0) wo2 + bo2), clipped if asked        3
//   out = (c1 x0 + c2 x) + c3 noise                  float32
// Each layer's output is rounded to bf16 where the next product reads it;
// the biases, the activations, x0 and the update stay float32.
//
// What bounds it.  A step is ~0.55 GFLOP of products at b1 (N = 1024, D =
// 128), 0.56 us on the 989 TFLOP/s of the bf16 tensor cores, and its
// inputs ~1.5 MB, 0.44 us of HBM: neither bounds it.  On an H100 the tile
// launch at b1 (64 blocks of 16 rows) takes ~22 us, and its warps wait
// neither on the ring nor at its barriers (0.1 us a layer, stamped by a
// -DLSDM_STEP_STAMPS build): a block's time is a ~2.4 us prologue, then
// each warp's own chain over 24 ring chunks and eight dependent layers,
// the chunk's copies issued, the ldmatrix / mma.sync chain and each
// layer's activation epilogue.  The ~0.5 MB each block streams from L2
// (the tail's bf16 weights and its scene's u2^T) is hidden only because
// each chunk is contiguous: read as 128-byte pieces at a 1 KB stride it
// took ~9 us more (PERF.md §6, K9 bf16's redesign).
//
// A call is two launches (C entries at the end), so that the step graph
// (ops/denoise.py: DenoiseStepGraph) runs step t + 1's u2 on its second
// stream beside step t's tiles:
//
//   1. u2_bf16_kernel: u2^T (2D rows, 512 k-contiguous columns, bf16) of
//      every scene, the layout the tile kernel's B operand reads.  A block
//      of 16 warps owns 32 rows (u0 columns) and 128 columns (w_up2 rows);
//      it computes its u0^T rows into shared memory (an outer product:
//      cheaper to recompute than to read) and its w_up2 rows arrive by
//      cp.async from the bf16 copy; each warp a 16 x 16 tile, K = 128 on
//      mma.sync.  Rows past 2D are written as zeros.  A block is latency-
//      bound by its GELUs: 16 warps in place of 4 took it from 8.6 to 5.7
//      us at b1 and from 11.2 to 8.8 at b8, the same bits.
//   2. step_bf16_tile_kernel<MT>: one block per tile of 16 MT point rows
//      (MT = 1, 2 or 4, ops/denoise.py: step_bf16_plan), of 8 warps, or 16
//      (two along the rows) for 32 and 64 rows: 8 warps on 64 rows were
//      latency-bound (0.049 against 0.037 ms at b8).  The tile's
//      activations stay in shared memory as bf16 rows; every layer's
//      weights (and u4's B, the scene's u2^T, and its A, the tile's w_up4
//      rows) stream through one cp.async ring of k chunks of 64 that runs
//      on across the eight layers, so the next layer's first chunks are in
//      flight during a layer's epilogue.  Each chunk is contiguous in
//      device memory (the operands are stored chunk by chunk with rows
//      padded as the stage holds them): read as strided rows the same
//      bytes took 0.031 against 0.022 ms at b1.  At a chunk each warp
//      computes its eighth of the layer's n8 tiles for its m16 tiles (A by
//      ldmatrix from the activation rows, B from the chunk), and after the
//      layer's last chunk applies the bias and the activation and stores
//      its bf16 outputs as the next layer's A; one block barrier a chunk
//      orders it all.  The last layer's one n8 tile is computed by warp m
//      for m tile m, which also applies the update.
//
// Why a ring and not a cluster holding the weights (denoise_step.cu's
// design): the tail's bf16 weights (~243 KB) do not fit one block, and
// split over a cluster every layer would need a DSMEM exchange and a
// cluster barrier, which the float32 design measured at ~2 us a layer
// (PERF.md §6, K9's float32 redesign); a ring costs only L2 bytes, which one tile of 16
// MT rows reads once for all its rows, and no barrier beyond its block's.
// The cluster design was not built.  Of the rings measured, TMA bulk
// copies on mbarriers in place of cp.async, and a ring shallower by one
// stage, read the same.
//
// Every width is compiled at the caps of the bf16 mode (U0 128, U2 512,
// 2D 256, D 128, DH 64, D15 192, DH2 64); a narrower model runs the same
// code on weights, biases and u2^T padded with zeros (ops/denoise.py:
// Bf16StepOperands), which add nothing to its outputs.  Rows of every
// shared-memory buffer are an odd number of 16-byte chunks, so the eight
// rows an ldmatrix reads fall in eight bank groups.  The sigmoid keeps
// denoise::sigmoid's IEEE quotient by the branch-free reciprocal (recip),
// and the coefficients are read on the device.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "denoise_mma.cuh"
#include "denoise_rows.cuh"

namespace {

using namespace denoise;
using bf16 = __nv_bfloat16;

// the compiled widths (caps)
constexpr int kU0 = 128, kU2 = 512, kD2 = 256, kD = 128, kDH = 64, kD15 = 192,
              kDH2 = 64;

// The tile kernel reads every product's B operand (and u4's A) in chunks of
// 64 k: (n, 64) bf16 rows padded to 72 (nine 16-byte pieces, an odd
// number), each chunk contiguous, so a chunk is one run of bytes from L2
// into its ring stage.
constexpr int kChunk = 64;
constexpr int kCld = kChunk + 8;

// ------------------------------------------------------------------ u2
constexpr int kU2Rows = 32;   // u2^T rows (u0 columns j) a block
constexpr int kU2Cols = 128;  // u2^T columns (w_up2 rows i) a block
constexpr int kU2Threads = 512;
constexpr int kU2NJ = kU2Cols / 8 / (kU2Threads / 64);  // n8 tiles a warp
static_assert(kU2NJ % 2 == 0, "n8 tiles in pairs");
constexpr int kU0ld = kU0 + 8;  // a row of 128 k padded to 17 chunks

// u2t[b] = gelu(u0_b^T @ w_up2^T + b_up2) rounded, (kD2, kU2) in chunks of
// 64 columns ((kU2 / 64, kD2, kCld), the pad columns not written), u0_b^T[j][k]
// = bf16(gelu(w_up0[k] e2_b[j] + b_up0[k])); w2 the bf16 copy of w_up2 (kU2,
// kU0), b_up2 padded to kU2.  Block (x, y, b): columns 128 x.., rows
// 32 y..; warp w rows 16 (w & 1).., columns 8 kU2NJ (w >> 1)...
__global__ void __launch_bounds__(kU2Threads)
u2_bf16_kernel(const float* __restrict__ e2, const float* __restrict__ w_up0,
               const float* __restrict__ b_up0, const bf16* __restrict__ w2,
               const float* __restrict__ b_up2, int d2, int u0, bf16* __restrict__ u2t) {
  __shared__ __align__(16) bf16 us[kU2Rows * kU0ld];
  __shared__ __align__(16) bf16 ws[kU2Cols * kU0ld];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int i0 = blockIdx.x * kU2Cols, j0 = blockIdx.y * kU2Rows, b = blockIdx.z;
  for (int e = tid; e < kU2Cols * (kU0 / 8); e += kU2Threads) {
    const int r = e >> 4, q = e & 15;
    copy16(ws + r * kU0ld + 8 * q, w2 + (size_t)(i0 + r) * kU0 + 8 * q, true);
  }
  copy_commit();
  // u0^T: a thread's pairs of k, as torch rounds it (the product, then the sum)
  for (int e = tid; e < kU2Rows * (kU0 / 2); e += kU2Threads) {
    const int jj = e / (kU0 / 2), k = 2 * (e - jj * (kU0 / 2)), j = j0 + jj;
    const float ej = j < d2 ? e2[(size_t)b * d2 + j] : 0.0f;
    float v[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      v[h] = j < d2 && k + h < u0
                 ? gelu(__fadd_rn(__fmul_rn(w_up0[k + h], ej), b_up0[k + h]))
                 : 0.0f;
    *reinterpret_cast<uint32_t*>(us + jj * kU0ld + k) = pack(v[0], v[1]);
  }
  copy_wait<0>();
  __syncthreads();

  const int wm = warp & 1, wn = warp >> 1;
  float c[kU2NJ][4];
#pragma unroll
  for (int j = 0; j < kU2NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.0f;
  const uint32_t abase = smem_u32(us) + 2 * ((16 * wm + (lane & 15)) * kU0ld + ((lane >> 4) << 3));
  const uint32_t bbase = smem_u32(ws) + 2 * ((8 * kU2NJ * wn + (lane & 7) + ((lane >> 4) << 3)) * kU0ld +
                                             (((lane >> 3) & 1) << 3));
#pragma unroll
  for (int ks = 0; ks < kU0 / 16; ++ks) {
    uint32_t a[4];
    ldsm_x4(a, abase + 32 * ks);
#pragma unroll
    for (int j = 0; j < kU2NJ; j += 2) {
      uint32_t bf[4];
      ldsm_x4(bf, bbase + 2 * (8 * j * kU0ld) + 32 * ks);
      mma(c[j], a, bf[0], bf[1]);
      mma(c[j + 1], a, bf[2], bf[3]);
    }
  }
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < kU2NJ; ++j) {
    const int i = i0 + 8 * kU2NJ * wn + 8 * j + 2 * t;
    const float b0 = b_up2[i], b1 = b_up2[i + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = j0 + 16 * wm + g + 8 * h;
      const uint32_t v = row < d2 ? pack(gelu(c[j][2 * h] + b0), gelu(c[j][2 * h + 1] + b1)) : 0u;
      *reinterpret_cast<uint32_t*>(
          u2t + (((size_t)b * (kU2 / kChunk) + (i >> 6)) * kD2 + row) * kCld + (i & 63)) = v;
    }
  }
}

// ------------------------------------------------------------- the row tiles
// A build with -DLSDM_STEP_STAMPS (profile_kernels.py --step_stamps) records,
// for each block of the tile kernel (up to kStampBlocks), thread 0's
// %globaltimer at its start and its end, and its clock64 at its start,
// after its prologue and after each layer, with the cycles it spent in
// each layer waiting for its own cp.async copies and at the block barrier;
// slots: 0 and 1 the start and the end (ns), 2 the SM, 3 the start, 4 the
// prologue's end, 5 + l layer l's end (cycles), 13 + l its copy waits and
// 21 + l its barrier waits (cycles).  Without it the hooks compile to
// nothing.
#ifdef LSDM_STEP_STAMPS
constexpr int kStampBlocks = 4096, kStampSlots = 32;
__device__ unsigned long long g_step_stamps[kStampBlocks * kStampSlots];
__device__ __forceinline__ unsigned long long* stamp_row() {
  const unsigned blk = blockIdx.y * gridDim.x + blockIdx.x;
  return threadIdx.x == 0 && blk < kStampBlocks ? g_step_stamps + blk * kStampSlots : nullptr;
}
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void stamp_start() {
  if (unsigned long long* s = stamp_row()) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    s[0] = global_ns(), s[2] = sm, s[3] = clock64();
  }
}
__device__ __forceinline__ void stamp_prologue() {
  if (unsigned long long* s = stamp_row()) s[4] = clock64();
}
__device__ __forceinline__ void stamp_layer(int l, long long copy, long long bar) {
  if (unsigned long long* s = stamp_row()) {
    s[5 + l] = clock64(), s[13 + l] = copy, s[21 + l] = bar;
    if (l == 7) s[1] = global_ns();
  }
}
#define STAMP_WAITS long long stamp_t = clock64(), stamp_copy = 0, stamp_bar = 0
#define STAMP_MARK stamp_t = clock64()
#define STAMP_ADD(sum)                         \
  do {                                         \
    const long long stamp_u = clock64();       \
    sum += stamp_u - stamp_t, stamp_t = stamp_u; \
  } while (0)
#define STAMP_START stamp_start()
#define STAMP_PROLOGUE stamp_prologue()
#define STAMP_LAYER(l) stamp_layer(l, stamp_copy, stamp_bar)
#else
#define STAMP_WAITS do {} while (0)
#define STAMP_MARK do {} while (0)
#define STAMP_ADD(sum) do {} while (0)
#define STAMP_START do {} while (0)
#define STAMP_PROLOGUE do {} while (0)
#define STAMP_LAYER(l) do {} while (0)
#endif

// A block's warps: kWarps along the columns of every layer, times wm_of(MT)
// along its rows (the MT m16 tiles split between them).
constexpr int kWarps = 8;
__host__ __device__ constexpr int wm_of(int mt) { return mt == 1 ? 1 : 2; }
__host__ __device__ constexpr int threads_of(int mt) { return 32 * kWarps * wm_of(mt); }
constexpr int kLayers = 8;
constexpr int kXld = kD2 + 8;     // an activation row: 33 chunks
constexpr int kPld = kDH + 8;     // p1's row: 9 chunks

// The layers in ring order: 0 u4, 1 emb, 2 p1, 3 p2, 4 h1, 5 h2, 6 h3, 7 x0;
// layer l writes n_of(l) outputs from k_of(l) inputs.
__host__ __device__ constexpr int n_of(int l) {
  return l == 0 ? kD2 : l == 1 ? kD : l == 2 ? kDH : l == 3 ? kD : l == 4 ? kD15
         : l == 5 ? kD : l == 6 ? kDH2 : 8;
}
__host__ __device__ constexpr int k_of(int l) {
  return l == 0 ? kU2 : l == 1 ? kD2 : l == 2 ? 16 : l == 3 ? kDH : l == 4 ? 2 * kD
         : l == 5 ? kD15 : l == 6 ? kD : kDH2;
}
__host__ __device__ constexpr int chunks_of(int l) { return (k_of(l) + kChunk - 1) / kChunk; }
// offsets of the column biases in the packed bias vector past b_up2: bc,
// bp0, bp2, bx0, bx2, bo0, bo2 (layers 1-7)
__host__ __device__ constexpr int bias_of(int l) {
  return l <= 1 ? 0 : bias_of(l - 1) + n_of(l - 1);
}
constexpr int kBiasCols = bias_of(kLayers);  // 712
template <int L>
constexpr int kBiasAt = bias_of(L);

// Shared memory of a tile of R = 16 MT rows: the ring's stages (bf16: a B
// chunk of up to 256 rows, then u4's A chunk of R rows), then X (u4, h1,
// h3), Y (p2 | emb, h2) and P (p1) (bf16), then the column and row biases
// (float32).  The ring takes as many stages as the rest leaves room for
// (5, 4 and 3 at MT 1, 2 and 4); one stage fewer read the same on an H100.
constexpr size_t kSmemMax = 232448;
__host__ __device__ constexpr int stage_elems(int mt) { return (kD2 + 16 * mt) * kCld; }
__host__ __device__ constexpr size_t fixed_smem(int mt) {
  return 2 * (size_t)(16 * mt * (2 * kXld + kPld)) + 4 * (size_t)(kBiasCols + 16 * mt);
}
__host__ __device__ constexpr int stages_of(int mt) {
  return (int)((kSmemMax - fixed_smem(mt)) / (2 * (size_t)stage_elems(mt)));
}
__host__ __device__ constexpr size_t tile_smem(int mt) {
  return 2 * (size_t)stages_of(mt) * stage_elems(mt) + fixed_smem(mt);
}
static_assert(stages_of(1) == 5 && stages_of(2) == 4 && stages_of(4) == 3,
              "the ring's depth at each tile size");
static_assert(stage_elems(1) % 8 == 0 && kXld % 16 == 8 && kCld % 16 == 8 && kPld % 16 == 8,
              "16-byte rows of an odd number of chunks");

struct TileArgs {
  const float *x, *noise, *cpcd, *coef;
  const bf16* u2t;      // (B, kU2 / 64, kD2, kCld) from u2_bf16_kernel
  const bf16* w4;       // w_up4 as bf16 (kU2 / 64, npad, kCld)
  const float* b_up4;   // (N)
  const float* bias;    // the packed biases: b_up2 (kU2), then kBiasCols
  const bf16* w[kLayers];  // layers 1-7: (chunks_of(l), n_of(l), kCld) bf16
  float* out;
  int n, npad, clip;  // npad: N rounded up to 64, w4's rows
};

// The ring: the tile's chunks (24) in order, chunk g in stage g % kStages
// (stages_of(MT)).  Each thread fills its share of the next chunk: layer
// l's chunk c, its n_of(l) weight rows of k [64 c, 64 c + 64), and for u4
// the tile's rows of w_up4 (zeros past n in the copy), each a contiguous
// run of 16-byte pieces.
template <int MT>
struct Ring {
  static constexpr int kStages = stages_of(MT);
  bf16* base;
  const TileArgs& a;
  int r0, b;
  int l = 0, c = 0, next = 0;  // the chunk filled next: layer l's c-th, the tile's next-th

  __device__ __forceinline__ bf16* stage(int g) const {
    return base + (g % kStages) * stage_elems(MT);
  }
  __device__ __forceinline__ const bf16* weights() const {
    return l == 0 ? a.u2t + (size_t)b * kD2 * kU2 / kChunk * kCld : l == 1 ? a.w[1]
           : l == 2 ? a.w[2] : l == 3 ? a.w[3] : l == 4 ? a.w[4] : l == 5 ? a.w[5]
           : l == 6 ? a.w[6] : a.w[7];
  }
  __device__ __forceinline__ void fill() {
    if (l >= kLayers) return;
    const bf16* src = weights() + (size_t)c * n_of(l) * kCld;
    bf16* dst = stage(next);
    for (int e = threadIdx.x; e < n_of(l) * kCld / 8; e += threads_of(MT))
      copy16(dst + 8 * e, src + 8 * e, true);
    if (l == 0) {
      src = a.w4 + ((size_t)c * a.npad + r0) * kCld;
      dst += kD2 * kCld;
      for (int e = threadIdx.x; e < 16 * MT * kCld / 8; e += threads_of(MT))
        copy16(dst + 8 * e, src + 8 * e, true);
    }
    ++next;
    if (++c == chunks_of(l)) ++l, c = 0;
  }
};

// c[m][j] += A @ W^T over one chunk: A the MT m16 tiles' rows (lane's
// address `a` at the chunk's k, rows `lda` bf16 apart), W this warp's NJ
// n8 tiles in the stage (lane's address `w`); KS k16 steps.  One
// ldmatrix.x4 feeds two n tiles (lanes 0-15 address tile j's rows at k and
// k + 8, lanes 16-31 tile j + 1's).
template <int MT, int NJ, int KS>
__device__ __forceinline__ void mma_chunk(float (&c)[MT][NJ][4], uint32_t a, int lda,
                                          uint32_t w) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t af[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) ldsm_x4(af[m], a + 2 * (16 * m * lda) + 32 * ks);
#pragma unroll
    for (int j = 0; j + 1 < NJ; j += 2) {
      uint32_t bf[4];
      ldsm_x4(bf, w + 2 * (8 * j * kCld) + 32 * ks);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        mma(c[m][j], af[m], bf[0], bf[1]);
        mma(c[m][j + 1], af[m], bf[2], bf[3]);
      }
    }
    if (NJ & 1) {
      uint32_t b0, b1;
      ldsm_x2(b0, b1, w + 2 * (8 * (NJ - 1) * kCld) + 32 * ks);
#pragma unroll
      for (int m = 0; m < MT; ++m) mma(c[m][NJ - 1], af[m], b0, b1);
    }
  }
}

enum { kGelu = 0, kSigmoid = 1 };

// act(c + bias) rounded to bf16 into out (rows `ldo` bf16 apart) at this
// warp's columns n0 + 8 j: bias per column (bias[n]) or, kRowBias, per row
// (bias[row]).  The sigmoid takes the branch-free reciprocal; where a lane
// meets 1 + exp(-y) >= 2^126 the warp stores denoise::sigmoid instead.
template <int MT, int NJ, int kAct, bool kRowBias>
__device__ __forceinline__ void store_layer(const float (&c)[MT][NJ][4], const float* bias,
                                            bf16* out, int ldo, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  bool slow = false;
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = n0 + 8 * j + 2 * t;
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float y = c[m][j][e] + (kRowBias ? bias[16 * m + g + 8 * (e >> 1)]
                                                 : bias[n + (e & 1)]);
          if (kAct == kGelu) {
            v[e] = gelu(y);
          } else if (pass == 0) {
            const float d = 1.0f + expf(-y);
            slow |= !(d < 0x1p126f);
            v[e] = recip(d);
          } else {
            v[e] = sigmoid(y);
          }
        }
        bf16* o = out + (16 * m + g) * ldo + n;
        *reinterpret_cast<uint32_t*>(o) = pack(v[0], v[1]);
        *reinterpret_cast<uint32_t*>(o + 8 * ldo) = pack(v[2], v[3]);
      }
    if (kAct == kGelu || !__any_sync(0xffffffffu, slow)) break;
  }
}

// One layer l of NJ n8 tiles a warp (for its MT / wm_of(MT) m16 tiles):
// its chunks from the ring (g counts them), A from `in` (rows `lda` apart;
// for u4 the stage's w_up4 rows), then its epilogue into `out`.
template <int MT, int NJ, int kAct, bool kRowBias, int L>
__device__ __forceinline__ void run_layer(Ring<MT>& ring, int& g, const bf16* in, int lda,
                                          const float* bias, bf16* out, int ldo) {
  constexpr int KS = (k_of(L) < kChunk ? k_of(L) : kChunk) / 16, kStages = stages_of(MT);
  constexpr int MW = MT / wm_of(MT);  // this warp's m16 tiles
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j0 = (warp % kWarps) * NJ, m0 = (warp / kWarps) * MW;
  float c[MW][NJ][4];
#pragma unroll
  for (int m = 0; m < MW; ++m)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[m][j][e] = 0.0f;
  const uint32_t a_lane = 2 * ((16 * m0 + (lane & 15)) * lda + ((lane >> 4) << 3));
  const uint32_t w_lane = 2 * ((8 * j0 + (lane & 7) + ((lane >> 4) << 3)) * kCld +
                               (((lane >> 3) & 1) << 3));
  STAMP_WAITS;
  for (int ch = 0; ch < chunks_of(L); ++ch, ++g) {
    STAMP_MARK;
    copy_wait<kStages - 2>();  // this thread's copies of chunk g landed
    STAMP_ADD(stamp_copy);
    __syncthreads();           // everyone's; chunk g - 1's stage is free
    STAMP_ADD(stamp_bar);
    ring.fill();      // chunk g + kStages - 1
    copy_commit();    // an empty group past the end keeps the count
    const bf16* st = ring.stage(g);
    const uint32_t a = L == 0 ? smem_u32(st + kD2 * kCld) + a_lane
                              : smem_u32(in + ch * kChunk) + a_lane;
    mma_chunk<MW, NJ, KS>(c, a, lda, smem_u32(st) + w_lane);
  }
  store_layer<MW, NJ, kAct, kRowBias>(c, kRowBias ? bias + 16 * m0 : bias,
                                      out + 16 * m0 * ldo, ldo, 8 * j0);
  STAMP_LAYER(L);
}

// The step for tile blockIdx.x (16 MT rows from 16 MT blockIdx.x) of scene
// blockIdx.y.
template <int MT>
__global__ void __launch_bounds__(threads_of(MT), 1) step_bf16_tile_kernel(const TileArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int R = 16 * MT, kStages = stages_of(MT), kThreads = threads_of(MT);
  constexpr int MW = MT / wm_of(MT);
  bf16* ring_base = reinterpret_cast<bf16*>(smem);
  bf16* X = ring_base + kStages * stage_elems(MT);
  bf16* Y = X + R * kXld;
  bf16* P = Y + R * kXld;
  float* bias = reinterpret_cast<float*>(P + R * kPld);  // kBiasCols, then R rows
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t = lane & 3;
  const int b = blockIdx.y, r0 = blockIdx.x * R;
  Ring<MT> ring{ring_base, a, r0, b};
  STAMP_START;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    ring.fill();
    copy_commit();
  }
  for (int e = tid; e < kBiasCols; e += kThreads) bias[e] = __ldg(a.bias + kU2 + e);
  for (int e = tid; e < R; e += kThreads)
    bias[kBiasCols + e] = r0 + e < a.n ? __ldg(a.b_up4 + r0 + e) : 0.0f;
  STAMP_PROLOGUE;
  // The sample's lanes: t < 2 holds columns 2t, 2t + 1 (< 3) of rows g8 and
  // g8 + 8 of m tile `mine`, as [row g8: 2t, 2t + 1, row g8 + 8: ...], the
  // accumulator layout of the last layer's tile (warps < MT) and of p1's A
  // fragment (every warp, for every m tile).
  auto row = [&](int m, int e) { return r0 + 16 * m + g8 + 8 * (e >> 1); };
  auto live = [&](int m, int e) { return t < 2 && 2 * t + (e & 1) < 3 && row(m, e) < a.n; };
  auto at = [&](int m, int e) { return ((size_t)b * a.n + row(m, e)) * 3 + 2 * t + (e & 1); };

  int g = 0;
  run_layer<MT, n_of(0) / 8 / kWarps, kGelu, true, 0>(ring, g, nullptr, kCld,
                                                       bias + kBiasCols, X, kXld);
  run_layer<MT, n_of(1) / 8 / kWarps, kGelu, false, 1>(ring, g, X, kXld, bias + kBiasAt<1>,
                                                        Y + kD, kXld);
  {  // p1 = sigmoid(bf16(x + cond_pcd) @ wp0 + bp0): A (k 0-2 of 16) from registers
    const int m0 = (warp / kWarps) * MW, wn = warp % kWarps;
    uint32_t af[MW][4];
#pragma unroll
    for (int m = 0; m < MW; ++m) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = live(m0 + m, e) ? __ldg(a.x + at(m0 + m, e)) + __ldg(a.cpcd + at(m0 + m, e))
                               : 0.0f;
      af[m][0] = pack(v[0], v[1]);
      af[m][1] = pack(v[2], v[3]);
      af[m][2] = af[m][3] = 0u;
    }
    constexpr int NJ = n_of(2) / 8 / kWarps;
    float c[MW][NJ][4] = {};
    STAMP_WAITS;
    copy_wait<kStages - 2>();
    STAMP_ADD(stamp_copy);
    __syncthreads();
    STAMP_ADD(stamp_bar);
    ring.fill();
    copy_commit();
    const uint32_t w = smem_u32(ring.stage(g)) +
                       2 * ((8 * wn * NJ + (lane & 7)) * kCld + (((lane >> 3) & 1) << 3));
    ++g;
    uint32_t b0, b1;
    ldsm_x2(b0, b1, w);
#pragma unroll
    for (int m = 0; m < MW; ++m) mma(c[m][0], af[m], b0, b1);
    store_layer<MW, NJ, kSigmoid, false>(c, bias + kBiasAt<2>, P + 16 * m0 * kPld, kPld,
                                         8 * wn * NJ);
    STAMP_LAYER(2);
  }
  run_layer<MT, n_of(3) / 8 / kWarps, kSigmoid, false, 3>(ring, g, P, kPld, bias + kBiasAt<3>,
                                                           Y, kXld);
  run_layer<MT, n_of(4) / 8 / kWarps, kSigmoid, false, 4>(ring, g, Y, kXld, bias + kBiasAt<4>,
                                                           X, kXld);
  run_layer<MT, n_of(5) / 8 / kWarps, kSigmoid, false, 5>(ring, g, X, kXld, bias + kBiasAt<5>,
                                                           Y, kXld);
  run_layer<MT, n_of(6) / 8 / kWarps, kGelu, false, 6>(ring, g, Y, kXld, bias + kBiasAt<6>,
                                                        X, kXld);
  // x0 = gelu(h3 @ wo2 + bo2): warp m < MT takes m tile m, then the update
  STAMP_WAITS;
  copy_wait<kStages - 2>();
  STAMP_ADD(stamp_copy);
  __syncthreads();
  STAMP_ADD(stamp_bar);
  if (warp >= MT) return;
  const int m = warp;
  float c[1][1][4] = {};
  mma_chunk<1, 1, kDH2 / 16>(
      c, smem_u32(X) + 2 * ((16 * m + (lane & 15)) * kXld + ((lane >> 4) << 3)), kXld,
      smem_u32(ring.stage(g)) + 2 * ((lane & 7) * kCld + (((lane >> 3) & 1) << 3)));
  const float* bo2 = bias + kBiasAt<7>;
  const float c1 = __ldg(a.coef), c2 = __ldg(a.coef + 1), c3 = __ldg(a.coef + 2);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (!live(m, e)) continue;
    float x0 = gelu(c[0][0][e] + bo2[2 * t + (e & 1)]);
    if (a.clip) x0 = fminf(fmaxf(x0, -1.0f), 1.0f);
    a.out[at(m, e)] = (c1 * x0 + c2 * __ldg(a.x + at(m, e))) + c3 * __ldg(a.noise + at(m, e));
  }
  STAMP_LAYER(7);
}

template <int MT>
const void* tile_kernel() {
  return (const void*)step_bf16_tile_kernel<MT>;
}
const void* tile_kernel_of(int mt) {
  return mt == 1 ? tile_kernel<1>() : mt == 2 ? tile_kernel<2>() : mt == 4 ? tile_kernel<4>()
                                                                           : nullptr;
}

struct StepDims {
  int B, N, D2, U0, U2, D, DH, D15, DH2;
};

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// dims within the caps; the bf16 weights (w[2], w[3], w[6..12]) and
// buffers on 16 bytes
bool dims_ok(const StepDims& d, const void* const* w) {
  bool ok = d.B > 0 && d.B <= 65535 && d.N > 0 && d.D2 == 2 * d.D && d.D > 0 &&
            d.D <= kD && d.U0 > 0 && d.U0 <= kU0 && d.U2 > 0 && d.U2 <= kU2 && d.DH > 0 &&
            d.DH <= kDH && d.D15 > 0 && d.D15 <= kD15 && d.DH2 > 0 && d.DH2 <= kDH2;
  ok = ok && aligned16(w[2]) && aligned16(w[3]);
  for (int i = 6; i < 13; ++i) ok = ok && aligned16(w[i]);
  return ok;
}

}  // namespace

extern "C" {

// K9's two launches in the bf16 mode, in this order, on one stream or,
// with an event between them, on two (ops/denoise.py: BoundStep).  Shapes:
// e2 (B, 2D); x, noise, cpcd, out (B, N, 3); coef (3,) on the device;
// scratch: u2^T, B * 8 * 256 * 72 bf16; w: 13 pointers, w_up0 (U0), b_up0
// (U0) float32, then the operands of ops/denoise.py: Bf16StepOperands:
// w_up2 (512, 128) bf16, w_up4 (8, N up to 64, 72) bf16, b_up4 (N)
// float32, the packed biases (b_up2 512, bc 128, bp0 64, bp2 128, bx0 192,
// bx2 128, bo0 64, bo2 8; float32), then wc, wp0, wp2, wx0, wx2, wo0, wo2
// as bf16 (out, k) rows of (128, 256), (64, 16), (128, 64), (192, 256),
// (128, 192), (64, 128), (8, 64) in chunks of 64 k, (k / 64 rounded up,
// out, 72), each zero-padded (wx0's pose half at k 0.., its emb half at k
// 128..); dims = {B, N, 2D, U0, U2, D, DH, D15, DH2}; mt: m16 tiles a block
// of the tile launch (1, 2 or 4, ops/denoise.py: step_bf16_plan).  Each
// returns cudaErrorInvalidValue for shapes past the caps (D 128, U0 128, U2
// 512, DH 64, D15 192, DH2 64), 2D != 2 D, B > 65535, another mt, or a bf16
// operand not on 16 bytes.
int lsdm_denoise_step_bf16_u2(const float* e2, const void* const* w, void* scratch,
                              const int* dims, void* stream) {
  const StepDims d{dims[0], dims[1], dims[2], dims[3], dims[4],
                   dims[5], dims[6], dims[7], dims[8]};
  if (!dims_ok(d, w) || !aligned16(scratch)) return (int)cudaErrorInvalidValue;
  const dim3 grid(kU2 / kU2Cols, kD2 / kU2Rows, d.B);
  u2_bf16_kernel<<<grid, kU2Threads, 0, (cudaStream_t)stream>>>(
      e2, (const float*)w[0], (const float*)w[1], (const bf16*)w[2], (const float*)w[5],
      d.D2, d.U0, (bf16*)scratch);
  return (int)cudaGetLastError();
}

int lsdm_denoise_step_bf16_tiles(const float* x, const float* noise, const float* cpcd,
                                 const float* coef, const void* const* w, float* out,
                                 const void* scratch, const int* dims, int mt, int clip,
                                 void* stream) {
  const StepDims d{dims[0], dims[1], dims[2], dims[3], dims[4],
                   dims[5], dims[6], dims[7], dims[8]};
  const void* kernel = tile_kernel_of(mt);
  if (!dims_ok(d, w) || !aligned16(scratch) || !kernel) return (int)cudaErrorInvalidValue;
  const int tiles = (d.N + 16 * mt - 1) / (16 * mt);
  const size_t smem = tile_smem(mt);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  TileArgs a{};
  a.x = x, a.noise = noise, a.cpcd = cpcd, a.coef = coef;
  a.u2t = (const bf16*)scratch;
  a.w4 = (const bf16*)w[3];
  a.npad = (d.N + 63) / 64 * 64;
  a.b_up4 = (const float*)w[4];
  a.bias = (const float*)w[5];
  for (int l = 1; l < kLayers; ++l) a.w[l] = (const bf16*)w[5 + l];
  a.out = out;
  a.n = d.N, a.clip = clip;
  const dim3 grid(tiles, d.B);
  cudaStream_t st = (cudaStream_t)stream;
  if (mt == 1)
    step_bf16_tile_kernel<1><<<grid, threads_of(1), smem, st>>>(a);
  else if (mt == 2)
    step_bf16_tile_kernel<2><<<grid, threads_of(2), smem, st>>>(a);
  else
    step_bf16_tile_kernel<4><<<grid, threads_of(4), smem, st>>>(a);
  return (int)cudaGetLastError();
}

// Blocks of the tile kernel of `mt` m16 tiles the current device runs at
// once (its occupancy an SM times the SMs), or a negative CUDA error.
int lsdm_denoise_step_bf16_max_blocks(int mt) {
  const void* kernel = tile_kernel_of(mt);
  if (!kernel) return -(int)cudaErrorInvalidValue;
  const size_t smem = tile_smem(mt);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int per_sm = 0, dev = 0, sms = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads_of(mt), smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return err != cudaSuccess ? -(int)err : per_sm * sms;
}

#ifdef LSDM_STEP_STAMPS
// The stamps of the last tile launch's first `n` blocks (kStampSlots each)
// into `host`.
int lsdm_denoise_step_bf16_stamps(unsigned long long* host, int n) {
  if (n < 0 || n > kStampBlocks) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyFromSymbol(host, g_step_stamps,
                                   (size_t)n * kStampSlots * sizeof(unsigned long long));
}
#endif

// 1 if func is the u2 kernel, 2 if it is a tile kernel, else 0: how
// lsdm_graph_kernel_nodes (denoise_step.cu) counts K9 bf16's graph nodes.
int lsdm_denoise_step_bf16_kind(const void* func) {
  if (func == (const void*)u2_bf16_kernel) return 1;
  return func == tile_kernel_of(1) || func == tile_kernel_of(2) || func == tile_kernel_of(4)
             ? 2 : 0;
}

}  // extern "C"

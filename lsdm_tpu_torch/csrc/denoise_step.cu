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
// batch 1.  Only u2 is shared by all the rows of a scene; every row of u4,
// and from there of emb and of the rest, depends on its own row of w_up4.
// So a call is two launches (the C entries at the end):
//
//   1. step_u2_kernel: u2 of every scene, one block per (32 x 32 tile of
//      u2, scene), 128 blocks a scene; each block recomputes the u0
//      columns it needs (u0 is an outer product: cheaper to recompute than
//      to read).  33.5 MFLOP a scene.
//   2. step_tile_kernel: a cluster of `cluster` blocks (1 to 8) per
//      tile of kTileRows = 32 point rows of a scene.  The tile's
//      activations stay in shared memory, k-major ([channel][row]); each
//      block of the cluster computes a slice of every layer's output
//      columns (col_slice) for all 32 rows and stores it into the next
//      buffer of every block of the cluster (distributed shared memory),
//      and one cluster barrier ends each layer.  So every weight a block
//      fetches serves 32 rows (the design before this one fetched each
//      weight from L2 by one load for 8 rows), and a scene's u2 is read
//      from L2 once a cluster: at batch 1 the 32 clusters read 16 MB of u2
//      a step, where 128 blocks of 8 rows read 64 MB.
//
// The step sampler's CUDA graph (ops/denoise.py:DenoiseStepGraph) runs
// each step's u2 launch on a second stream into one of two scratch
// buffers, beside the tile launch of the step before, on the SMs the tile
// grid leaves free (36 at b1); programmatic dependent launch of the tile
// kernel after u2 on one stream measured 1-2% a step and is not used.
//
// Inside a block, each layer is a register-tiled FMA loop over shared
// memory: each of 512 threads owns 4 rows x 4 columns (one float4 of
// activations and one of weights a k, 16 FMAs), and where a layer's slice
// has fewer such units than the block has threads, `parts` (a power of
// two) groups of threads split its k and meet in shared memory (red),
// summed in order.  The weights stream through a ring of kRingStages k
// tiles of up to 24 KB filled by cp.async, and the ring runs on across
// layers, so the next layer's first tile is in flight during a layer's
// epilogue and barrier.  w_up4's rows of the tile come in by cp.async
// from w_up4^T (taken once when the wrapper binds the weights) at the
// start, straight into the k-major layout the u4 layer reads.  The
// x-dependent first layer (3 inputs) is computed by every block of the
// cluster alone, the last (3 outputs) by each block for its own share of
// the rows, which it also updates.
//
// About 0.555 GFLOP a step and scene at the flagship width, 0.27 of it in
// u4: the step is bound by the FP32 FMA rate (the weights, 2.7 MB, take
// ~0.8 us at HBM rate).  What holds it (PERF.md §6, from a copy of an
// earlier build that stamps %globaltimer at each phase): the FMA loops
// run at ~30% of the FMA peak, about half the rate of the same loop
// alone; the prologue takes ~5 us and each layer's epilogue and barrier
// ~2 us, which is why the first min(parts, 4) parts of a unit share its
// epilogue.  Of the variants measured, 256 threads were ~10% slower, 8 x
// 4 outputs a thread no faster, 8 x 8 (k split over a warp's phases, met
// by shuffles) slower at batch 1, three or four smaller ring stages
// slower than two, and 16-byte weight loads from L2 straight into
// registers 2.6x slower.  Every product is a hand-written FMA loop in
// true float32 (no TF32), GELU the exact erf form: no cuBLAS.  The host
// plan (ops/denoise.py:step_plan) picks the cluster size by the waves
// the card needs, from the device's occupancy of this kernel
// (lsdm_denoise_step_max_clusters; a block takes ~216 KB of shared
// memory at the flagship width, so an SM holds one, and on an H100
// clusters fit the GPCs 39 of 3, 30 of 4).  The coefficients are read from the
// device ([c1, c2, c3], a row of the sampler's (T, 3) table), so a step
// needs no host synchronisation and T steps capture into one CUDA graph.
//
// The bf16 mode (the TPU kernel at compute_dtype=bfloat16) is its own
// design on the bf16 tensor cores, denoise_step_bf16.cu.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "denoise_rows.cuh"

namespace {

namespace cg = cooperative_groups;
using denoise::gelu;
using denoise::sigmoid;

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
  const int j0 = blockIdx.x * kU2Tile;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const float* e2b = e2 + (size_t)b * d2;
  const int i0 = blockIdx.y * kU2Tile;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int k0 = 0; k0 < u0_dim; k0 += kU2K) {
    for (int e = threadIdx.x; e < kU2K * kU2Tile; e += kU2Threads) {
      const int kk = e / kU2Tile, jj = e - kk * kU2Tile;
      const int k = k0 + kk, j = j0 + jj;
      const float u0 = (k < u0_dim && j < d2)
                           ? gelu(w_up0[k] * e2b[j] + b_up0[k]) : 0.0f;
      u0s[kk][jj] = u0;
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
    if (i < u2_dim) {
      const float v = gelu(acc[q] + b_up2[i]);
      u2[((size_t)b * u2_dim + i) * d2 + j] = v;
    }
  }
}

// ------------------------------------------------------------ the row tiles
constexpr int kTileRows = 32;     // point rows a cluster carries
constexpr int kTileThreads = 512;
constexpr int kGroups = kTileRows / 4;  // float4 row groups of a tile
constexpr int kRingStages = 2;
constexpr int kStageFloats = 6144;  // one ring stage: bk x pw weights
constexpr int kMaxBk = 256;         // k rows of a ring stage at most
// columns of one pass of a layer: a unit of 4 x 4 outputs a thread
constexpr int kPassCols = 4 * (kTileThreads / kGroups);
constexpr int kMaxParts = 16;
constexpr int kRedFloats = kTileThreads * 16;  // the parts' partial sums
constexpr int kMaxJobs = 16;
constexpr int kMaxCluster = 8;
constexpr size_t kSmemMax = 232448;  // dynamic shared memory of a block

enum { kActGelu = 0, kActSigmoid = 1 };

struct StepWeights {
  const float *w_up4, *b_up4, *wc, *bc, *wp0, *bp0, *wp2, *bp2, *wx0, *bx0,
      *wx2, *bx2, *wo0, *bo0, *wo2, *bo2;
};

struct StepDims {
  int B, N, D2, U0, U2, D, DH, D15, DH2;
};

// Offsets (floats) of a tile block's shared buffers, each [channels][32]:
// wt holds the tile's w_up4 rows (U2 channels) until u4 is done, then h1
// and later h3; u4 holds u4, then h2; cat the pose features and emb.
struct TileLayout {
  int wt, u4, cat, p1, brow, ring, red, total;
  __host__ __device__ explicit TileLayout(const StepDims& d) {
    int r0 = d.U2 > d.D15 ? d.U2 : d.D15;
    r0 = r0 > d.DH2 ? r0 : d.DH2;
    const int r1 = d.D2 > d.D ? d.D2 : d.D;
    wt = 0;
    u4 = wt + r0 * kTileRows;
    cat = u4 + r1 * kTileRows;
    p1 = cat + 2 * d.D * kTileRows;
    brow = p1 + d.DH * kTileRows;
    ring = brow + kTileRows;
    red = ring + kRingStages * kStageFloats;
    total = red + kRedFloats;
  }
};

// Columns [lo, hi) of a layer of fout outputs that cluster rank `rank`
// computes: slices of ceil(fout / cluster) rounded up to 4 (16-byte weight
// copies), the last ones short or empty (ops/denoise.py:col_slice).
__host__ __device__ inline void col_slice(int fout, int cluster, int rank,
                                          int* lo, int* hi) {
  const int sl = cluster > 1 ? ((fout + cluster - 1) / cluster + 3) / 4 * 4
                             : fout;
  *lo = rank * sl < fout ? rank * sl : fout;
  *hi = *lo + sl < fout ? *lo + sl : fout;
}

// One pass of a layer over the tile: columns [n0, n1) of w (k, fout),
// activations from buffer `in` ([k][32]) into buffer `out` ([fout][32]).
struct Job {
  const float* w;
  const float* bias;  // per column; null: per row (brow)
  int k, fout, n0, n1;
  int pw;     // n1 - n0 rounded up to 4: the ring stage's row
  int bk;     // k rows of a ring stage
  int parts;  // groups of threads splitting k
  int tiles;  // ring stages the pass takes
  int in, out, act, barrier;
};

__host__ __device__ inline int job_parts(int pw) {
  const int units = kGroups * (pw / 4);
  int parts = 1;
  while (parts < kMaxParts && 2 * parts * units <= kTileThreads) parts *= 2;
  return parts;
}

// The passes of every layer, in order, for cluster rank `rank`: p2 and u4
// (one barrier after both), emb, h1, h2, h3.  Returns the count, or -1
// past kMaxJobs.
__host__ __device__ inline int make_jobs(const StepDims& d, const TileLayout& L,
                                         const StepWeights& w, const float* u2b,
                                         int cluster, int rank, Job* jobs) {
  struct Layer {
    const float* w;
    const float* bias;
    int k, fout, in, out, act, barrier;
  };
  const Layer layers[6] = {
      {w.wp2, w.bp2, d.DH, d.D, L.p1, L.cat, kActSigmoid, 0},
      {u2b, nullptr, d.U2, d.D2, L.wt, L.u4, kActGelu, 1},
      {w.wc, w.bc, d.D2, d.D, L.u4, L.cat + d.D * kTileRows, kActGelu, 1},
      {w.wx0, w.bx0, 2 * d.D, d.D15, L.cat, L.wt, kActSigmoid, 1},
      {w.wx2, w.bx2, d.D15, d.D, L.wt, L.u4, kActSigmoid, 1},
      {w.wo0, w.bo0, d.D, d.DH2, L.u4, L.wt, kActGelu, 1},
  };
  int n = 0;
  for (int l = 0; l < 6; ++l) {
    const Layer& y = layers[l];
    int lo, hi;
    col_slice(y.fout, cluster, rank, &lo, &hi);
    int n0 = lo;
    do {  // an empty slice still makes one pass: it owns the barrier
      if (n >= kMaxJobs) return -1;
      const int n1 = n0 + kPassCols < hi ? n0 + kPassCols : hi;
      Job& j = jobs[n++];
      j.w = y.w;
      j.bias = y.bias;
      j.k = y.k;
      j.fout = y.fout;
      j.n0 = n0;
      j.n1 = n1;
      j.pw = (n1 - n0 + 3) / 4 * 4;
      j.bk = j.pw > 0 ? (kStageFloats / j.pw < kMaxBk ? kStageFloats / j.pw
                                                      : kMaxBk)
                      : kMaxBk;
      j.parts = j.pw > 0 ? job_parts(j.pw) : 1;
      j.tiles = n1 > n0 ? (y.k + j.bk - 1) / j.bk : 0;
      j.in = y.in;
      j.out = y.out;
      j.act = y.act;
      j.barrier = n1 >= hi ? y.barrier : 0;
      n0 = n1;
    } while (n0 < hi);
  }
  return n;
}

__device__ __forceinline__ void copy16(float* dst, const float* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void copy4(float* dst, const float* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most kPending of this thread's copy groups are in flight.
template <int kPending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The ring's producer: walks the block's passes tile by tile, so that a
// fill finds its pass and k rows without a search.
struct Filler {
  int job = 0, kt = 0;  // the pass and k tile filled next

  // Tile g (the next of the sequence) into its stage: k rows [kt bk, kt bk
  // + bk) of the pass's columns, zeros past n1.  A thread's copies walk
  // the tile's (row, float4) grid by the block's width without a division.
  __device__ __forceinline__ void fill(const Job* jobs, int njobs, int g,
                                       float* ring) {
    while (job < njobs && kt >= jobs[job].tiles) ++job, kt = 0;
    if (job >= njobs) return;
    const Job& J = jobs[job];
    float* st = ring + (g % kRingStages) * kStageFloats;
    const int k0 = kt * J.bk;
    const int rows = J.k - k0 < J.bk ? J.k - k0 : J.bk;
    const int q4 = J.pw >> 2;
    const bool vec = (J.fout & 3) == 0 && ((uintptr_t)J.w & 15) == 0;
    const int dk = kTileThreads / q4, dc = kTileThreads - dk * q4;
    int kk = threadIdx.x / q4, c4 = threadIdx.x - kk * q4;
    for (; kk < rows; kk += dk, c4 += dc) {
      if (c4 >= q4) c4 -= q4, ++kk;
      if (kk >= rows) break;
      const int n = J.n0 + 4 * c4, left = J.n1 - n;
      const float* src = J.w + (size_t)(k0 + kk) * J.fout + n;
      float* dst = st + kk * J.pw + 4 * c4;
      if (vec) {
        copy16(dst, src, left >= 4 ? 16 : 4 * left);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          copy4(dst + i, i < left ? src + i : J.w, i < left ? 4 : 0);
      }
    }
    ++kt;
  }
};

__device__ __forceinline__ float act(int a, float v) {
  return a == kActGelu ? gelu(v) : sigmoid(v);
}

// The step for tile blockIdx.x / cluster of scene blockIdx.y, as rank
// blockIdx.x % cluster of its cluster.  u2: the scenes' (U2, 2D) tables
// from step_u2_kernel; w4t: w_up4^T (U2, N).
__global__ void __launch_bounds__(kTileThreads, 1)
step_tile_kernel(const float* __restrict__ x, const float* __restrict__ noise,
                 const float* __restrict__ cpcd, const float* __restrict__ u2,
                 const float* __restrict__ w4t, const float* __restrict__ coef,
                 StepWeights w, StepDims d, int cluster, int clip,
                 float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  __shared__ Job jobs[kMaxJobs];
  __shared__ int njobs_s;
  const TileLayout L(d);
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int rank = blockIdx.x % cluster;
  const int r0 = (blockIdx.x / cluster) * kTileRows;
  const int rows = d.N - r0 < kTileRows ? d.N - r0 : kTileRows;

  // the tile's w_up4 rows, k-major: one cp.async group ahead of the ring's
  {
    float* wt = sm + L.wt;
    const bool vec = (d.N & 3) == 0 && ((uintptr_t)w4t & 15) == 0;
    for (int e = tid; e < d.U2 * kGroups; e += kTileThreads) {
      const int k = e / kGroups, r = 4 * (e - k * kGroups);
      const float* src = w4t + (size_t)k * d.N + r0 + r;
      const int left = rows - r;
      if (vec) {
        copy16(wt + k * kTileRows + r, left > 0 ? src : w4t,
               left >= 4 ? 16 : left > 0 ? 4 * left : 0);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          copy4(wt + k * kTileRows + r + i, i < left ? src + i : w4t,
                i < left ? 4 : 0);
      }
    }
    copy_commit();
  }
  if (tid == 0) {
    njobs_s = make_jobs(d, L, w, u2 + (size_t)b * d.U2 * d.D2, cluster, rank,
                        jobs);
  }
  // the sample and the noise of the rows this block updates, read now by
  // the threads that update them at the end
  const int my_r = tid / 3, my_c = tid - 3 * my_r;
  const bool mine = tid < 3 * kTileRows && my_r % cluster == rank && my_r < rows;
  const size_t my_off = ((size_t)b * d.N + r0 + my_r) * 3 + my_c;
  const float my_x = mine ? x[my_off] : 0.0f;
  const float my_noise = mine ? noise[my_off] : 0.0f;
  // b_up4 of the tile's rows, by the last warp
  if (tid >= kTileThreads - kTileRows) {
    const int r = tid - (kTileThreads - kTileRows);
    sm[L.brow + r] = r < rows ? w.b_up4[r0 + r] : 0.0f;
  }
  // p1 = sigmoid((x + cond_pcd) @ wp0 + bp0), all of it in every block, by
  // warps 1.. while thread 0 builds the job table: thread t takes row
  // t % 32 and the outputs t / 32 - 1 + 15 i
  if (tid >= kTileRows) {
    const int r = tid % kTileRows;
    const size_t off = ((size_t)b * d.N + r0 + r) * 3;
    float a[3] = {0.0f, 0.0f, 0.0f};
    if (r < rows) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        a[c] = x[off + c] + cpcd[off + c];
      }
    }
    constexpr int kWarpsP1 = kTileThreads / kTileRows - 1;
#pragma unroll 4
    for (int o = tid / kTileRows - 1; o < d.DH; o += kWarpsP1) {
      float v = a[0] * __ldg(w.wp0 + o);
      v = fmaf(a[1], __ldg(w.wp0 + d.DH + o), v);
      v = fmaf(a[2], __ldg(w.wp0 + 2 * d.DH + o), v);
      const float p1 = sigmoid(v + __ldg(w.bp0 + o));
      sm[L.p1 + o * kTileRows + r] = p1;
    }
  }
  __syncthreads();
  const int njobs = njobs_s;
  float* ring = sm + L.ring;
  Filler filler;
#pragma unroll
  for (int s = 0; s < kRingStages - 1; ++s) {
    filler.fill(jobs, njobs, s, ring);
    copy_commit();
  }
  // every block of the cluster runs before any writes into another
  if (cluster > 1) cg::this_cluster().sync();

  const unsigned sm_s = (unsigned)__cvta_generic_to_shared(sm);
  int g = 0;  // the ring tile consumed next
  for (int jn = 0; jn < njobs; ++jn) {
    const Job J = jobs[jn];
    const int units = kGroups * (J.pw >> 2);
    const bool on = tid < units * J.parts;
    const int unit = on ? tid % units : 0, part = on ? tid / units : 0;
    const int rg = unit % kGroups, cgi = unit / kGroups;
    // rows 4 rg..4 rg + 3 of column n: the bias, the activation, and the
    // float4 into this block's buffer and each peer's
    auto store_out = [&](float4 v, int n) {
      const float bc = J.bias ? __ldg(J.bias + n) : 0.0f;
      const float* br = sm + L.brow + 4 * rg;
      auto out1 = [&](float u) { return act(J.act, u); };
      const float4 val = make_float4(out1(v.x + (J.bias ? bc : br[0])),
                                     out1(v.y + (J.bias ? bc : br[1])),
                                     out1(v.z + (J.bias ? bc : br[2])),
                                     out1(v.w + (J.bias ? bc : br[3])));
      float* dst = sm + J.out + n * kTileRows + 4 * rg;
      *reinterpret_cast<float4*>(dst) = val;
      if (cluster > 1) {
        cg::cluster_group cl = cg::this_cluster();
#pragma unroll
        for (int r = 0; r < kMaxCluster; ++r)
          if (r < cluster && r != rank)
            *reinterpret_cast<float4*>(cl.map_shared_rank(dst, r)) = val;
      }
    };
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    for (int kt = 0; kt < J.tiles; ++kt, ++g) {
      copy_wait<kRingStages - 2>();  // this thread's copies of tile g landed
      __syncthreads();  // everyone's; the stage of tile g - 1 is free
      filler.fill(jobs, njobs, g + kRingStages - 1, ring);
      copy_commit();  // an empty group past the end keeps the count
      if (!on) continue;
      const int k0 = kt * J.bk;
      const int kn = J.k - k0 < J.bk ? J.k - k0 : J.bk;
      const unsigned as = sm_s + 4u * (J.in + k0 * kTileRows + 4 * rg);
      const unsigned bs =
          sm_s + 4u * (L.ring + (g % kRingStages) * kStageFloats + 4 * cgi);
#pragma unroll 4
      for (int kk = part; kk < kn; kk += J.parts) {
        float4 a, c;
        asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                     : "=f"(a.x), "=f"(a.y), "=f"(a.z), "=f"(a.w)
                     : "r"(as + 4u * kk * kTileRows));
        asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                     : "=f"(c.x), "=f"(c.y), "=f"(c.z), "=f"(c.w)
                     : "r"(bs + 4u * kk * J.pw));
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], cv[j], acc[i][j]);
      }
    }
    // the parts meet: each leaves its sums in red, column-major, and the
    // first min(parts, 4) parts of a unit share its 4 columns, each adding
    // its columns' sums in part order, then the bias, the activation and
    // the stores, so the epilogue runs on up to 4x the threads
    const int span = J.parts < 4 ? J.parts : 4;
    if (J.parts > 1) {
      float4* red = reinterpret_cast<float4*>(sm + L.red);
      if (on) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          red[(part * 4 + j) * units + unit] =
              make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
      }
      __syncthreads();
      if (on && part < span) {
        for (int j = part; j < 4; j += span) {
          const int n = J.n0 + 4 * cgi + j;
          if (n >= J.n1) continue;
          float4 v = red[j * units + unit];
          for (int q = 1; q < J.parts; ++q) {
            const float4 u = red[(q * 4 + j) * units + unit];
            v.x += u.x;
            v.y += u.y;
            v.z += u.z;
            v.w += u.w;
          }
          store_out(v, n);
        }
      }
    } else if (on) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = J.n0 + 4 * cgi + j;
        if (n < J.n1)
          store_out(make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]), n);
      }
    }
    if (J.barrier) {
      if (cluster > 1)
        cg::this_cluster().sync();
      else
        __syncthreads();
    }
  }

  // x0 = gelu(h3 @ wo2 + bo2) and the update, for the rows of this rank:
  // four partial sums a thread, so its loads and FMAs overlap
  if (mine) {
    const int r = my_r, c = my_c;
    const float* h3 = sm + L.wt;
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    int k = 0;
    for (; k + 4 <= d.DH2; k += 4) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = fmaf(h3[(k + i) * kTileRows + r], __ldg(w.wo2 + 3 * (k + i) + c),
                    v[i]);
    }
    for (; k < d.DH2; ++k)
      v[0] = fmaf(h3[k * kTileRows + r], __ldg(w.wo2 + 3 * k + c), v[0]);
    float x0v = gelu(((v[0] + v[1]) + (v[2] + v[3])) + __ldg(w.bo2 + c));
    if (clip) x0v = fminf(fmaxf(x0v, -1.0f), 1.0f);
    out[my_off] = (coef[0] * x0v + coef[1] * my_x) + coef[2] * my_noise;
  }
}

cudaError_t launch_u2(const float* e2, const float* const* w, float* scratch,
                      const StepDims& d, cudaStream_t st) {
  const dim3 grid((d.D2 + kU2Tile - 1) / kU2Tile,
                  (d.U2 + kU2Tile - 1) / kU2Tile, d.B);
  step_u2_kernel<<<grid, kU2Threads, 0, st>>>(
      e2, w[0], w[1], w[2], w[3], d.D2, d.U0, d.U2, scratch);
  return cudaGetLastError();
}

cudaError_t launch_tiles(const float* x, const float* noise, const float* cpcd,
                         const float* coef, const float* const* w,
                         const float* w4t, float* out, const float* scratch,
                         const StepDims& d, int cluster, int clip,
                         cudaStream_t st) {
  const TileLayout L(d);
  const size_t smem = sizeof(float) * (size_t)L.total;
  // beside the static job table
  if (smem + sizeof(Job) * kMaxJobs + sizeof(int) > kSmemMax)
    return cudaErrorInvalidValue;
  const StepWeights sw{w[4],  w[5],  w[6],  w[7],  w[8],  w[9],
                       w[10], w[11], w[12], w[13], w[14], w[15],
                       w[16], w[17], w[18], w[19]};
  Job probe[kMaxJobs];
  for (int r = 0; r < cluster; ++r)
    if (make_jobs(d, L, sw, scratch, cluster, r, probe) < 0)
      return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      step_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = (d.N + kTileRows - 1) / kTileRows;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * cluster, d.B);
  cfg.blockDim = dim3(kTileThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, step_tile_kernel, x, noise, cpcd,
                           scratch, w4t, coef, sw, d, cluster, clip, out);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

StepDims dims_of(const int* dims) {
  return StepDims{dims[0], dims[1], dims[2], dims[3], dims[4],
                  dims[5], dims[6], dims[7], dims[8]};
}

bool dims_ok(const StepDims& d, int cluster) {
  return d.B > 0 && d.B <= 65535 && d.N > 0 && d.D2 == 2 * d.D && d.D > 0 &&
         d.U0 > 0 && d.U2 > 0 && d.DH > 0 && d.D15 > 0 && d.DH2 > 0 &&
         cluster >= 1 && cluster <= kMaxCluster &&
         (long long)((d.N + kTileRows - 1) / kTileRows) * cluster <= 0x7fffffff;
}

}  // namespace

extern "C" {

// A K9 call is these two launches, in this order, on one stream or, with
// an event between them, on two (ops/denoise.py:BoundStep).  Shapes: e2
// (B, 2D); x, noise, cpcd, out (B, N, 3); coef (3,) on the device; w: the
// 20 DenoiseStepParams pointers in field order; w4t: w_up4^T (U2, N);
// scratch: B * U2 * 2D floats (u2); dims = {B, N, 2D, U0, U2, D, DH, D15,
// DH2} with DH, D15 the widths of input_process's layers 0 and 2 and DH2
// that of output_process's layer 0; cluster: blocks a tile of 32 rows (1
// to 8, ops/denoise.py:step_plan).  Each returns cudaErrorInvalidValue for
// shapes the kernels do not take (2D != 2 D, B > 65535, more shared memory
// than a block can have).
int lsdm_denoise_step_u2(const float* e2, const float* const* w,
                         float* scratch, const int* dims, void* stream) {
  const StepDims d = dims_of(dims);
  if (!dims_ok(d, 1)) return (int)cudaErrorInvalidValue;
  return (int)launch_u2(e2, w, scratch, d, (cudaStream_t)stream);
}

int lsdm_denoise_step_tiles(const float* x, const float* noise,
                            const float* cpcd, const float* coef,
                            const float* const* w, const float* w4t,
                            float* out, const float* scratch, const int* dims,
                            int cluster, int clip, void* stream) {
  const StepDims d = dims_of(dims);
  if (!dims_ok(d, cluster)) return (int)cudaErrorInvalidValue;
  return (int)launch_tiles(x, noise, cpcd, coef, w, w4t, out, scratch,
                                  d, cluster, clip, (cudaStream_t)stream);
}

// Clusters of `cluster` tile blocks the device runs at once for these dims
// (cudaOccupancyMaxActiveClusters), or a negative CUDA error.
int lsdm_denoise_step_max_clusters(const int* dims, int cluster) {
  const StepDims d = dims_of(dims);
  if (!dims_ok(d, cluster)) return -(int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)TileLayout(d).total;
  const void* kernel = (const void*)step_tile_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((d.N + kTileRows - 1) / kTileRows) * cluster, d.B);
  cfg.blockDim = dim3(kTileThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err != cudaSuccess ? -(int)err : n;
}

// K9 bf16's kernels (denoise_step_bf16.cu): 1 u2, 2 tiles, 0 neither
int lsdm_denoise_step_bf16_kind(const void* func);

// The kernel nodes of a captured CUDA graph (a cudaGraph_t): counts[0] all
// of them, counts[1] K9's u2 launches, counts[2] its tile launches (either
// mode's).
int lsdm_graph_kernel_nodes(void* graph, int* counts) {
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes((cudaGraph_t)graph, nullptr, &n);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNode_t* nodes = new cudaGraphNode_t[n > 0 ? n : 1];
  err = cudaGraphGetNodes((cudaGraph_t)graph, nodes, &n);
  counts[0] = counts[1] = counts[2] = 0;
  for (size_t i = 0; err == cudaSuccess && i < n; ++i) {
    cudaGraphNodeType type;
    if ((err = cudaGraphNodeGetType(nodes[i], &type)) != cudaSuccess) break;
    if (type != cudaGraphNodeTypeKernel) continue;
    ++counts[0];
    cudaKernelNodeParams p;
    if (cudaGraphKernelNodeGetParams(nodes[i], &p) != cudaSuccess) continue;
    const int bf16 = lsdm_denoise_step_bf16_kind(p.func);
    if (p.func == (void*)step_u2_kernel || bf16 == 1) ++counts[1];
    if (p.func == (void*)step_tile_kernel || bf16 == 2) ++counts[2];
  }
  delete[] nodes;
  return (int)err;
}

}  // extern "C"

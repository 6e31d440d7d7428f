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
//   pass 1 (denoise_tables.cu): the t-only part of every step of the
//     chunk, as four batched FP32 GEMMs over (scene, step) with bias and
//     exact-erf GELU fused into the epilogue: the embedding, and the
//     embedding's half of the first combination_extraction layer, g = emb
//     @ wx0_t[D:] + bx0 (the layer reads concat(pose features, emb), so
//     its product splits in two).  About 0.42 GFLOP a step at the
//     flagship width: bound by FP32 FMA throughput.  A 3-stage cp.async
//     ring of 32-deep k tiles, 8 x 8 outputs a thread with register
//     double-buffering, tile shapes chosen per product, u0 computed in
//     the first product's operand producer; the source note has the rest.
//   pass 2: the x-dependent tail, six layers of 65,920 weights (264 KB at
//     D = 128) and the update, for each point row through the chunk's
//     steps.  Rows never exchange data, but every row needs all the
//     weights every step: streamed from L2 they bound the pass by the
//     latency of those reads (each weight fed only a tile's 8 FMAs).  One
//     SM's 227 KB cannot hold them; two can.  So a cluster of two blocks
//     (distributed shared memory) takes a pair of tiles A and B of R rows
//     and splits the tail where its two halves weigh the same: rank 0
//     holds wp0, wp2 and the pose-feature rows of wx0 (32,960 floats at D =
//     128) and carries a tile from x_t + cond_pcd to h1 = sigmoid(p2 @
//     wx0_t[:D] + g); rank 1 holds wx2, wo0 and wo2 (32,960 floats) and
//     carries it from h1 to x0 and the update.  The weights are read from
//     device memory once per launch.  The two ranks ping-pong: in each
//     phase rank 0 runs the front of one tile while rank 1 runs the back
//     of the other; rank 0 writes h1 (R x 192) into rank 1's shared
//     memory, rank 1 writes the new sample (R x 3) into both, and one
//     cluster barrier ends the phase: two barriers a step for 2 R rows.
//     The wide layers are register-tiled FMA loops over shared memory (a
//     thread: 8 rows x 4 columns of a k part; the parts meet in shared
//     memory), the last one a warp per row.  With one block of 12 warps
//     an SM, a phase is bound by the latency of its chain of layers, each
//     FMA loop, epilogue (the activations) and barrier after the other,
//     more than by its FMAs: a phase takes the time of about R + 6 rows.
//     So R is chosen per launch (tile_rows): 8 at batch 1 (64 clusters,
//     one wave of the ~66 that fit), 16 at batch 4 and 8 (half the waves
//     of 8-row tiles; 24 rows do not fit at D = 128).  A phase's rows of g
//     and of the noise arrive by cp.async during its first layers.
//
// The sample is carried in the output buffer from chunk to chunk.  The
// chunk length comes from the caller, which sizes the scratch (pass 1's
// transposed weights and the tables of one chunk).  Every product is
// hand-written (FMA loops): no cuBLAS.
//
// lsdm_denoise_chain_tables runs pass 1 alone, so a check can hold its
// tables against a plain computation: the chain's final sample barely
// moves with pass 1's rounding (the sigmoid layers of pass 2 damp it), so
// it cannot show whether pass 1 computes in exact float32.
//
// The bf16 mode (lsdm_denoise_chain_bf16; the TPU kernel at
// compute_dtype=bfloat16, whose dot() rounds both operands to bf16 and sums
// in float32, denoise_pallas.py:237-239) is its own design on the bf16
// tensor cores in both passes: pass 1's bf16 kernels in denoise_tables.cu,
// pass 2 in denoise_chain_bf16.cu (one block holds the tail's bf16 weights,
// warps carry 16-row tiles through the six layers in registers).  This
// file is the float32 mode.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "denoise_rows.cuh"    // gelu, sigmoid
#include "denoise_tables.cuh"  // pass 1

namespace {

using namespace denoise;

// ---------------------------------------------------------------- pass 2
constexpr int kPairThreads = 384;
constexpr int kMaxTileRows = 32;  // tiles of 8, 16, 24 or 32 point rows
struct TailWeights {
  const float *wp0, *bp0, *wp2, *bp2, *wx0, *bx0, *wx2, *bx2, *wo0, *bo0,
      *wo2, *bo2;
};

__host__ __device__ inline int up4(int v) { return (v + 3) & ~3; }
// a row stride of at least n floats whose count of float4s is odd: eight
// rows read at one column then fall in eight different banks
__host__ __device__ inline int odd4(int n) { return 4 * ((up4(n) / 4) | 1); }

// Parts of k that dense_tile splits a (k_dim -> out_dim) layer over a tile
// of `rows` rows into: as many as the block's threads allow beside the
// layer's units (four columns x eight rows), and no more than leave about
// eight k to each part.
__host__ __device__ inline int layer_parts(int k_dim, int out_dim, int rows) {
  const int units = (up4(out_dim) / 4) * (rows / 8);
  int parts = kPairThreads / units;
  if (parts > (k_dim + 7) / 8) parts = (k_dim + 7) / 8;
  return parts < 1 ? 1 : parts;
}

// Offsets (floats) of every buffer in a pass-2 block's shared memory, for
// tiles of `rows` rows.  The two blocks of a cluster share one layout, so
// a buffer of the peer lies at the same offset.  Each buffer starts on a
// float4.  The ranks' weights share one region, and so do their
// activations; within a rank, a layer's output may take the place of its
// input, which is dead once the layer's FMA loop has passed a barrier.
struct PairLayout {
  int wp0, wp2, wx0, bp0, bp2;       // rank 0's weights, rows padded to 4
  int wx2, wo0, wo2, bx2, bo0, bo2;  // rank 1's
  int x, cp;                         // [tile][row][3] sample and cond_pcd
  int p, gb;        // rank 0: p1, then p2 ([width][row]); g rows
  int h1, h, nz;    // rank 1: [tile][D15][row]; h2, then h3; noise
  int red;          // dense_tile's partial sums
  int rows, gld;    // tile rows; row stride of gb
  int total;        // floats in all
  int units;        // the most units of any layer
};

PairLayout pair_layout(int D, int DH, int D15, int DH2, int rows) {
  PairLayout L;
  int o = 0;
  auto take = [&o](int n) {
    const int at = o;
    o += up4(n);
    return at;
  };
  L.rows = rows;
  L.wp0 = take(3 * up4(DH));
  L.wp2 = take(DH * up4(D));
  L.wx0 = take(D * up4(D15));
  L.bp0 = take(DH);
  L.bp2 = take(D);
  const int rank0_weights = o;
  o = 0;
  L.wx2 = take(D15 * up4(D));
  L.wo0 = take(D * up4(DH2));
  L.wo2 = take(DH2 * 4);
  L.bx2 = take(D);
  L.bo0 = take(DH2);
  L.bo2 = take(3);
  if (o < rank0_weights) o = rank0_weights;
  L.x = take(2 * 3 * rows);
  L.cp = take(2 * 3 * rows);
  const int acts = o;
  L.gld = odd4(D15);
  L.p = take((DH > D ? DH : D) * rows);
  L.gb = take(rows * L.gld);
  const int rank0_acts = o;
  o = acts;
  L.h1 = take(2 * D15 * rows);
  L.h = take((D > DH2 ? D : DH2) * rows);
  L.nz = take(3 * rows + 3);  // this phase's noise rows, then c1, c2, c3
  if (o < rank0_acts) o = rank0_acts;
  const int layers[4][2] = {{DH, D}, {D, D15}, {D15, D}, {D, DH2}};
  int red = 0;
  L.units = 0;
  for (const auto& kn : layers) {
    const int units = (up4(kn[1]) / 4) * (rows / 8);
    const int r = layer_parts(kn[0], kn[1], rows) * rows * odd4(kn[1]);
    red = r > red ? r : red;
    L.units = units > L.units ? units : L.units;
  }
  L.red = take(red);
  L.total = o;
  return L;
}

// One 4-byte cp.async from global to shared memory; valid false fills 0.
__device__ __forceinline__ void copy4_async(float* dst, const float* src,
                                            bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// (rows x cols) row-major weights into shared memory with rows padded to a
// multiple of 4 by zeros.
__device__ void load_matrix(float* dst, const float* __restrict__ src,
                            int rows, int cols) {
  const int ld = up4(cols);
  for (int e = threadIdx.x; e < rows * ld; e += kPairThreads) {
    const int k = e / ld, o = e - k * ld;
    dst[e] = o < cols ? __ldg(src + (size_t)k * cols + o) : 0.0f;
  }
}

// out[o][r] = act(sum_k in[k][r] * w[k][o] + bias) for a tile of `rows`
// rows, everything in shared memory (out may be the peer's): w (k_dim,
// out_dim) with rows padded to 4, in [k][rows].  bias is bias[o], or,
// where it is null, gbias[r * gld + o].  Thread t owns one unit, a column
// group (four columns, read as one float4) of a row group (eight rows, two
// float4 per k): 32 sums in registers, over the k congruent to its part
// modulo the layer's parts.  The partials meet in red and every thread
// finishes outputs from there, four columns of a row at once.  Per k a
// warp reads its weights (one float4 a lane) and two float4 of the
// activations, most of them broadcast, for 32 FMAs a lane.  Ends with a
// block barrier.
template <bool kGelu>
__device__ __forceinline__ void dense_tile(const float* w, int k_dim,
                                           int out_dim, const float* bias,
                                           const float* gbias, int gld,
                                           const float* in, float* out,
                                           float* red, int rows) {
  const int tid = threadIdx.x;
  const int ld = up4(out_dim);
  const int groups = ld >> 2, units = groups * (rows >> 3);
  const int parts = layer_parts(k_dim, out_dim, rows);
  const int rs = odd4(out_dim);  // row stride of red: reads free of conflicts
  const int part = tid / units, unit = tid - part * units;
  const int grp = unit % groups, rg = unit / groups;
  if (part < parts) {
    float acc[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = 0.0f;
    const float4* w4 = reinterpret_cast<const float4*>(w) + grp;
    const float4* in4 = reinterpret_cast<const float4*>(in) + 2 * rg;
    const int istride = rows >> 2;
#pragma unroll 4
    for (int k = part; k < k_dim; k += parts) {
      const float4 wv = w4[k * groups];
      const float4 lo = in4[k * istride], hi = in4[k * istride + 1];
      const float a[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        acc[r][0] = fmaf(a[r], wv.x, acc[r][0]);
        acc[r][1] = fmaf(a[r], wv.y, acc[r][1]);
        acc[r][2] = fmaf(a[r], wv.z, acc[r][2]);
        acc[r][3] = fmaf(a[r], wv.w, acc[r][3]);
      }
    }
    float4* red4 = reinterpret_cast<float4*>(red);
#pragma unroll
    for (int r = 0; r < 8; ++r)
      red4[(part * rows + 8 * rg + r) * (rs >> 2) + grp] =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
  __syncthreads();
  // the epilogue: a thread per (row, column group), r fastest, so that
  // its float4 reads of red, bias and gbias and its stores to out are
  // free of bank conflicts
  const float4* red4 = reinterpret_cast<const float4*>(red);
  const int rs4 = rs >> 2, gld4 = gld >> 2;
  for (int it = tid; it < rows * groups; it += kPairThreads) {
    const int g4 = it / rows, r = it - g4 * rows;
    float4 v = red4[r * rs4 + g4];
    for (int q = 1; q < parts; ++q) {
      const float4 u = red4[(q * rows + r) * rs4 + g4];
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    const float4 bv = bias ? reinterpret_cast<const float4*>(bias)[g4]
                           : reinterpret_cast<const float4*>(gbias)[r * gld4 + g4];
    const float y[4] = {v.x + bv.x, v.y + bv.y, v.z + bv.z, v.w + bv.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (4 * g4 + j < out_dim) {
        const float a = kGelu ? gelu(y[j]) : sigmoid(y[j]);
        out[(4 * g4 + j) * rows + r] = a;
      }
  }
  __syncthreads();
}

// Steps [t0, t0 + tc) for two tiles of L.rows point rows, A (tile 0) and
// B (tile 1), of one scene, on a cluster of two blocks.  Rank 0 holds the
// layers from x_t + cond_pcd to h1, rank 1 those from h1 to the update;
// their weights stay in shared memory for the whole launch.  Phase k of
// 2 tc + 1: rank 0 carries tile k % 2 at step k / 2 to h1, written into
// rank 1's shared memory; rank 1 carries tile (k - 1) % 2 at step (k - 1)
// / 2 from its h1 to the new sample, written into both blocks; one
// cluster barrier ends the phase.  Each phase starts with cp.async copies
// of its rows of g (rank 0) or of the noise and its coefficients (rank 1),
// which land while the first layers run.  g holds the chunk's table emb @
// wx0_t[D:] + bx0, shape (B * tc, n, d15).  x_in and x_out are the same
// buffer after the first chunk: every block reads its rows at the start,
// rank 1 writes them at the end.
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kPairThreads)
chain_pair_kernel(const float* x_in, float* x_out,
                  float* __restrict__ last_in, const float* __restrict__ noise,
                  const float* __restrict__ cpcd, const float* __restrict__ g,
                  const float* __restrict__ coef, TailWeights w, PairLayout L,
                  int n, int d, int dh, int d15, int dh2, int t_total, int t0,
                  int tc, int pairs, int clip) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  float* peer = cluster.map_shared_rank(sm, rank ^ 1);
  const int rows = L.rows;
  const int pair = blockIdx.x / 2;
  const int b = pair / pairs;
  const int rbase = (pair - b * pairs) * 2 * rows;
  const int tid = threadIdx.x;
  // threads tid < 3 rows own one (row, coordinate) of each tile's sample
  const bool owner = tid < 3 * rows;
  const int my_r = tid / 3, my_c = tid - 3 * (tid / 3);

  auto row_ok = [&](int s, int r) { return rbase + s * rows + r < n; };
  auto offset = [&](int s) {  // of the owner's element in (B, n, 3)
    return ((size_t)b * n + rbase + s * rows + my_r) * 3 + my_c;
  };

  if (rank == 0) {
    load_matrix(sm + L.wp0, w.wp0, 3, dh);
    load_matrix(sm + L.wp2, w.wp2, dh, d);
    load_matrix(sm + L.wx0, w.wx0, d, d15);  // the pose-feature half
    load_matrix(sm + L.bp0, w.bp0, 1, dh);
    load_matrix(sm + L.bp2, w.bp2, 1, d);
  } else {
    load_matrix(sm + L.wx2, w.wx2, d15, d);
    load_matrix(sm + L.wo0, w.wo0, d, dh2);
    load_matrix(sm + L.wo2, w.wo2, dh2, 3);
    load_matrix(sm + L.bx2, w.bx2, 1, d);
    load_matrix(sm + L.bo0, w.bo0, 1, dh2);
    load_matrix(sm + L.bo2, w.bo2, 1, 3);
  }
  if (owner) {
    for (int s = 0; s < 2; ++s) {
      const bool ok = row_ok(s, my_r);
      sm[L.x + s * 3 * rows + tid] = ok ? x_in[offset(s)] : 0.0f;
      sm[L.cp + s * 3 * rows + tid] = ok ? cpcd[offset(s)] : 0.0f;
    }
  }

  cluster.sync();  // the peer runs, and both blocks' buffers are loaded
  for (int k = 0; k < 2 * tc + 1; ++k) {
    if (rank == 0 && k < 2 * tc) {
      const int s = k & 1, tt = k >> 1;
      const float* src = g + ((size_t)(b * tc + tt) * n + rbase + s * rows) * d15;
      for (int e = tid; e < rows * d15; e += kPairThreads) {
        const int r = e / d15, j = e - r * d15;
        copy4_async(sm + L.gb + r * L.gld + j, row_ok(s, r) ? src + e : g,
                    row_ok(s, r));
      }
      copy_commit();
      {  // p1 = sigmoid((x_t + cond_pcd) @ wp0_t + bp0), k = 3: no split
        const float* xs = sm + L.x + s * 3 * rows;
        const float* cs = sm + L.cp + s * 3 * rows;
        const int ld = up4(dh);
        for (int e = tid; e < rows * dh; e += kPairThreads) {
          const int o = e / rows, r = e - o * rows;
          float v = 0.0f;
          for (int c = 0; c < 3; ++c) {
            const float xc = xs[3 * r + c] + cs[3 * r + c];
            v = fmaf(xc, sm[L.wp0 + c * ld + o], v);
          }
          sm[L.p + e] = sigmoid(v + sm[L.bp0 + o]);
        }
        __syncthreads();
      }
      dense_tile<false>(sm + L.wp2, dh, d, sm + L.bp2, nullptr, 0, sm + L.p,
                        sm + L.p, sm + L.red, rows);
      copy_wait();  // this phase's g (dense_tile's barrier shares it)
      dense_tile<false>(sm + L.wx0, d, d15, nullptr, sm + L.gb, L.gld, sm + L.p,
                        peer + L.h1 + s * d15 * rows, sm + L.red, rows);
    } else if (rank == 1 && k >= 1) {
      const int s = (k - 1) & 1, t = t0 + ((k - 1) >> 1);
      if (owner)
        copy4_async(sm + L.nz + tid,
                    noise + (((size_t)b * t_total + t) * n + rbase + s * rows +
                             my_r) * 3 + my_c,
                    row_ok(s, my_r));
      else if (tid < 3 * rows + 3)
        copy4_async(sm + L.nz + tid, coef + (size_t)t * 3 + (tid - 3 * rows),
                    true);
      copy_commit();
      dense_tile<false>(sm + L.wx2, d15, d, sm + L.bx2, nullptr, 0,
                        sm + L.h1 + s * d15 * rows, sm + L.h, sm + L.red, rows);
      copy_wait();  // this phase's noise (wo0's barrier shares it)
      dense_tile<true>(sm + L.wo0, d, dh2, sm + L.bo0, nullptr, 0, sm + L.h,
                       sm + L.h, sm + L.red, rows);
      // x0 = gelu(h3 @ wo2_t + bo2) and the update, a warp per row: the
      // lanes split k, a butterfly sums, lanes 0-2 update (row, lane)
      const int lane = tid & 31;
      const float* nz = sm + L.nz;
      for (int r = tid >> 5; r < rows; r += kPairThreads / 32) {
        float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
        for (int j = lane; j < dh2; j += 32) {
          const float hv = sm[L.h + j * rows + r];
          const float* wj = sm + L.wo2 + 4 * j;
          a0 = fmaf(hv, wj[0], a0);
          a1 = fmaf(hv, wj[1], a1);
          a2 = fmaf(hv, wj[2], a2);
        }
        for (int off = 16; off; off >>= 1) {
          a0 += __shfl_xor_sync(0xffffffffu, a0, off);
          a1 += __shfl_xor_sync(0xffffffffu, a1, off);
          a2 += __shfl_xor_sync(0xffffffffu, a2, off);
        }
        if (lane < 3) {
          const float sum = lane == 0 ? a0 : lane == 1 ? a1 : a2;
          float x0v = gelu(sum + sm[L.bo2 + lane]);
          if (clip) x0v = fminf(fmaxf(x0v, -1.0f), 1.0f);
          const int at = L.x + s * 3 * rows + 3 * r + lane;
          const float xv = sm[at];
          const bool ok = row_ok(s, r);
          if (t == t_total - 1 && ok)
            last_in[((size_t)b * n + rbase + s * rows + r) * 3 + lane] = xv;
          const float next = (nz[3 * rows] * x0v + nz[3 * rows + 1] * xv) +
                             nz[3 * rows + 2] * nz[3 * r + lane];
          sm[at] = next;
          peer[at] = next;
        }
      }
    }
    cluster.sync();  // h1 and the new sample visible to the peer
  }
  if (rank == 1 && owner) {
    for (int s = 0; s < 2; ++s)
      if (row_ok(s, my_r)) x_out[offset(s)] = sm[L.x + s * 3 * rows + tid];
  }
}

// The tile height of a launch for B scenes of n rows: among the heights
// whose buffers fit in `smem_limit` bytes, the one that minimises the
// waves of clusters the card runs times a phase's cost.  A phase costs its
// rows plus a fixed part (its barriers and the latency of its layers'
// chain) of about kPhaseRows rows: on an H100, 6.4 us a phase at 8 rows
// and 9.9 at 16 (PERF.md).  So B = 1 takes 8 rows (64 clusters, one
// wave), and a larger batch taller tiles and fewer waves.  Returns 0 if
// no height fits.
constexpr int kPhaseRows = 6;
int tile_rows(const ChainDims& d, int sms, size_t smem_limit) {
  const int wave = sms / 2 > 0 ? sms / 2 : 1;  // clusters a wave
  int best = 0;
  long long best_cost = 0;
  for (int rows = 8; rows <= kMaxTileRows; rows += 8) {
    const PairLayout L = pair_layout(d.D, d.DH, d.D15, d.DH2, rows);
    if (sizeof(float) * (size_t)L.total > smem_limit || L.units > kPairThreads)
      continue;
    const long long clusters = (long long)d.B * ((d.N + 2 * rows - 1) / (2 * rows));
    const long long cost = (clusters + wave - 1) / wave * (rows + kPhaseRows);
    if (!best || cost < best_cost) best = rows, best_cost = cost;
  }
  return best;
}

}  // namespace

extern "C" {

// x_init, cond_pcd (B, N, 3); noise (B, T, N, 3); e2 (B, T, 2D); coef
// (T, 3); w: the 20 DenoiseStepParams pointers in field order; final,
// last_in (B, N, 3) outputs; scratch: U0*U2 + U2*ldn + B * tc * (U2*2D +
// 2D*ldn + D*ldn + N*D15) floats, ldn = N rounded up to 4
// (denoise_tables.cuh); dims = {B, T, N, 2D, U0, U2, D, DH, D15, DH2, tc}
// with DH, D15 the widths of input_process's layers 0 and 2 and DH2 that
// of output_process's layer 0.  Returns cudaErrorInvalidValue for shapes
// the kernel does not take: 2D != 2 * D, shapes pass 1 does not take
// (tables_check), or a pass-2 block whose weights and buffers exceed the
// shared memory a block may opt into (232,448 bytes on an H100: D up to
// about 160).  The bf16 mode's entry is in denoise_chain_bf16.cu.
int lsdm_denoise_chain(const float* x_init, const float* noise,
                       const float* cpcd, const float* e2, const float* coef,
                       const float* const* w, float* final_x, float* last_in,
                       float* scratch, const int* dims, int clip,
                       void* stream) {
  const ChainDims d{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5],
                    dims[6], dims[7], dims[8], dims[9], dims[10]};
  if (d.B <= 0 || d.T <= 0 || d.TC <= 0 || d.D2 != 2 * d.D)
    return (int)cudaErrorInvalidValue;
  int dev, limit, sms;
  cudaError_t err;
  if ((err = tables_check(d, w, scratch, false))) return (int)err;
  if ((err = cudaGetDevice(&dev)) ||
      (err = cudaDeviceGetAttribute(
           &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)))
    return (int)err;
  const int rows = tile_rows(d, sms, (size_t)limit);
  if (!rows) return (int)cudaErrorInvalidValue;
  const PairLayout L = pair_layout(d.D, d.DH, d.D15, d.DH2, rows);
  const size_t smem = sizeof(float) * (size_t)L.total;
  if ((err = cudaFuncSetAttribute(chain_pair_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)))
    return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const TailWeights tail{w[8],  w[9],  w[10], w[11], w[12], w[13],
                         w[14], w[15], w[16], w[17], w[18], w[19]};
  const int pairs = (d.N + 2 * rows - 1) / (2 * rows);  // tile pairs a scene
  if ((err = transpose_weights(st, d, w, scratch))) return (int)err;
  for (int t0 = 0; t0 < d.T; t0 += d.TC) {
    const int tc = d.TC < d.T - t0 ? d.TC : d.T - t0;
    float* g;
    if ((err = chain_tables(st, d, e2, w, scratch, t0, tc, false, false, &g)))
      return (int)err;
    chain_pair_kernel<<<2 * d.B * pairs, kPairThreads, smem, st>>>(
        t0 == 0 ? x_init : final_x, final_x, last_in, noise, cpcd, g, coef,
        tail, L, d.N, d.D, d.DH, d.D15, d.DH2, d.T, t0, tc, pairs, clip);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"

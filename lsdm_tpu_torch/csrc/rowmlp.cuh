// The row-MLP engine of the fused SetAbstraction (sa_fused.cu, K7) and
// FeaturePropagation (fp_fused.cu, K8) stage kernels: dense layers over a
// tile of activation rows that stays in shared memory, in exact float32.
//
// What bounds it on an H100: the layers' float32 FMAs on the CUDA cores
// (no TF32, no tensor cores: the port keeps float32 numerics).  The
// design feeds the FMA units as the GEMM of denoise_tables.cu does:
// - Activations live channel-major (buf[c * ldm + row]) in one of two
//   ping-pong buffers, so a thread reads its rows of one input channel as
//   float4s.  ldm = 4 (mod 32) spreads the gathers' stores over all banks.
// - A layer's weights (fin, fout) stream through a ring of kStages k tiles
//   (BK x BN floats) in shared memory, filled by cp.async (zero-fill for
//   ragged columns), which every row of the block reuses.
// - Each of the 256 threads owns a TM x TN tile of outputs in registers
//   (tile_tm/tile_tn: 4 or 8): per input channel TM / 4 + TN / 4 float4
//   loads for TM x TN FMAs, 16 FMAs a load at 8 x 8.  A warp's 8 x 4
//   lanes read 128 bytes of activations and at most 128 of weights a
//   channel, one wavefront each.  The block tile (BM x BN) is chosen per
//   layer by the host plan (lsdm_tpu_torch/ops/rowmlp.py) from nine shapes,
//   32 x 256 to 256 x 32.
// - Two blocks an SM (128 registers a thread) hide the latency of each
//   other's prologue and barriers.
// - A cluster of `cluster` blocks may share one tile of rows: each block
//   computes a column slice (col_slice) of every layer and stores it into
//   every peer's next buffer through DSMEM; one cluster barrier a layer.
// - dense_tiles<T> is not inlined, so each tile shape gets its own
//   register allocation under the kernels' 128-register cap (two blocks
//   an SM); it reads shared memory by shared-window addresses (lds4).
//
// Numerics are those of the TPU kernels and the plain versions: each
// output is one FMA chain over its input channels in ascending order, the
// bias added after the sum, ReLU applied last.
//
// The kernels' bf16 modes are their own design on the bf16 tensor cores
// (rowmma.cuh).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace rowmlp {

// Four consecutive floats from global memory: one 16-byte load.
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

constexpr int kThreads = 256;
constexpr int kMaxLayers = 8;    // layers a kernel computes
constexpr int kStages = 3;       // depth of the weight ring
constexpr int kStageFloats = 2048;  // floats of one ring stage at most
constexpr size_t kSmemMax = 232448;  // dynamic shared memory of a block

// The register tiles (ops/rowmlp.py:TILES): TM x TN outputs a thread; a
// warp's lanes are 8 x 4 threads (lane & 7 down the rows, lane >> 3 across
// the columns), so a warp covers 8 TM rows x 4 TN columns and per input
// channel reads 128 bytes of activations and 64 or 128 of weights; the
// block's 8 warps stand WY down the rows by 8 / WY across the columns.
constexpr int kTiles = 9;
__host__ __device__ constexpr int tile_tm(int t) { return t < 3 ? 8 : 4; }
__host__ __device__ constexpr int tile_tn(int t) { return t < 7 ? 8 : 4; }
__host__ __device__ constexpr int tile_wy(int t) {
  return t == 2 || t == 5 ? 4
         : t == 0 || t == 4 || t == 8 ? 2
         : t == 6                     ? 8
                                      : 1;
}
__host__ __device__ constexpr int tile_bm(int t) {
  return tile_wy(t) * 8 * tile_tm(t);
}
__host__ __device__ constexpr int tile_bn(int t) {
  return kThreads / 32 / tile_wy(t) * 4 * tile_tn(t);
}
__host__ __device__ constexpr int tile_bk(int t) {
  return kStageFloats / tile_bn(t) < 32 ? kStageFloats / tile_bn(t) : 32;
}

// A launch plan, as ops/rowmlp.py:Plan.ints() lays it out.
struct Plan {
  int rows;     // SA centres or FP targets a cluster takes
  int cluster;  // blocks of a cluster sharing those rows
  int ldm;      // row stride of the channel-major buffers, floats
  int cap0, cap1;  // channels of buffers 0 and 1
  int ring;     // floats of the weight ring
  int red;      // floats of the SA max's partial results
  int smem;     // dynamic shared memory of a block, bytes
  int tile[kMaxLayers];
};

struct Layers {
  const float* w[kMaxLayers];  // (fin, fout) row-major, BatchNorm folded in
  const float* b[kMaxLayers];  // (fout,)
  int fin[kMaxLayers];
  int fout[kMaxLayers];
  int relu[kMaxLayers];        // 1: ReLU after the bias, 0: none
  int n;
};

// Columns [lo, hi) of a layer of fout outputs that cluster rank `rank`
// computes: slices of ceil(fout / cluster) rounded up to 4 (16-byte weight
// copies), the last ones short or empty (ops/rowmlp.py:col_slice).
__host__ __device__ inline void col_slice(int fout, int cluster, int rank,
                                          int* lo, int* hi) {
  const int sl = cluster > 1 ? ((fout + cluster - 1) / cluster + 3) / 4 * 4
                             : fout;
  *lo = rank * sl < fout ? rank * sl : fout;
  *hi = *lo + sl < fout ? *lo + sl : fout;
}

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// True when the plan can carry `m` rows through the layers: every tile
// valid and within ldm, the ring and the buffers large enough (`first`:
// the width gathered into buffer 0 before layer 0), `red_groups` groups of
// the last layer's slice in `red`, and smem the layout's bytes with
// `extra_floats` after it, within a block's limit.
inline bool plan_ok(const Plan& p, const Layers& L, int m, int first,
                    int red_groups, long long extra_floats) {
  if (p.cluster != 1 && p.cluster != 2 && p.cluster != 4 && p.cluster != 8)
    return false;
  if (p.rows < 1 || p.ldm % 32 != 4 || p.ldm < m || p.cap0 < first ||
      p.cap1 < 0 || p.ring < 0 || p.ring % 4 || p.red < 0 || p.red % 4)
    return false;
  for (int l = 0; l < L.n; ++l) {
    const int t = p.tile[l];
    if (t < 0 || t >= kTiles) return false;
    if (round_up(m, tile_bm(t)) > p.ldm) return false;
    if (kStages * tile_bk(t) * tile_bn(t) > p.ring) return false;
    if (L.fin[l] > (l & 1 ? p.cap1 : p.cap0)) return false;
  }
  if (red_groups > 0 && L.n > 0) {
    int lo, hi;
    col_slice(L.fout[L.n - 1], p.cluster, 0, &lo, &hi);
    if ((long long)red_groups * (hi - lo) > p.red) return false;
  }
  const long long floats = (long long)(p.cap0 + p.cap1) * p.ldm + p.ring +
                           p.red + extra_floats;
  return 4 * floats == p.smem && (size_t)p.smem <= kSmemMax;
}

// Launches `kernel` on clusters of plan.cluster blocks along x with the
// plan's dynamic shared memory.
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), dim3 grid, const Plan& p,
                   cudaStream_t st, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)p.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// One 16-byte (or 4-byte) copy from global to shared memory, of which the
// first `bytes` come from src and the rest are zeros.
__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}
// A 16-byte load from shared memory by its shared-window address: the
// engine's functions are not inlined into the kernels, so a generic
// pointer would not tell the compiler which memory it reads.
__device__ __forceinline__ float4 lds4(unsigned addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Where a layer's outputs go.
enum { kToShared = 0, kToMax = 1, kToGlobal = 2 };
struct Sink {
  int mode;
  // kToShared: the next buffer, channel-major with stride ldm, in the
  // shared memory of every rank of the block's cluster of `cluster` blocks
  // (this block's own included)
  float* nxt;
  int cluster;
  // kToMax: red[(row / group) * (hi - lo) + n - lo] = max over the group's
  // rows, as int bits of the non-negative ReLU outputs
  int* red;
  int group;
  // kToGlobal: out[row * ldo + n]
  float* out;
  int ldo;
};

// A thread's rows are {r0 + i} (TM = 4) or {r0 + i, r0 + WM/2 + i}
// (TM = 8), i < 4, r0 = its warp's first row + 4 (lane & 7), WM = 8 TM the
// warp's rows; its columns the same pattern from c0 = its warp's first
// column + 4 (lane >> 3), WN = 4 TN.
template <int T>
__device__ __forceinline__ int tile_row(int r0, int i) {
  return i < 4 ? r0 + i : r0 + 4 * tile_tm(T) + (i - 4);
}
template <int T>
__device__ __forceinline__ int tile_col(int c0, int j) {
  return j < 4 ? c0 + j : c0 + 2 * tile_tn(T) + (j - 4);
}

// out[row, n] = act(in[row] . w[:, n] + b[n]) for rows < m and columns
// [lo, hi), `in` channel-major in shared memory (fin channels, stride
// ldm, at least round_up(m, BM) rows allocated), sent to `sink`.
// Not inlined: each tile shape gets its own register allocation.
template <int T>
__device__ __noinline__ void dense_tiles(const float* in, int ldm, int m,
                                         const float* __restrict__ w,
                                         const float* __restrict__ bias,
                                         int fin, int fout, int relu, int lo,
                                         int hi, float* ring, Sink sink) {
  constexpr int TM = tile_tm(T), TN = tile_tn(T), WY = tile_wy(T);
  constexpr int BM = tile_bm(T), BN = tile_bn(T), BK = tile_bk(T);
  constexpr int WM = 8 * TM, WN = 4 * TN, STAGE = BK * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // this thread's first row and column within the block tile
  const int ty = (warp % WY) * WM + 4 * (lane & 7);
  const int tx = (warp / WY) * WN + 4 * (lane >> 3);
  const bool vec = (fout & 3) == 0 && ((uintptr_t)w & 15) == 0;
  const int tiles = (fin + BK - 1) / BK;
  const unsigned in_s = (unsigned)__cvta_generic_to_shared(in);
  const unsigned ring_s = (unsigned)__cvta_generic_to_shared(ring);
  for (int n0 = lo; n0 < hi; n0 += BN) {
    for (int m0 = 0; m0 < m; m0 += BM) {
      __syncthreads();  // every thread is done with the ring's stages

      // stage s <- weight rows [k0, k0 + BK), columns [n0, n0 + BN)
      auto fill = [&](int s, int k0) {
        float* ws = ring + s * STAGE;
#pragma unroll
        for (int e = tid; e < STAGE / 4; e += kThreads) {
          const int k = e / (BN / 4), n = 4 * (e - k * (BN / 4));
          const int gk = k0 + k, gn = n0 + n;
          const int left = gk < fin ? hi - gn : 0;
          const float* src = w + (size_t)gk * fout + gn;
          if (vec) {
            copy16(ws + k * BN + n, left > 0 ? src : w,
                   left >= 4 ? 16 : left > 0 ? 4 * left : 0);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              copy4(ws + k * BN + n + j, j < left ? src + j : w,
                    j < left ? 4 : 0);
          }
        }
      };

      float acc[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

#pragma unroll
      for (int s = 0; s < kStages - 1; ++s) {
        if (s < tiles) fill(s, s * BK);
        copy_commit();
      }
      for (int kt = 0; kt < tiles; ++kt) {
        copy_wait<kStages - 2>();  // this thread's copies of tile kt landed
        __syncthreads();           // everyone's; the stage of kt - 1 is free
        const int next = kt + kStages - 1;
        if (next < tiles) fill(next % kStages, next * BK);
        copy_commit();  // an empty group past the end keeps the count
        // shared-window byte addresses of this thread's fragments
        const unsigned as = in_s + 4u * ((unsigned)(kt * BK) * ldm + m0 + ty);
        const unsigned bs = ring_s + 4u * ((kt % kStages) * STAGE + tx);
        const int kn = fin - kt * BK < BK ? fin - kt * BK : BK;
#pragma unroll 4
        for (int kk = 0; kk < kn; ++kk) {
          float a[TM], b[TN];
          const float4 a0 = lds4(as + 4u * kk * ldm);
          a[0] = a0.x, a[1] = a0.y, a[2] = a0.z, a[3] = a0.w;
          if constexpr (TM == 8) {
            const float4 a1 = lds4(as + 4u * (kk * ldm + WM / 2));
            a[4] = a1.x, a[5] = a1.y, a[6] = a1.z, a[7] = a1.w;
          }
          const float4 b0 = lds4(bs + 4u * kk * BN);
          b[0] = b0.x, b[1] = b0.y, b[2] = b0.z, b[3] = b0.w;
          if constexpr (TN == 8) {
            const float4 b1 = lds4(bs + 4u * (kk * BN + WN / 2));
            b[4] = b1.x, b[5] = b1.y, b[6] = b1.z, b[7] = b1.w;
          }
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
      }

      // the epilogue: bias, activation, then the sink
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = n0 + tile_col<T>(tx, j);
        const float bj = n < hi ? __ldg(bias + n) : 0.0f;
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float v = __fadd_rn(acc[i][j], bj);
          acc[i][j] = relu ? fmaxf(v, 0.0f) : v;
        }
      }
      if (sink.mode == kToShared) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int n = n0 + tile_col<T>(tx, j);
          if (n >= hi) continue;
#pragma unroll
          for (int h = 0; h < TM / 4; ++h) {
            const float4 v = make_float4(acc[4 * h][j], acc[4 * h + 1][j],
                                         acc[4 * h + 2][j], acc[4 * h + 3][j]);
            float* dst = sink.nxt + (size_t)n * ldm + m0 + tile_row<T>(ty, 4 * h);
            if (sink.cluster == 1) {
              *reinterpret_cast<float4*>(dst) = v;
            } else {
              cooperative_groups::cluster_group cl =
                  cooperative_groups::this_cluster();
              for (int r = 0; r < sink.cluster; ++r)
                *reinterpret_cast<float4*>(cl.map_shared_rank(dst, r)) = v;
            }
          }
        }
      } else if (sink.mode == kToMax) {
        const int width = hi - lo;
        int* red = sink.red;
#pragma unroll
        for (int h = 0; h < TM / 4; ++h) {
          const int r0 = m0 + tile_row<T>(ty, 4 * h);
          if (r0 >= m) continue;
          const bool whole = sink.group % 4 == 0 && r0 + 3 < m;
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const int n = n0 + tile_col<T>(tx, j);
            if (n >= hi) continue;
            if (whole) {  // four rows of one group
              const float v =
                  fmaxf(fmaxf(acc[4 * h][j], acc[4 * h + 1][j]),
                        fmaxf(acc[4 * h + 2][j], acc[4 * h + 3][j]));
              atomicMax(red + (r0 / sink.group) * width + (n - lo),
                        __float_as_int(v));
            } else {
#pragma unroll
              for (int i = 0; i < 4; ++i)
                if (r0 + i < m)
                  atomicMax(red + ((r0 + i) / sink.group) * width + (n - lo),
                            __float_as_int(acc[4 * h + i][j]));
            }
          }
        }
      } else {
        const bool vec_out = (sink.ldo & 3) == 0;
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int r = m0 + tile_row<T>(ty, i);
          if (r >= m) continue;
          float* row = sink.out + (size_t)r * sink.ldo;
#pragma unroll
          for (int g = 0; g < TN / 4; ++g) {
            const int n = n0 + tile_col<T>(tx, 4 * g);
            if (vec_out && n + 4 <= hi) {
              *reinterpret_cast<float4*>(row + n) =
                  make_float4(acc[i][4 * g], acc[i][4 * g + 1],
                              acc[i][4 * g + 2], acc[i][4 * g + 3]);
            } else {
#pragma unroll
              for (int j = 0; j < 4; ++j)
                if (n + j < hi) row[n + j] = acc[i][4 * g + j];
            }
          }
        }
      }
    }
  }
}

// One layer with the plan's tile `tile` (0 <= tile < kTiles).
__device__ inline void dense_layer(int tile, const float* in, int ldm, int m,
                                   const float* w, const float* bias, int fin,
                                   int fout, int relu, int lo, int hi,
                                   float* ring, Sink sink) {
  switch (tile) {
#define ROWMLP_TILE(T)                                                    \
  case T:                                                                 \
    dense_tiles<T>(in, ldm, m, w, bias, fin, fout, relu, lo, hi, ring,   \
                   sink);                                                 \
    break;
    ROWMLP_TILE(0) ROWMLP_TILE(1) ROWMLP_TILE(2) ROWMLP_TILE(3)
    ROWMLP_TILE(4) ROWMLP_TILE(5) ROWMLP_TILE(6) ROWMLP_TILE(7)
    ROWMLP_TILE(8)
#undef ROWMLP_TILE
    default:
      break;
  }
}

// A sink that stores into the next buffer `nxt` of every rank of the
// block's cluster (its own included).
__device__ inline Sink shared_sink(float* nxt, int cluster) {
  Sink s = {};
  s.mode = kToShared;
  s.nxt = nxt;
  s.cluster = cluster;
  return s;
}

// The barrier that ends a layer: the cluster's where peers write into this
// block's buffers, the block's otherwise.
__device__ inline void layer_barrier(int cluster) {
  if (cluster > 1)
    cooperative_groups::this_cluster().sync();
  else
    __syncthreads();
}

// buf[c * ldm + row] = f(row, c) for rows < `rows` (zeros above, to the
// next multiple of 4) and channels c < `chans`.  A thread takes one channel
// and four consecutive rows: a warp's loads inside f read consecutive
// channels of a row (coalesced), and with ldm = 4 (mod 32) its float4
// stores fall on distinct banks.  Four such items a pass, their loads all
// issued before the first store, so a pass waits for device memory once.
template <typename F>
__device__ __forceinline__ void fill_rows(float* buf, int ldm, int rows,
                                          int chans, F f) {
  constexpr int kItems = 4;
  const int total = ((rows + 3) >> 2) * chans;
  for (int e0 = threadIdx.x; e0 < total; e0 += kItems * kThreads) {
    float v[kItems][4];
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int e = e0 + u * kThreads;
      const int g = e / chans, c = e - g * chans, r0 = 4 * g;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[u][i] = e < total && r0 + i < rows ? f(r0 + i, c) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int e = e0 + u * kThreads;
      if (e >= total) break;
      const int g = e / chans, c = e - g * chans;
      *reinterpret_cast<float4*>(buf + (size_t)c * ldm + 4 * g) =
          make_float4(v[u][0], v[u][1], v[u][2], v[u][3]);
    }
  }
}

// fill_rows four channels at a time, for chans a multiple of 4: f4(row,
// c) returns channels c..c+3 of a row as a float4 (one 16-byte load where
// fill_rows makes four), and a thread stores its 4 rows x 4 channels as
// four float4s, one a channel.  Consecutive threads take consecutive
// channel groups of a row, so the loads stay coalesced.
template <typename F4>
__device__ __forceinline__ void fill_rows4(float* buf, int ldm, int rows,
                                           int chans, F4 f4) {
  constexpr int kItems = 2;
  const int q4 = chans >> 2, total = ((rows + 3) >> 2) * q4;
  for (int e0 = threadIdx.x; e0 < total; e0 += kItems * kThreads) {
    float4 v[kItems][4];
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int e = e0 + u * kThreads;
      const int g = e / q4, c = 4 * (e - g * q4), r0 = 4 * g;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[u][i] = e < total && r0 + i < rows ? f4(r0 + i, c)
                                             : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int e = e0 + u * kThreads;
      if (e >= total) break;
      const int g = e / q4, c = 4 * (e - g * q4);
      float* dst = buf + (size_t)c * ldm + 4 * g;
      const float4(&x)[4] = v[u];
      *reinterpret_cast<float4*>(dst) = make_float4(x[0].x, x[1].x, x[2].x, x[3].x);
      *reinterpret_cast<float4*>(dst + ldm) =
          make_float4(x[0].y, x[1].y, x[2].y, x[3].y);
      *reinterpret_cast<float4*>(dst + 2 * ldm) =
          make_float4(x[0].z, x[1].z, x[2].z, x[3].z);
      *reinterpret_cast<float4*>(dst + 3 * ldm) =
          make_float4(x[0].w, x[1].w, x[2].w, x[3].w);
    }
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

}  // namespace rowmlp

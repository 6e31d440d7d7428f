// The lane-split nearest-k scan shared by 3-NN selection (K2,
// ballquery.cu) and the chamfer nearest neighbour (K11, chamfer.cu).
//
// For every target point of a cloud: the K nearest sources of another
// cloud by a squared distance whose products and sums are rounded as the
// plain version rounds them, ties to the lowest index.  That is the K
// smallest (distance, index) pairs in lexicographic order: lax.top_k(-d)
// for K2, the JAX kernel's argmin within a tile and `tile_min <
// running_min` across tiles for K11.
//
// What bounds it on an H100: instruction issue.  Nothing is large (a
// 1024-point cloud is 12 KB, the outputs at most 54 x 1024 x 3 pairs),
// but every (target, source) pair takes about eight float32 instructions
// (chip_smoke.py: DIST_INSTRS) and its compare and insert.  The design
// keeps the card full of independent pairs, whatever the grid:
// - A block of kWarps warps streams the source cloud through a shared
//   tile of kTile {x, y, z, |x|^2} float4s, so no source count is capped
//   and each source is read from device memory once a block.
// - Each target is served by a group of L lanes (L a power of two <= 32,
//   a warp holds 32 / L groups), and each group serves G targets.  Lane r
//   of a group reads sources r, r + L, r + 2L, ... of each tile, in
//   ascending order: one 16-byte shared load a source, reused for all G
//   targets of the lane.  Host plans (ops/ballquery.py:three_nn_plan,
//   ops/chamfer.py:chamfer_nn_plan) pick L and G from the grid: small
//   source clouds and large grids take small L, small grids large L, so
//   the card holds enough warps; K2 takes G = 1 and K11 up to 4.
// - Each lane keeps its own sorted top-K of the sources it read.  Strict
//   < in ascending index order keeps the earlier index of equal
//   distances, so a lane's list is the K smallest of its sources in
//   (distance, index) order.  For K = 3 a pair that beats the lane's
//   third is inserted behind a branch (12 instructions), and a warp runs
//   the insert whenever any of its lanes takes it: early in a scan most
//   steps, since each lane's list starts empty.  That, not the distance,
//   is what K2 spends beyond its bound; K = 1 keeps its minimum by a
//   select, with no branch.
// - After the last tile, log2(L) butterfly levels of __shfl_xor_sync
//   merge the group's lists: each level takes the partner's K pairs, keeps
//   the K smallest of the two sorted lists in (distance, index) order
//   (the bitonic half-cleaner, then a sorting network of K), and leaves
//   every lane of the pair with the same list.  So ties resolve to the
//   lowest index across lanes and tiles as they do in one in-order scan.
//
// The distances: K2's is pointdist.cuh's sq_dist, (-2 (q.x) + |q|^2) +
// |x|^2; K11's is (|q|^2 + |x|^2) - 2 (q.x), clamped at 0 after the
// selection.  q.x = (q0 x0 + q1 x1) + q2 x2 with every product and sum
// rounded on its own.  In both, -2 (q.x) and the add after it are one
// FMA: a product by -2 is exact in float32 (it only moves the exponent),
// so the FMA's one rounding of -2 (q.x) + a is the separately rounded
// sum's, and the distances are the plain versions' bits.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "pointdist.cuh"

namespace nearest {

constexpr int kWarps = 8;                 // warps a block
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 1024;               // sources a shared-memory tile
constexpr int kNone = INT_MAX;            // index of an empty slot
constexpr unsigned kFull = 0xffffffffu;

// (distance, index) a before b, lexicographically
__device__ __forceinline__ bool before(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// The K smallest (distance, index) pairs a lane has seen, ascending.
template <int K>
struct TopK {
  float d[K];
  int i[K];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int m = 0; m < K; ++m) {
      d[m] = INFINITY;
      i[m] = kNone;
    }
  }

  // The scan visits j in ascending order, so strict < on the distance
  // alone places an equal distance after the pairs already held.
  __device__ __forceinline__ void insert(float v, int j) {
    if (!(v < d[K - 1])) return;
    bool lt[K];
#pragma unroll
    for (int m = 0; m < K; ++m) lt[m] = v < d[m];
#pragma unroll
    for (int m = K - 1; m > 0; --m) {  // from the top: d[m - 1] still old
      const bool up = lt[m - 1];
      d[m] = lt[m] ? (up ? d[m - 1] : v) : d[m];
      i[m] = lt[m] ? (up ? i[m - 1] : j) : i[m];
    }
    d[0] = lt[0] ? v : d[0];
    i[0] = lt[0] ? j : i[0];
  }

  __device__ __forceinline__ void exchange(int a, int b) {
    const bool swap = before(d[b], i[b], d[a], i[a]);
    const float da = d[a], db = d[b];
    const int ia = i[a], ib = i[b];
    d[a] = swap ? db : da;
    i[a] = swap ? ib : ia;
    d[b] = swap ? da : db;
    i[b] = swap ? ia : ib;
  }

  // Merge with the list of lane ^ off: the K smallest of both, sorted.
  // Pairing mine ascending with the partner's descending and keeping the
  // smaller of each pair leaves the K smallest as a bitonic sequence; a
  // sorting network orders it.  The partner computes the same K pairs in
  // reverse order, so after the sort both lanes hold the same list.
  __device__ __forceinline__ void merge_xor(int off) {
    float od[K];
    int oi[K];
#pragma unroll
    for (int m = 0; m < K; ++m) {
      od[m] = __shfl_xor_sync(kFull, d[m], off);
      oi[m] = __shfl_xor_sync(kFull, i[m], off);
    }
#pragma unroll
    for (int m = 0; m < K; ++m) {
      const bool mine = before(d[m], i[m], od[K - 1 - m], oi[K - 1 - m]);
      d[m] = mine ? d[m] : od[K - 1 - m];
      i[m] = mine ? i[m] : oi[K - 1 - m];
    }
    if constexpr (K == 2) exchange(0, 1);
    if constexpr (K == 3) {
      exchange(0, 1);
      exchange(1, 2);
      exchange(0, 1);
    }
  }
};

// The squared distance of target q (|q|^2 = qq) to staged source x (|x|^2
// in x.w): kChamfer picks K11's form, else K2's (notes above).
template <bool kChamfer>
__device__ __forceinline__ float distance(float q0, float q1, float q2,
                                          float qq, float4 x) {
  const float dot = __fadd_rn(__fadd_rn(__fmul_rn(q0, x.x), __fmul_rn(q1, x.y)),
                              __fmul_rn(q2, x.z));
  if (kChamfer) return __fmaf_rn(-2.0f, dot, __fadd_rn(qq, x.w));
  return __fadd_rn(__fmaf_rn(-2.0f, dot, qq), x.w);
}

// Targets tgt (B, N, 3) against sources src (B, S, 3).  K2 (kChamfer
// false) writes the first k of its K pairs to dist, idx (B, N, k); K11
// writes max(d, 0) and the index of its one pair to dist, idx (B, N).
template <int K, int L, int G, bool kChamfer>
__global__ void __launch_bounds__(kThreads)
nearest_kernel(const float* __restrict__ tgt, const float* __restrict__ src,
               int n, int s, int k, float* __restrict__ dist,
               int32_t* __restrict__ idx) {
  constexpr int kPerWarp = 32 / L * G;  // targets a warp
  __shared__ float4 tile[kTile];
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane % L;  // this lane's place in its group
  const int t0 = (blockIdx.x * kWarps + warp) * kPerWarp + lane / L * G;
  float q0[G], q1[G], q2[G], qq[G];
  TopK<K> top[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    q0[g] = q1[g] = q2[g] = 0.0f;  // a target past n: computed, not written
    if (t0 + g < n) {
      const float* p = tgt + ((size_t)b * n + t0 + g) * 3;
      q0[g] = p[0];
      q1[g] = p[1];
      q2[g] = p[2];
    }
    qq[g] = sq_norm(q0[g], q1[g], q2[g]);
    top[g].clear();
  }
  const float* cloud = src + (size_t)b * s * 3;
  for (int base = 0; base < s; base += kTile) {
    const int cnt = min(kTile, s - base);
    __syncthreads();  // the previous tile is no longer read
    for (int j = threadIdx.x; j < cnt; j += kThreads) {
      const float* p = cloud + (size_t)(base + j) * 3;
      const float a0 = p[0], a1 = p[1], a2 = p[2];
      tile[j] = make_float4(a0, a1, a2, sq_norm(a0, a1, a2));
    }
    __syncthreads();
#pragma unroll 4
    for (int j = sub; j < cnt; j += L) {
      const float4 x = tile[j];
#pragma unroll
      for (int g = 0; g < G; ++g)
        top[g].insert(distance<kChamfer>(q0[g], q1[g], q2[g], qq[g], x),
                      base + j);
    }
  }
#pragma unroll
  for (int off = 1; off < L; off <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) top[g].merge_xor(off);
  }
  // every lane of a group holds the group's lists; lane g % L writes target g
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int t = t0 + g;
    if (g % L != sub || t >= n) continue;
    const size_t row = (size_t)b * n + t;
    if (kChamfer) {
      dist[row] = fmaxf(top[g].d[0], 0.0f);
      idx[row] = top[g].i[0];
    } else {
#pragma unroll
      for (int m = 0; m < K; ++m) {
        if (m < k) {
          dist[row * k + m] = top[g].d[m];
          idx[row * k + m] = top[g].i[m];
        }
      }
    }
  }
}

using Kernel = void (*)(const float*, const float*, int, int, int, float*,
                        int32_t*);

// K2 takes one target a lane (its plan: each target's inserts would make
// the lane's others wait); K11, whose minimum is a select, 1, 2 or 4.
template <int K, int L, bool kChamfer>
Kernel pick_group(int group) {
  if (group == 1) return nearest_kernel<K, L, 1, kChamfer>;
  if constexpr (K == 1) {
    if (group == 2) return nearest_kernel<K, L, 2, kChamfer>;
    if (group == 4) return nearest_kernel<K, L, 4, kChamfer>;
  }
  return nullptr;
}

template <int K, bool kChamfer>
Kernel pick(int lanes, int group) {
  switch (lanes) {
    case 1: return pick_group<K, 1, kChamfer>(group);
    case 2: return pick_group<K, 2, kChamfer>(group);
    case 4: return pick_group<K, 4, kChamfer>(group);
    case 8: return pick_group<K, 8, kChamfer>(group);
    case 16: return pick_group<K, 16, kChamfer>(group);
    case 32: return pick_group<K, 32, kChamfer>(group);
    default: return nullptr;
  }
}

// Launches the scan of b clouds: `lanes` lanes a target (1-32, a power of
// two) and `group` targets a lane (K = 1: 1, 2 or 4; else 1), from the
// host plan.
template <int K, bool kChamfer>
cudaError_t launch(const float* tgt, const float* src, int b, int n, int s,
                   int k, int lanes, int group, float* dist, int32_t* idx,
                   cudaStream_t stream) {
  const Kernel kernel = pick<K, kChamfer>(lanes, group);
  if (kernel == nullptr || b > 65535) return cudaErrorInvalidValue;
  const long long per_block = (long long)kWarps * (32 / lanes) * group;
  const long long blocks = (n + per_block - 1) / per_block;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  kernel<<<dim3((unsigned)blocks, b), kThreads, 0, stream>>>(tgt, src, n, s, k,
                                                             dist, idx);
  return cudaGetLastError();
}

}  // namespace nearest

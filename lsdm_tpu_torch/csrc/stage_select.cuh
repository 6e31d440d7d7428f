// The selections of the fused stage kernels, shared by both modes of each:
// K7's ball query (sa_fused.cu, sa_fused_bf16.cu) and K8's 3-NN with its
// inverse-distance weights (fp_fused.cu, fp_fused_bf16.cu).  Both run in
// float32 in either mode, on the distance bits of pointdist.cuh, so the
// bf16 kernels select exactly the points the float32 kernels select.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "pointdist.cuh"

namespace stage_select {

constexpr float kEps = 1e-8f;

// x rounded to bf16 (nearest even, as torch and XLA round), as a float
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Ball query of the nq centres new_xyz[b, q0 ..] (a cloud of s centres) in
// the staged cloud of n points: one warp per centre, in index order, as in
// K1; four chunks of 32 points a step, their distances computed together.
// Row r of sel (nsample entries) gets the first nsample in-radius points,
// empty slots repeat the first, and an empty ball gathers point 0.
template <int kWarps>
__device__ __forceinline__ void ball_select(const float* cloud, int n,
                                            const float* __restrict__ new_xyz,
                                            int b, int s, int q0, int nq,
                                            float radius2, int nsample,
                                            int* sel) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;  // lanes below this one
  for (int r = warp; r < nq; r += kWarps) {
    const float* qp = new_xyz + ((size_t)b * s + q0 + r) * 3;
    const float a0 = qp[0], a1 = qp[1], a2 = qp[2];
    const float qq = sq_norm(a0, a1, a2);
    int* row = sel + r * nsample;
    int count = 0;   // warp-uniform
    int first = -1;  // warp-uniform
    for (int base = 0; base < n && count < nsample; base += 128) {
      bool in[4];
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int i = base + 32 * h + lane;
        in[h] = i < n && sq_dist(a0, a1, a2, qq, cloud[i], cloud[n + i],
                                 cloud[2 * n + i], cloud[3 * n + i]) <= radius2;
      }
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        if (count >= nsample) break;
        const unsigned mask = __ballot_sync(0xffffffffu, in[h]);
        if (mask == 0u) continue;
        if (first < 0) first = base + 32 * h + __ffs(mask) - 1;
        const int pos = count + __popc(mask & lower);
        if (in[h] && pos < nsample) row[pos] = base + 32 * h + lane;
        count += __popc(mask);
      }
    }
    const int fill = first < 0 ? 0 : first;  // an empty row gathers point 0
    for (int j = count + lane; j < nsample; j += 32) row[j] = fill;
  }
}

// A lane's three smallest (distance, index) of the sources it scanned, in
// ascending index order: strict < keeps the lower index of equal distances.
struct Top3 {
  float d0, d1, d2;
  int i0, i1, i2;
  __device__ void init(int s) {
    d0 = d1 = d2 = INFINITY;
    i0 = i1 = i2 = s;
  }
  __device__ void insert(float d, int j) {
    if (d < d2) {
      if (d < d1) {
        d2 = d1; i2 = i1;
        if (d < d0) {
          d1 = d0; i1 = i0;
          d0 = d; i0 = j;
        } else {
          d1 = d; i1 = j;
        }
      } else {
        d2 = d; i2 = j;
      }
    }
  }
};

// k rounds of the warp's smallest (distance, index) head, popped from the
// lane that holds it (the same selection as K2's in-order scan); lane 0
// writes target r's inverse-distance weights (kBf16: rounded to bf16) and
// indices.
template <bool kBf16>
__device__ void nn_weights(Top3& t, int k, int s, int lane, int r,
                           float* nn_w, int* nn_i) {
  float dk[3];
  int ik[3];
  for (int kk = 0; kk < k; ++kk) {
    float md = t.d0;
    int mi = t.i0;
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, md, off);
      const int oi = __shfl_xor_sync(0xffffffffu, mi, off);
      if (od < md || (od == md && oi < mi)) {
        md = od;
        mi = oi;
      }
    }
    if (t.i0 == mi) {
      t.d0 = t.d1; t.i0 = t.i1;
      t.d1 = t.d2; t.i1 = t.i2;
      t.d2 = INFINITY; t.i2 = s;
    }
    dk[kk] = md;
    ik[kk] = mi < s ? mi : s - 1;  // (only NaN distances leave none)
  }
  if (lane == 0) {
    float rc[3];
    float norm = 0.0f;
    for (int kk = 0; kk < k; ++kk) {
      rc[kk] = __fdiv_rn(1.0f, __fadd_rn(dk[kk], kEps));
      norm = kk == 0 ? rc[0] : __fadd_rn(norm, rc[kk]);
    }
    for (int kk = 0; kk < k; ++kk) {
      const float wk = __fdiv_rn(rc[kk], norm);
      nn_w[3 * r + kk] = kBf16 ? bf16r(wk) : wk;
      nn_i[3 * r + kk] = ik[kk];
    }
  }
}

// 3-NN of the nr targets xyz1[b, n0 ..] (a cloud of n targets) among the s
// staged sources: one warp per pair of targets (r, r + kWarps), which share
// the loads of the sources and run two independent insertion chains; each
// lane keeps the three smallest of its strided share, then nn_weights
// merges them.  Target r's k weights and indices go to nn_w / nn_i[3 r ..].
template <bool kBf16, int kWarps>
__device__ __forceinline__ void nearest3(const float* cloud, int s, int k,
                                         const float* __restrict__ xyz1,
                                         int b, int n, int n0, int nr,
                                         float* nn_w, int* nn_i) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < nr; r += 2 * kWarps) {
    const int r2 = r + kWarps;
    const bool two = r2 < nr;  // warp-uniform
    const float* qa = xyz1 + ((size_t)b * n + n0 + r) * 3;
    const float* qb = two ? qa + 3 * kWarps : qa;
    const float a0 = qa[0], a1 = qa[1], a2 = qa[2], aa = sq_norm(a0, a1, a2);
    const float b0 = qb[0], b1 = qb[1], b2 = qb[2], bb = sq_norm(b0, b1, b2);
    Top3 ta, tb;
    ta.init(s);
    tb.init(s);
    for (int j = lane; j < s; j += 32) {
      const float x = cloud[j], y = cloud[s + j], z = cloud[2 * s + j],
                  w = cloud[3 * s + j];
      ta.insert(sq_dist(a0, a1, a2, aa, x, y, z, w), j);
      if (two) tb.insert(sq_dist(b0, b1, b2, bb, x, y, z, w), j);
    }
    nn_weights<kBf16>(ta, k, s, lane, r, nn_w, nn_i);
    if (two) nn_weights<kBf16>(tb, k, s, lane, r2, nn_w, nn_i);
  }
}

}  // namespace stage_select

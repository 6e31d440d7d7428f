// Fused eval-mode FeaturePropagation stage (K8) for Hopper.
//
// Replaces lsdm_tpu/ops/fp_fused_pallas.py:fp_stage_fused.  Plain version:
// lsdm_tpu_torch/ops/fp_fused.py:fp_stage_fused_plain.
//
// For each target point: its k = min(3, S) nearest sources (the K2 rule:
// distances of pointdist.cuh, ties to the lowest index), inverse-distance
// weights r_i = 1 / (d_i + 1e-8), w_i = r_i / ((r_0 + r_1) + r_2), the
// interpolation sum_i w_i * points2[idx_i], concatenated after the
// target's own features points1 when there are any, then the stage's
// layers (BatchNorm folded) each with its activation: ReLU, or none for a
// trailing Linear such as the backbone's conv2, which rides fp1's launch
// together with the head.  The (N, k, C) gathered tensor of the composed
// path never exists.
//
// What bounds it on an H100: the layers' float32 FMAs (2.1 GFLOP at fp2
// and 1.2 at fp1 with the head, batch 1).  A block takes `rows` targets:
// the source cloud staged in shared memory, one warp per target for the
// 3-NN (each lane keeps the three smallest of its strided share of the
// sources, then three rounds of a warp-wide (distance, index) minimum
// merge them, which is the same selection as K2's in-order scan), then
// the input rows built in shared memory and carried through the layers
// (rowmlp.cuh); the last layer writes device memory.  `rows` is 32, or 16
// where the input rows are wide (fp4: 256 + 512 channels).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pointdist.cuh"
#include "rowmlp.cuh"

namespace {

constexpr int kMaxRows = 32;
constexpr float kEps = 1e-8f;

size_t fp_smem(int rows, int ld, int s, int* mcap) {
  *mcap = (rows + kRowChunk - 1) / kRowChunk * kRowChunk;
  return sizeof(float) * (2 * (size_t)(*mcap) * ld + 4 * (size_t)s) +
         (sizeof(float) + sizeof(int)) * 3 * (size_t)rows;
}

__global__ void __launch_bounds__(kMlpThreads)
fp_fused_kernel(const float* __restrict__ xyz1, const float* __restrict__ xyz2,
                const float* __restrict__ p1, const float* __restrict__ p2,
                MlpLayers layers, int n, int s, int k, int d1, int d2, int ld,
                int rows, int mcap, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* buf0 = reinterpret_cast<float*>(smem4);
  float* buf1 = buf0 + (size_t)mcap * ld;
  float* cloud = buf1 + (size_t)mcap * ld;
  float* nn_w = cloud + 4 * s;
  int* nn_i = reinterpret_cast<int*>(nn_w + 3 * rows);

  const int b = blockIdx.y;
  const int n0 = blockIdx.x * rows;
  const int nr = min(rows, n - n0);
  stage_cloud(xyz2 + (size_t)b * s * 3, s, cloud);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < nr; r += kMlpWarps) {
    const float* qp = xyz1 + ((size_t)b * n + n0 + r) * 3;
    const float a0 = qp[0], a1 = qp[1], a2 = qp[2];
    const float qq = sq_norm(a0, a1, a2);
    // this lane's three smallest of sources lane, lane + 32, ...; strict <
    // keeps the lower index of equal distances
    float bd0 = INFINITY, bd1 = INFINITY, bd2 = INFINITY;
    int bi0 = s, bi1 = s, bi2 = s;
    for (int j = lane; j < s; j += 32) {
      const float d = sq_dist(a0, a1, a2, qq, cloud[j], cloud[s + j],
                              cloud[2 * s + j], cloud[3 * s + j]);
      if (d < bd2) {
        if (d < bd1) {
          bd2 = bd1; bi2 = bi1;
          if (d < bd0) {
            bd1 = bd0; bi1 = bi0;
            bd0 = d; bi0 = j;
          } else {
            bd1 = d; bi1 = j;
          }
        } else {
          bd2 = d; bi2 = j;
        }
      }
    }
    // k rounds: the warp's smallest (distance, index) head; its lane pops it
    float dk[3];
    int ik[3];
    for (int kk = 0; kk < k; ++kk) {
      float md = bd0;
      int mi = bi0;
      for (int off = 16; off > 0; off >>= 1) {
        const float od = __shfl_xor_sync(0xffffffffu, md, off);
        const int oi = __shfl_xor_sync(0xffffffffu, mi, off);
        if (od < md || (od == md && oi < mi)) {
          md = od;
          mi = oi;
        }
      }
      if (bi0 == mi) {
        bd0 = bd1; bi0 = bi1;
        bd1 = bd2; bi1 = bi2;
        bd2 = INFINITY; bi2 = s;
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
        nn_w[3 * r + kk] = __fdiv_rn(rc[kk], norm);
        nn_i[3 * r + kk] = ik[kk];
      }
    }
  }
  __syncthreads();

  // input rows [points1, sum_i w_i * points2[idx_i]], summed in order i
  const int f0 = d1 + d2;
  for (int e = threadIdx.x; e < nr * f0; e += kMlpThreads) {
    const int r = e / f0, c = e - r * f0;
    float v;
    if (c < d1) {
      v = p1[((size_t)b * n + n0 + r) * d1 + c];
    } else {
      const float* src = p2 + (size_t)b * s * d2 + (c - d1);
      v = __fmul_rn(nn_w[3 * r], src[(size_t)nn_i[3 * r] * d2]);
      for (int kk = 1; kk < k; ++kk)
        v = __fadd_rn(v, __fmul_rn(nn_w[3 * r + kk],
                                   src[(size_t)nn_i[3 * r + kk] * d2]));
    }
    buf0[(size_t)r * ld + c] = v;
  }
  __syncthreads();

  float* cur = buf0;
  float* nxt = buf1;
  int width = f0;
  for (int l = 0; l + 1 < layers.n; ++l) {
    dense_rows(cur, ld, width, layers.w[l], layers.b[l], layers.fout[l],
               layers.relu[l], nxt, ld, nr);
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
    width = layers.fout[l];
  }
  const int l = layers.n - 1;
  dense_rows(cur, ld, width, layers.w[l], layers.b[l], layers.fout[l],
             layers.relu[l], out + ((size_t)b * n + n0) * layers.fout[l],
             layers.fout[l], nr);
}

}  // namespace

extern "C" {

// xyz1 (B, N, 3) targets, xyz2 (B, S, 3) sources, p1 (B, N, D1) or null
// (D1 = 0), p2 (B, S, D2); params = {W1', b1', ..., WL', bL'} with Wl'
// (F_{l-1}, F_l), F_0 = D1 + D2; widths = {F_1, ..., F_L}; relu[l] = 1
// for a ReLU after layer l, 0 for none.  -> out (B, N, F_L), float32.
int lsdm_fp_fused(const float* xyz1, const float* xyz2, const float* p1,
                  const float* p2, const float* const* params,
                  const int* widths, const int* relu, int n_layers, int b,
                  int n, int s, int d1, int d2, float* out, void* stream) {
  if (b <= 0 || n <= 0) return 0;
  if (n_layers < 1 || n_layers > kMaxLayers || s < 1 || d2 < 1 || d1 < 0 ||
      (d1 > 0 && p1 == nullptr))
    return (int)cudaErrorInvalidValue;
  MlpLayers layers = {};
  layers.n = n_layers;
  int ld = d1 + d2;  // the stored widths: the input and layers 1..L-1
  for (int l = 0; l < n_layers; ++l) {
    layers.w[l] = params[2 * l];
    layers.b[l] = params[2 * l + 1];
    layers.fout[l] = widths[l];
    layers.relu[l] = relu[l];
    if (l + 1 < n_layers && widths[l] > ld) ld = widths[l];
  }
  ld = pad4(ld);
  int rows = kMaxRows < n ? kMaxRows : n;
  int mcap;
  size_t smem = fp_smem(rows, ld, s, &mcap);
  while (rows > 1 && smem > kSmemBudget) {
    rows = rows > kRowChunk ? rows - kRowChunk : rows / 2;
    smem = fp_smem(rows, ld, s, &mcap);
  }
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fp_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int k = s < 3 ? s : 3;
  const dim3 grid((n + rows - 1) / rows, b);
  fp_fused_kernel<<<grid, kMlpThreads, smem, (cudaStream_t)stream>>>(
      xyz1, xyz2, p1, p2, layers, n, s, k, d1, d2, ld, rows, mcap, out);
  return (int)cudaGetLastError();
}

}  // extern "C"

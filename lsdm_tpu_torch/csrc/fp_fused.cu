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
// and 1.2 at fp1 with the head, batch 1).  A cluster of plan.cluster
// blocks takes plan.rows targets of one cloud: each block stages the
// source cloud in shared memory, runs the 3-NN (one warp per pair of
// targets, two independent chains on the same loads: each lane keeps the
// three smallest of its strided share of the sources, then three rounds of
// a warp-wide (distance, index) minimum merge them, which is the same
// selection as K2's in-order scan) and builds the input rows
// channel-major in shared memory, then computes its column slice of every
// layer with the register-tiled engine of rowmlp.cuh, passing each layer's
// slice to its peers through DSMEM; the last layer writes device memory.
// The plan (rows, cluster, tiles, layout) comes from
// lsdm_tpu_torch/ops/rowmlp.py:plan_fp.
//
// The bf16 mode (lsdm_fp_fused_bf16) is its own design on the bf16 tensor
// cores, fp_fused_bf16.cu; the 3-NN is shared (stage_select.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include "pointdist.cuh"
#include "rowmlp.cuh"
#include "stage_select.cuh"

namespace {

using namespace rowmlp;

__global__ void __launch_bounds__(kThreads, 2)
fp_fused_kernel(const float* __restrict__ xyz1, const float* __restrict__ xyz2,
                const float* __restrict__ p1, const float* __restrict__ p2,
                Layers layers, Plan p, int n, int s, int k, int d1, int d2,
                float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const int ldm = p.ldm;
  float* buf0 = reinterpret_cast<float*>(smem4);
  float* buf1 = buf0 + (size_t)p.cap0 * ldm;
  float* ring = buf1 + (size_t)p.cap1 * ldm;
  float* cloud = ring + p.ring + p.red;
  float* nn_w = cloud + 4 * s;
  int* nn_i = reinterpret_cast<int*>(nn_w + 3 * p.rows);

  const int C = p.cluster;
  const int rank = blockIdx.x % C;  // the cluster spans C blocks along x
  const int b = blockIdx.y;
  const int n0 = blockIdx.x / C * p.rows;
  const int nr = min(p.rows, n - n0);
  stage_cloud(xyz2 + (size_t)b * s * 3, s, cloud);
  __syncthreads();

  stage_select::nearest3<false, kThreads / 32>(cloud, s, k, xyz1, b, n, n0, nr,
                                               nn_w, nn_i);
  __syncthreads();

  // input rows [points1, sum_i w_i * points2[idx_i]] into buffer 0,
  // channel-major, summed in order i
  const int f0 = d1 + d2;
  if ((d1 & 3) == 0 && (d2 & 3) == 0 && aligned16(p1) && aligned16(p2)) {
    // four channels a load: a group never straddles points1 | interpolation
    fill_rows4(buf0, ldm, nr, f0, [&](int r, int c) {
      if (c < d1) return load4(p1 + ((size_t)b * n + n0 + r) * d1 + c);
      const float* src = p2 + (size_t)b * s * d2 + (c - d1);
      float4 v = load4(src + (size_t)nn_i[3 * r] * d2);
      const float w0 = nn_w[3 * r];
      v = make_float4(__fmul_rn(w0, v.x), __fmul_rn(w0, v.y),
                      __fmul_rn(w0, v.z), __fmul_rn(w0, v.w));
      for (int kk = 1; kk < k; ++kk) {
        const float4 x = load4(src + (size_t)nn_i[3 * r + kk] * d2);
        const float w = nn_w[3 * r + kk];
        v = make_float4(__fadd_rn(v.x, __fmul_rn(w, x.x)),
                        __fadd_rn(v.y, __fmul_rn(w, x.y)),
                        __fadd_rn(v.z, __fmul_rn(w, x.z)),
                        __fadd_rn(v.w, __fmul_rn(w, x.w)));
      }
      return v;
    });
  } else {
    fill_rows(buf0, ldm, nr, f0, [&](int r, int c) {
      if (c < d1) return p1[((size_t)b * n + n0 + r) * d1 + c];
      const float* src = p2 + (size_t)b * s * d2 + (c - d1);
      float v = __fmul_rn(nn_w[3 * r], src[(size_t)nn_i[3 * r] * d2]);
      for (int kk = 1; kk < k; ++kk)
        v = __fadd_rn(v, __fmul_rn(nn_w[3 * r + kk],
                                   src[(size_t)nn_i[3 * r + kk] * d2]));
      return v;
    });
  }
  // every block of the cluster runs before a peer writes into it
  layer_barrier(C);

  float* cur = buf0;
  float* nxt = buf1;
  for (int l = 0; l + 1 < layers.n; ++l) {
    int lo, hi;
    col_slice(layers.fout[l], C, rank, &lo, &hi);
    dense_layer(p.tile[l], cur, ldm, nr, layers.w[l], layers.b[l],
                layers.fin[l], layers.fout[l], layers.relu[l], lo, hi, ring,
                shared_sink(nxt, C));
    layer_barrier(C);
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  const int l = layers.n - 1;
  int lo, hi;
  col_slice(layers.fout[l], C, rank, &lo, &hi);
  Sink sink = {};
  sink.mode = kToGlobal;
  sink.out = out + ((size_t)b * n + n0) * layers.fout[l];
  sink.ldo = layers.fout[l];
  dense_layer(p.tile[l], cur, ldm, nr, layers.w[l], layers.b[l],
              layers.fin[l], layers.fout[l], layers.relu[l], lo, hi, ring,
              sink);
}

}  // namespace

extern "C" {

// xyz1 (B, N, 3) targets, xyz2 (B, S, 3) sources, p1 (B, N, D1) or null
// (D1 = 0), p2 (B, S, D2); params = {W1', b1', ..., WL', bL'} with Wl'
// (F_{l-1}, F_l), F_0 = D1 + D2; widths = {F_1, ..., F_L}; relu[l] = 1
// for a ReLU after layer l, 0 for none; plan =
// ops/rowmlp.py:plan_fp(...).ints().  -> out (B, N, F_L), float32.
// Returns cudaErrorInvalidValue for a plan that cannot carry these shapes.
int lsdm_fp_fused(const float* xyz1, const float* xyz2, const float* p1,
                  const float* p2, const float* const* params,
                  const int* widths, const int* relu, int n_layers, int b,
                  int n, int s, int d1, int d2, const int* plan, float* out,
                  void* stream) {
  if (b <= 0 || n <= 0) return 0;
  if (n_layers < 1 || n_layers > kMaxLayers || s < 1 || d2 < 1 || d1 < 0 ||
      (d1 > 0 && p1 == nullptr))
    return (int)cudaErrorInvalidValue;
  Layers layers = {};
  layers.n = n_layers;
  for (int l = 0; l < n_layers; ++l) {
    layers.w[l] = params[2 * l];
    layers.b[l] = params[2 * l + 1];
    layers.fin[l] = l == 0 ? d1 + d2 : widths[l - 1];
    layers.fout[l] = widths[l];
    layers.relu[l] = relu[l];
  }
  Plan p = {};
  p.rows = plan[0], p.cluster = plan[1], p.ldm = plan[2], p.cap0 = plan[3];
  p.cap1 = plan[4], p.ring = plan[5], p.red = plan[6], p.smem = plan[7];
  for (int l = 0; l < layers.n; ++l) p.tile[l] = plan[8 + l];
  // the sources (x, y, z, |p|^2), then the 3-NN weights and indices
  const long long extra = 4LL * s + 6LL * p.rows;
  if (p.rows > 4096 || !plan_ok(p, layers, p.rows, d1 + d2, 0, extra))
    return (int)cudaErrorInvalidValue;
  const int k = s < 3 ? s : 3;
  const dim3 grid((n + p.rows - 1) / p.rows * p.cluster, b);
  return (int)launch(fp_fused_kernel, grid, p, (cudaStream_t)stream, xyz1,
                     xyz2, p1, p2, layers, p, n, s, k, d1, d2, out);
}

}  // extern "C"

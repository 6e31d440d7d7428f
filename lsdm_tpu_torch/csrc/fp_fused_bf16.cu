// Fused eval-mode FeaturePropagation stage (K8) in the bf16 mode, on the
// bf16 tensor cores.
//
// Replaces, at compute_dtype=bfloat16, lsdm_tpu/ops/fp_fused_pallas.py:
// fp_stage_fused (:32-89, :146).  Plain version: lsdm_tpu_torch/ops/
// fp_fused.py:fp_stage_fused_plain(..., compute_dtype=torch.bfloat16).  The
// float32 mode is fp_fused.cu.  For each target point: its k = min(3, S)
// nearest sources in float32 (stage_select.cuh, K2's rule: ties to the
// lowest index), r_i = 1 / (d_i + 1e-8), w_i = bf16(r_i / ((r_0 + r_1) +
// r_2)), the interpolation bf16(sum_i w_i * points2[idx_i]) summed in
// float32, the layer input [points1, interpolation] (points1 and points2
// bf16), then the stage's layers, each bf16(act(h @ bf16(W') + b')) with
// act ReLU or none (fp1 carries the backbone's head and conv2 as two more
// layers); a bf16 output.
//
// What bounds it on an H100: its products, ~4.4 GFLOP over fp4-fp1 at 9
// clouds, 4.5 us at the 989 TFLOP/s of the bf16 tensor cores; the float32
// prologue (staging, 3-NN, gather) is the rest, and what the design
// leaves.  A block of 8 warps takes plan.rows targets of one cloud
// (ops/rowmlp.py:plan_fp_bf16): while the first weight chunks stream into
// the ring it stages the sources and runs the 3-NN, gathers the input rows
// as bf16 rows in shared memory, then carries them through the layers on
// the engine of rowmma.cuh (mma.sync); the last layer writes device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pointdist.cuh"
#include "rowmma.cuh"
#include "stage_select.cuh"

namespace {

using namespace rowmma;

template <int MT>
__global__ void __launch_bounds__(kThreads, 2)
fp_bf16_kernel(const float* __restrict__ xyz1, const float* __restrict__ xyz2,
               const bf16* __restrict__ p1, const bf16* __restrict__ p2, const Layers L,
               const Plan p, int n, int s, int k, int d1, int d2, bf16* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rp = rows_pad(p);
  bf16* buf0 = reinterpret_cast<bf16*>(smem + ring_bytes(p, L));
  bf16* buf1 = buf0 + (size_t)rp * p.ld0;
  float* cloud = reinterpret_cast<float*>(buf1 + (size_t)rp * p.ld1);
  float* nn_w = cloud + 4 * s;
  int* nn_i = reinterpret_cast<int*>(nn_w + round4(3 * p.rows));

  const int b = blockIdx.y, n0 = blockIdx.x * p.rows;
  const int nr = min(p.rows, n - n0);
  Ring ring{reinterpret_cast<bf16*>(smem), L, p.kc, p.passes};
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    ring.fill();
    copy_commit();
  }
  stage_cloud(xyz2 + (size_t)b * s * 3, s, cloud);
  __syncthreads();
  stage_select::nearest3<true, kWarps>(cloud, s, k, xyz1, b, n, n0, nr, nn_w, nn_i);
  __syncthreads();

  // the input rows [points1, sum_i w_i * points2[idx_i]] into buffer 0 as
  // bf16 rows, the sum in order i, eight channels a 16-byte load where the
  // widths allow (a piece then never straddles points1 | interpolation)
  const int f0 = d1 + d2;
  const bool vec = (d1 & 7) == 0 && (d2 & 7) == 0 && aligned16(p1) && aligned16(p2);
  const bf16* p1b = p1 + ((size_t)b * n + n0) * d1;
  const bf16* p2b = p2 + (size_t)b * s * d2;
  fill_rows(buf0, p.ld0, nr, rp, f0, [&](int r, int c0, float(&x)[8]) {
    const int* idx = nn_i + 3 * r;
    const float* w = nn_w + 3 * r;
    if (vec) {
      if (c0 < d1) {
        load8(p1b + (size_t)r * d1 + c0, x);
        return;
      }
      float y[8];
      load8(p2b + (size_t)idx[0] * d2 + (c0 - d1), y);
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = __fmul_rn(w[0], y[i]);
      for (int kk = 1; kk < k; ++kk) {
        load8(p2b + (size_t)idx[kk] * d2 + (c0 - d1), y);
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] = __fadd_rn(x[i], __fmul_rn(w[kk], y[i]));
      }
      return;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = c0 + i;
      if (c >= f0) break;
      if (c < d1) {
        x[i] = __bfloat162float(p1b[(size_t)r * d1 + c]);
        continue;
      }
      const bf16* src = p2b + (c - d1);
      float v = __fmul_rn(w[0], __bfloat162float(src[(size_t)idx[0] * d2]));
      for (int kk = 1; kk < k; ++kk)
        v = __fadd_rn(v, __fmul_rn(w[kk], __bfloat162float(src[(size_t)idx[kk] * d2])));
      x[i] = v;
    }
  });
  __syncthreads();

  bf16* cur = buf0;
  bf16* nxt = buf1;
  int ldc = p.ld0, ldn = p.ld1, g = 0;
  for (int l = 0; l + 1 < L.n; ++l) {
    run_layer<MT>(ring, g, L, l, cur, ldc, p, [&](auto& c, int row0, int c0, int nj) {
      store_rows(c, L.b[l], L.fout[l], L.relu[l], nxt, ldn, row0, c0, nj);
    });
    bf16* t = cur;
    cur = nxt, nxt = t;
    const int u = ldc;
    ldc = ldn, ldn = u;
  }
  const int l = L.n - 1;
  bf16* dst = out + ((size_t)b * n + n0) * L.fout[l];
  run_layer<MT>(ring, g, L, l, cur, ldc, p, [&](auto& c, int row0, int c0, int nj) {
    store_global(c, L.b[l], L.fout[l], L.relu[l], dst, nr, row0, c0, nj);
  });
}

}  // namespace

extern "C" {

// The bf16 mode of lsdm_fp_fused: xyz1 (B, N, 3) targets, xyz2 (B, S, 3)
// sources, float32; p1 (B, N, D1) or null (D1 = 0), p2 (B, S, D2), bf16;
// params = {W1', b1', ..., WL', bL'} with Wl' the bf16 (round16(F_l),
// round16(F_{l-1})) rows of W'^T, zero-padded (ops/rowmlp.py:Bf16Operands),
// F_0 = D1 + D2, and bl' (F_l,) float32; widths = {F_1, ..., F_L}; relu[l]
// = 1 for a ReLU after layer l, 0 for none; plan =
// ops/rowmlp.py:plan_fp_bf16(...).ints().  -> out (B, N, F_L) bf16.
// Returns cudaErrorInvalidValue for a plan that cannot carry these shapes.
int lsdm_fp_fused_bf16(const float* xyz1, const float* xyz2, const bf16* p1,
                       const bf16* p2, const void* const* params, const int* widths,
                       const int* relu, int n_layers, int b, int n, int s, int d1, int d2,
                       const int* plan, bf16* out, void* stream) {
  if (b <= 0 || n <= 0) return 0;
  if (n_layers < 1 || n_layers > kMaxLayers || s < 1 || d2 < 1 || d1 < 0 ||
      (d1 > 0 && p1 == nullptr))
    return (int)cudaErrorInvalidValue;
  Layers L = {};
  L.n = n_layers;
  for (int l = 0; l < n_layers; ++l) {
    L.w[l] = static_cast<const bf16*>(params[2 * l]);
    L.b[l] = static_cast<const float*>(params[2 * l + 1]);
    L.fin[l] = l == 0 ? d1 + d2 : widths[l - 1];
    L.fout[l] = widths[l];
    L.relu[l] = relu[l];
  }
  const Plan p = read_plan(plan);
  // the sources (x, y, z, |p|^2), then the 3-NN weights and indices
  const long long extra = 4LL * s + 2LL * round4(3 * p.rows);
  if (p.rows > 4096 || p.red != 0 || !plan_ok(p, L, p.rows, d1 + d2, extra))
    return (int)cudaErrorInvalidValue;
  const int k = s < 3 ? s : 3;
  const dim3 grid((n + p.rows - 1) / p.rows, b);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FP_BF16_LAUNCH(MT)                                                         \
  case MT:                                                                         \
    return (int)launch(fp_bf16_kernel<MT>, grid, p, st, xyz1, xyz2, p1, p2, L, p, n, \
                       s, k, d1, d2, out);
  switch (p.mt) {
    FP_BF16_LAUNCH(2)
    FP_BF16_LAUNCH(4)
    FP_BF16_LAUNCH(8)
    FP_BF16_LAUNCH(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FP_BF16_LAUNCH
}

}  // extern "C"

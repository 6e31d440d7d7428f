// Fused eval-mode SetAbstraction stage (K7) in the bf16 mode, on the bf16
// tensor cores.
//
// Replaces, at compute_dtype=bfloat16, lsdm_tpu/ops/sa_fused_pallas.py:
// sa_stage_fused (:61-129, :158-162, :187).  Plain version:
// lsdm_tpu_torch/ops/sa_fused.py:sa_stage_fused_plain(..., compute_dtype=
// torch.bfloat16).  The float32 mode is sa_fused.cu.  For each centre q of
// a cloud, the ball query on the float32 centres (stage_select.cuh, K1's
// rule; an empty ball gathers point 0), then per selected point p
//   h1 = bf16(relu(Z1[p] - bf16(q) . W1'[:3]))    Z1 = bf16(bf16(base) @
//                                                  bf16(W1') + b1') comes in
//   h  = bf16(relu(h @ bf16(W') + b'))            layers 2..L, float32 sums
// and the output, bf16, is the max of h over the nsample points.
//
// What bounds it on an H100: layers 2..L are 7.25 GFLOP over the four
// flagship stages at 9 clouds, 7.3 us at the 989 TFLOP/s of the bf16
// tensor cores; the float32 prologue (staging, ball query, gather) is the
// rest, and what the design leaves.  A block of 8 warps takes plan.rows
// centres of one cloud (ops/rowmlp.py:plan_sa_bf16): while the first
// weight chunks stream into the ring it stages the cloud, computes the
// centre terms and runs the ball query, gathers h1 for its rows x nsample
// rows into bf16 rows in shared memory, then carries them through layers
// 2..L on the engine of rowmma.cuh (mma.sync).  Layer L goes straight into
// the max: where nsample is a power of two up to 32 (the flagship's 32 is
// two m16 tiles) a warp's 32 rows hold whole centres, so the max is taken
// in registers and shuffles and each output is stored once, with no
// atomics; any other nsample takes a shared atomicMax on the bits of the
// non-negative ReLU outputs, exact because rounding is monotone.  A one-
// layer MLP stores the max of layer 1.

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
sa_bf16_kernel(const float* __restrict__ xyz, const float* __restrict__ new_xyz,
               const bf16* __restrict__ z1, const float* __restrict__ w1x, const Layers L,
               const Plan p, int n, int s, int f1, float radius2, int nsample,
               bf16* __restrict__ out, int f_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rp = rows_pad(p);
  bf16* buf0 = reinterpret_cast<bf16*>(smem + ring_bytes(p, L));
  bf16* buf1 = buf0 + (size_t)rp * p.ld0;
  float* cloud = reinterpret_cast<float*>(buf1 + (size_t)rp * p.ld1);
  float* cterm = cloud + 4 * n;
  int* red = reinterpret_cast<int*>(cterm + round4(p.rows * f1));
  int* sel = red + round4(p.red);

  const int b = blockIdx.y, q0 = blockIdx.x * p.rows;
  const int nq = min(p.rows, s - q0), m = nq * nsample;
  Ring ring{reinterpret_cast<bf16*>(smem), L, p.kc, p.passes};
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    ring.fill();
    copy_commit();
  }
  stage_cloud(xyz + (size_t)b * n * 3, n, cloud);
  // the centre terms bf16(q) . W1'[:3] in the order (q0 w0 + q1 w1) + q2 w2
  // (w1x is bf16-exact, so the products are exact)
  for (int e = threadIdx.x; e < nq * f1; e += kThreads) {
    const int g = e / f1, f = e - g * f1;
    const float* qp = new_xyz + ((size_t)b * s + q0 + g) * 3;
    cterm[e] = __fadd_rn(
        __fadd_rn(__fmul_rn(stage_select::bf16r(qp[0]), w1x[f]),
                  __fmul_rn(stage_select::bf16r(qp[1]), w1x[f1 + f])),
        __fmul_rn(stage_select::bf16r(qp[2]), w1x[2 * f1 + f]));
  }
  for (int e = threadIdx.x; e < p.red; e += kThreads) red[e] = 0;
  __syncthreads();
  stage_select::ball_select<kWarps>(cloud, n, new_xyz, b, s, q0, nq, radius2,
                                    nsample, sel);
  __syncthreads();

  // layer 1 into buffer 0 as bf16 rows, eight channels a 16-byte load of Z1
  // where its rows allow
  const bf16* z1b = z1 + (size_t)b * n * f1;
  const bool vec = (f1 & 7) == 0 && aligned16(z1);
  fill_rows(buf0, p.ld0, m, rp, f1, [&](int r, int c0, float(&x)[8]) {
    const float* ct = cterm + (r / nsample) * f1 + c0;
    const bf16* zr = z1b + (size_t)sel[r] * f1 + c0;
    if (vec) {
      float zv[8];
      load8(zr, zv);
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = fmaxf(__fsub_rn(zv[i], ct[i]), 0.0f);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (c0 + i < f1) x[i] = fmaxf(__fsub_rn(__bfloat162float(zr[i]), ct[i]), 0.0f);
    }
  });
  __syncthreads();

  // layers 2..L-1, each into the other buffer
  bf16* cur = buf0;
  bf16* nxt = buf1;
  int ldc = p.ld0, ldn = p.ld1, g = 0;
  for (int l = 0; l + 1 < L.n; ++l) {
    run_layer<MT>(ring, g, L, l, cur, ldc, p, [&](auto& c, int row0, int c0, int nj) {
      store_rows(c, L.b[l], L.fout[l], 1, nxt, ldn, row0, c0, nj);
    });
    bf16* t = cur;
    cur = nxt, nxt = t;
    const int u = ldc;
    ldc = ldn, ldn = u;
  }

  bf16* dst = out + ((size_t)b * s + q0) * f_out;
  if (L.n > 0) {  // layer L straight into the max over each centre
    const int l = L.n - 1;
    const bool regs = nsample <= 32 && (nsample & (nsample - 1)) == 0;
    run_layer<MT>(ring, g, L, l, cur, ldc, p, [&](auto& c, int row0, int c0, int nj) {
      if (regs)
        store_max(c, L.b[l], f_out, dst, f_out, nq, nsample, row0, c0, nj);
      else
        store_atomic(c, L.b[l], f_out, red, m, nsample, row0, c0, nj);
    });
    if (!regs) {
      __syncthreads();
      for (int e = threadIdx.x; e < nq * f_out; e += kThreads)
        dst[e] = __float2bfloat16_rn(__int_as_float(red[e]));
    }
  } else {  // a one-layer MLP: the max of layer 1
    for (int e = threadIdx.x; e < nq * f_out; e += kThreads) {
      const int q = e / f_out, j = e - q * f_out;
      float best = 0.0f;
      for (int k = 0; k < nsample; ++k)
        best = fmaxf(best, __bfloat162float(cur[(size_t)(q * nsample + k) * ldc + j]));
      dst[e] = __float2bfloat16_rn(best);
    }
  }
}

}  // namespace

extern "C" {

// The bf16 mode of lsdm_sa_fused: xyz (B, N, 3), new_xyz (B, S, 3) float32;
// z1 (B, N, F1) = bf16(bf16(base) @ bf16(W1') + b1') bf16; w1x (3, F1) =
// W1'[:3] rounded to bf16 (float32); params = {W2', b2', ..., WL', bL'}
// with Wl' the bf16 (round16(F_l), round16(F_{l-1})) rows of W'^T, zero-
// padded (ops/rowmlp.py:Bf16Operands), and bl' (F_l,) float32; widths =
// {F1, ..., FL}; n_layers = L; plan = ops/rowmlp.py:plan_sa_bf16(...).ints().
// -> out (B, S, FL) bf16.  Returns cudaErrorInvalidValue for a plan that
// cannot carry these shapes.
int lsdm_sa_fused_bf16(const float* xyz, const float* new_xyz, const bf16* z1,
                       const float* w1x, const void* const* params, const int* widths,
                       int n_layers, int b, int n, int s, float radius2, int nsample,
                       const int* plan, bf16* out, void* stream) {
  if (b <= 0 || s <= 0) return 0;
  if (n_layers < 1 || n_layers - 1 > kMaxLayers || nsample < 1 || n < 1)
    return (int)cudaErrorInvalidValue;
  Layers L = {};
  L.n = n_layers - 1;
  for (int l = 0; l < L.n; ++l) {
    L.w[l] = static_cast<const bf16*>(params[2 * l]);
    L.b[l] = static_cast<const float*>(params[2 * l + 1]);
    L.fin[l] = widths[l];
    L.fout[l] = widths[l + 1];
    L.relu[l] = 1;
  }
  const Plan p = read_plan(plan);
  const int f1 = widths[0], f_out = widths[n_layers - 1];
  const bool regs = nsample <= 32 && (nsample & (nsample - 1)) == 0;
  // the cloud (x, y, z, |p|^2), the centre terms, the max's partial
  // results, the selection
  const long long extra = 4LL * n + round4(p.rows * f1) + round4(p.red) +
                          round4(p.rows * nsample);
  if (p.rows > 4096 || !plan_ok(p, L, p.rows * nsample, f1, extra) ||
      p.red < (L.n > 0 && !regs ? p.rows * f_out : 0))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((s + p.rows - 1) / p.rows, b);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SA_BF16_LAUNCH(MT)                                                           \
  case MT:                                                                           \
    return (int)launch(sa_bf16_kernel<MT>, grid, p, st, xyz, new_xyz, z1, w1x, L, p, \
                       n, s, f1, radius2, nsample, out, f_out);
  switch (p.mt) {
    SA_BF16_LAUNCH(2)
    SA_BF16_LAUNCH(4)
    SA_BF16_LAUNCH(8)
    SA_BF16_LAUNCH(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SA_BF16_LAUNCH
}

}  // extern "C"

// Rank-1-head multi-head attention, backward (K5), for Hopper.
//
// Replaces lsdm_tpu/ops/attn_pallas.py:_rank1_mha_bwd_pallas (the VJP of
// rank1_mha_train, whose forward is K4, csrc/rank1_attn.cu).  Plain
// version: lsdm_tpu_torch/ops/attn.py:rank1_mha_bwd_plain.
//
// Per cloud b and head h (one scalar per head, scale 1), with
// w[l, s] = softmax_s(q[l] k[s]), out[l] = sum_s w v[s], the cotangent g
// and D[l] = g[l] out[l]:
//   dq[l] = sum_s w[l, s] (g[l] v[s] - D[l]) k[s]
//   dk[s] = sum_l w[l, s] (g[l] v[s] - D[l]) q[l]
//   dv[s] = sum_l w[l, s] g[l]
// The (L, S) plane of w is recomputed and never stored.
//
// The TPU kernel walks the query tiles in order and accumulates dk and dv
// in a block that stays resident across the grid.  Blocks on Hopper run
// in no order, so this takes two passes and no atomics, and its result is
// the same from run to run:
//   * the row pass, one thread per (cloud, head, query row): the row's
//     maximum comes from max(k)/min(k) as in K4 (exact: rounding is
//     monotonic), one sweep over the keys sums e = exp(q k - m) and
//     e (g v - D) k, and it writes dq and the row statistics (m, sum e) to
//     a (B, H, L) scratch;
//   * the column pass, one thread per (cloud, head, key): a block stages
//     the rows' q, g, D, m and 1 / sum e of its head in shared memory, and
//     each thread sweeps the rows to sum dk and dv of its key.
// Every sum runs over up to 1024 terms in sequence, so each is compensated
// (Kahan), as K4's are.
//
// What bounds it on an H100: one exp per (row, key) pair and pass, i.e.
// 2 x B x H x L x S exponentials (2 x 6.8e8 at the training flagship,
// 54 clouds of 1024 points, 12 heads) and about 20 other float32
// operations per pair; the inputs and outputs are ~13 MB.  Both passes are
// bound by instruction issue.  All threads of a warp read the same staged
// value per iteration: shared-memory broadcasts, no bank conflicts.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBwdThreads = 256;

__device__ __forceinline__ void kahan_add(float& sum, float& comp, float x) {
  const float y = __fsub_rn(x, comp);
  const float t = __fadd_rn(sum, y);
  comp = __fsub_rn(__fsub_rn(t, sum), y);
  sum = t;
}

// Row pass: dq and the per-row (max, sum of e).
__global__ void __launch_bounds__(kBwdThreads)
rank1_bwd_rows_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ out,
                      const float* __restrict__ g, int l, int s, int h,
                      float* __restrict__ dq, float* __restrict__ row_max,
                      float* __restrict__ row_sum) {
  extern __shared__ float smem[];
  __shared__ float red_max[kBwdThreads / 32], red_min[kBwdThreads / 32];
  float* ks = smem;
  float* vs = smem + s;
  const int hh = blockIdx.y, b = blockIdx.z;

  float kmax = -INFINITY, kmin = INFINITY;
  for (int j = threadIdx.x; j < s; j += kBwdThreads) {
    const float kj = k[((size_t)b * s + j) * h + hh];
    ks[j] = kj;
    vs[j] = v[((size_t)b * s + j) * h + hh];
    kmax = fmaxf(kmax, kj);
    kmin = fminf(kmin, kj);
  }
  for (int off = 16; off > 0; off >>= 1) {
    kmax = fmaxf(kmax, __shfl_xor_sync(0xffffffffu, kmax, off));
    kmin = fminf(kmin, __shfl_xor_sync(0xffffffffu, kmin, off));
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    red_max[warp] = kmax;
    red_min[warp] = kmin;
  }
  __syncthreads();
  kmax = red_max[0];
  kmin = red_min[0];
  for (int w = 1; w < kBwdThreads / 32; ++w) {
    kmax = fmaxf(kmax, red_max[w]);
    kmin = fminf(kmin, red_min[w]);
  }

  const int row = blockIdx.x * kBwdThreads + threadIdx.x;
  if (row >= l) return;
  const size_t at = ((size_t)b * l + row) * h + hh;
  const float qv = q[at], gv = g[at];
  const float d = __fmul_rn(gv, out[at]);
  const float m = qv >= 0.0f ? __fmul_rn(qv, kmax) : __fmul_rn(qv, kmin);
  float se = 0.0f, ce = 0.0f;  // sum of e
  float sa = 0.0f, ca = 0.0f;  // sum of e (g v - D) k
  for (int j = 0; j < s; ++j) {
    const float e = expf(__fsub_rn(__fmul_rn(qv, ks[j]), m));
    kahan_add(se, ce, e);
    const float t = __fmul_rn(__fsub_rn(__fmul_rn(gv, vs[j]), d), ks[j]);
    kahan_add(sa, ca, __fmul_rn(e, t));
  }
  dq[at] = __fdiv_rn(sa, se);
  const size_t r = ((size_t)b * h + hh) * l + row;
  row_max[r] = m;
  row_sum[r] = se;
}

// Column pass: dk and dv from the row statistics.
__global__ void __launch_bounds__(kBwdThreads)
rank1_bwd_cols_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ out,
                      const float* __restrict__ g,
                      const float* __restrict__ row_max,
                      const float* __restrict__ row_sum, int l, int s, int h,
                      float* __restrict__ dk, float* __restrict__ dv) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* gs = smem + l;
  float* ds = smem + 2 * l;
  float* ms = smem + 3 * l;
  float* rs = smem + 4 * l;  // 1 / sum of e
  const int hh = blockIdx.y, b = blockIdx.z;
  for (int i = threadIdx.x; i < l; i += kBwdThreads) {
    const size_t at = ((size_t)b * l + i) * h + hh;
    const size_t r = ((size_t)b * h + hh) * l + i;
    const float gi = g[at];
    qs[i] = q[at];
    gs[i] = gi;
    ds[i] = __fmul_rn(gi, out[at]);
    ms[i] = row_max[r];
    rs[i] = __frcp_rn(row_sum[r]);
  }
  __syncthreads();

  const int col = blockIdx.x * kBwdThreads + threadIdx.x;
  if (col >= s) return;
  const size_t at = ((size_t)b * s + col) * h + hh;
  const float kv = k[at], vv = v[at];
  float sk = 0.0f, ck = 0.0f;  // dk
  float sv = 0.0f, cv = 0.0f;  // dv
  for (int i = 0; i < l; ++i) {
    const float w = __fmul_rn(expf(__fsub_rn(__fmul_rn(qs[i], kv), ms[i])), rs[i]);
    kahan_add(sv, cv, __fmul_rn(w, gs[i]));
    const float t = __fmul_rn(__fsub_rn(__fmul_rn(gs[i], vv), ds[i]), qs[i]);
    kahan_add(sk, ck, __fmul_rn(w, t));
  }
  dk[at] = sk;
  dv[at] = sv;
}

}  // namespace

extern "C" {

// q, out, g (B, L, H), k and v (B, S, H), float32 -> dq (B, L, H), dk and
// dv (B, S, H); stats: a (2, B, H, L) float32 scratch (row max, row sum).
int lsdm_rank1_attn_bwd(const float* q, const float* k, const float* v,
                        const float* out, const float* g, int b, int l, int s,
                        int h, float* dq, float* dk, float* dv, float* stats,
                        void* stream) {
  if (b <= 0 || l <= 0 || h <= 0 || s <= 0) return 0;
  if (b > 65535 || h > 65535) return (int)cudaErrorInvalidValue;
  const size_t row_smem = sizeof(float) * 2 * (size_t)s;
  const size_t col_smem = sizeof(float) * 5 * (size_t)l;
  cudaError_t err = cudaFuncSetAttribute(
      rank1_bwd_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)row_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(rank1_bwd_cols_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)col_smem);
  if (err != cudaSuccess) return (int)err;
  float* row_max = stats;
  float* row_sum = stats + (size_t)b * h * l;
  const dim3 rows((l + kBwdThreads - 1) / kBwdThreads, h, b);
  rank1_bwd_rows_kernel<<<rows, kBwdThreads, row_smem, (cudaStream_t)stream>>>(
      q, k, v, out, g, l, s, h, dq, row_max, row_sum);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 cols((s + kBwdThreads - 1) / kBwdThreads, h, b);
  rank1_bwd_cols_kernel<<<cols, kBwdThreads, col_smem, (cudaStream_t)stream>>>(
      q, k, v, out, g, row_max, row_sum, l, s, h, dk, dv);
  return (int)cudaGetLastError();
}

}  // extern "C"

// Rank-1-head multi-head attention, forward (K4), for Hopper.
//
// Replaces lsdm_tpu/ops/attn_pallas.py:rank1_mha_pallas.  Plain version:
// lsdm_tpu_torch/ops/attn.py:rank1_mha_plain.
//
// The SDM's pcd_attention has embed_dim == num_heads == 12, so every head
// is one scalar: per cloud b, query row l and head h,
//   out[b, l, h] = sum_s softmax_s(q[b, l, h] * k[b, s, h]) * v[b, s, h]
// (scale 1/sqrt(1) = 1, float32).  The composed path writes the logits and
// the softmax weights, two (B, 12, L, S) float32 planes (453 MB each at
// batch 1, L = S = 1024), to device memory; here they never exist.
//
// What bounds it on an H100: the L x S exponentials (113 M at batch 1),
// i.e. instruction issue; it moves only q, k, v and out.  A block takes
// one (cloud, head) and 256 query rows, stages that head's k and v
// columns in shared memory and reduces max(k) and min(k); each thread then
// owns one row.  The row maximum of a rank-1 row is q * max(k) for q >= 0
// and q * min(k) otherwise (rounding is monotonic, so this is exactly the
// largest rounded logit), so a single pass over s sums e = exp(q k - m)
// and e * v, each with a compensated (Kahan) sum so that 1024 terms in
// sequence keep the accuracy of the plain version's tree reductions, and
// out = (sum e v) / (sum e).  All threads of a warp read the same k[s] and
// v[s]: shared-memory broadcasts.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kAttnThreads = 256;

__global__ void __launch_bounds__(kAttnThreads)
rank1_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, int l, int s, int h,
                  float* __restrict__ out) {
  extern __shared__ float smem[];
  __shared__ float red_max[kAttnThreads / 32], red_min[kAttnThreads / 32];
  float* ks = smem;
  float* vs = smem + s;
  const int hh = blockIdx.y, b = blockIdx.z;

  float kmax = -INFINITY, kmin = INFINITY;
  for (int j = threadIdx.x; j < s; j += kAttnThreads) {
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
  for (int w = 1; w < kAttnThreads / 32; ++w) {
    kmax = fmaxf(kmax, red_max[w]);
    kmin = fminf(kmin, red_min[w]);
  }

  const int row = blockIdx.x * kAttnThreads + threadIdx.x;
  if (row >= l) return;
  const float qv = q[((size_t)b * l + row) * h + hh];
  const float m = qv >= 0.0f ? __fmul_rn(qv, kmax) : __fmul_rn(qv, kmin);
  float se = 0.0f, ce = 0.0f;  // sum of e and its compensation
  float sv = 0.0f, cv = 0.0f;  // sum of e * v and its compensation
  for (int j = 0; j < s; ++j) {
    const float e = expf(__fsub_rn(__fmul_rn(qv, ks[j]), m));
    const float ye = __fsub_rn(e, ce);
    const float te = __fadd_rn(se, ye);
    ce = __fsub_rn(__fsub_rn(te, se), ye);
    se = te;
    const float yv = __fsub_rn(__fmul_rn(e, vs[j]), cv);
    const float tv = __fadd_rn(sv, yv);
    cv = __fsub_rn(__fsub_rn(tv, sv), yv);
    sv = tv;
  }
  out[((size_t)b * l + row) * h + hh] = __fdiv_rn(sv, se);
}

}  // namespace

extern "C" {

// q (B, L, H), k and v (B, S, H), float32 -> out (B, L, H).
int lsdm_rank1_attn(const float* q, const float* k, const float* v, int b,
                    int l, int s, int h, float* out, void* stream) {
  if (b <= 0 || l <= 0 || h <= 0) return 0;
  if (s < 1 || b > 65535 || h > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 2 * (size_t)s;
  cudaError_t err = cudaFuncSetAttribute(
      rank1_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((l + kAttnThreads - 1) / kAttnThreads, h, b);
  rank1_attn_kernel<<<grid, kAttnThreads, smem, (cudaStream_t)stream>>>(
      q, k, v, l, s, h, out);
  return (int)cudaGetLastError();
}

}  // extern "C"

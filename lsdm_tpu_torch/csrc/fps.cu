// Farthest-point sampling (K3) for Hopper.
//
// Replaces lsdm_tpu/ops/fps_pallas.py: farthest_point_sample_pallas, and
// serves the contract of lsdm_tpu/ops/fps_batched_pallas.py:
// farthest_point_sample_batched (same indices).  Plain version:
// lsdm_tpu_torch/ops/fps.py.
//
// Semantics (reference pointnet2_utils.py:60-81): out[0] = start; the
// running minimum distance starts at 1e10; each step adds the point whose
// minimum distance to the selected set is largest, ties to the lowest
// index.  The distance is ((x-cx)^2 + (y-cy)^2) + (z-cz)^2 with every op
// rounded on its own, as the plain version computes it, so the indices
// are equal.
//
// What bounds it on an H100: npoint dependent steps, each an O(N) update
// and a block-wide argmax, so latency, not bytes or FLOPs (a 1024-point
// cloud is 12 KB).  One block per cloud keeps the cloud and its distance
// row in shared memory for the whole selection, and the argmax is a warp
// shuffle reduction plus one pass over the per-warp winners: two block
// barriers per step.  Clouds are independent, so the grid covers any
// number of them (the batched Pallas kernel had no size guard).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFpsThreads = 512;

// (value, index) that wins an argmax: larger value, then lower index
__device__ __forceinline__ void arg_max(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void __launch_bounds__(kFpsThreads)
fps_kernel(const float* __restrict__ xyz, const int32_t* __restrict__ start,
           int n, int npoint, int32_t* __restrict__ out) {
  extern __shared__ float smem[];  // x[n], y[n], z[n], dist[n]
  __shared__ float warp_v[kFpsThreads / 32];
  __shared__ int warp_i[kFpsThreads / 32];
  __shared__ int s_far;
  const int b = blockIdx.x;
  float* sx = smem;
  float* sy = smem + n;
  float* sz = smem + 2 * n;
  float* dist = smem + 3 * n;
  const float* cloud = xyz + (size_t)b * n * 3;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    sx[i] = cloud[3 * i];
    sy[i] = cloud[3 * i + 1];
    sz[i] = cloud[3 * i + 2];
    dist[i] = 1e10f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int far = start[b];
  int32_t* orow = out + (size_t)b * npoint;
  for (int it = 0; it < npoint; ++it) {
    if (threadIdx.x == 0) orow[it] = far;
    const float c0 = sx[far], c1 = sy[far], c2 = sz[far];
    float best = -1.0f;  // distances are >= 0
    int best_i = n;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const float d0 = __fsub_rn(sx[i], c0);
      const float d1 = __fsub_rn(sy[i], c1);
      const float d2 = __fsub_rn(sz[i], c2);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)),
                                __fmul_rn(d2, d2));
      const float m = fminf(dist[i], d);
      dist[i] = m;
      if (m > best) {  // strict: this thread visits ascending i
        best = m;
        best_i = i;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, best, off);
      const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
      arg_max(best, best_i, ov, oi);
    }
    if (lane == 0) {
      warp_v[warp] = best;
      warp_i[warp] = best_i;
    }
    __syncthreads();
    if (warp == 0) {
      best = lane < nwarps ? warp_v[lane] : -1.0f;
      best_i = lane < nwarps ? warp_i[lane] : n;
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, best, off);
        const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
        arg_max(best, best_i, ov, oi);
      }
      if (lane == 0) s_far = best_i;
    }
    __syncthreads();
    far = s_far;
  }
}

}  // namespace

extern "C" {

// xyz (B, N, 3) float32, start (B,) int32 in [0, N) -> out (B, npoint) int32.
int lsdm_fps(const float* xyz, const int32_t* start, int b, int n, int npoint,
             int32_t* out, void* stream) {
  if (b <= 0 || npoint <= 0) return 0;
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 4 * (size_t)n;
  fps_kernel<<<b, kFpsThreads, smem, (cudaStream_t)stream>>>(xyz, start, n,
                                                            npoint, out);
  return (int)cudaGetLastError();
}

}  // extern "C"

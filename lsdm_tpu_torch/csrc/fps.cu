// Farthest-point sampling (K3) for Hopper.
//
// Replaces lsdm_tpu/ops/fps_pallas.py: farthest_point_sample_pallas, and
// serves the contract of lsdm_tpu/ops/fps_batched_pallas.py:
// farthest_point_sample_batched (same indices).  Plain version:
// lsdm_tpu_torch/ops/fps.py.
//
// Semantics (reference pointnet2_utils.py:60-81): out[0] = start (0 when
// no start is given); the running minimum distance starts at 1e10; each
// step adds the point whose minimum distance to the selected set is
// largest, ties to the lowest index.  The distance is ((x-cx)^2 +
// (y-cy)^2) + (z-cz)^2 with every op rounded on its own, as the plain
// version computes it, so the indices are equal.
//
// What bounds it on an H100: npoint dependent rounds, each an O(N) update
// and an argmax over the cloud, so the latency of one round, not bytes or
// FLOPs (a 1024-point cloud is 12 KB).  One block per cloud; the host
// picks its warps from N (ops/fps.py:fps_plan) and each lane owns PPT
// contiguous points, whose coordinates and running distances stay in
// registers for the whole selection.  The cloud also sits in shared
// memory, where every lane reads the round's centre as a broadcast.  The
// argmax of a round: each lane takes its first maximum over its points;
// the warp takes __reduce_max_sync over the distances' bits (non-negative
// floats order as unsigned ints), the lowest lane holding that maximum by
// __ballot_sync and __ffs, and that lane's index by one shuffle: lanes own
// ascending ranges, so the lowest lane holds the lowest index.  With more
// than one warp, each warp's winner goes to a double-buffered slot in
// shared memory, one __syncthreads, and every warp reduces the slots the
// same way itself: one block barrier a round, none with one warp.  Points
// past N (the last lanes' padding) hold distance 0 and the highest
// indices, so they never win over a real point.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFpsMaxWarps = 32;

template <int PPT>
__global__ void __launch_bounds__(kFpsMaxWarps * 32)
fps_kernel(const float* __restrict__ xyz, const int32_t* __restrict__ start,
           int n, int npoint, int32_t* __restrict__ out) {
  extern __shared__ float4 cloud[];  // n x (x, y, z, 0)
  __shared__ unsigned slot_v[2][kFpsMaxWarps];
  __shared__ int slot_i[2][kFpsMaxWarps];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const float* src = xyz + (size_t)b * n * 3;
  const int first = tid * PPT;
  float px[PPT], py[PPT], pz[PPT], dist[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int i = first + j;
    px[j] = py[j] = pz[j] = dist[j] = 0.0f;
    if (i < n) {
      px[j] = src[3 * i];
      py[j] = src[3 * i + 1];
      pz[j] = src[3 * i + 2];
      dist[j] = 1e10f;
      cloud[i] = make_float4(px[j], py[j], pz[j], 0.0f);
    }
  }
  __syncthreads();

  int far = start != nullptr ? start[b] : 0;
  int32_t* orow = out + (size_t)b * npoint;
  for (int it = 0; it < npoint; ++it) {
    if (tid == 0) orow[it] = far;
    const float4 c = cloud[far];
    unsigned best = 0u;
    int bj = 0;
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const float d0 = __fsub_rn(px[j], c.x);
      const float d1 = __fsub_rn(py[j], c.y);
      const float d2 = __fsub_rn(pz[j], c.z);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)),
                                __fmul_rn(d2, d2));
      dist[j] = fminf(dist[j], d);
      const unsigned bits = __float_as_uint(dist[j]);
      if (bits > best) {  // strict: the first maximum of ascending indices
        best = bits;
        bj = j;
      }
    }
    const unsigned wmax = __reduce_max_sync(0xffffffffu, best);
    const int who = __ffs(__ballot_sync(0xffffffffu, best == wmax)) - 1;
    const int widx = __shfl_sync(0xffffffffu, first + bj, who);
    if (nwarps == 1) {
      far = widx;
      continue;
    }
    const int buf = it & 1;
    if (lane == 0) {
      slot_v[buf][warp] = wmax;
      slot_i[buf][warp] = widx;
    }
    __syncthreads();
    // a slot is rewritten two rounds later, after every warp has passed
    // the next round's barrier and so has read it
    const unsigned v = lane < nwarps ? slot_v[buf][lane] : 0u;
    const int vi = lane < nwarps ? slot_i[buf][lane] : 0;
    const unsigned bmax = __reduce_max_sync(0xffffffffu, v);
    const int wwin = __ffs(__ballot_sync(0xffffffffu, lane < nwarps && v == bmax)) - 1;
    far = __shfl_sync(0xffffffffu, vi, wwin);
  }
}

template <int PPT>
int launch(const float* xyz, const int32_t* start, int b, int n, int npoint,
           int warps, int32_t* out, cudaStream_t stream) {
  const size_t smem = sizeof(float4) * (size_t)n;
  // beside the static slots: above 48 KB in all, only by opting in
  if (smem + 2 * kFpsMaxWarps * (sizeof(unsigned) + sizeof(int)) > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fps_kernel<PPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  fps_kernel<PPT><<<b, warps * 32, smem, stream>>>(xyz, start, n, npoint, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// xyz (B, N, 3) float32, start (B,) int32 in [0, N) or null (every cloud
// starts at 0) -> out (B, npoint) int32.  The plan: `warps` warps a cloud,
// each lane owning `ppt` points (1, 2 or 4), covering N.
int lsdm_fps(const float* xyz, const int32_t* start, int b, int n, int npoint,
             int warps, int ppt, int32_t* out, void* stream) {
  if (b <= 0 || npoint <= 0) return 0;
  if (n <= 0 || warps < 1 || warps > kFpsMaxWarps || (size_t)warps * 32 * ppt < (size_t)n)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (ppt) {
    case 1: return launch<1>(xyz, start, b, n, npoint, warps, out, st);
    case 2: return launch<2>(xyz, start, b, n, npoint, warps, out, st);
    case 4: return launch<4>(xyz, start, b, n, npoint, warps, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"

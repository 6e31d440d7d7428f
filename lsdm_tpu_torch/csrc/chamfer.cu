// Directed nearest neighbour of the chamfer loss (K11), for Hopper.
//
// Replaces lsdm_tpu/ops/chamfer_pallas.py:_directed_min_sqdist (behind
// chamfer_distance_pallas, the training loss's chamfer_impl="pallas").
// Plain version: lsdm_tpu_torch/ops/chamfer.py:directed_nn_plain.
//
// For every point x[b, i] of x (B, N, 3) against y (B, M, 3):
//   d(i, j)     = (|x_i|^2 + |y_j|^2) - 2 (x_i . y_j),
//   argmin[b,i] = the lowest j of the smallest d (strict <, scanning j in
//                 order: the JAX kernel's argmin within a 128-column tile
//                 and `tile_min < running_min` across tiles),
//   min[b, i]   = max(d(i, argmin), 0) (the clamp after the min).
// |x|^2 = (x0 x0 + x1 x1) + x2 x2 and x.y = (x0 y0 + x1 y1) + x2 y2, every
// product and sum rounded on its own (no FMA contraction, no TF32), in the
// order of the plain version's elementwise torch ops, so kernel and plain
// version give the same bits and the same indices.  The loss launches it
// twice, once in each direction; the backward is plain torch (gathers and
// an index_add at the saved indices).
//
// One thread per point of x; a block stages y in shared memory in tiles of
// kTile points (x, y, z, |y|^2), and every thread of a warp reads the same
// staged point per iteration: shared-memory broadcasts.  What bounds it on
// an H100: N x M distances of ~12 float32 operations (2 x 6 x 1024 x 1024
// per loss at the training flagship, batch 6 of 1024 points), i.e.
// instruction issue; it reads 24 KB per direction and writes 48 KB.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChamferThreads = 256;  // points of x per block
constexpr int kTile = 2048;           // points of y per shared-memory tile

__device__ __forceinline__ float sq_norm3(float a0, float a1, float a2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, a0), __fmul_rn(a1, a1)),
                   __fmul_rn(a2, a2));
}

__global__ void __launch_bounds__(kChamferThreads)
chamfer_nn_kernel(const float* __restrict__ x, const float* __restrict__ y,
                  int n, int m, float* __restrict__ min_out,
                  int32_t* __restrict__ arg_out) {
  __shared__ float ys[4 * kTile];
  const int b = blockIdx.y;
  const int i = blockIdx.x * kChamferThreads + threadIdx.x;
  const bool live = i < n;
  float x0 = 0.0f, x1 = 0.0f, x2 = 0.0f;
  if (live) {
    const float* p = x + ((size_t)b * n + i) * 3;
    x0 = p[0];
    x1 = p[1];
    x2 = p[2];
  }
  const float xx = sq_norm3(x0, x1, x2);
  float best = INFINITY;
  int arg = 0;
  for (int start = 0; start < m; start += kTile) {
    const int cnt = min(kTile, m - start);
    __syncthreads();  // the previous tile is no longer read
    for (int j = threadIdx.x; j < cnt; j += kChamferThreads) {
      const float* p = y + ((size_t)b * m + start + j) * 3;
      const float a0 = p[0], a1 = p[1], a2 = p[2];
      ys[j] = a0;
      ys[kTile + j] = a1;
      ys[2 * kTile + j] = a2;
      ys[3 * kTile + j] = sq_norm3(a0, a1, a2);
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < cnt; ++j) {
      const float dot = __fadd_rn(
          __fadd_rn(__fmul_rn(x0, ys[j]), __fmul_rn(x1, ys[kTile + j])),
          __fmul_rn(x2, ys[2 * kTile + j]));
      const float d = __fsub_rn(__fadd_rn(xx, ys[3 * kTile + j]),
                                __fmul_rn(2.0f, dot));
      if (d < best) {  // strict: an equal distance keeps the lower index
        best = d;
        arg = start + j;
      }
    }
  }
  if (live) {
    min_out[(size_t)b * n + i] = fmaxf(best, 0.0f);
    arg_out[(size_t)b * n + i] = arg;
  }
}

}  // namespace

extern "C" {

// x (B, N, 3), y (B, M, 3) float32 -> min (B, N) float32, argmin (B, N) int32.
int lsdm_chamfer_nn(const float* x, const float* y, int b, int n, int m,
                    float* min_out, int32_t* arg_out, void* stream) {
  if (b <= 0 || n <= 0) return 0;
  if (m <= 0 || b > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kChamferThreads - 1) / kChamferThreads, b);
  chamfer_nn_kernel<<<grid, kChamferThreads, 0, (cudaStream_t)stream>>>(
      x, y, n, m, min_out, arg_out);
  return (int)cudaGetLastError();
}

}  // extern "C"

// Directed nearest neighbour of the chamfer loss (K11), for Hopper.
//
// Replaces lsdm_tpu/ops/chamfer_pallas.py:_directed_min_sqdist (behind
// chamfer_distance_pallas, the training loss's chamfer_impl="pallas", and
// the ICP of scene editing).  Plain version:
// lsdm_tpu_torch/ops/chamfer.py:directed_nn_plain.
//
// For every point x[b, i] of x (B, N, 3) against y (B, M, 3):
//   d(i, j)     = (|x_i|^2 + |y_j|^2) - 2 (x_i . y_j),
//   argmin[b,i] = the lowest j of the smallest d (the JAX kernel's argmin
//                 within a 128-column tile and `tile_min < running_min`
//                 across tiles),
//   min[b, i]   = max(d(i, argmin), 0) (the clamp after the min).
// |x|^2 = (x0 x0 + x1 x1) + x2 x2 and x.y = (x0 y0 + x1 y1) + x2 y2, every
// product and sum rounded on its own (no TF32), in the order of the plain
// version's elementwise torch ops; - 2 (x.y) and its add are one FMA, which
// gives the same bits (nearest.cuh).  So kernel and plain version give the
// same distances and indices.  The loss launches it twice, once in each
// direction; the backward is plain torch (gathers and a scatter_add at the
// saved indices).
//
// The scan is nearest.cuh's with K = 1: what bounds it on an H100 is
// instruction issue (N x M pairs of ~10 float32 instructions: 64 x 1024 x
// 1024 an ICP iteration, 6 x 1024 x 1024 each way at the training
// flagship); a host plan (ops/chamfer.py:chamfer_nn_plan) picks the lanes
// a point and the points a lane so the card holds enough warps at both
// shapes, and the sources stream through shared tiles, so M is not capped.

#include <cuda_runtime.h>
#include <stdint.h>

#include "nearest.cuh"

extern "C" {

// x (B, N, 3), y (B, M, 3) float32 -> min (B, N) float32, argmin (B, N)
// int32; `lanes` lanes a point of x and `group` points a lane from the host
// plan.
int lsdm_chamfer_nn(const float* x, const float* y, int b, int n, int m,
                    int lanes, int group, float* min_out, int32_t* arg_out,
                    void* stream) {
  if (b <= 0 || n <= 0) return 0;
  if (m <= 0) return (int)cudaErrorInvalidValue;
  return (int)nearest::launch<1, true>(x, y, b, n, m, 1, lanes, group, min_out,
                                       arg_out, (cudaStream_t)stream);
}

}  // extern "C"

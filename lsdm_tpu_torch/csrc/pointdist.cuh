// Squared point distances shared by the selection kernels of the port:
// ball query (ballquery.cu), the train select-gather (sg_fused.cu), the
// fused SA stage (sa_fused.cu) and the fused FP stage (fp_fused.cu); the
// nearest-k scan of 3-NN and the chamfer nearest neighbour (nearest.cuh)
// takes its norms and rounds its distance the same way.
//
// The distance is (-2 (q.x) + |q|^2) + |x|^2 with q.x = (q0 x0 + q1 x1) +
// q2 x2.  Every product and sum is rounded on its own (__fmul_rn/__fadd_rn
// are never contracted into FMAs), in the order the plain versions' separate
// torch ops use (lsdm_tpu_torch/ops/ballquery.py:square_distance), so every
// kernel and every plain version produce the same bits and select the same
// indices.  One definition, so the kernels cannot drift apart.

#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ float sq_norm(float a0, float a1, float a2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, a0), __fmul_rn(a1, a1)),
                   __fmul_rn(a2, a2));
}

__device__ __forceinline__ float sq_dist(float q0, float q1, float q2,
                                         float qq, float x0, float x1,
                                         float x2, float xx) {
  const float dot = __fadd_rn(__fadd_rn(__fmul_rn(q0, x0), __fmul_rn(q1, x1)),
                              __fmul_rn(q2, x2));
  return __fadd_rn(__fadd_rn(__fmul_rn(-2.0f, dot), qq), xx);
}

// Stage cloud (n, 3) into shared memory as x[], y[], z[], |p|^2[].
__device__ __forceinline__ void stage_cloud(
    const float* __restrict__ cloud, int n, float* s) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float a0 = cloud[3 * i], a1 = cloud[3 * i + 1], a2 = cloud[3 * i + 2];
    s[i] = a0;
    s[n + i] = a1;
    s[2 * n + i] = a2;
    s[3 * n + i] = sq_norm(a0, a1, a2);
  }
}

// The activations of the denoise kernels: the chain (K6, denoise_chain.cu,
// denoise_tables.cu, denoise_chain_bf16.cu) and the step (K9,
// denoise_step.cu, denoise_step_bf16.cu).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace denoise {

// torch's nn.GELU(): the exact erf form
__device__ __forceinline__ float gelu(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

}  // namespace denoise

// The activations of the denoise kernels: the chain (K6, denoise_chain.cu
// and denoise_tables.cu) and the step (K9, denoise_step.cu).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace denoise {

// x rounded to bf16 (to nearest even, as torch and XLA round), as a float:
// the bf16 modes round each product's operands, and products of
// bf16-exact operands are exact in float32, as on the MXU
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// torch's nn.GELU(): the exact erf form
__device__ __forceinline__ float gelu(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

}  // namespace denoise

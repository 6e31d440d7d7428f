// K6's first pass (denoise_tables.cu), as the chain (denoise_chain.cu)
// calls it: the dimensions of a call, the layout of the scratch, and the
// launches that fill a chunk's tables.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace denoise {

// Dimensions of a chain call, from the caller's dims array (see the entry
// points of denoise_chain.cu).
struct ChainDims {
  int B, T, N, D2, U0, U2, D, DH, D15, DH2, TC;
};

// The scratch, in floats: w_up2^T (U0, U2) and w_up4^T (U2, ldn), written
// once a call, then the tables of one chunk of steps, each batched over z
// = scene * tc + step: u2 (U2, 2D), u4^T (2D, ldn), emb^T (D, ldn) and g
// (N, D15), row-major.  ldn = N rounded up to 4, so that every row of a
// table with a point column starts on 16 bytes.
struct TablesLayout {
  int ldn;
  size_t w2t, w4t, tables;      // offsets
  size_t u2, u4t, embt, g;      // floats of each table per (scene, step)
};

TablesLayout tables_layout(const ChainDims& d);

// cudaSuccess when pass 1 takes these shapes and weights: D, D15 and U2
// multiples of 4, and wc_t, wx0_t and the scratch on 16 bytes (its 16-byte
// copies); cudaErrorInvalidValue otherwise.
cudaError_t tables_check(const ChainDims& d, const float* const* w,
                         const float* scratch);

// Writes w_up2^T and w_up4^T into the scratch: once a call, before the
// first chunk.
cudaError_t transpose_weights(cudaStream_t st, const ChainDims& d,
                              const float* const* w, float* scratch);

// Pass 1 for steps [t0, t0 + tc) of every scene: fills the chunk's tables
// u2, u4^T, emb^T and g after the transposed weights, one GEMM launch each.
// Sets *g_out to g.  bf16: the bf16 mode (weights rounded by the caller;
// u0 rounded as it enters its product, u2, u4^T and emb^T rounded as they
// are stored, g float32).
cudaError_t chain_tables(cudaStream_t st, const ChainDims& d, const float* e2,
                         const float* const* w, float* scratch, int t0, int tc,
                         bool bf16, float** g_out);

}  // namespace denoise

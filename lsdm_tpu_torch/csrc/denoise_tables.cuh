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

// The scratch, counted in floats.  The float32 mode: w_up2^T (U0, U2) and
// w_up4^T (U2, ldn), written once a call, then the tables of one chunk of
// steps, each batched over z = scene * tc + step: u2 (U2, 2D), u4^T (2D,
// ldn), emb^T (D, ldn) and g (N, D15), row-major, float32; ldn = N rounded
// up to 4, so that every row of a table with a point column starts on 16
// bytes.  The bf16 mode: no weights (the caller's bf16 operand copies hold
// them, transposed once per model), then u0 (U0, 2D), u2 (U2, 2D) and u4^T
// (2D, ldn) as bf16 (two to a float; ldn = N rounded up to 8, rows on 16
// bytes), g float32, and last emb^T (D, ldn) as bf16, which only pass 1
// alone keeps (emb^T reaches g through shared memory).
struct TablesLayout {
  int ldn;
  size_t w2t, w4t, tables;      // offsets
  size_t u0, u2, u4t, embt, g;  // floats of each table per (scene, step)
};

TablesLayout tables_layout(const ChainDims& d, bool bf16);

// cudaSuccess when pass 1 takes these shapes and weights: D, D15 and U2
// multiples of 4, and wc_t, wx0_t, the scratch and, in the bf16 mode, the
// four bf16 operand copies w[20..23] on 16 bytes (its 16-byte copies), and
// in the bf16 mode 2D <= 256 and D15 <= 192 (its tail kernel's tile);
// cudaErrorInvalidValue otherwise.
cudaError_t tables_check(const ChainDims& d, const float* const* w,
                         const float* scratch, bool bf16);

// Writes w_up2^T and w_up4^T into the scratch of the float32 mode: once a
// call, before the first chunk.
cudaError_t transpose_weights(cudaStream_t st, const ChainDims& d,
                              const float* const* w, float* scratch);

// Pass 1 for steps [t0, t0 + tc) of every scene: fills the chunk's tables
// u2, u4^T, emb^T and g, one GEMM launch each.  Sets *g_out to g.  bf16:
// the bf16 mode on the tensor cores (w[0..19] rounded by the caller,
// w[20..23] its bf16 operand copies): u0, u2 and u4^T stored as bf16, then
// one launch for emb^T and g (float32), emb^T stored only if keep_emb
// (after g: the chain's scratch has no room for it).
cudaError_t chain_tables(cudaStream_t st, const ChainDims& d, const float* e2,
                         const float* const* w, float* scratch, int t0, int tc,
                         bool bf16, bool keep_emb, float** g_out);

}  // namespace denoise

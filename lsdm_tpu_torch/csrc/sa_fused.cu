// Fused eval-mode SetAbstraction stage (K7) for Hopper.
//
// Replaces lsdm_tpu/ops/sa_fused_pallas.py:sa_stage_fused.  Plain version:
// lsdm_tpu_torch/ops/sa_fused.py:sa_stage_fused_plain.
//
// For each query center q of a cloud: ball query (the first nsample
// in-radius points in index order, empty slots repeat the first, an empty
// row gathers point 0), then per selected point p
//   h1 = relu(Z1[p] - q . W1'[:3])        (layer 1 hoisted to the N points:
//                                          Z1 = base @ W1' + b1' comes in)
//   h  = relu(h @ W' + b')                (layers 2..L, BatchNorm folded)
// and the output row is the max of h over the nsample points.  The
// grouped (S, K, C) tensor that the composed path writes to device memory
// never leaves shared memory.
//
// What bounds it on an H100: arithmetic.  Layers 2..L are ~1.8 GFLOP per
// stage at batch 1 (9 clouds), 7.25 GFLOP over the four stages, in float32
// FMAs on the CUDA cores (no tensor cores: the port keeps float32
// numerics).  The selection is a small share (the K1 scan, 9 x 1024 x 1024
// distances at sa1).  The design gives a block a tile of `rows` query
// rows: the cloud staged in shared memory for the selection (one warp per
// row, __ballot_sync in index order, stopping at nsample, as in K1), the
// layer-1 rows gathered from Z1, and the activations of all rows x nsample
// ping-ponged between two shared-memory buffers through the layers
// (rowmlp.cuh).  `rows` is the largest count (<= 8) whose buffers stay
// under kSmemBudget, so sa4's 256-wide layers get one row (32 x 256
// floats per buffer) and sa1 eight.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pointdist.cuh"
#include "rowmlp.cuh"

namespace {

constexpr int kMaxRows = 8;  // query rows per block: one selection warp each

struct SaShape {
  int mcap;  // activation rows per buffer: rows * nsample + kRowChunk
  int ld;    // row stride of the buffers (floats, a multiple of 4)
};

size_t sa_smem(int rows, int nsample, int ld, int n, SaShape* shape) {
  shape->mcap = rows * nsample + kRowChunk;
  shape->ld = ld;
  return sizeof(float) * (2 * (size_t)shape->mcap * ld + 4 * (size_t)n) +
         sizeof(int) * (size_t)rows * nsample;
}

__global__ void __launch_bounds__(kMlpThreads)
sa_fused_kernel(const float* __restrict__ xyz, const float* __restrict__ new_xyz,
                const float* __restrict__ z1, const float* __restrict__ w1x,
                MlpLayers layers, int n, int s, int f1, float radius2,
                int nsample, int rows, SaShape shape, float* __restrict__ out,
                int f_out) {
  extern __shared__ float4 smem4[];
  float* buf0 = reinterpret_cast<float*>(smem4);
  float* buf1 = buf0 + (size_t)shape.mcap * shape.ld;
  float* cloud = buf1 + (size_t)shape.mcap * shape.ld;
  int* sel = reinterpret_cast<int*>(cloud + 4 * n);
  const int ld = shape.ld;

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * rows;
  const int nq = min(rows, s - q0);
  stage_cloud(xyz + (size_t)b * n * 3, n, cloud);
  __syncthreads();

  // ball query: one warp per query row, in index order, as in K1
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;  // lanes below this one
  for (int r = warp; r < nq; r += kMlpWarps) {
    const float* qp = new_xyz + ((size_t)b * s + q0 + r) * 3;
    const float a0 = qp[0], a1 = qp[1], a2 = qp[2];
    const float qq = sq_norm(a0, a1, a2);
    int* row = sel + r * nsample;
    int count = 0;   // warp-uniform
    int first = -1;  // warp-uniform
    for (int base = 0; base < n && count < nsample; base += 32) {
      const int i = base + lane;
      bool in = false;
      if (i < n)
        in = sq_dist(a0, a1, a2, qq, cloud[i], cloud[n + i], cloud[2 * n + i],
                     cloud[3 * n + i]) <= radius2;
      const unsigned mask = __ballot_sync(0xffffffffu, in);
      if (mask == 0u) continue;
      if (first < 0) first = base + __ffs(mask) - 1;
      const int pos = count + __popc(mask & lower);
      if (in && pos < nsample) row[pos] = i;
      count += __popc(mask);
    }
    const int fill = first < 0 ? 0 : first;  // an empty row gathers point 0
    for (int j = count + lane; j < nsample; j += 32) row[j] = fill;
  }
  __syncthreads();

  // layer 1: relu(Z1[p] - q . W1'[:3]), center term in the order
  // (q0 w0 + q1 w1) + q2 w2
  const int m = nq * nsample;
  for (int e = threadIdx.x; e < m * f1; e += kMlpThreads) {
    const int row = e / f1, f = e - row * f1;
    const float* qp = new_xyz + ((size_t)b * s + q0 + row / nsample) * 3;
    const float c = __fadd_rn(__fadd_rn(__fmul_rn(qp[0], w1x[f]),
                                        __fmul_rn(qp[1], w1x[f1 + f])),
                              __fmul_rn(qp[2], w1x[2 * f1 + f]));
    const float g = z1[((size_t)b * n + sel[row]) * f1 + f];
    buf0[(size_t)row * ld + f] = fmaxf(__fsub_rn(g, c), 0.0f);
  }
  __syncthreads();

  // layers 2..L-1 through shared memory, layer L straight into the max
  float* cur = buf0;
  float* nxt = buf1;
  int width = f1;
  for (int l = 0; l + 1 < layers.n; ++l) {
    dense_rows(cur, ld, width, layers.w[l], layers.b[l], layers.fout[l], 1,
               nxt, ld, m);
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
    width = layers.fout[l];
  }
  float* dst = out + ((size_t)b * s + q0) * f_out;
  if (layers.n > 0) {
    const int l = layers.n - 1;
    dense_relu_max(cur, ld, width, layers.w[l], layers.b[l], f_out, nsample,
                   nq, dst);
  } else {  // a one-layer MLP: the max of layer 1
    for (int e = threadIdx.x; e < nq * f_out; e += kMlpThreads) {
      const int g = e / f_out, j = e - g * f_out;
      float best = 0.0f;
      for (int k = 0; k < nsample; ++k)
        best = fmaxf(best, cur[((size_t)g * nsample + k) * ld + j]);
      dst[(size_t)g * f_out + j] = best;
    }
  }
}

}  // namespace

extern "C" {

// xyz (B, N, 3), new_xyz (B, S, 3), z1 (B, N, F1) = base @ W1' + b1',
// w1x (3, F1) = W1'[:3]; params = {W2', b2', ..., WL', bL'} with Wl'
// (F_{l-1}, F_l) and bl' (F_l,); widths = {F1, ..., FL}; n_layers = L.
// -> out (B, S, FL), all float32.
int lsdm_sa_fused(const float* xyz, const float* new_xyz, const float* z1,
                  const float* w1x, const float* const* params,
                  const int* widths, int n_layers, int b, int n, int s,
                  float radius2, int nsample, float* out, void* stream) {
  if (b <= 0 || s <= 0) return 0;
  if (n_layers < 1 || n_layers - 1 > kMaxLayers || nsample < 1 || n < 1)
    return (int)cudaErrorInvalidValue;
  MlpLayers layers = {};
  layers.n = n_layers - 1;
  int ld = widths[0];  // the stored widths: layer 1 and layers 2..L-1
  for (int l = 0; l < layers.n; ++l) {
    layers.w[l] = params[2 * l];
    layers.b[l] = params[2 * l + 1];
    layers.fout[l] = widths[l + 1];
    layers.relu[l] = 1;
    if (l + 1 < layers.n && widths[l + 1] > ld) ld = widths[l + 1];
  }
  ld = pad4(ld);
  SaShape shape;
  int rows = kMaxRows < s ? kMaxRows : s;
  size_t smem = sa_smem(rows, nsample, ld, n, &shape);
  while (rows > 1 && smem > kSmemBudget)
    smem = sa_smem(--rows, nsample, ld, n, &shape);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sa_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s + rows - 1) / rows, b);
  sa_fused_kernel<<<grid, kMlpThreads, smem, (cudaStream_t)stream>>>(
      xyz, new_xyz, z1, w1x, layers, n, s, widths[0], radius2, nsample, rows,
      shape, out, widths[n_layers - 1]);
  return (int)cudaGetLastError();
}

}  // extern "C"

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
// FMAs on the CUDA cores.  The selection is a small share (the K1 scan,
// 9 x 1024 x 1024 distances at sa1).  A cluster of plan.cluster blocks
// takes plan.rows centres of one cloud: each block stages the cloud in
// shared memory, runs the selection (one warp per centre, __ballot_sync in
// index order, stopping at nsample, as in K1) and gathers layer 1 for all
// rows x nsample activation rows, then computes its column slice of layers
// 2..L with the register-tiled engine of rowmlp.cuh, passing each layer's
// slice to its peers through DSMEM.  Layer L goes straight into the max
// over each centre's nsample rows (shared-memory atomicMax on the bits of
// the non-negative ReLU outputs) without being stored.  Before the layers
// that region holds the centre terms of layer 1.  The plan (rows,
// cluster, tiles, layout) comes from lsdm_tpu_torch/ops/rowmlp.py:plan_sa.
//
// The bf16 mode (lsdm_sa_fused_bf16) is its own design on the bf16 tensor
// cores, sa_fused_bf16.cu; the ball query is shared (stage_select.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include "pointdist.cuh"
#include "rowmlp.cuh"
#include "stage_select.cuh"

namespace {

using namespace rowmlp;

__global__ void __launch_bounds__(kThreads, 2)
sa_fused_kernel(const float* __restrict__ xyz, const float* __restrict__ new_xyz,
                const float* __restrict__ z1, const float* __restrict__ w1x,
                Layers layers, Plan p, int n, int s, int f1, float radius2,
                int nsample, float* __restrict__ out, int f_out) {
  extern __shared__ float4 smem4[];
  const int ldm = p.ldm;
  float* buf0 = reinterpret_cast<float*>(smem4);
  float* buf1 = buf0 + (size_t)p.cap0 * ldm;
  float* ring = buf1 + (size_t)p.cap1 * ldm;
  float* red = ring + p.ring;
  float* cloud = red + p.red;
  int* sel = reinterpret_cast<int*>(cloud + 4 * n);

  const int C = p.cluster;
  const int rank = blockIdx.x % C;  // the cluster spans C blocks along x
  const int b = blockIdx.y;
  const int q0 = blockIdx.x / C * p.rows;
  const int nq = min(p.rows, s - q0);
  const int m = nq * nsample;
  stage_cloud(xyz + (size_t)b * n * 3, n, cloud);
  __syncthreads();

  // the centre terms q . W1'[:3] of layer 1, in the order (q0 w0 + q1 w1)
  // + q2 w2, kept in the (not yet used) red region
  float* cterm = red;
  for (int e = threadIdx.x; e < nq * f1; e += kThreads) {
    const int g = e / f1, f = e - g * f1;
    const float* qp = new_xyz + ((size_t)b * s + q0 + g) * 3;
    cterm[e] = __fadd_rn(__fadd_rn(__fmul_rn(qp[0], w1x[f]),
                                   __fmul_rn(qp[1], w1x[f1 + f])),
                         __fmul_rn(qp[2], w1x[2 * f1 + f]));
  }

  stage_select::ball_select<kThreads / 32>(cloud, n, new_xyz, b, s, q0, nq,
                                           radius2, nsample, sel);
  __syncthreads();

  // layer 1 into buffer 0, channel-major: relu(Z1[p] - q . W1'[:3]), four
  // channels a load where the rows of Z1 allow 16-byte loads
  const float* z1b = z1 + (size_t)b * n * f1;
  auto h1 = [](float g, float c) { return fmaxf(__fsub_rn(g, c), 0.0f); };
  if ((f1 & 3) == 0 && aligned16(z1)) {
    fill_rows4(buf0, ldm, m, f1, [&](int row, int f) {
      const float4 g = load4(z1b + (size_t)sel[row] * f1 + f);
      const float4 c = *reinterpret_cast<const float4*>(
          cterm + (row / nsample) * f1 + f);
      return make_float4(h1(g.x, c.x), h1(g.y, c.y), h1(g.z, c.z),
                         h1(g.w, c.w));
    });
  } else {
    fill_rows(buf0, ldm, m, f1, [&](int row, int f) {
      return h1(z1b[(size_t)sel[row] * f1 + f], cterm[(row / nsample) * f1 + f]);
    });
  }
  // every block of the cluster runs before a peer writes into it
  layer_barrier(C);

  // layers 2..L-1: each block's column slice into every rank's next buffer
  float* cur = buf0;
  float* nxt = buf1;
  for (int l = 0; l + 1 < layers.n; ++l) {
    int lo, hi;
    col_slice(layers.fout[l], C, rank, &lo, &hi);
    dense_layer(p.tile[l], cur, ldm, m, layers.w[l], layers.b[l],
                layers.fin[l], layers.fout[l], 1, lo, hi, ring,
                shared_sink(nxt, C));
    layer_barrier(C);
    float* t = cur;
    cur = nxt;
    nxt = t;
  }

  float* dst = out + ((size_t)b * s + q0) * f_out;
  if (layers.n > 0) {  // layer L straight into the max over each centre
    const int l = layers.n - 1;
    int lo, hi;
    col_slice(f_out, C, rank, &lo, &hi);
    const int width = hi - lo;
    for (int e = threadIdx.x; e < nq * width; e += kThreads) red[e] = 0.0f;
    // (dense_tiles opens each tile with a barrier, ordering these zeros)
    Sink sink = {};
    sink.mode = kToMax;
    sink.red = reinterpret_cast<int*>(red);
    sink.group = nsample;
    dense_layer(p.tile[l], cur, ldm, m, layers.w[l], layers.b[l],
                layers.fin[l], f_out, 1, lo, hi, ring, sink);
    __syncthreads();
    for (int e = threadIdx.x; e < nq * width; e += kThreads) {
      const int g = e / width, j = e - g * width;
      dst[(size_t)g * f_out + lo + j] = red[e];
    }
  } else if (rank == 0) {  // a one-layer MLP: the max of layer 1
    for (int e = threadIdx.x; e < nq * f_out; e += kThreads) {
      const int g = e / f_out, j = e - g * f_out;
      float best = 0.0f;
      for (int k = 0; k < nsample; ++k)
        best = fmaxf(best, cur[(size_t)j * ldm + g * nsample + k]);
      dst[(size_t)g * f_out + j] = best;
    }
  }
}

}  // namespace

extern "C" {

// xyz (B, N, 3), new_xyz (B, S, 3), z1 (B, N, F1) = base @ W1' + b1',
// w1x (3, F1) = W1'[:3]; params = {W2', b2', ..., WL', bL'} with Wl'
// (F_{l-1}, F_l) and bl' (F_l,); widths = {F1, ..., FL}; n_layers = L;
// plan = ops/rowmlp.py:plan_sa(...).ints().  -> out (B, S, FL), all
// float32.  Returns cudaErrorInvalidValue for a plan that cannot carry
// these shapes.
int lsdm_sa_fused(const float* xyz, const float* new_xyz, const float* z1,
                  const float* w1x, const float* const* params,
                  const int* widths, int n_layers, int b, int n, int s,
                  float radius2, int nsample, const int* plan, float* out,
                  void* stream) {
  if (b <= 0 || s <= 0) return 0;
  if (n_layers < 1 || n_layers - 1 > kMaxLayers || nsample < 1 || n < 1)
    return (int)cudaErrorInvalidValue;
  Layers layers = {};
  layers.n = n_layers - 1;
  for (int l = 0; l < layers.n; ++l) {
    layers.w[l] = params[2 * l];
    layers.b[l] = params[2 * l + 1];
    layers.fin[l] = widths[l];
    layers.fout[l] = widths[l + 1];
    layers.relu[l] = 1;
  }
  Plan p = {};
  p.rows = plan[0], p.cluster = plan[1], p.ldm = plan[2], p.cap0 = plan[3];
  p.cap1 = plan[4], p.ring = plan[5], p.red = plan[6], p.smem = plan[7];
  for (int l = 0; l < layers.n; ++l) p.tile[l] = plan[8 + l];
  const long long extra = 4LL * n + (long long)p.rows * nsample;  // cloud, sel
  if (p.rows > 512 || p.red < p.rows * widths[0] ||  // red holds the cterms
      !plan_ok(p, layers, p.rows * nsample, widths[0], p.rows, extra) ||
      (layers.n == 0 && p.cluster != 1))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((s + p.rows - 1) / p.rows * p.cluster, b);
  return (int)launch(sa_fused_kernel, grid, p, (cudaStream_t)stream, xyz,
                     new_xyz, z1, w1x, layers, p, n, s, widths[0], radius2,
                     nsample, out, widths[n_layers - 1]);
}

}  // extern "C"

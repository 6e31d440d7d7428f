// Ball query + neighbourhood gather (K10), bf16 mode, for Hopper.
//
// Replaces lsdm_tpu/ops/sg_fused_pallas.py:_sg_call at
// compute_dtype=bfloat16 (:67-73, :106-112).  Plain version:
// lsdm_tpu_torch/ops/sg_fused.py:select_gather_plain on a bf16 base.  The
// float32 mode is csrc/sg_fused.cu.
//
// For every center q of new_xyz (B, S, 3) over the cloud xyz (B, N, 3):
//   idx[b, q, :]    = the first nsample in-radius point indices (K1's rule);
//   out[b, q, k, c] = base[b, idx[b, q, k], c] - (c < 3 ? bf16(q_c) : 0),
// base (B, N, C) and out bf16; the subtraction g - bf16(q) is exact in
// float32 or rounded once to bf16 (sg_fused_pallas.py:69, :113).
//
// Selection is K1's scan, unchanged (ballscan.cuh, in float32, the same
// indices as K1 and the float32 mode).  The gather writes each center's
// (nsample, C) slab as 16-byte streaming stores (st.global.cs), as the
// float32 mode does: lane l takes the 16-byte chunks l, l + 32 P, ... of
// the slab's aligned body (P the warps a slab), each 8 values starting at
// (slot k, column c), walked without division.  Where C >= 8 a chunk is
// copied a source row at a time, not a value at a time: each piece of it
// that lies in one source row (one where the chunk lies inside a row, two
// where it crosses a slot boundary) is read as the one or two aligned
// 16-byte blocks of base that hold it and shifted into place in registers
// (word selects by the offset's bits and one funnel shift by 16 bits), the
// pieces merged by position, two chunks a step with all four pieces' loads
// issued first.  (A block is read only where it holds a value of its
// piece, and an aligned 16-byte block never crosses a page, so its other
// values, shifted out or masked, are mapped memory.)  Only a row's first
// three values take an arithmetic step: one packed bf16x2 subtraction of
// the center's bf16 coordinates, placed at their positions (zero
// elsewhere); a bf16 subtraction rounds the exact difference once, which
// equals rounding the float32 difference once more (the float32 difference
// of two bf16 values is exact unless their exponents lie more than 16
// apart, and then the result rounds to the larger either way).  Where
// C < 8 (sa1's 6 columns, whose time is the scan's) a chunk spans up to
// three slots and is read one value a load, as the first bf16 instance
// read every chunk: it measured faster there than a loop over up to four
// pieces.  The slab's unaligned head and tail (none where nsample C is a
// multiple of 8, as at the flagship) go one value a lane.
//
// Warps a slab (P, from the host plan ops/sg_fused.py:select_gather_bf16_
// plan): where the centers are too few to fill the card (sa4's 864 at the
// training flagship, sa3's 576 and sa4's 144 at 9 clouds) and their slabs
// long (4,192 and 8,288 values), P = 2-8 warps share a slab: each repeats
// the center's scan (a cloud of 256 or 64 points, one or two rounds) and
// writes every P-th 32-chunk stretch of the body; the first writes the idx
// row, the head and the tail.
//
// What bounds it on an H100: the output stream, B S K C bf16 values
// (123 MB over sa1-sa4 at 54 clouds), written once; sa1's by the scan's
// instructions (8 a pair).  What holds it is its gather's loads: built
// without them (stores of a constant) it takes half the time at sa2, built
// without its stores it takes all of it, in this design as in the first,
// which read each value with its own 2-byte load.
//
// LSDM_SG_ABLATE (a build flag of profile_kernels.py --sg_ablation, not
// set otherwise): 1 stores a constant body with no loads, 2 loads and
// assembles every chunk but stores none of the body.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ballscan.cuh"

#ifndef LSDM_SG_ABLATE
#define LSDM_SG_ABLATE 0
#endif

namespace {

using ballscan::kRoundPoints;
using ballscan::kWarps;

// 16 values of a source row, as 8 words (two aligned 16-byte blocks a, b),
// shifted so that output value j (0..7) is value u - 8 + j of the pair
// (a, b): u in [8, 16) reads a then b; u in [1, 8) reads value u + j - 8
// of a where that is >= 0 (the rest is a's values again, to be masked).
// Word selects by bits 2 and 1 of u, one funnel shift by bit 0.
__device__ __forceinline__ void shift_in(uint32_t (&o)[4], const uint4& a,
                                         const uint4& b, int u) {
  const uint32_t hi8 = (u & 8) ? 0xffffffffu : 0u;
  uint32_t w[8] = {a.x, a.y, a.z, a.w,
                   (b.x & hi8) | (a.x & ~hi8), (b.y & hi8) | (a.y & ~hi8),
                   (b.z & hi8) | (a.z & ~hi8), (b.w & hi8) | (a.w & ~hi8)};
  if (u & 4) {
#pragma unroll
    for (int j = 0; j < 6; ++j) w[j] = w[j + 2];
  }
  if (u & 2) {
#pragma unroll
    for (int j = 0; j < 5; ++j) w[j] = w[j + 1];
  }
  const int sh = (u & 1) * 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = __funnelshift_r(w[i], w[i + 1], sh);
}

// the center's three bf16 coordinates at output values p, p + 1, p + 2
// (p in [-2, 8)), +0 at every other value
__device__ __forceinline__ void center_at(uint32_t (&o)[4], uint32_t c01,
                                          uint32_t c2, int p) {
  // as shift_in from the block (c01, c2, 0, 0) and a zero block: u = 8 - p
  const int u = 8 - p;
  uint32_t w[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
  if (u & 8) {
    w[0] = c01;
    w[1] = c2;
  } else {
    w[4] = c01;
    w[5] = c2;
  }
  if (u & 4) {
#pragma unroll
    for (int j = 0; j < 6; ++j) w[j] = w[j + 2];
  }
  if (u & 2) {
#pragma unroll
    for (int j = 0; j < 5; ++j) w[j] = w[j + 1];
  }
  const int sh = (u & 1) * 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = __funnelshift_r(w[i], w[i + 1], sh);
}

__device__ __forceinline__ uint32_t sub_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// two floats rounded to bf16 (to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// o's values from e on taken from r (the values before e kept)
__device__ __forceinline__ void merge_from(uint32_t (&o)[4], const uint32_t (&r)[4], int e) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[i] = 2 * i >= e ? r[i] : 2 * i + 1 == e ? __byte_perm(o[i], r[i], 0x7610) : o[i];
  }
}

// A chunk of 8 values where C >= 8: piece a, the rest of slot k's row from
// column cs (len values, up to 8), and piece b, the first 8 - len values of
// slot k + 1's row where len < 8; each as the blocks that hold it and its
// value offset in the first.  Loads only where ok (a chunk past the body).
struct Pieces {
  uint4 xa, ya, xb, yb;
  int at_a, at_b, len, cs;
};

__device__ __forceinline__ Pieces load_pieces(const __nv_bfloat16* cloud,
                                              const int32_t* sl, int c, int k,
                                              int cs, bool ok) {
  Pieces p;
  p.cs = cs;
  p.len = min(8, c - cs);
  const bool two = p.len < 8;
  const __nv_bfloat16* a = cloud + (size_t)sl[ok ? k : 0] * c + cs;
  const __nv_bfloat16* b = cloud + (size_t)sl[ok && two ? k + 1 : 0] * c;
  const uint4* ba = reinterpret_cast<const uint4*>((uintptr_t)a & ~(uintptr_t)15);
  const uint4* bb = reinterpret_cast<const uint4*>((uintptr_t)b & ~(uintptr_t)15);
  p.at_a = (int)(((uintptr_t)a >> 1) & 7);
  p.at_b = (int)(((uintptr_t)b >> 1) & 7);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  p.xa = ok ? __ldg(ba) : zero;
  p.ya = ok && p.at_a + p.len > 8 ? __ldg(ba + 1) : p.xa;
  p.xb = ok && two ? __ldg(bb) : zero;
  p.yb = ok && two && p.at_b + 8 - p.len > 8 ? __ldg(bb + 1) : p.xb;
  return p;
}

// The chunk's 8 values from its pieces, minus the center's coordinates at
// each row's first three values (a row that starts in the chunk, at value
// len, or before it, at value -cs; both only where C < 11).
__device__ __forceinline__ uint4 assemble(const Pieces& p, int c, uint32_t c01,
                                          uint32_t c2) {
  uint32_t o[4], r[4], m[4], m2[4];
  shift_in(o, p.xa, p.ya, 8 + p.at_a);
  shift_in(r, p.xb, p.yb, 8 + p.at_b - p.len);
  merge_from(o, r, p.len);
  center_at(m, c01, c2, p.cs < 3 ? -p.cs : p.len);
  if (c < 11) {  // warp-uniform: a chunk may hold two rows' first values
    center_at(m2, c01, c2, p.cs < 3 ? p.len : 8);
#pragma unroll
    for (int i = 0; i < 4; ++i) m[i] |= m2[i];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = sub_bf16x2(o[i], m[i]);
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// kQueriesPerWarp: 1, 2 or 4 centers a warp; split: 1, 2, 4 or 8 warps a
// center's slab, > 1 only with one center a warp.  kTwoPieces: C >= 8, the
// row copy; else one value a load.
template <int kQueriesPerWarp, bool kTwoPieces>
__global__ void __launch_bounds__(kWarps * 32)
select_gather_bf16_kernel(const float* __restrict__ xyz,
                          const float* __restrict__ new_xyz,
                          const __nv_bfloat16* __restrict__ base, int n, int np,
                          int s, int c, float radius2, int nsample, int split,
                          __nv_bfloat16* __restrict__ out,
                          int32_t* __restrict__ idx) {
  constexpr int Q = kQueriesPerWarp;
  extern __shared__ float4 pts[];
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gw = blockIdx.x * kWarps + warp;
  const int part = gw % split;
  const int q0 = (gw / split) * Q;
  ballscan::Queries<Q> qs;
  ballscan::load_queries(qs, new_xyz, b, s, q0, nsample);
  ballscan::stage_points(xyz + (size_t)b * n * 3, n, np, pts);
  __syncthreads();
  if (q0 >= s) return;  // whole warp leaves together
  int32_t* slots = reinterpret_cast<int32_t*>(pts + np) + warp * Q * nsample;
  ballscan::scan(qs, pts, n, np, s, q0, radius2, nsample,
                 [&](int t) { return slots + t * nsample; });
  __syncwarp();

  // the walk: lane l's first chunk of an aligned body is chunk 32 part + l,
  // at value 8 (32 part + l); a step is 32 split chunks
  const int first = 8 * (32 * part + lane);
  const int k_lane = first / c, c_lane = first - k_lane * c;
  const int k_step = 256 * split / c, c_step = 256 * split - k_step * c;
  const int total = nsample * c;
  const __nv_bfloat16* cloud = base + (size_t)b * n * c;
#pragma unroll
  for (int t = 0; t < Q; ++t) {
    if (q0 + t >= s) break;
    const int32_t* sl = slots + t * nsample;
    const size_t row = (size_t)b * s + q0 + t;
    if (part == 0) {
      for (int j = lane; j < nsample; j += 32) idx[row * nsample + j] = sl[j];
    }
    // the center rounded to bf16, as the JAX kernel's qc
    const float q_0 = __bfloat162float(__float2bfloat16_rn(qs.c0[t]));
    const float q_1 = __bfloat162float(__float2bfloat16_rn(qs.c1[t]));
    const float q_2 = __bfloat162float(__float2bfloat16_rn(qs.c2[t]));
    const uint32_t c01 = bf16_bits(q_0) | (bf16_bits(q_1) << 16), c2 = bf16_bits(q_2);
    auto value = [&](int k, int cc) {
      const float v = __bfloat162float(cloud[(size_t)sl[k] * c + cc]);
      return cc < 3 ? __fsub_rn(v, cc == 0 ? q_0 : cc == 1 ? q_1 : q_2) : v;
    };
    __nv_bfloat16* slab = out + row * total;
    // values before the slab's first 16-byte boundary, and after its body
    int head = (int)((((uintptr_t)0 - (uintptr_t)slab) & 15) / 2);
    head = head < total ? head : total;
    const int body = (total - head) / 8;  // 16-byte stores
    const int tail = total - head - 8 * body;
    if (part == 0) {
      if (lane < head) slab[lane] = __float2bfloat16_rn(value(lane / c, lane % c));
      if (lane < tail) {
        const int at = total - 1 - lane;
        slab[at] = __float2bfloat16_rn(value(at / c, at % c));
      }
    }
    int k = k_lane, cc = c_lane + head;
    while (cc >= c) cc -= c, ++k;
    uint4* dst = reinterpret_cast<uint4*>(slab + head);
    const int stride = 32 * split;  // chunks between a lane's chunks
    auto advance = [&](int& kk, int& ce) {
      kk += k_step;
      ce += c_step;
      if (ce >= c) ce -= c, ++kk;
    };
#if LSDM_SG_ABLATE == 2
    uint32_t sink = 0u;
#define LSDM_SG_STORE(at, o) (sink ^= (o).x ^ (o).y ^ (o).z ^ (o).w)
#else
#define LSDM_SG_STORE(at, o) __stcs(dst + (at), (o))
#endif
#if LSDM_SG_ABLATE == 1
    for (int v = 32 * part + lane; v < body; v += stride)
      LSDM_SG_STORE(v, make_uint4(0x3f803f80u, 0x3f803f80u, 0x3f803f80u, 0x3f803f80u));
#else
    if constexpr (kTwoPieces) {
      // C >= 8, at most two pieces a chunk: two chunks a step, all their
      // loads issued before either is assembled
      for (int v = 32 * part + lane; v < body; v += 2 * stride) {
        int k1 = k, c1 = cc;
        advance(k1, c1);
        const bool second = v + stride < body;
        const Pieces p0 = load_pieces(cloud, sl, c, k, cc, true);
        const Pieces p1 = load_pieces(cloud, sl, c, k1, c1, second);
        LSDM_SG_STORE(v, assemble(p0, c, c01, c2));
        if (second) LSDM_SG_STORE(v + stride, assemble(p1, c, c01, c2));
        k = k1, cc = c1;
        advance(k, cc);
      }
    } else {
      // C < 8: a chunk spans up to three slots; one value a load
      for (int v = 32 * part + lane; v < body; v += stride) {
        uint32_t o[4];
        int kk = k, ce = cc;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float lo = value(kk, ce);
          if (++ce == c) ce = 0, ++kk;
          o[i] = pack(lo, value(kk, ce));
          if (++ce == c) ce = 0, ++kk;
        }
        LSDM_SG_STORE(v, make_uint4(o[0], o[1], o[2], o[3]));
        advance(k, cc);
      }
    }
#endif
#undef LSDM_SG_STORE
#if LSDM_SG_ABLATE == 2
    if (sink == 0x9e3779b9u + (uint32_t)n) dst[0] = make_uint4(sink, 0u, 0u, 0u);
#endif
  }
}

template <int kQueriesPerWarp, bool kTwoPieces>
cudaError_t launch_select_gather_bf16(const float* xyz, const float* new_xyz,
                                      const __nv_bfloat16* base, int b, int n,
                                      int s, int c, float radius2, int nsample,
                                      int split, __nv_bfloat16* out,
                                      int32_t* idx, cudaStream_t stream) {
  const int np = (n + kRoundPoints - 1) / kRoundPoints * kRoundPoints;
  const size_t smem = sizeof(float4) * (size_t)np +
                      sizeof(int32_t) * (size_t)kWarps * kQueriesPerWarp * nsample;
  if (smem > ballscan::kSmemMax) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {  // above the default, only by opting in
    const cudaError_t err = cudaFuncSetAttribute(
        select_gather_bf16_kernel<kQueriesPerWarp, kTwoPieces>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  // warps: one a center group of kQueriesPerWarp, times split
  const long long warps = (long long)(s + kQueriesPerWarp - 1) / kQueriesPerWarp * split;
  const dim3 grid((unsigned)((warps + kWarps - 1) / kWarps), b);
  select_gather_bf16_kernel<kQueriesPerWarp, kTwoPieces><<<grid, kWarps * 32, smem, stream>>>(
      xyz, new_xyz, base, n, np, s, c, radius2, nsample, split, out, idx);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// xyz (B, N, 3), new_xyz (B, S, 3) float32, base (B, N, C) bf16 ->
// out (B, S, nsample, C) bf16, idx (B, S, nsample) int32; centers a warp
// (1, 2 or 4) and warps a slab (1, 2, 4 or 8; more than 1 only with one
// center a warp) from the host plan.
int lsdm_select_gather_bf16(const float* xyz, const float* new_xyz,
                            const __nv_bfloat16* base, int b, int n, int s,
                            int c, float radius2, int nsample,
                            int queries_per_warp, int split,
                            __nv_bfloat16* out, int32_t* idx, void* stream) {
  if (b <= 0 || s <= 0 || n <= 0 || nsample <= 0) return 0;
  if (c < 3 || b > 65535) return (int)cudaErrorInvalidValue;
  if (split != 1 && split != 2 && split != 4 && split != 8)
    return (int)cudaErrorInvalidValue;
  if (split > 1 && queries_per_warp != 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define LSDM_SG_LAUNCH(Q, TWO)                                                 \
  return (int)launch_select_gather_bf16<Q, TWO>(xyz, new_xyz, base, b, n, s, c, \
                                                radius2, nsample, split, out,   \
                                                idx, st)
  const bool two = c >= 8;
  switch (queries_per_warp) {
    case 1:
      if (two) LSDM_SG_LAUNCH(1, true);
      LSDM_SG_LAUNCH(1, false);
    case 2:
      if (two) LSDM_SG_LAUNCH(2, true);
      LSDM_SG_LAUNCH(2, false);
    case 4:
      if (two) LSDM_SG_LAUNCH(4, true);
      LSDM_SG_LAUNCH(4, false);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LSDM_SG_LAUNCH
}

}  // extern "C"

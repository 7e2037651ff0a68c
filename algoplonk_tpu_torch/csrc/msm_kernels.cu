// The four MSM kernels of the bucket scan (algoplonk_tpu_torch/ops/msm.py),
// CUDA for sm_90a, bound to Python through a plain C interface (ctypes).
//
// They replace these Pallas TPU kernels of algoplonk_tpu/ops/curve_pallas.py:
//   K1 pallas_mixed_add_signed_multi (:250) -> ap_mixed_add_signed_multi
//   K2 pallas_jac_add_multi_scan     (:357) -> ap_jac_add_multi_scan
//   K3 pallas_jac_add                (:292) -> ap_jac_add
//   K4 pallas_canon                  (:404) -> ap_canon
//
// Layout, as on the TPU: limbs-major [coord, W, B] int32 words, lane b of
// word w of coordinate k at (k * W + w) * B + b.  One thread owns one lane, so
// a warp reads each word of 32 neighbouring lanes as one coalesced 128-byte
// line.  On the TPU the grid walks tiles of 512 lanes in order; here every
// lane is independent, the sequential step axis (g) becomes a loop inside the
// thread, and the accumulator stays in registers across all g steps, as it
// stayed in VMEM there.
//
// What bounds them on the H100: 32-bit integer multiply throughput and
// registers.  A mixed add is 11 Montgomery multiplies (~3,000 integer
// instructions at W = 8) on ~100 live words per lane; memory traffic per add
// is 24 words of accumulator (once per kernel) plus 16 words per gathered
// point.  The design answers with one lane per thread, fully unrolled word
// loops, strict (canonical) arithmetic so no bound tracking is needed, and
// 128-thread blocks so the register file, not the block size, sets
// occupancy.  Making them fast (lazy reduction, PTX carry chains, shared
// point tables) is later work.
//
// K1 also fuses the point gather that the TPU path staged through HBM
// (algoplonk_tpu/ops/msm.py:271-273): it reads the [N+1, 2W] flat affine table
// at the row of each packed member index (sign in bit SIGN_SHIFT), clamping
// the row as the XLA gather clamps.
//
// Every entry point launches on the given stream, does not synchronise, and
// returns cudaGetLastError() so the caller sees a refused launch.

#include <cuda_runtime.h>

#include <cstdint>

#include "curve.cuh"

namespace {

constexpr int kW = 8;            // BN254: both fields are 8 words
constexpr int kThreads = 128;
constexpr int kSignShift = 26;   // ops/msm.py SIGN_SHIFT
constexpr int kRowMask = (1 << kSignShift) - 1;

using Consts = ap::CurveConsts<kW>;
using P = ap::Proj<kW>;

template <int W>
__device__ __forceinline__ void load_proj(ap::Proj<W>& q, const uint32_t* src,
                                          int64_t B, int64_t b) {
#pragma unroll
  for (int w = 0; w < W; ++w) {
    q.x[w] = src[(0 * W + w) * B + b];
    q.y[w] = src[(1 * W + w) * B + b];
    q.z[w] = src[(2 * W + w) * B + b];
  }
}

template <int W>
__device__ __forceinline__ void store_proj(uint32_t* dst, const ap::Proj<W>& q,
                                           int64_t B, int64_t b) {
#pragma unroll
  for (int w = 0; w < W; ++w) {
    dst[(0 * W + w) * B + b] = q.x[w];
    dst[(1 * W + w) * B + b] = q.y[w];
    dst[(2 * W + w) * B + b] = q.z[w];
  }
}

// K1: acc [3, W, B] + g signed affine points gathered from pts [nrows, 2W]
// at packed [g, B] -> out [3, W, B].
__global__ void __launch_bounds__(kThreads)
mixed_add_signed_multi_kernel(const uint32_t* __restrict__ acc,
                              const uint32_t* __restrict__ pts,
                              const int32_t* __restrict__ packed,
                              uint32_t* __restrict__ out, int64_t B, int g,
                              int64_t nrows, Consts cc) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  P a;
  load_proj<kW>(a, acc, B, b);
  for (int k = 0; k < g; ++k) {
    const int32_t pk = packed[(int64_t)k * B + b];
    int64_t row = pk & kRowMask;
    if (row > nrows - 1) row = nrows - 1;
    const bool neg = ((pk >> kSignShift) == 1);
    uint32_t x2[kW], y2[kW];
    const uint32_t* src = pts + row * (2 * kW);
#pragma unroll
    for (int w = 0; w < kW; ++w) {
      x2[w] = src[w];
      y2[w] = src[kW + w];
    }
    // identity from the raw coordinates, before the sign is applied
    const bool q_inf = ap::is_zero<kW>(x2) && ap::is_zero<kW>(y2);
    if (neg) {
      uint32_t zero[kW] = {0};
      ap::sub_mod<kW>(y2, zero, y2, cc.f.p);
    }
    ap::mixed_add<kW>(a, x2, y2, q_inf, cc);
  }
  store_proj<kW>(out, a, B, b);
}

// K2: acc [3, W, B] + qs[0..g) ([3g, W, B]), emitting the accumulator after
// every step: out[3k:3k+3] = acc + qs[0] + ... + qs[k].
__global__ void __launch_bounds__(kThreads)
jac_add_multi_scan_kernel(const uint32_t* __restrict__ acc,
                          const uint32_t* __restrict__ qs,
                          uint32_t* __restrict__ out, int64_t B, int g,
                          Consts cc) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  P a, q;
  load_proj<kW>(a, acc, B, b);
  for (int k = 0; k < g; ++k) {
    load_proj<kW>(q, qs + (int64_t)3 * k * kW * B, B, b);
    ap::jac_add<kW>(a, a, q, cc);
    store_proj<kW>(out + (int64_t)3 * k * kW * B, a, B, b);
  }
}

// K3: p [3, W, B] + q [3, W, B] -> out [3, W, B].
__global__ void __launch_bounds__(kThreads)
jac_add_kernel(const uint32_t* __restrict__ p, const uint32_t* __restrict__ q,
               uint32_t* __restrict__ out, int64_t B, Consts cc) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  P a, c;
  load_proj<kW>(a, p, B, b);
  load_proj<kW>(c, q, B, b);
  ap::jac_add<kW>(a, a, c, cc);
  store_proj<kW>(out, a, B, b);
}

// K4: x [R, W, B] (any W-word values) -> canonical x mod p, one Montgomery
// multiply by the Montgomery one per element.
__global__ void __launch_bounds__(kThreads)
canon_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
             int64_t rows, int64_t B, Consts cc) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * B) return;
  const int64_t r = i / B, b = i % B;
  uint32_t v[kW];
#pragma unroll
  for (int w = 0; w < kW; ++w) v[w] = x[(r * kW + w) * B + b];
  ap::mont_mul<kW>(v, v, cc.f.one, cc.f);
#pragma unroll
  for (int w = 0; w < kW; ++w) out[(r * kW + w) * B + b] = v[w];
}

inline unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// consts: host pointer to the packed Consts words (p, n0, one, b3).
int ap_mixed_add_signed_multi(const void* acc, const void* pts,
                              const void* packed, void* out, int64_t B, int g,
                              int64_t nrows, const void* consts,
                              void* stream) {
  const Consts cc = *static_cast<const Consts*>(consts);
  if (B > 0)
    mixed_add_signed_multi_kernel<<<blocks_for(B), kThreads, 0,
                                    (cudaStream_t)stream>>>(
        (const uint32_t*)acc, (const uint32_t*)pts, (const int32_t*)packed,
        (uint32_t*)out, B, g, nrows, cc);
  return (int)cudaGetLastError();
}

int ap_jac_add_multi_scan(const void* acc, const void* qs, void* out,
                          int64_t B, int g, const void* consts, void* stream) {
  const Consts cc = *static_cast<const Consts*>(consts);
  if (B > 0)
    jac_add_multi_scan_kernel<<<blocks_for(B), kThreads, 0,
                                (cudaStream_t)stream>>>(
        (const uint32_t*)acc, (const uint32_t*)qs, (uint32_t*)out, B, g, cc);
  return (int)cudaGetLastError();
}

int ap_jac_add(const void* p, const void* q, void* out, int64_t B,
               const void* consts, void* stream) {
  const Consts cc = *static_cast<const Consts*>(consts);
  if (B > 0)
    jac_add_kernel<<<blocks_for(B), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)p, (const uint32_t*)q, (uint32_t*)out, B, cc);
  return (int)cudaGetLastError();
}

int ap_canon(const void* x, void* out, int64_t rows, int64_t B,
             const void* consts, void* stream) {
  const Consts cc = *static_cast<const Consts*>(consts);
  if (rows * B > 0)
    canon_kernel<<<blocks_for(rows * B), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (uint32_t*)out, rows, B, cc);
  return (int)cudaGetLastError();
}

int ap_consts_words() { return (int)(sizeof(Consts) / sizeof(uint32_t)); }

}  // extern "C"

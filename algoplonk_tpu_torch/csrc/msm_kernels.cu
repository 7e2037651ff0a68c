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
// registers.  A mixed add is 13 Montgomery multiplies (~3,500 integer
// multiply instructions at W = 8, ~7,800 at W = 12) on ~100 (W = 8) or ~150
// (W = 12) live words per lane; memory traffic per add is 3W words of
// accumulator (once per kernel) plus 2W words per gathered point.  The design
// answers with one lane per thread, fully unrolled word loops, strict
// (canonical) arithmetic so no bound tracking is needed, and 128-thread blocks
// so the register file, not the block size, sets occupancy.  At W = 12 a
// projective point is 36 words and ptxas spills (chip_smoke.py prints its
// report).  Making them fast (lazy reduction, PTX carry chains, shared point
// tables) is later work.
//
// Every kernel is a template on W.  The file is compiled once for W = 8
// (BN254's fields) and once for W = 12 (BLS12-381's base field), and each
// object exports its entry points under names that end in its width
// (lanes.cuh: ap_canon_w8, ap_canon_w12).
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
#include "lanes.cuh"

namespace {

using ap::kThreads;
constexpr int kSignShift = 26;   // ops/msm.py SIGN_SHIFT
constexpr int kRowMask = (1 << kSignShift) - 1;
using ap::blocks_for;
using ap::load_proj;
using ap::store_proj;

// K1: acc [3, W, B] + g signed affine points gathered from pts [nrows, 2W]
// at packed [g, B] -> out [3, W, B].
template <int W>
__global__ void __launch_bounds__(kThreads)
mixed_add_signed_multi_kernel(const uint32_t* __restrict__ acc,
                              const uint32_t* __restrict__ pts,
                              const int32_t* __restrict__ packed,
                              uint32_t* __restrict__ out, int64_t B, int g,
                              int64_t nrows, ap::CurveConsts<W> cc) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  ap::Proj<W> a;
  load_proj<W>(a, acc, B, b);
  for (int k = 0; k < g; ++k) {
    const int32_t pk = packed[(int64_t)k * B + b];
    int64_t row = pk & kRowMask;
    if (row > nrows - 1) row = nrows - 1;
    const bool neg = ((pk >> kSignShift) == 1);
    uint32_t x2[W], y2[W];
    const uint32_t* src = pts + row * (2 * W);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      x2[w] = src[w];
      y2[w] = src[W + w];
    }
    // identity from the raw coordinates, before the sign is applied
    const bool q_inf = ap::is_zero<W>(x2) && ap::is_zero<W>(y2);
    if (neg) ap::neg_mod<W>(y2, cc.f.p);
    ap::mixed_add<W>(a, x2, y2, q_inf, cc);
  }
  store_proj<W>(out, a, B, b);
}

// K2: acc [3, W, B] + qs[0..g) ([3g, W, B]), emitting the accumulator after
// every step: out[3k:3k+3] = acc + qs[0] + ... + qs[k].
template <int W>
__global__ void __launch_bounds__(kThreads)
jac_add_multi_scan_kernel(const uint32_t* __restrict__ acc,
                          const uint32_t* __restrict__ qs,
                          uint32_t* __restrict__ out, int64_t B, int g,
                          ap::CurveConsts<W> cc) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  ap::Proj<W> a, q;
  load_proj<W>(a, acc, B, b);
  for (int k = 0; k < g; ++k) {
    load_proj<W>(q, qs + (int64_t)3 * k * W * B, B, b);
    ap::jac_add<W>(a, a, q, cc);
    store_proj<W>(out + (int64_t)3 * k * W * B, a, B, b);
  }
}

// K3: p [3, W, B] + q [3, W, B] -> out [3, W, B].
template <int W>
__global__ void __launch_bounds__(kThreads)
jac_add_kernel(const uint32_t* __restrict__ p, const uint32_t* __restrict__ q,
               uint32_t* __restrict__ out, int64_t B, ap::CurveConsts<W> cc) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  ap::Proj<W> a, c;
  load_proj<W>(a, p, B, b);
  load_proj<W>(c, q, B, b);
  ap::jac_add<W>(a, a, c, cc);
  store_proj<W>(out, a, B, b);
}

// K4: x [R, W, B] (any W-word values) -> canonical x mod p, one Montgomery
// multiply by the Montgomery one per element.
template <int W>
__global__ void __launch_bounds__(kThreads)
canon_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
             int64_t rows, int64_t B, ap::CurveConsts<W> cc) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * B) return;
  const int64_t r = i / B, b = i % B;
  uint32_t v[W];
#pragma unroll
  for (int w = 0; w < W; ++w) v[w] = x[(r * W + w) * B + b];
  ap::mont_mul<W>(v, v, cc.f.one, cc.f);
#pragma unroll
  for (int w = 0; w < W; ++w) out[(r * W + w) * B + b] = v[w];
}

}  // namespace

extern "C" {

// consts: host pointer to the packed CurveConsts<AP_W> words (p, n0, one, b3).
int AP_ENTRY(ap_mixed_add_signed_multi)(const void* acc, const void* pts,
                                        const void* packed, void* out,
                                        int64_t B, int g, int64_t nrows,
                                        const void* consts, void* stream) {
  const auto cc = *static_cast<const ap::CurveConsts<AP_W>*>(consts);
  if (B > 0)
    mixed_add_signed_multi_kernel<AP_W><<<blocks_for(B), kThreads, 0,
                                          (cudaStream_t)stream>>>(
        (const uint32_t*)acc, (const uint32_t*)pts, (const int32_t*)packed,
        (uint32_t*)out, B, g, nrows, cc);
  return (int)cudaGetLastError();
}

int AP_ENTRY(ap_jac_add_multi_scan)(const void* acc, const void* qs, void* out,
                                    int64_t B, int g, const void* consts,
                                    void* stream) {
  const auto cc = *static_cast<const ap::CurveConsts<AP_W>*>(consts);
  if (B > 0)
    jac_add_multi_scan_kernel<AP_W><<<blocks_for(B), kThreads, 0,
                                      (cudaStream_t)stream>>>(
        (const uint32_t*)acc, (const uint32_t*)qs, (uint32_t*)out, B, g, cc);
  return (int)cudaGetLastError();
}

int AP_ENTRY(ap_jac_add)(const void* p, const void* q, void* out, int64_t B,
                         const void* consts, void* stream) {
  const auto cc = *static_cast<const ap::CurveConsts<AP_W>*>(consts);
  if (B > 0)
    jac_add_kernel<AP_W><<<blocks_for(B), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)p, (const uint32_t*)q, (uint32_t*)out, B, cc);
  return (int)cudaGetLastError();
}

int AP_ENTRY(ap_canon)(const void* x, void* out, int64_t rows, int64_t B,
                       const void* consts, void* stream) {
  const auto cc = *static_cast<const ap::CurveConsts<AP_W>*>(consts);
  if (rows * B > 0)
    canon_kernel<AP_W><<<blocks_for(rows * B), kThreads, 0,
                         (cudaStream_t)stream>>>(
        (const uint32_t*)x, (uint32_t*)out, rows, B, cc);
  return (int)cudaGetLastError();
}

// Words of CurveConsts<AP_W>.
int AP_ENTRY(ap_consts_words)() {
  return (int)(sizeof(ap::CurveConsts<AP_W>) / sizeof(uint32_t));
}

}  // extern "C"

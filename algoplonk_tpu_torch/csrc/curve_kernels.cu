// The three curve kernels that no prove path runs, CUDA for sm_90a, bound to
// Python through a plain C interface (ctypes).
//
// They replace these Pallas TPU kernels of algoplonk_tpu/ops/curve_pallas.py:
//   K5 pallas_mixed_add        (:156) -> ap_mixed_add
//   K6 pallas_mixed_add_signed (:201) -> ap_mixed_add_signed
//   K7 pallas_jac_add_multi    (:324) -> ap_jac_add_multi
// (K8 pallas_field_mul is field_kernels.cu's.)
//
// They take the limbs-major [coord, W, B] layout of the MSM kernels
// (lanes.cuh), one lane per thread, and reuse their formulas (curve.cuh): K5
// and K6 are one step of K1 without the gather, K7 is K2 without the store
// after every step.
//
// Every kernel is a template on W.  The file is compiled once for W = 8 and
// once for W = 12, and each object exports its entry points under names that
// end in its width (lanes.cuh).  What bounds them on the H100 is what bounds
// K1-K4: 32-bit integer multiplies and, at W = 12, registers.  They run the
// lazy formulas of curve.cuh and store canonical words.  A simple kernel that
// is right is all this file claims; each is held word for word against its
// plain PyTorch version (algoplonk_tpu_torch/ops/curve_kernels.py).
//
// Every entry point launches on the given stream, does not synchronise, and
// returns cudaGetLastError() so the caller sees a refused launch.

#include <cuda_runtime.h>

#include <cstdint>

#include "curve.cuh"
#include "lanes.cuh"

namespace {

using ap::blocks_for;
using ap::kThreads;
using ap::load_proj;
using ap::store_proj;

template <int W>
__device__ __forceinline__ void load_affine(uint32_t* x, uint32_t* y,
                                            const uint32_t* src, int64_t B,
                                            int64_t b) {
#pragma unroll
  for (int w = 0; w < W; ++w) {
    x[w] = src[(0 * W + w) * B + b];
    y[w] = src[(1 * W + w) * B + b];
  }
}

// K5: acc [3, W, B] + affine pts [2, W, B] -> out [3, W, B]; (0, 0) is the
// identity.
template <int W>
__global__ void __launch_bounds__(kThreads)
mixed_add_kernel(const uint32_t* __restrict__ acc,
                 const uint32_t* __restrict__ pts, uint32_t* __restrict__ out,
                 int64_t B, ap::CurveConsts<W> cc) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  ap::Proj<W> a;
  load_proj<W>(a, acc, B, b);
  uint32_t x2[W], y2[W];
  load_affine<W>(x2, y2, pts, B, b);
  const bool q_inf = ap::is_zero<W>(x2) && ap::is_zero<W>(y2);
  ap::mixed_add<W>(a, x2, y2, q_inf, cc);
  store_proj<W>(out, a, B, b, cc.f.p);
}

// K6: as K5, with the point negated on lanes where neg [1, B] is non-zero.
// The identity mask comes from the raw coordinates, before the negation.
template <int W>
__global__ void __launch_bounds__(kThreads)
mixed_add_signed_kernel(const uint32_t* __restrict__ acc,
                        const uint32_t* __restrict__ pts,
                        const int32_t* __restrict__ neg,
                        uint32_t* __restrict__ out, int64_t B,
                        ap::CurveConsts<W> cc) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  ap::Proj<W> a;
  load_proj<W>(a, acc, B, b);
  uint32_t x2[W], y2[W];
  load_affine<W>(x2, y2, pts, B, b);
  const bool q_inf = ap::is_zero<W>(x2) && ap::is_zero<W>(y2);
  if (neg[b] != 0) ap::neg_mod<W>(y2, cc.f.p);
  ap::mixed_add<W>(a, x2, y2, q_inf, cc);
  store_proj<W>(out, a, B, b, cc.f.p);
}

// K7's blocks per SM for ptxas: with no minimum, ptxas held K7 at W = 12 to
// 168 registers and spilled 28 bytes; a minimum of 2 gives it 190 and no
// spill (the step loop's unrolling made no difference).
constexpr int kK7MinBlocks = AP_W == 8 ? 1 : 2;

// K7: acc [3, W, B] + qs[0..g) ([3g, W, B]) -> out [3, W, B], the
// accumulator kept in registers and stored once.
template <int W>
__global__ void __launch_bounds__(kThreads, kK7MinBlocks)
jac_add_multi_kernel(const uint32_t* __restrict__ acc,
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
  }
  store_proj<W>(out, a, B, b, cc.f.p);
}

}  // namespace

extern "C" {

// consts: host pointer to the packed CurveConsts<AP_W> words (p, n0, one,
// 2p, k3b).
int AP_ENTRY(ap_mixed_add)(const void* acc, const void* pts, void* out,
                           int64_t B, const void* consts, void* stream) {
  const auto cc = *static_cast<const ap::CurveConsts<AP_W>*>(consts);
  if (B > 0)
    mixed_add_kernel<AP_W><<<blocks_for(B), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)acc, (const uint32_t*)pts, (uint32_t*)out, B, cc);
  return (int)cudaGetLastError();
}

int AP_ENTRY(ap_mixed_add_signed)(const void* acc, const void* pts,
                                  const void* neg, void* out, int64_t B,
                                  const void* consts, void* stream) {
  const auto cc = *static_cast<const ap::CurveConsts<AP_W>*>(consts);
  if (B > 0)
    mixed_add_signed_kernel<AP_W><<<blocks_for(B), kThreads, 0,
                                    (cudaStream_t)stream>>>(
        (const uint32_t*)acc, (const uint32_t*)pts, (const int32_t*)neg,
        (uint32_t*)out, B, cc);
  return (int)cudaGetLastError();
}

int AP_ENTRY(ap_jac_add_multi)(const void* acc, const void* qs, void* out,
                               int64_t B, int g, const void* consts,
                               void* stream) {
  const auto cc = *static_cast<const ap::CurveConsts<AP_W>*>(consts);
  if (B > 0)
    jac_add_multi_kernel<AP_W><<<blocks_for(B), kThreads, 0,
                                 (cudaStream_t)stream>>>(
        (const uint32_t*)acc, (const uint32_t*)qs, (uint32_t*)out, B, g, cc);
  return (int)cudaGetLastError();
}

}  // extern "C"

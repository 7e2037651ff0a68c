// Lane layout, launch helpers and entry-point names shared by
// msm_kernels.cu and curve_kernels.cu.
//
// Layout, as on the TPU: limbs-major [coord, W, B] int32 words, lane b of
// word w of coordinate k at (k * W + w) * B + b.  One thread owns one lane
// (K2 runs several threads per lane: msm_kernels.cu).  Points are loaded
// canonical, carried lazily through the formulas (curve.cuh) and stored
// canonical.
//
// Those two sources are compiled once per width, with -DAP_W=8 and
// -DAP_W=12 (ops/_build.py), so that the long W = 12 builds run in
// processes of their own.  Each object names its C entry points with the
// suffix of its width: AP_ENTRY(ap_jac_add) is ap_jac_add_w12 under
// -DAP_W=12.

#pragma once

#ifndef AP_W
#error "compile with -DAP_W=8 or -DAP_W=12"
#endif

#define AP_ENTRY_PASTE(name, w) name##_w##w
#define AP_ENTRY_NAME(name, w) AP_ENTRY_PASTE(name, w)
#define AP_ENTRY(name) AP_ENTRY_NAME(name, AP_W)

#include <cstdint>

#include "curve.cuh"

namespace ap {

constexpr int kThreads = 128;

inline unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

template <int W>
__device__ __forceinline__ void load_proj(Proj<W>& q, const uint32_t* src,
                                          int64_t B, int64_t b) {
#pragma unroll
  for (int w = 0; w < W; ++w) {
    q.x[w] = src[(0 * W + w) * B + b];
    q.y[w] = src[(1 * W + w) * B + b];
    q.z[w] = src[(2 * W + w) * B + b];
  }
}

// Stores a lazy point (coordinates below 2p) in canonical form.
template <int W>
__device__ __forceinline__ void store_proj(uint32_t* dst, const Proj<W>& q,
                                           int64_t B, int64_t b,
                                           const uint32_t* p) {
  uint32_t x[W], y[W], z[W];
  cond_sub<W>(x, q.x, p);
  cond_sub<W>(y, q.y, p);
  cond_sub<W>(z, q.z, p);
#pragma unroll
  for (int w = 0; w < W; ++w) {
    dst[(0 * W + w) * B + b] = x[w];
    dst[(1 * W + w) * B + b] = y[w];
    dst[(2 * W + w) * B + b] = z[w];
  }
}

}  // namespace ap

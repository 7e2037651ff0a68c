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
// registers.  A mixed add is 11 Montgomery multiplies (curve.cuh; 2,992
// multiply instructions at W = 8, 6,600 at W = 12) on ~100 (W = 8) or ~150
// (W = 12) live words per lane; memory traffic per add is 3W words of
// accumulator (once per kernel) plus 2W words per gathered point.  The design
// answers with fully unrolled word loops on the lazy field core (field.cuh,
// PTX carry chains, values kept below 2p and made canonical once, at the
// store), and:
// - K1 reads each gathered row as 16-byte vectors and fetches the next
//   step's row (and the index after it) before the current step's add: into
//   registers at W = 8, with cp.async into a per-thread slot of shared
//   memory, double-buffered, at W = 12, where registers are short.  Its block
//   size is set per width (kK1Threads) so that a commit's lanes spread over
//   all 132 SMs.
// - K2 runs T threads per lane (T of 1, 4 or 16, chosen by the wrapper
//   from the lane and step counts alone), so that the few lanes of phase 2a
//   fill the card: each thread sums its g/T steps, the T partial sums are
//   scanned across the lane's threads (Kogge-Stone, exclusive, acc put in
//   front, through warp shuffles: a lane's threads share a warp), and each
//   thread rescans its steps from its carry-in.  The serial depth drops from
//   g adds to g/T - 1 + log2 T + g/T.  The RCB formulas are complete, so
//   the re-association is safe; the outputs equal the sequential scan's as
//   points, and word for word the plain version's, which follows the same
//   association (ops/curve_kernels.py plain_jac_add_multi_scan).
// ptxas fits every kernel without spills (chip_smoke.py prints its report).
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

// K1's block size and the blocks an SM must hold (ptxas's register budget).
#if AP_W == 8
constexpr int kK1Threads = 128;
constexpr int kK1MinBlocks = 3;
#else
constexpr int kK1Threads = 64;
constexpr int kK1MinBlocks = 5;
#endif

__device__ __forceinline__ int64_t row_of(int32_t pk, int64_t nrows) {
  const int64_t row = pk & kRowMask;
  return row > nrows - 1 ? nrows - 1 : row;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(gmem)
               : "memory");
}

template <int W>
__device__ __forceinline__ void unpack_row(uint32_t* x2, uint32_t* y2,
                                           const uint4* v) {
  uint32_t r[2 * W];
#pragma unroll
  for (int c = 0; c < W / 2; ++c) {
    r[4 * c] = v[c].x;
    r[4 * c + 1] = v[c].y;
    r[4 * c + 2] = v[c].z;
    r[4 * c + 3] = v[c].w;
  }
#pragma unroll
  for (int w = 0; w < W; ++w) {
    x2[w] = r[w];
    y2[w] = r[W + w];
  }
}

// One step of K1: acc <- acc + (+-) the gathered row.
template <int W>
__device__ __forceinline__ void signed_step(ap::Proj<W>& a, const uint4* row,
                                            int32_t pk,
                                            const ap::CurveConsts<W>& cc) {
  uint32_t x2[W], y2[W];
  unpack_row<W>(x2, y2, row);
  // identity from the raw coordinates, before the sign is applied
  const bool q_inf = ap::is_zero<W>(x2) && ap::is_zero<W>(y2);
  if ((pk >> kSignShift) == 1) ap::neg_mod<W>(y2, cc.f.p);
  ap::mixed_add<W>(a, x2, y2, q_inf, cc);
}

// K1: acc [3, W, B] + g signed affine points gathered from pts [nrows, 2W]
// at packed [g, B] -> out [3, W, B].  pts is 16-byte aligned (the wrapper
// checks), and a row is W / 2 16-byte vectors.
template <int W>
__global__ void __launch_bounds__(kK1Threads, kK1MinBlocks)
mixed_add_signed_multi_kernel(const uint32_t* __restrict__ acc,
                              const uint32_t* __restrict__ pts,
                              const int32_t* __restrict__ packed,
                              uint32_t* __restrict__ out, int64_t B, int g,
                              int64_t nrows, ap::CurveConsts<W> cc) {
  constexpr int kV = W / 2;             // 16-byte vectors per row
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const uint4* rows = reinterpret_cast<const uint4*>(pts);
  ap::Proj<W> a;
  load_proj<W>(a, acc, B, b);
  int32_t pk = g > 0 ? packed[b] : 0;
  int32_t pk_next = g > 1 ? packed[B + b] : 0;
  if constexpr (W <= 8) {
    // register double buffer
    uint4 cur[kV], nxt[kV];
    if (g > 0) {
      const uint4* src = rows + row_of(pk, nrows) * kV;
#pragma unroll
      for (int c = 0; c < kV; ++c) cur[c] = src[c];
    }
    for (int k = 0; k < g; ++k) {
      const int32_t pk_after = k + 2 < g ? packed[(int64_t)(k + 2) * B + b] : 0;
      if (k + 1 < g) {
        const uint4* s2 = rows + row_of(pk_next, nrows) * kV;
#pragma unroll
        for (int c = 0; c < kV; ++c) nxt[c] = s2[c];
      }
      signed_step<W>(a, cur, pk, cc);
#pragma unroll
      for (int c = 0; c < kV; ++c) cur[c] = nxt[c];
      pk = pk_next;
      pk_next = pk_after;
    }
  } else {
    // cp.async into this thread's two slots of shared memory, laid out
    // [slot][vector][thread] so that a warp's 16-byte reads hit distinct
    // banks
    extern __shared__ uint4 slots[];
    const int nt = blockDim.x, tid = threadIdx.x;
    auto issue = [&](int slot, int32_t p) {
      const uint4* s2 = rows + row_of(p, nrows) * kV;
#pragma unroll
      for (int c = 0; c < kV; ++c) cp_async16(&slots[(slot * kV + c) * nt + tid], s2 + c);
      asm volatile("cp.async.commit_group;" ::: "memory");
    };
    if (g > 0) issue(0, pk);
    for (int k = 0; k < g; ++k) {
      const int32_t pk_after = k + 2 < g ? packed[(int64_t)(k + 2) * B + b] : 0;
      if (k + 1 < g) {
        issue((k + 1) & 1, pk_next);
        asm volatile("cp.async.wait_group 1;" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;" ::: "memory");
      }
      uint4 cur[kV];
      const int slot = k & 1;
#pragma unroll
      for (int c = 0; c < kV; ++c) cur[c] = slots[(slot * kV + c) * nt + tid];
      signed_step<W>(a, cur, pk, cc);
      pk = pk_next;
      pk_next = pk_after;
    }
  }
  store_proj<W>(out, a, B, b, cc.f.p);
}

template <int W>
__device__ __forceinline__ void shfl_up_proj(ap::Proj<W>& dst,
                                             const ap::Proj<W>& src, int d,
                                             int T) {
#pragma unroll
  for (int w = 0; w < W; ++w) {
    dst.x[w] = __shfl_up_sync(0xffffffffu, src.x[w], d, T);
    dst.y[w] = __shfl_up_sync(0xffffffffu, src.y[w], d, T);
    dst.z[w] = __shfl_up_sync(0xffffffffu, src.z[w], d, T);
  }
}

// K2: acc [3, W, B] + qs[0..g) ([3g, W, B]), emitting the accumulator after
// every step: out[3k:3k+3] = acc + qs[0] + ... + qs[k], with T threads per
// lane (T a power of two <= 16 dividing g).  Thread s of lane b is thread
// b * T + s of the grid, so a lane's threads share a warp; lanes past B
// compute on lane B - 1's data, take part in the shuffles, and store nothing.
template <int W>
__global__ void __launch_bounds__(kThreads)
jac_add_multi_scan_kernel(const uint32_t* __restrict__ acc,
                          const uint32_t* __restrict__ qs,
                          uint32_t* __restrict__ out, int64_t B, int g, int T,
                          ap::CurveConsts<W> cc) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int s = (int)(t % T);
  const int64_t lane = t / T;
  const bool live = lane < B;
  const int64_t b = live ? lane : B - 1;
  const int L = g / T;
  const int k0 = s * L;
  const int64_t step = (int64_t)3 * W * B;
  ap::Proj<W> y, q;
  if (T > 1) {
    // 1. this thread's partial sum qs[k0] + ... + qs[k0 + L - 1]
    load_proj<W>(y, qs + k0 * step, B, b);
    for (int j = 1; j < L; ++j) {
      load_proj<W>(q, qs + (k0 + j) * step, B, b);
      ap::jac_add<W>(y, y, q, cc);
    }
    // 2. exclusive scan over the lane's threads: shift the partial sums up
    // by one, acc in front, then Kogge-Stone
    shfl_up_proj<W>(q, y, 1, T);
    if (s > 0) y = q;
  }
  if (s == 0) load_proj<W>(y, acc, B, b);
  for (int d = 1; d < T; d <<= 1) {
    shfl_up_proj<W>(q, y, d, T);
    if (s >= d) ap::jac_add<W>(y, q, y, cc);
  }
  // 3. rescan this thread's steps from its carry-in
  for (int j = 0; j < L; ++j) {
    load_proj<W>(q, qs + (k0 + j) * step, B, b);
    ap::jac_add<W>(y, y, q, cc);
    if (live) store_proj<W>(out + (k0 + j) * step, y, B, b, cc.f.p);
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
  store_proj<W>(out, a, B, b, cc.f.p);
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

// consts: host pointer to the packed CurveConsts<AP_W> words (p, n0, one,
// 2p, k3b).
int AP_ENTRY(ap_mixed_add_signed_multi)(const void* acc, const void* pts,
                                        const void* packed, void* out,
                                        int64_t B, int g, int64_t nrows,
                                        const void* consts, void* stream) {
  const auto cc = *static_cast<const ap::CurveConsts<AP_W>*>(consts);
  // W > 8: two row slots of shared memory per thread for cp.async
  const size_t smem = AP_W > 8 ? (size_t)2 * (AP_W / 2) * 16 * kK1Threads : 0;
  if (B > 0)
    mixed_add_signed_multi_kernel<AP_W>
        <<<(unsigned)((B + kK1Threads - 1) / kK1Threads), kK1Threads, smem,
           (cudaStream_t)stream>>>(
            (const uint32_t*)acc, (const uint32_t*)pts, (const int32_t*)packed,
            (uint32_t*)out, B, g, nrows, cc);
  return (int)cudaGetLastError();
}

// T: threads per lane, a power of two <= 16 that divides g.
int AP_ENTRY(ap_jac_add_multi_scan)(const void* acc, const void* qs, void* out,
                                    int64_t B, int g, int T,
                                    const void* consts, void* stream) {
  if (T < 1 || T > 16 || (T & (T - 1)) != 0 || g % T != 0)
    return (int)cudaErrorInvalidValue;
  const auto cc = *static_cast<const ap::CurveConsts<AP_W>*>(consts);
  if (B > 0 && g > 0)
    jac_add_multi_scan_kernel<AP_W><<<blocks_for(B * T), kThreads, 0,
                                      (cudaStream_t)stream>>>(
        (const uint32_t*)acc, (const uint32_t*)qs, (uint32_t*)out, B, g, T, cc);
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

// The four curve kernels that no prove path runs, CUDA for sm_90a, bound to
// Python through a plain C interface (ctypes).
//
// They replace these Pallas TPU kernels of algoplonk_tpu/ops/curve_pallas.py:
//   K4 pallas_canon            (:404) -> ap_canon
//   K5 pallas_mixed_add        (:156) -> ap_mixed_add
//   K6 pallas_mixed_add_signed (:201) -> ap_mixed_add_signed
//   K7 pallas_jac_add_multi    (:324) -> ap_jac_add_multi
// (K8 pallas_field_mul is field_kernels.cu's.)
//
// They take the limbs-major [coord, W, B] layout of the MSM kernels
// (lanes.cuh) and reuse their formulas (curve.cuh): K5 and K6 are one step
// of K1 without the gather, K7 is K2 without the store after every step.
// K4 makes any W-word value canonical; every curve kernel stores canonical
// words, so the MSM needs no K4.
//
// Every kernel is a template on W.  The file is compiled once for W = 8 and
// once for W = 12, and each object exports its entry points under names that
// end in its width (lanes.cuh).  K5-K7 run the lazy formulas of curve.cuh
// and store canonical words; each kernel is held word for word against its
// plain PyTorch version (algoplonk_tpu_torch/ops/curve_kernels.py).
//
// What bounds them on the H100.  K4 is bound by bytes: it reads each word
// once and writes it once.  On the TPU it was a strict Montgomery multiply
// by R mod p (2 W^2 + W products an element); here x < 2^(32 W) < (q + 1) p
// with q = floor((2^(32 W) - 1) / p), 5 for BN254's Fp and 9 for
// BLS12-381's, so x mod p is a ladder of conditional subtractions of 2^j p
// (j = 2, 1, 0 at W = 8; 3, 2, 1, 0 at W = 12), each a borrow chain and a
// select, and no multiply.  Each thread owns 4 consecutive lanes of one row,
// so each of its W loads and W stores is one 16-byte vector; a shape whose
// lanes or pointers do not allow that runs one lane a thread.
// K5-K7 are bound by 32-bit integer multiplies, and the chain of dependent
// ones each thread runs when the lanes are too few to fill the card's 132
// SMs with warps:
// - K7 (g projective adds per lane, the last sum only) ran g = 16 dependent
//   adds on one thread per lane: at the kernel-test widths, 1,664 lanes at
//   W = 12 are 13 blocks on 132 SMs.  It now runs T threads per lane (T a
//   power of two <= 16 dividing g, chosen by the wrapper from the lane and
//   step counts alone): each thread sums g/T steps and a tree of warp
//   shuffles adds the T partial sums, so the chain is g/T + log2 T adds.
//   The RCB formulas are complete, so the re-association is safe; the sum
//   equals the sequential one as a point, and word for word the plain
//   version's, which follows the same association.
// - K5 and K6 (one mixed add per lane, 11 multiplies in two stages of
//   independent ones; K6 negates the point on flagged lanes) share one
//   kernel, and run TM = 1 or 2 threads per lane, chosen by the wrapper
//   from the width: at TM = 2 one warp per role of ap::mixed_add_roles, the
//   products exchanged through shared memory, so the chain is 6
//   multiplies and the warps on the card double.  Every product is
//   ap::mixed_add's, so the words are too.  Its block and the blocks an SM
//   must hold are set per TM and width (kMixedThreads, kMixedMinBlocks) so
//   that a kernel-test width fills the card's SMs evenly.
//
// Every entry point launches on the given stream, does not synchronise, and
// returns cudaGetLastError() so the caller sees a refused launch.

#include <cuda_runtime.h>

#include <cstdint>

#include "curve.cuh"
#include "lanes.cuh"

namespace {

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

// Stores coordinate k of a lazy point (below 2p) in canonical form.
template <int W>
__device__ __forceinline__ void store_coord(uint32_t* dst, int k,
                                            const uint32_t* v, int64_t B,
                                            int64_t b, const uint32_t* p) {
  uint32_t x[W];
  ap::cond_sub<W>(x, v, p);
#pragma unroll
  for (int w = 0; w < W; ++w) dst[(k * W + w) * B + b] = x[w];
}

// K4's ladder, the multiples 2^j p it subtracts, largest first (j = S - 1,
// ..., 0).  S is compiled per width: the wrapper derives it from p and W
// (the bit length of floor((2^(32 W) - 1) / p)) and the entry refuses any
// other, so a field whose quotient needs one more step is never reduced
// wrongly.
constexpr int kCanonSteps = AP_W == 8 ? 3 : 4;
constexpr int kCanonThreads = 128;

template <int W, int S>
struct CanonLadder {
  uint32_t m[S][W];
};

// x <- x mod p for any W-word x below 2^S p: before the step that
// subtracts 2^j p, x < 2^(j+1) p, and one conditional subtraction (a
// borrow chain and a select, cond_sub) leaves x < 2^j p.
template <int W, int S>
__device__ __forceinline__ void canon_ladder(uint32_t* x,
                                             const CanonLadder<W, S>& c) {
#pragma unroll
  for (int j = 0; j < S; ++j) ap::cond_sub<W>(x, x, c.m[j]);
}

// K4: x [R, W, B] (any W-word values) -> out [R, W, B], each element x mod
// p, in one pass that reads every word once and writes it once.  V = 4:
// thread t owns lanes 4 (t mod B/4) ... + 3 of row t / (B/4), so each of
// its W loads and W stores is one 16-byte vector (B a multiple of 4, both
// pointers 16-byte aligned; streaming cache hints, nothing is read twice).
// V = 1: one lane a thread, for any other shape.
template <int W, int S, int V>
__global__ void __launch_bounds__(kCanonThreads)
canon_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
             int64_t rows, int64_t B, CanonLadder<W, S> c) {
  const int64_t groups = B / V;
  const int64_t t = (int64_t)blockIdx.x * kCanonThreads + threadIdx.x;
  if (t >= rows * groups) return;
  const int64_t r = t / groups;
  const int64_t at = r * W * B + (t - r * groups) * V;
  if constexpr (V == 4) {
    uint32_t e[4][W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const uint4 q = __ldcs(reinterpret_cast<const uint4*>(x + at + w * B));
      e[0][w] = q.x;
      e[1][w] = q.y;
      e[2][w] = q.z;
      e[3][w] = q.w;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) canon_ladder<W, S>(e[k], c);
#pragma unroll
    for (int w = 0; w < W; ++w)
      __stcs(reinterpret_cast<uint4*>(out + at + w * B),
             make_uint4(e[0][w], e[1][w], e[2][w], e[3][w]));
  } else {
    uint32_t e[W];
#pragma unroll
    for (int w = 0; w < W; ++w) e[w] = x[at + w * B];
    canon_ladder<W, S>(e, c);
#pragma unroll
    for (int w = 0; w < W; ++w) out[at + w * B] = e[w];
  }
}

// K5's and K6's shapes, index TM - 1 for TM = 1, 2 threads per lane: the
// block (TM = 1: one lane a thread; TM = 2: groups of two warps that share
// 32 lanes) and the blocks an SM must hold, which caps ptxas's registers:
// the fastest without a spill at the kernel-test widths on an H100
// (PERF.md).  A shape that runs 98,688 lanes at W = 8 in one wave needs at
// most 85 registers a thread, and ptxas spilled at 80 and at 96; at 128,
// blocks of 256 beat blocks of 128.
#if AP_W == 8
constexpr int kMixedThreads[2] = {256, 128};
constexpr int kMixedMinBlocks[2] = {2, 4};
#else
constexpr int kMixedThreads[2] = {128, 128};
constexpr int kMixedMinBlocks[2] = {3, 3};
#endif

// K5 and K6: acc [3, W, B] + affine pts [2, W, B] -> out [3, W, B]; (0, 0)
// is the identity.  kSigned (K6): the point is negated on lanes where neg
// [1, B] is non-zero, after the identity mask is taken from the raw
// coordinates; K5 reads no neg.  TM = 1: one thread per lane runs
// mixed_add.  TM = 2: a group of two warps runs 32 lanes, warp k of the
// group in role k of mixed_add_roles, and stores the coordinates its role
// holds (x and z, or y); lanes past B compute on lane B - 1's data (they
// hold the block's barriers) and store nothing.
template <int W, bool kSigned, int TM, int NT, int MINB>
__global__ void __launch_bounds__(NT, MINB)
mixed_add_signed_kernel(const uint32_t* __restrict__ acc,
                        const uint32_t* __restrict__ pts,
                        const int32_t* __restrict__ neg,
                        uint32_t* __restrict__ out, int64_t B,
                        ap::CurveConsts<W> cc) {
  constexpr int kGroups = TM == 1 ? 1 : NT / (32 * TM);
  static_assert(TM == 1 || NT == kGroups * 32 * TM, "a block of whole groups");
  const int warp = threadIdx.x / 32, l = threadIdx.x % 32;
  const int role = TM == 1 ? 0 : warp % TM;
  const int64_t lane =
      TM == 1 ? (int64_t)blockIdx.x * NT + threadIdx.x
              : ((int64_t)blockIdx.x * kGroups + warp / TM) * 32 + l;
  if (TM == 1 && lane >= B) return;
  const bool live = lane < B;
  const int64_t b = live ? lane : B - 1;
  ap::Proj<W> a;
  load_proj<W>(a, acc, B, b);
  uint32_t x2[W], y2[W];
  load_affine<W>(x2, y2, pts, B, b);
  const bool q_inf = ap::is_zero<W>(x2) && ap::is_zero<W>(y2);
  if constexpr (kSigned) {
    if (neg[b] != 0) ap::neg_mod<W>(y2, cc.f.p);
  }
  if constexpr (TM == 1) {
    ap::mixed_add<W>(a, x2, y2, q_inf, cc);
    store_proj<W>(out, a, B, b, cc.f.p);
  } else {
    __shared__ uint32_t ex[kGroups][ap::kRoleSlots * W * 32];
    ap::mixed_add_roles<W>(a, x2, y2, q_inf, role, ex[warp / TM], l, cc);
    if (live && role == 0) {
      store_coord<W>(out, 0, a.x, B, b, cc.f.p);
      store_coord<W>(out, 2, a.z, B, b, cc.f.p);
    } else if (live) {
      store_coord<W>(out, 1, a.y, B, b, cc.f.p);
    }
  }
}

// Launches K5 (kSigned false, neg unused) or K6 with Tm threads per lane
// (1 or 2) in that count's block shape.
template <int W, bool kSigned>
int launch_mixed_add(const void* acc, const void* pts, const void* neg,
                     void* out, int64_t B, int Tm,
                     const ap::CurveConsts<W>& cc, cudaStream_t stream) {
  if (Tm != 1 && Tm != 2) return (int)cudaErrorInvalidValue;
  const auto a = (const uint32_t*)acc, q = (const uint32_t*)pts;
  const auto s = (const int32_t*)neg;
  const auto o = (uint32_t*)out;
  if (B > 0 && Tm == 1) {
    constexpr int nt = kMixedThreads[0];
    mixed_add_signed_kernel<W, kSigned, 1, nt, kMixedMinBlocks[0]>
        <<<(unsigned)((B + nt - 1) / nt), nt, 0, stream>>>(a, q, s, o, B, cc);
  } else if (B > 0) {
    constexpr int nt = kMixedThreads[1], lanes = nt / 2;   // lanes per block
    mixed_add_signed_kernel<W, kSigned, 2, nt, kMixedMinBlocks[1]>
        <<<(unsigned)((B + lanes - 1) / lanes), nt, 0, stream>>>(a, q, s, o, B,
                                                                 cc);
  }
  return (int)cudaGetLastError();
}

template <int W>
__device__ __forceinline__ void shfl_down_proj(ap::Proj<W>& dst,
                                               const ap::Proj<W>& src, int d,
                                               int T) {
#pragma unroll
  for (int w = 0; w < W; ++w) {
    dst.x[w] = __shfl_down_sync(0xffffffffu, src.x[w], d, T);
    dst.y[w] = __shfl_down_sync(0xffffffffu, src.y[w], d, T);
    dst.z[w] = __shfl_down_sync(0xffffffffu, src.z[w], d, T);
  }
}

// K7's block and the blocks an SM must hold for ptxas: at W = 12 a minimum
// of 2 gives it 201 registers and no spill (with none, the one-thread
// kernel it replaced was held to 168 and spilled 28 bytes); at W = 8 no
// minimum gives 136 registers, and a minimum of 4 (128) spilled 16 bytes.
constexpr int kK7Threads = 128;
constexpr int kK7MinBlocks = AP_W == 8 ? 1 : 2;

// K7: acc [3, W, B] + qs[0..g) ([3g, W, B]) -> out [3, W, B], with T
// threads per lane (T a power of two <= 16 dividing g): thread s sums steps
// [s L, (s + 1) L) (L = g / T), thread 0 from acc, and a tree over the
// lane's threads adds the T partial sums, y[s] <- y[s] + y[s + d] for d =
// 1, 2, 4, ..., through warp shuffles (thread s of lane b is thread b T + s
// of the grid, so a lane's threads share a warp).  Thread 0 stores the
// sum; lanes past B compute on lane B - 1's data, take part in the
// shuffles, and store nothing.
template <int W, int NT, int MINB>
__global__ void __launch_bounds__(NT, MINB)
jac_add_multi_kernel(const uint32_t* __restrict__ acc,
                     const uint32_t* __restrict__ qs,
                     uint32_t* __restrict__ out, int64_t B, int g, int T,
                     ap::CurveConsts<W> cc) {
  const int64_t t = (int64_t)blockIdx.x * NT + threadIdx.x;
  const int s = (int)(t % T);
  const int64_t lane = t / T;
  const bool live = lane < B;
  const int64_t b = live ? lane : B - 1;
  const int L = g / T;
  const int64_t step = (int64_t)3 * W * B;
  ap::Proj<W> y, q;
  load_proj<W>(y, s == 0 ? acc : qs + s * L * step, B, b);
  for (int j = s == 0 ? 0 : 1; j < L; ++j) {
    load_proj<W>(q, qs + (s * L + j) * step, B, b);
    ap::jac_add<W>(y, y, q, cc);
  }
  for (int d = 1; d < T; d <<= 1) {
    shfl_down_proj<W>(q, y, d, T);
    ap::jac_add<W>(y, y, q, cc);
  }
  if (s == 0 && live) store_proj<W>(out, y, B, b, cc.f.p);
}

}  // namespace

extern "C" {

// K4.  steps: the ladder's length, which must be kCanonSteps; ladder: host
// pointer to its steps x W words (2^j p, largest first).
int AP_ENTRY(ap_canon)(const void* x, void* out, int64_t rows, int64_t B,
                       int steps, const void* ladder, void* stream) {
  if (steps != kCanonSteps || rows < 0 || B < 0)
    return (int)cudaErrorInvalidValue;
  const auto c = *static_cast<const CanonLadder<AP_W, kCanonSteps>*>(ladder);
  const bool vec = B % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  const int64_t threads = rows * (vec ? B / 4 : B);
  const unsigned blocks =
      (unsigned)((threads + kCanonThreads - 1) / kCanonThreads);
  const auto st = (cudaStream_t)stream;
  const auto in = (const uint32_t*)x;
  const auto o = (uint32_t*)out;
  if (threads > 0 && vec)
    canon_kernel<AP_W, kCanonSteps, 4><<<blocks, kCanonThreads, 0, st>>>(
        in, o, rows, B, c);
  else if (threads > 0)
    canon_kernel<AP_W, kCanonSteps, 1><<<blocks, kCanonThreads, 0, st>>>(
        in, o, rows, B, c);
  return (int)cudaGetLastError();
}

// consts: host pointer to the packed CurveConsts<AP_W> words (p, n0, one,
// 2p, k3b).  Tm: threads per lane, 1 or 2.
int AP_ENTRY(ap_mixed_add)(const void* acc, const void* pts, void* out,
                           int64_t B, int Tm, const void* consts,
                           void* stream) {
  const auto cc = *static_cast<const ap::CurveConsts<AP_W>*>(consts);
  return launch_mixed_add<AP_W, false>(acc, pts, nullptr, out, B, Tm, cc,
                                       (cudaStream_t)stream);
}

int AP_ENTRY(ap_mixed_add_signed)(const void* acc, const void* pts,
                                  const void* neg, void* out, int64_t B,
                                  int Tm, const void* consts, void* stream) {
  const auto cc = *static_cast<const ap::CurveConsts<AP_W>*>(consts);
  return launch_mixed_add<AP_W, true>(acc, pts, neg, out, B, Tm, cc,
                                      (cudaStream_t)stream);
}

// T: threads per lane, a power of two <= 16 that divides g (1 if g = 0).
int AP_ENTRY(ap_jac_add_multi)(const void* acc, const void* qs, void* out,
                               int64_t B, int g, int T, const void* consts,
                               void* stream) {
  if (T < 1 || T > 16 || (T & (T - 1)) != 0 || g % T != 0 || (g == 0 && T > 1))
    return (int)cudaErrorInvalidValue;
  const auto cc = *static_cast<const ap::CurveConsts<AP_W>*>(consts);
  if (B > 0)
    jac_add_multi_kernel<AP_W, kK7Threads, kK7MinBlocks>
        <<<(unsigned)((B * T + kK7Threads - 1) / kK7Threads), kK7Threads, 0,
           (cudaStream_t)stream>>>(
        (const uint32_t*)acc, (const uint32_t*)qs, (uint32_t*)out, B, g, T, cc);
  return (int)cudaGetLastError();
}

}  // extern "C"

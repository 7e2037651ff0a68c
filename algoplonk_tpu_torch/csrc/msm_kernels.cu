// The three MSM kernels of the bucket scan (algoplonk_tpu_torch/ops/msm.py),
// CUDA for sm_90a, bound to Python through a plain C interface (ctypes).
//
// They replace these Pallas TPU kernels of algoplonk_tpu/ops/curve_pallas.py:
//   K1 pallas_mixed_add_signed_multi (:250) -> ap_mixed_add_signed_multi
//   K2 pallas_jac_add_multi_scan     (:357) -> ap_jac_add_multi_scan
//   K3 pallas_jac_add                (:292) -> ap_jac_add, and the chains of
//      it that the MSM runs: ap_jac_add_window_scan, ap_window_combine
// Every one stores canonical words, so the MSM needs no K4 (pallas_canon,
// :404), which curve_kernels.cu holds with the other off-path kernels.
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
// - K3's chains: on the TPU every round of a window's Kogge-Stone scan
//   (algoplonk_tpu/ops/msm.py phase 2) and of phase 4's tree is one launch
//   of the single add, rolled and masked in HBM, and phase 4's doublings
//   and final add run in XLA.  Here one block owns one window, holds its
//   points in shared memory (limbs-major [coord][W][lane], so a warp's
//   accesses fall in distinct banks) and runs the whole chain with a
//   barrier between rounds.  Few windows (24 at a commit) leave most SMs
//   idle; the kernels are bound by the chain's depth of dependent adds,
//   not by the card's multiply rate.
// ptxas fits every kernel without spills (chip_smoke.py prints its report).
//
// Every kernel is a template on W.  The file is compiled once for W = 8
// (BN254's fields) and once for W = 12 (BLS12-381's base field), and each
// object exports its entry points under names that end in its width
// (lanes.cuh: ap_jac_add_w8, ap_jac_add_w12).
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

// Point i of n in a limbs-major shared array [3][W][n], lazy words as they
// are (no canonical form until the final store).
template <int W>
__device__ __forceinline__ void load_smem(ap::Proj<W>& q, const uint32_t* s,
                                          int n, int i) {
#pragma unroll
  for (int w = 0; w < W; ++w) {
    q.x[w] = s[(0 * W + w) * n + i];
    q.y[w] = s[(1 * W + w) * n + i];
    q.z[w] = s[(2 * W + w) * n + i];
  }
}

template <int W>
__device__ __forceinline__ void store_smem(uint32_t* s, int n, int i,
                                           const ap::Proj<W>& q) {
#pragma unroll
  for (int w = 0; w < W; ++w) {
    s[(0 * W + w) * n + i] = q.x[w];
    s[(1 * W + w) * n + i] = q.y[w];
    s[(2 * W + w) * n + i] = q.z[w];
  }
}

template <int W>
__device__ __forceinline__ void set_identity(ap::Proj<W>& q,
                                             const ap::CurveConsts<W>& cc) {
#pragma unroll
  for (int w = 0; w < W; ++w) {
    q.x[w] = 0;
    q.y[w] = cc.f.one[w];
    q.z[w] = 0;
  }
}

// K3 scan's block size: the most threads whose registers an SM holds (one
// add each per wave); a window of more lanes runs in waves.
#if AP_W == 8
constexpr int kScanThreads = 512;
#else
constexpr int kScanThreads = 256;
#endif
constexpr int kMaxWindow = 1024;   // CHUNK / K_BLOCK / SUPER (ops/msm.py)

// K3 scan: x [3, W, B] holds nwin = gridDim.x windows of E lanes (lane
// w * E + i); out [3, W, nwin * E] is each window's inclusive scan, in the
// association of the rolled loop it replaces (ops/curve_kernels.py
// plain_jac_add_window_scan): rounds sh = 1, 2, 4, ... < E, and in each
// y[i] <- y[i] + y[i - sh] for i >= sh, y[i] <- y[i] + identity for i < sh
// (which scales the point, so it is kept for the words' sake).  Block w
// holds window w in shared memory.  A round runs in waves of blockDim.x
// lanes from the top down: every thread of a wave reads its two operands
// and adds before the barrier and writes after it, and a wave reads only
// lanes below the ones the waves before it wrote, so one buffer serves.
template <int W>
__global__ void __launch_bounds__(kScanThreads)
jac_add_window_scan_kernel(const uint32_t* __restrict__ x,
                           uint32_t* __restrict__ out, int64_t B, int E,
                           ap::CurveConsts<W> cc) {
  extern __shared__ uint32_t y[];   // [3][W][E]
  const int nt = blockDim.x, tid = threadIdx.x;
  const int64_t lane0 = (int64_t)blockIdx.x * E;
  const int64_t live = (int64_t)gridDim.x * E;
  for (int i = tid; i < E; i += nt) {
    ap::Proj<W> q;
    load_proj<W>(q, x, B, lane0 + i);
    store_smem<W>(y, E, i, q);
  }
  __syncthreads();
  for (int sh = 1; sh < E; sh <<= 1) {
    for (int hi = E; hi > 0; hi -= nt) {
      const int i = hi - nt + tid;
      ap::Proj<W> a, b;
      if (i >= 0) {
        load_smem<W>(a, y, E, i);
        if (i >= sh)
          load_smem<W>(b, y, E, i - sh);
        else
          set_identity<W>(b, cc);
        ap::jac_add<W>(a, a, b, cc);
      }
      __syncthreads();
      if (i >= 0) store_smem<W>(y, E, i, a);
    }
    __syncthreads();
  }
  for (int i = tid; i < E; i += nt) {
    ap::Proj<W> q;
    load_smem<W>(q, y, E, i);
    store_proj<W>(out, q, live, lane0 + i, cc.f.p);
  }
}

// K3 phase 4's tree threads; one more warp runs the doubling chain.  An SM
// splits its registers over four quarters and a block's warps over those,
// so 9 warps cap a thread at 168 registers, which spills the W = 12 add;
// 8 warps allow 255.
#if AP_W == 8
constexpr int kTreeThreads = 256;
#else
constexpr int kTreeThreads = 224;
#endif

__device__ __forceinline__ void tree_sync() {
  asm volatile("bar.sync 1, %0;" ::"r"(kTreeThreads) : "memory");
}

// K3 phase 4: base, in_block [3, W, B] hold nw = gridDim.x windows of D + 1
// lanes (lane w * (D + 1) + d, D = 2^(c-1)); out [nw, 3, W] (batch-major,
// canonical) is S_w = D P[e_D] - sum_{d<D} P[e_d] with P[e_d] = base +
// in_block, as ops/curve_kernels.py plain_window_combine computes it a round
// at a time.  Block w: the tree threads sum P[e_d], d < D, by the rolled
// tree's pairing, restricted to the lanes that reach lane 0 (round h = D/2,
// ..., 1: y[j] <- y[j] + y[j + h] for j < h).  The first round is fused with
// the P[e_d] adds, so shared memory holds only the D/2 lanes that survive
// it (c = 12 fits at W = 12); the later rounds run in place, since y[j + h]
// is not written in the round that reads it.  Meanwhile thread
// kTreeThreads, in a warp of its own, adds P[e_D] and doubles it c - 1
// times in registers.  After one barrier it adds the negated sum.  The
// critical path is c + 2 dependent point operations.
template <int W>
__global__ void __launch_bounds__(kTreeThreads + 32)
window_combine_kernel(const uint32_t* __restrict__ base,
                      const uint32_t* __restrict__ in_block,
                      uint32_t* __restrict__ out, int64_t B, int D, int c,
                      ap::CurveConsts<W> cc) {
  extern __shared__ uint32_t y[];   // [3][W][n]
  const int tid = threadIdx.x;
  const int h0 = D >> 1, n = h0 > 0 ? h0 : 1;
  const int64_t lane0 = (int64_t)blockIdx.x * (D + 1);
  ap::Proj<W> top;
  if (tid < kTreeThreads) {
    // y[j] = P[e_j] + P[e_{j + h0}] (y[0] = P[e_0] when D = 1); the second
    // point waits in y[j], so that one point at a time stays in registers
    for (int j = tid; j < n; j += kTreeThreads) {
      ap::Proj<W> a, b;
#pragma unroll 1
      for (int k = h0 > 0; k >= 0; --k) {
        load_proj<W>(a, base, B, lane0 + j + k * h0);
        load_proj<W>(b, in_block, B, lane0 + j + k * h0);
        ap::jac_add<W>(a, a, b, cc);
        if (k) store_smem<W>(y, n, j, a);
      }
      if (h0 > 0) {
        load_smem<W>(b, y, n, j);
        ap::jac_add<W>(a, a, b, cc);
      }
      store_smem<W>(y, n, j, a);
    }
    tree_sync();
    for (int h = h0 >> 1; h >= 1; h >>= 1) {
      for (int j = tid; j < h; j += kTreeThreads) {
        ap::Proj<W> a, b;
        load_smem<W>(a, y, n, j);
        load_smem<W>(b, y, n, j + h);
        ap::jac_add<W>(a, a, b, cc);
        store_smem<W>(y, n, j, a);
      }
      tree_sync();
    }
  } else if (tid == kTreeThreads) {
    ap::Proj<W> b;
    load_proj<W>(top, base, B, lane0 + D);
    load_proj<W>(b, in_block, B, lane0 + D);
    ap::jac_add<W>(top, top, b, cc);
    for (int k = 1; k < c; ++k) ap::jac_double<W>(top, top, cc);
  }
  __syncthreads();
  if (tid == kTreeThreads) {
    ap::Proj<W> s;
    load_smem<W>(s, y, n, 0);
    const uint32_t zero[W] = {0};
    ap::sub_lazy<W>(s.y, zero, s.y, cc.p2);   // -sum
    ap::jac_add<W>(top, top, s, cc);
    uint32_t* o = out + (int64_t)blockIdx.x * 3 * W;
    ap::cond_sub<W>(o, top.x, cc.f.p);
    ap::cond_sub<W>(o + W, top.y, cc.f.p);
    ap::cond_sub<W>(o + 2 * W, top.z, cc.f.p);
  }
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

// nwin windows of E lanes (1 <= E <= kMaxWindow) in x's B lanes; out has
// nwin * E lanes.  Above 48 KB the window's shared memory must be allowed
// explicitly; its error, like a refused launch, is returned.
int AP_ENTRY(ap_jac_add_window_scan)(const void* x, void* out, int64_t B,
                                     int nwin, int E, const void* consts,
                                     void* stream) {
  if (E < 1 || E > kMaxWindow || nwin < 0 || (int64_t)nwin * E > B)
    return (int)cudaErrorInvalidValue;
  const auto cc = *static_cast<const ap::CurveConsts<AP_W>*>(consts);
  const int nt = ((E + 31) / 32) * 32 < kScanThreads ? ((E + 31) / 32) * 32
                                                     : kScanThreads;
  const size_t smem = (size_t)E * 3 * AP_W * sizeof(uint32_t);
  const cudaError_t e = cudaFuncSetAttribute(
      jac_add_window_scan_kernel<AP_W>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (nwin > 0)
    jac_add_window_scan_kernel<AP_W><<<nwin, nt, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (uint32_t*)out, B, E, cc);
  return (int)cudaGetLastError();
}

// nw windows of D + 1 lanes in the B lanes of base and in_block, D =
// 2^(c-1); out is [nw, 3, W].
int AP_ENTRY(ap_window_combine)(const void* base, const void* in_block,
                                void* out, int64_t B, int nw, int c,
                                const void* consts, void* stream) {
  if (c < 1 || c > 12 || nw < 0) return (int)cudaErrorInvalidValue;
  const int D = 1 << (c - 1);
  if ((int64_t)nw * (D + 1) > B) return (int)cudaErrorInvalidValue;
  const auto cc = *static_cast<const ap::CurveConsts<AP_W>*>(consts);
  const size_t smem = (size_t)(D > 1 ? D / 2 : 1) * 3 * AP_W * sizeof(uint32_t);
  const cudaError_t e = cudaFuncSetAttribute(
      window_combine_kernel<AP_W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (nw > 0)
    window_combine_kernel<AP_W><<<nw, kTreeThreads + 32, smem,
                                  (cudaStream_t)stream>>>(
        (const uint32_t*)base, (const uint32_t*)in_block, (uint32_t*)out, B, D,
        c, cc);
  return (int)cudaGetLastError();
}

// Words of CurveConsts<AP_W>.
int AP_ENTRY(ap_consts_words)() {
  return (int)(sizeof(ap::CurveConsts<AP_W>) / sizeof(uint32_t));
}

}  // extern "C"

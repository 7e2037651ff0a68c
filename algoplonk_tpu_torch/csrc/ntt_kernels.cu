// The NTT stage kernel of the four-step transforms
// (algoplonk_tpu_torch/ops/ntt_kernels.py), CUDA for sm_90a, bound to Python
// through a plain C interface (ctypes).
//
// It replaces the Pallas TPU kernel K9, algoplonk_tpu/ops/ntt_pallas.py
// _stages_kernel (:129), as the reference's _pass_kernel (:245) drives it:
// one call runs ALL log2(C) radix-2 stages of the N / C independent length-C
// sub-transforms held in contiguous rows of the input.
//   forward (DIF): halves C/2 .. 1, (u, v) -> (u + v, (u - v) w)
//   inverse (DIT): halves 1 .. C/2, (u, v) -> (u + v w, u - v w)
// with w = w_2h^j for the butterfly at offset j < h of a 2h block, where w_2h
// is the stage's own root (inverted for the inverse).  Output stays
// bit-reversed within each sub-transform (DIF produces, DIT consumes that
// order), so no permutation is ever materialised.  An optional entry
// multiply is applied on load and an optional exit multiply on store.
//
// Layout: batch-major [N, W] int32 words, element e at e * W.  The TPU keeps
// [L, N] limbs-major only because it pads a minor dimension of 22 to 128;
// Hopper does not pad.  Twiddles are a per-plan [C, W] table in "heap"
// order: row h + j holds w_2h^j (row 0 unused), one table per direction.
//
// Design: one block per sub-transform.  The block loads its C elements into
// shared memory, runs the stages there with __syncthreads() between them
// (256 threads, each looping over C/2/256 butterflies), and stores.  Global
// loads and stores are two 16-byte vectors per element, neighbouring threads
// on neighbouring elements, so a warp moves 1 KB in full sectors.  Shared
// memory is WORD-major, s[w * C + e]: a warp's 32 loads of word w hit 32
// consecutive elements (conflict-free) from stage half 32 on; for halves
// below 32 its u (or v) indices cover half of a 64-element span, so each
// bank is hit at most twice.  Element-major shared storage would put the 8
// words of an element in 8 banks and serialise a warp 8 ways.
//
// What bounds it on the H100: 32-bit integer multiplies.  A butterfly is one
// CIOS Montgomery multiply (about 2 W^2 + W = 136 wide products at W = 8)
// plus an add and a sub; at N = 2^19 and C = 512 a pass is 9 * 2^18 such
// multiplies against 16 MiB read and 16 MiB written (32 MiB more with entry
// and exit tables), far below the card's memory rate.  The design keeps each
// element in shared memory across all stages (one read and one write of
// device memory per pass, where the radix-2 plain version makes one of each
// per stage), keeps every value strict (canonical) so the output needs no
// K4 pass, and leaves lazy reduction and PTX carry chains to a later change.
//
// Shared memory: C * W * 4 bytes (16 KB at C = 512, 32 KB at C = 1024, 64 KB
// at C = 2048, the largest sub-transform for N <= 2^22); above 48 KB it is
// granted once with cudaFuncSetAttribute.
//
// The entry point launches on the given stream, does not synchronise, and
// returns cudaGetLastError() so the caller sees a refused launch.

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace {

constexpr int kW = 8;             // both BN254 and BLS12-381 Fr fit 8 words
constexpr int kThreads = 256;
constexpr int kMaxC = 2048;

using FC = ap::FieldConsts<kW>;

__device__ __forceinline__ void load_elem(uint32_t* v, const uint32_t* src) {
  const uint4 a = reinterpret_cast<const uint4*>(src)[0];
  const uint4 b = reinterpret_cast<const uint4*>(src)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store_elem(uint32_t* dst, const uint32_t* v) {
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(v[4], v[5], v[6], v[7]);
}

template <bool kInverse>
__global__ void __launch_bounds__(kThreads)
ntt_pass_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ tw,
                const uint32_t* __restrict__ entry,
                const uint32_t* __restrict__ exit_, uint32_t* __restrict__ out,
                int log_c, FC fc) {
  extern __shared__ uint32_t s[];  // [W][C], word-major
  const int C = 1 << log_c;
  const int half = C >> 1;
  const int64_t base = (int64_t)blockIdx.x * C;

  for (int e = threadIdx.x; e < C; e += kThreads) {
    uint32_t v[kW];
    load_elem(v, x + (base + e) * kW);
    if (entry != nullptr) {
      uint32_t en[kW];
      load_elem(en, entry + (base + e) * kW);
      ap::mont_mul<kW>(v, v, en, fc);
    }
#pragma unroll
    for (int w = 0; w < kW; ++w) s[w * C + e] = v[w];
  }
  __syncthreads();

  for (int st = 0; st < log_c; ++st) {
    const int log_h = kInverse ? st : log_c - 1 - st;
    const int h = 1 << log_h;
    for (int b = threadIdx.x; b < half; b += kThreads) {
      const int j = b & (h - 1);
      const int iu = 2 * b - j;  // (b / h) * 2h + j
      const int iv = iu + h;
      uint32_t u[kW], v[kW], w[kW];
#pragma unroll
      for (int k = 0; k < kW; ++k) {
        u[k] = s[k * C + iu];
        v[k] = s[k * C + iv];
      }
      load_elem(w, tw + (int64_t)(h + j) * kW);
      uint32_t a[kW], d[kW];
      if (kInverse) {
        ap::mont_mul<kW>(v, v, w, fc);
        ap::add_mod<kW>(a, u, v, fc.p);
        ap::sub_mod<kW>(d, u, v, fc.p);
      } else {
        ap::add_mod<kW>(a, u, v, fc.p);
        ap::sub_mod<kW>(d, u, v, fc.p);
        ap::mont_mul<kW>(d, d, w, fc);
      }
#pragma unroll
      for (int k = 0; k < kW; ++k) {
        s[k * C + iu] = a[k];
        s[k * C + iv] = d[k];
      }
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < C; e += kThreads) {
    uint32_t v[kW];
#pragma unroll
    for (int w = 0; w < kW; ++w) v[w] = s[w * C + e];
    if (exit_ != nullptr) {
      uint32_t ex[kW];
      load_elem(ex, exit_ + (base + e) * kW);
      ap::mont_mul<kW>(v, v, ex, fc);
    }
    store_elem(out + (base + e) * kW, v);
  }
}

template <bool kInverse>
cudaError_t launch(const uint32_t* x, const uint32_t* tw, const uint32_t* entry,
                   const uint32_t* exit_, uint32_t* out, int64_t N, int log_c,
                   const FC& fc, cudaStream_t stream) {
  static bool smem_granted = false;
  const size_t smem = ((size_t)kW * sizeof(uint32_t)) << log_c;
  if (smem > 48 * 1024 && !smem_granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        ntt_pass_kernel<kInverse>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(kMaxC * kW * sizeof(uint32_t)));
    if (e != cudaSuccess) return e;
    smem_granted = true;
  }
  const int64_t blocks = N >> log_c;
  if (blocks > 0)
    ntt_pass_kernel<kInverse><<<(unsigned)blocks, kThreads, smem, stream>>>(
        x, tw, entry, exit_, out, log_c, fc);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, entry, exit_, out: [N, W] device words (entry / exit_ may be null);
// tw: [C, W] device twiddles in heap order; consts: host pointer to the
// packed FieldConsts words (p, n0, one) of the scalar field.
int ap_ntt_pass(const void* x, const void* tw, const void* entry,
                const void* exit_, void* out, int64_t N, int C, int inverse,
                const void* consts, void* stream) {
  if (C < 2 || C > kMaxC || (C & (C - 1)) != 0 || N % C != 0)
    return (int)cudaErrorInvalidValue;
  int log_c = 0;
  while ((1 << log_c) < C) ++log_c;
  const FC fc = *static_cast<const FC*>(consts);
  const auto* xp = static_cast<const uint32_t*>(x);
  const auto* twp = static_cast<const uint32_t*>(tw);
  const auto* entry_p = static_cast<const uint32_t*>(entry);
  const auto* exit_p = static_cast<const uint32_t*>(exit_);
  auto* op = static_cast<uint32_t*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      inverse ? launch<true>(xp, twp, entry_p, exit_p, op, N, log_c, fc, st)
              : launch<false>(xp, twp, entry_p, exit_p, op, N, log_c, fc, st);
  return (int)e;
}

int ap_ntt_consts_words() { return (int)(sizeof(FC) / sizeof(uint32_t)); }

}  // extern "C"

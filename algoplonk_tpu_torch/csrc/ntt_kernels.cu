// K9, the NTT pass kernel of the four-step transforms
// (algoplonk_tpu_torch/ops/ntt_kernels.py), CUDA for sm_90a, bound to Python
// through a plain C interface (ctypes).
//
// It replaces the Pallas TPU kernel K9, algoplonk_tpu/ops/ntt_pallas.py
// _stages_kernel (:129), as the reference's _pass_kernel (:245) drives it:
// one call runs ALL log2(C) radix-2 stages of the N / C independent length-C
// sub-transforms of the input.
//   forward (DIF): halves C/2 .. 1, (u, v) -> (u + v, (u - v) w)
//   inverse (DIT): halves 1 .. C/2, (u, v) -> (u + v w, u - v w)
// with w = w_2h^j for the butterfly at offset j < h of a 2h block, where w_2h
// is the stage's own root (inverted for the inverse).  Output stays
// bit-reversed within each sub-transform (DIF produces, DIT consumes that
// order), so no permutation is ever materialised.  An optional entry
// multiply is applied on load and an optional exit multiply on store; every
// output word is canonical.
//
// Layout: [N, W] int32 words, an element is 32 bytes.  Element i of
// sub-transform s lies at position i * es + s * ss of the input (in
// elements) and at i * es' + s * ss' of the output; the entry table is read
// at the input's positions, the exit table at the output's.  (es, ss) =
// (1, C) is the contiguous layout; (N / C, 1) is a column of an [C, N / C]
// array, which is how the four-step transforms fold their transposes into
// the passes.  The TPU keeps [L, N] limbs-major only because it pads a minor
// dimension of 22 to 128; Hopper does not pad.  Twiddles are a per-plan
// [C, W] table in "heap" order: row h + j holds w_2h^j (row 0 unused).
//
// What bounds it on the H100: 32-bit integer multiplies.  A butterfly's CIOS
// Montgomery multiply is 2 W^2 + W = 136 wide products at W = 8; a pass of
// 2^19 elements moves 16 MiB each way (32 MiB more with entry and exit
// tables), far below the card's memory rate.  The multiply's own SASS (a
// mad.hi for every mad.lo, an addc for the carries) reaches about 60% of
// the card's 32-bit multiply rate alone; the design spends as little as it
// can around it.
//
// Design:
// - Rounds of up to three stages.  In a round a thread owns 8 elements of
//   one sub-transform (a radix-8 group; or two radix-4 or four radix-2
//   groups in the one round of 1 or 2 stages that a log2(C) not divisible
//   by 3 needs) and runs the round's stages on them with no barrier: the
//   groups of a round partition the sub-transform.  A barrier before each
//   round but the first exchanges the elements, so C = 512 is 3 rounds and
//   2 exchanges (the kernel this one replaced: one stage per barrier, 9).
//   The elements stay in shared memory and a stage's butterflies run as a
//   loop over one butterfly body: unrolled in registers, the rounds were
//   tens of kilobytes of straight-line code that each warp ran once, and
//   the unrolled kernel ran slower than the looped one.
// - No multiply by one.  A butterfly whose twiddle index j is 0 adds and
//   subtracts only.  In the round of halves 1, 2 and 4 (the last of a DIF
//   pass, the first of a DIT one) that is 7 of a group's 12 butterflies,
//   uniform across the warp; elsewhere it falls on one thread of a warp.
// - Twiddles off the dependent path.  The block copies the table into
//   shared memory while its first elements load, ahead of the first
//   barrier; a butterfly reads its twiddle there.
// - A grid that fills the card.  A block takes S adjacent sub-transforms
//   (subs_per_block: S C / 8 threads, 256 but for a column layout at C =
//   1024 and for C = 2048, 512), under 128 registers a thread, so an SM
//   holds 512 threads: at N = 2^19 a pass is a single wave of 256 blocks
//   (128 for a column pass at C = 1024).
// - The transposes folded in.  In a column layout the first round's and the
//   last round's neighbouring threads take adjacent columns (S >= 4 up to
//   C = 1024: 128 contiguous bytes an access); in the contiguous layout
//   neighbouring threads take neighbouring elements.  A thread moves an
//   element as two 16-byte vectors, so every 32-byte sector is used whole.
//   The fused entry and exit multiplies load the next element while they
//   multiply one.
// - Shared memory holds elements whole (two 16-byte chunks each), XOR-
//   swizzled (data_chunk, tw_chunk) so that the 8 threads of a quarter-warp,
//   which one 16-byte access serves together, reach 8 distinct bank groups
//   in every stage of every pass size, and the regions of a block's
//   sub-transforms are offset (region_base) so that the column layout's
//   first and last rounds, whose neighbouring threads are in different
//   sub-transforms, do too.
// - Lazy values.  On a field with 4p < R (BN254's Fr) values stay below 2p
//   between stages (field.cuh's lazy ops) and are made canonical on store;
//   on one without that headroom (BLS12-381's Fr) every op is strict.  The
//   wrapper checks the headroom; the entry point refuses a lazy launch on a
//   modulus of 2^254 or more.
//
// Shared memory: the twiddle table (C * 32 bytes) and S regions of C * 32 +
// 128 bytes: 80.5 KB at C = 512 and 96.3 KB at C = 1024 (two blocks an SM),
// 160.5 KB for a column pass at C = 1024, 192.3 KB at C = 2048; granted
// once with cudaFuncSetAttribute.  C = 4096 would need 384.5 KB, above the
// 227 KB a Hopper block may have, so kMaxC = 2048.
//
// Above kMaxC (a 2^23 coset's P2 and P2' at C = 4096; P1 and P1' from
// 2^24 on) the wrapper splits a pass.  A DIF pass runs its stages of
// halves C/2 .. kMaxC over HBM, one launch of ntt_stage each (below), then
// K9 at C' = kMaxC on the pieces they leave; a DIT pass runs K9 first, then
// the HBM stages in rising halves.  Piece t < C / C' of sub-transform s is
// its elements t C' .. (t + 1) C' - 1, at (i + t C') es + s ss: K9 takes
// the full pass's strides and the count of pieces (`pieces`) and runs
// sub-transform s + t (N / C) of length C' there.  In the contiguous layout
// that is the contiguous layout of C'; in the column layout it is not one
// stride.  The twiddle table's first C' rows are the C' table.
//
// ntt_stage is one radix-2 stage of half h over the N / C sub-transforms,
// N / 2 butterflies, one a thread, in the sub-transforms' layout (each
// element's output lies where its input did).  It is bound by bytes: at N =
// 2^23 it moves 2 x 256 MiB (0.16 ms at 3.35 TB/s) against 2^22 multiplies
// (about 0.07 ms), so it reads each element once and writes it once,
// neighbouring threads on neighbouring elements (element-fastest in the
// contiguous layout, sub-transform-fastest in the column layout).  Its
// arithmetic is strict, so its output is canonical and K9's input
// contract holds after it.  The entry multiply is read at the element's
// position before the butterfly, the exit multiply after it; the first
// stage of a split DIF pass takes the entry, the last of a DIT pass the
// exit.
//
// The entry points launch on the given stream, do not synchronise, and
// return cudaGetLastError() so the caller sees a refused launch.

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace {

constexpr int kW = 8;             // both BN254 and BLS12-381 Fr fit 8 words
constexpr int kE = 8;             // elements a thread holds
constexpr int kMaxC = 2048;
constexpr int kMaxThreads = 512;
constexpr int kPad = 8;           // 16-byte chunks between two regions
constexpr int64_t kMaxN = 1 << 28;  // so that every word offset fits 32 bits

using FC = ap::FieldConsts<kW>;

struct Consts {
  FC fc;
  uint32_t p2[kW];   // 2p, the bound of the lazy ops
};

struct Pass {
  const uint32_t* x;
  const uint32_t* tw;
  const uint32_t* entry;   // null: none
  const uint32_t* exit_;   // null: none
  uint32_t* out;
  int subs;                // N / C sub-transforms of length C
  int m;                   // N / (C pieces): sub-transforms of the full pass
  int in_es, in_ss, out_es, out_ss;   // positions stay below N <= kMaxN
  int log_c;
  int per_block;           // S, sub-transforms a block takes
};

// Position of element 0 of sub-transform `sub`: piece t = sub / m of the
// full pass's sub-transform sub % m, whose element i lies at
// (i + t C) es + (sub % m) ss.
__device__ __forceinline__ uint32_t sub_base(int sub, int m, int C, int es, int ss) {
  const uint32_t t = (uint32_t)sub / (uint32_t)m;
  return ((uint32_t)sub - t * (uint32_t)m) * (uint32_t)ss + t * (uint32_t)C * (uint32_t)es;
}

// Sub-transforms a block takes: 256 threads up to C = 512; at C = 1024, four
// (512 threads) for a column layout, so that an access covers four adjacent
// columns, else two (two blocks an SM); two at C = 2048.
__host__ __device__ constexpr int subs_per_block(int C, bool column) {
  return C <= 512 ? 256 / (C < kE ? 1 : C / kE) : (C == 1024 && column ? 4 : 2);
}

__host__ __device__ constexpr int threads_per_sub(int C) { return C < kE ? 1 : C / kE; }

// 16-byte chunks of the shared memory: the twiddle table, then S regions of
// 2 C chunks kPad apart
size_t shared_bytes(int log_c, int S) {
  const int C = 1 << log_c;
  return (2 * (size_t)C + (size_t)S * (2 * C + kPad)) * sizeof(uint4);
}

// Chunk of half 0 of element x within its region; half 1 is this ^ 1.
// 2 x' + b with x' = x ^ (bits 3-4 of x) and b = bit 2 ^ bit 5 of x: a
// quarter-warp whose 8 elements differ in bits 0-2 (or 3-5, as in the round
// of halves 1, 2, 4) reaches the 8 bank groups (chunk mod 8) once each.
__device__ __forceinline__ int data_chunk(int x) {
  return ((x ^ ((x >> 3) & 3)) << 1) | (((x >> 2) ^ (x >> 5)) & 1);
}

// First chunk of sub-transform s's region: regions lie 2 C + kPad chunks
// apart, shifted by 0, 1, 4, 5, 2, 3, 6, 7 chunks, so that 8 regions, or 4
// regions each read at two elements whose chunks differ by 2, or 2 regions
// at four elements, fill the 8 bank groups.
__device__ __forceinline__ int region_base(int s, int C) {
  return s * (2 * C + kPad) + ((s & 1) | ((s & 2) << 1) | ((s & 4) >> 1));
}

// Chunk of half 0 of twiddle row `row` (half 1 is this ^ 1): 8 consecutive
// rows fill the 8 bank groups.
__device__ __forceinline__ int tw_chunk(int row) { return (row << 1) | ((row >> 2) & 1); }

__device__ __forceinline__ void ld_global(uint32_t* v, const uint32_t* src) {
  const uint4 a = reinterpret_cast<const uint4*>(src)[0];
  const uint4 b = reinterpret_cast<const uint4*>(src)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void st_global(uint32_t* dst, const uint32_t* v) {
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void ld_shared(uint32_t* v, const uint4* sm, int c) {
  const uint4 a = sm[c], b = sm[c ^ 1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void st_shared(uint4* sm, int c, const uint32_t* v) {
  sm[c] = make_uint4(v[0], v[1], v[2], v[3]);
  sm[c ^ 1] = make_uint4(v[4], v[5], v[6], v[7]);
}

// ------------------------------------------------- field ops by contract

template <bool kLazy>
__device__ __forceinline__ void fmul(uint32_t* o, const uint32_t* a, const uint32_t* b,
                                     const Consts& k) {
  if (kLazy) ap::mont_mul_lazy<kW>(o, a, b, k.fc);
  else ap::mont_mul<kW>(o, a, b, k.fc);
}

template <bool kLazy>
__device__ __forceinline__ void fadd(uint32_t* o, const uint32_t* a, const uint32_t* b,
                                     const Consts& k) {
  if (kLazy) ap::add_lazy<kW>(o, a, b, k.p2);
  else ap::add_mod<kW>(o, a, b, k.fc.p);
}

template <bool kLazy>
__device__ __forceinline__ void fsub(uint32_t* o, const uint32_t* a, const uint32_t* b,
                                     const Consts& k) {
  if (kLazy) ap::sub_lazy<kW>(o, a, b, k.p2);
  else ap::sub_mod<kW>(o, a, b, k.fc.p);
}

// (u, v) <- the butterfly with twiddle w, or with w = 1 (add and subtract
// only) when by_one
template <bool kInverse, bool kLazy>
__device__ __forceinline__ void butterfly(uint32_t* u, uint32_t* v, const uint32_t* w,
                                          bool by_one, const Consts& k) {
  uint32_t d[kW];
  if (kInverse && !by_one) fmul<kLazy>(v, v, w, k);
  fsub<kLazy>(d, u, v, k);
  fadd<kLazy>(u, u, v, k);
  if (!kInverse && !by_one) fmul<kLazy>(v, d, w, k);
  else ap::copy<kW>(v, d);
}

// Round position of the thread's element e = q 2^K + t: group gam = q T + g
// of the round's C / 2^K, with stage halves 2^a .. 2^(a + K - 1); the group
// is the elements hi 2^(a+K) + t 2^a + lo, t < 2^K, for gam = hi 2^a + lo.
__device__ __forceinline__ int elem_x(int g, int e, int T, int a, int K) {
  const int gam = (e >> K) * T + g;
  return ((gam >> a) << (a + K)) | ((e & ((1 << K) - 1)) << a) | (gam & ((1 << a) - 1));
}

template <bool kInverse, bool kLazy>
__global__ void __launch_bounds__(kMaxThreads, 1)
ntt_pass_kernel(const Pass P, const Consts k) {
  extern __shared__ uint4 sm[];
  const int L = P.log_c;
  const int C = 1 << L;
  const int E = C < kE ? C : kE;      // elements a thread owns in a round
  const int T = threads_per_sub(C);
  const int S = P.per_block;
  const int tid = threadIdx.x;
  uint4* tws = sm;
  uint4* data = sm + 2 * C;
  const int s_block = blockIdx.x * S;

  // The plan: nr rounds of 3 stages, but the round of the largest halves
  // has ktop (1-3); a DIF pass runs them from the top, a DIT pass from the
  // bottom, so the round of halves 1, 2, 4 always has 3 stages (C >= 8).
  const int nr = (L + 2) / 3;
  const int ktop = L - 3 * (nr - 1);
  auto plan = [&](int r, int& K, int& a) {
    if (kInverse) {
      K = r == nr - 1 ? ktop : 3;
      a = 3 * r;
    } else {
      K = r == 0 ? ktop : 3;
      a = r == 0 ? L - ktop : L - ktop - 3 * r;
    }
  };
  // Thread -> (sub-transform s, thread g within it).  The first round
  // follows the input's layout and the last the output's: sub-transform
  // fastest for a column layout (neighbouring threads on adjacent columns),
  // else element fastest, as every middle round.
  auto map = [&](int r, int& s, int& g) {
    const bool col = r == 0 ? P.in_es != 1 : (r == nr - 1 ? P.out_es != 1 : false);
    if (col) {
      s = tid % S;
      g = tid / S;
    } else {
      g = tid % T;
      s = tid / T;
    }
  };

  // ---- load: the elements of the thread's first-round group, through the
  // entry multiply, into shared memory; the twiddles beside them
  int K, a, s, g;
  plan(0, K, a);
  map(0, s, g);
  uint4* region = data + region_base(s, C);
  const int sub = s_block + s;
  const uint32_t in_base = sub_base(sub, P.m, C, P.in_es, P.in_ss);
  auto in_pos = [&](int e) {   // word offset of the thread's element e
    return ((uint32_t)(elem_x(g, e, T, a, K) * P.in_es) + in_base) * kW;
  };
  if (sub < P.subs) {
    if (P.entry == nullptr) {
      uint32_t v[kE][kW];   // all of the thread's loads in flight at once
#pragma unroll
      for (int e = 0; e < kE; ++e)
        if (e < E) ld_global(v[e], P.x + in_pos(e));
#pragma unroll
      for (int e = 0; e < kE; ++e)
        if (e < E) st_shared(region, data_chunk(elem_x(g, e, T, a, K)), v[e]);
    } else {
      // one multiply body; the next element and its entry load meanwhile
      uint32_t x[kW], en[kW], nx[kW], nen[kW];
      ld_global(nx, P.x + in_pos(0));
      ld_global(nen, P.entry + in_pos(0));
#pragma unroll 1
      for (int e = 0; e < E; ++e) {
        ap::copy<kW>(x, nx);
        ap::copy<kW>(en, nen);
        if (e + 1 < E) {
          ld_global(nx, P.x + in_pos(e + 1));
          ld_global(nen, P.entry + in_pos(e + 1));
        }
        fmul<kLazy>(x, x, en, k);
        st_shared(region, data_chunk(elem_x(g, e, T, a, K)), x);
      }
    }
  }
  const uint4* tw_src = reinterpret_cast<const uint4*>(P.tw);
  for (int c = tid; c < 2 * C; c += blockDim.x) tws[tw_chunk(c >> 1) ^ (c & 1)] = tw_src[c];

  // ---- rounds: a thread runs the K stages of its group's elements with no
  // barrier (each round's groups partition the elements), one butterfly
  // body in a loop; a barrier before each round, after the first, exchanges
  for (int r = 0; r < nr; ++r) {
    plan(r, K, a);
    map(r, s, g);
    region = data + region_base(s, C);
    __syncthreads();
#pragma unroll 1
    for (int st = 0; st < K; ++st) {
      const int qq = kInverse ? st : K - 1 - st;   // stage half 2^(a + qq)
#pragma unroll 1
      for (int b = 0; b < E / 2; ++b) {             // the stage's butterflies
        const int q = b >> (K - 1);                  // group
        const int tt = b & ((1 << (K - 1)) - 1);
        const int t = ((tt >> qq) << (qq + 1)) | (tt & ((1 << qq) - 1));   // bit qq clear
        const int gam = q * T + g;
        const int lo = gam & ((1 << a) - 1);
        const int xu = ((gam >> a) << (a + K)) | (t << a) | lo;
        const int xv = xu | (1 << (a + qq));
        const int j = ((t & ((1 << qq) - 1)) << a) | lo;   // twiddle w_2h^j
        const int cu = data_chunk(xu), cv = data_chunk(xv);
        uint32_t u[kW], v[kW], w[kW];
        ld_shared(u, region, cu);
        ld_shared(v, region, cv);
        if (j != 0) ld_shared(w, tws, tw_chunk((1 << (a + qq)) + j));
        butterfly<kInverse, kLazy>(u, v, w, j == 0, k);
        st_shared(region, cu, u);
        st_shared(region, cv, v);
      }
    }
  }

  // ---- store: the thread's own last-round elements (no barrier needed),
  // through the exit multiply or, for lazy values, a final subtraction
  if (s_block + s >= P.subs) return;
  const uint32_t out_base = sub_base(s_block + s, P.m, C, P.out_es, P.out_ss);
  auto out_pos = [&](int e) {
    return ((uint32_t)(elem_x(g, e, T, a, K) * P.out_es) + out_base) * kW;
  };
  if (P.exit_ == nullptr) {
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      if (e >= E) continue;
      uint32_t v[kW];
      ld_shared(v, region, data_chunk(elem_x(g, e, T, a, K)));
      if (kLazy) ap::cond_sub<kW>(v, v, k.fc.p);   // below 2p -> canonical
      st_global(P.out + out_pos(e), v);
    }
  } else {
    uint32_t v[kW], ex[kW], nex[kW];
    ld_global(nex, P.exit_ + out_pos(0));
#pragma unroll 1
    for (int e = 0; e < E; ++e) {
      ap::copy<kW>(ex, nex);
      if (e + 1 < E) ld_global(nex, P.exit_ + out_pos(e + 1));
      ld_shared(v, region, data_chunk(elem_x(g, e, T, a, K)));
      ap::mont_mul<kW>(v, v, ex, k.fc);   // any a < R with b < p: canonical
      st_global(P.out + out_pos(e), v);
    }
  }
}

template <bool kInverse, bool kLazy>
cudaError_t launch(const Pass& P, const Consts& k, cudaStream_t stream) {
  static bool smem_granted = false;
  if (!smem_granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        ntt_pass_kernel<kInverse, kLazy>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shared_bytes(11, subs_per_block(kMaxC, true)));
    if (e != cudaSuccess) return e;
    smem_granted = true;
  }
  const int C = 1 << P.log_c;
  const int blocks = (P.subs + P.per_block - 1) / P.per_block;
  const int threads = threads_per_sub(C) * P.per_block;
  if (blocks > 0)
    ntt_pass_kernel<kInverse, kLazy>
        <<<(unsigned)blocks, threads, shared_bytes(P.log_c, P.per_block), stream>>>(P, k);
  return cudaGetLastError();
}

// ------------------------------------------------------- ntt_stage

constexpr int kStageThreads = 256;

struct Stage {
  const uint32_t* x;
  const uint32_t* tw;
  const uint32_t* entry;   // null: none
  const uint32_t* exit_;   // null: none
  uint32_t* out;
  uint32_t butterflies;    // N / 2
  uint32_t m;              // N / C sub-transforms
  int log_c, log_h;        // C and the stage's half h
  uint32_t es, ss;         // positions stay below N <= kMaxN
};

// Butterfly b of the stage: (u, v) at elements i and i + h of sub-transform
// s, i = 2 h (q / h) + j with j = q mod h, twiddle w_2h^j = tw[h + j].
template <bool kInverse>
__global__ void __launch_bounds__(kStageThreads)
ntt_stage_kernel(const Stage P, const FC fc) {
  const uint32_t b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= P.butterflies) return;
  uint32_t s, q;
  if (P.es == 1) {   // contiguous within a sub-transform: element fastest
    s = b >> (P.log_c - 1);
    q = b & ((1u << (P.log_c - 1)) - 1);
  } else {           // sub-transform fastest
    q = b / P.m;
    s = b - q * P.m;
  }
  const uint32_t h = 1u << P.log_h;
  const uint32_t j = q & (h - 1);
  const uint32_t i = ((q >> P.log_h) << (P.log_h + 1)) | j;
  const uint32_t pu = (i * P.es + s * P.ss) * kW;
  const uint32_t pv = pu + h * P.es * kW;
  uint32_t u[kW], v[kW], w[kW], d[kW];
  ld_global(u, P.x + pu);
  ld_global(v, P.x + pv);
  if (j != 0) ld_global(w, P.tw + (h + j) * kW);
  if (P.entry != nullptr) {
    uint32_t eu[kW], ev[kW];
    ld_global(eu, P.entry + pu);
    ld_global(ev, P.entry + pv);
    ap::mont_mul<kW>(u, u, eu, fc);
    ap::mont_mul<kW>(v, v, ev, fc);
  }
  if (kInverse && j != 0) ap::mont_mul<kW>(v, v, w, fc);
  ap::sub_mod<kW>(d, u, v, fc.p);
  ap::add_mod<kW>(u, u, v, fc.p);
  if (!kInverse && j != 0) ap::mont_mul<kW>(v, d, w, fc);
  else ap::copy<kW>(v, d);
  if (P.exit_ != nullptr) {
    uint32_t xu[kW], xv[kW];
    ld_global(xu, P.exit_ + pu);
    ld_global(xv, P.exit_ + pv);
    ap::mont_mul<kW>(u, u, xu, fc);
    ap::mont_mul<kW>(v, v, xv, fc);
  }
  st_global(P.out + pu, u);
  st_global(P.out + pv, v);
}

// Every position i es + s ss (i < C, s < M) lies in [0, N)
bool in_bounds(int64_t N, int C, int64_t M, int64_t es, int64_t ss) {
  return es >= 1 && ss >= 1 && (C - 1) * es + (M - 1) * ss < N;
}

int log2_of(int64_t v) {
  int l = 0;
  while ((int64_t(1) << l) < v) ++l;
  return l;
}

}  // namespace

extern "C" {

// x, entry, exit_, out: [N, W] device words (entry / exit_ may be null);
// tw: [C, W] device twiddles in heap order; pieces: the pass is of length
// C pieces and this launch runs its pieces of length C (1: the whole pass;
// see the header); (in_es, in_ss) and (out_es, out_ss): element and
// sub-transform strides of the full pass's input (and entry) and output
// (and exit), in elements, every position below N <= 2^28; lazy: keep
// values below 2p between stages (needs 4p < R); consts: host pointer to
// the packed FieldConsts words (p, n0, one) of the scalar field.
int ap_ntt_pass(const void* x, const void* tw, const void* entry, const void* exit_, void* out,
                int64_t N, int C, int64_t pieces, int inverse, int lazy, int64_t in_es,
                int64_t in_ss, int64_t out_es, int64_t out_ss, const void* consts,
                void* stream) {
  if (C < 2 || C > kMaxC || (C & (C - 1)) != 0 || pieces < 1 || (pieces & (pieces - 1)) != 0
      || pieces > kMaxN || N % (C * pieces) != 0 || N > kMaxN)
    return (int)cudaErrorInvalidValue;
  const int64_t M = N / (C * pieces);
  if (!in_bounds(N, (int)(C * pieces), M, in_es, in_ss)
      || !in_bounds(N, (int)(C * pieces), M, out_es, out_ss))
    return (int)cudaErrorInvalidValue;
  Consts k;
  k.fc = *static_cast<const FC*>(consts);
  if (lazy && (k.fc.p[kW - 1] >> 30) != 0) return (int)cudaErrorInvalidValue;  // 4p >= R
  uint64_t carry = 0;
  for (int i = 0; i < kW; ++i) {
    const uint64_t s2 = 2 * (uint64_t)k.fc.p[i] + carry;
    k.p2[i] = (uint32_t)s2;
    carry = s2 >> 32;
  }
  const int log_c = log2_of(C);
  Pass P;
  P.x = static_cast<const uint32_t*>(x);
  P.tw = static_cast<const uint32_t*>(tw);
  P.entry = static_cast<const uint32_t*>(entry);
  P.exit_ = static_cast<const uint32_t*>(exit_);
  P.out = static_cast<uint32_t*>(out);
  P.subs = (int)(N / C);
  P.m = (int)M;
  P.in_es = (int)in_es;
  P.in_ss = (int)in_ss;
  P.out_es = (int)out_es;
  P.out_ss = (int)out_ss;
  P.log_c = log_c;
  P.per_block = subs_per_block(C, in_es != 1 || out_es != 1);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (inverse) e = lazy ? launch<true, true>(P, k, st) : launch<true, false>(P, k, st);
  else e = lazy ? launch<false, true>(P, k, st) : launch<false, false>(P, k, st);
  return (int)e;
}

// One radix-2 stage of half h (DIF or DIT by `inverse`) over the N / C
// length-C sub-transforms of x, element i of sub-transform s at i es + s ss
// of x, entry, exit_ and out alike; tw: [2h or more, W] heap-order
// twiddles; entry / exit_ may be null; strict arithmetic, canonical output.
int ap_ntt_stage(const void* x, const void* tw, const void* entry, const void* exit_, void* out,
                 int64_t N, int64_t C, int64_t h, int inverse, int64_t es, int64_t ss,
                 const void* consts, void* stream) {
  if (C < 2 || (C & (C - 1)) != 0 || h < 1 || (h & (h - 1)) != 0 || 2 * h > C || C > kMaxN
      || N % C != 0 || N > kMaxN || !in_bounds(N, (int)C, N / C, es, ss))
    return (int)cudaErrorInvalidValue;
  Stage P;
  P.x = static_cast<const uint32_t*>(x);
  P.tw = static_cast<const uint32_t*>(tw);
  P.entry = static_cast<const uint32_t*>(entry);
  P.exit_ = static_cast<const uint32_t*>(exit_);
  P.out = static_cast<uint32_t*>(out);
  P.butterflies = (uint32_t)(N / 2);
  P.m = (uint32_t)(N / C);
  P.log_c = log2_of(C);
  P.log_h = log2_of(h);
  P.es = (uint32_t)es;
  P.ss = (uint32_t)ss;
  const FC fc = *static_cast<const FC*>(consts);
  const auto st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)((P.butterflies + kStageThreads - 1) / kStageThreads);
  if (blocks > 0) {
    if (inverse) ntt_stage_kernel<true><<<blocks, kStageThreads, 0, st>>>(P, fc);
    else ntt_stage_kernel<false><<<blocks, kStageThreads, 0, st>>>(P, fc);
  }
  return (int)cudaGetLastError();
}

int ap_ntt_consts_words() { return (int)(sizeof(FC) / sizeof(uint32_t)); }

}  // extern "C"

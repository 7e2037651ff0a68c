// Montgomery field core inlined by every kernel of msm_kernels.cu,
// curve_kernels.cu and ntt_kernels.cu.
//
// Replaces algoplonk_tpu/ops/field_pallas.py:FieldVals (with field_consts,
// field_mats and sub_bias_limbs), the field arithmetic that the TPU kernels
// inline.  On the TPU a multiply is Karatsuba column products on the MXU in
// bf16 plus a coarse REDC over 12-bit limbs, because the VPU has no wide
// integer multiply.  Hopper has one, so this is the CIOS Montgomery multiply
// over W 32-bit words, written with PTX carry chains: every 32x32 product
// half is one mad.lo/mad.hi that also adds the running word and the carry
// flag (mad.lo.cc, madc.hi.cc, addc.cc), so a W-word multiply is 4 W^2 such
// instructions plus about 6 W carry moves.  Each row adds the low halves of
// its products in one chain, then the high halves, one word up, in a second;
// no 64-bit temporary and no separate carry word is kept.
//
// What bounds it on the H100: 32-bit integer multiply throughput (a W = 8
// multiply is 2 W^2 + W = 136 wide products, 272 multiply instructions) and
// registers.
//
// Two contracts:
// - strict (mont_mul, add_mod, sub_mod, neg_mod): inputs below p give a
//   canonical output.  mont_mul also takes any a < R with b < p.  Valid for
//   p < R / 2 (every field here, BLS12-381's Fr at W = 8 included).
// - lazy (mont_mul_lazy, add_lazy, sub_lazy, mul_small_lazy): inputs and
//   outputs in [0, 2p), with no final subtraction in the multiply: for
//   a, b < 2p, (a b + m p) / R < 4p^2 / R + p < 2p.  Valid only where
//   4p < R: BN254's Fp (W = 8) and BLS12-381's Fp (W = 12), the fields of
//   the curve formulas, which alone use it.  The wrapper refuses to pack
//   curve constants for a field without that headroom
//   (ops/curve_kernels.py check_lazy_headroom); cond_sub(., ., p) makes a
//   lazy value canonical again.
//
// Each carry chain is a run of volatile asm statements, which the compiler
// keeps in order; nothing between them touches the carry flag.
//
// Everything is templated on W: BN254 and BLS12-381's scalar field use W = 8
// (R = 2^256), BLS12-381's base field W = 12 (R = 2^384).

#pragma once

#include <cstdint>

namespace ap {

template <int W>
struct FieldConsts {
  uint32_t p[W];    // modulus, little-endian words
  uint32_t n0;      // -p^-1 mod 2^32
  uint32_t one[W];  // R mod p (Montgomery one)
};

namespace ptx {

__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t sub_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t mul_lo(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("mul.lo.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t mad_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}

}  // namespace ptx

template <int W>
__device__ __forceinline__ bool is_zero(const uint32_t* a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) acc |= a[i];
  return acc == 0;
}

// out = t - m if t >= m else t   (any t, m of W words; out may alias t)
template <int W>
__device__ __forceinline__ void cond_sub(uint32_t* out, const uint32_t* t,
                                         const uint32_t* m) {
  uint32_t d[W];
  d[0] = ptx::sub_cc(t[0], m[0]);
#pragma unroll
  for (int i = 1; i < W; ++i) d[i] = ptx::subc_cc(t[i], m[i]);
  const uint32_t borrow = ptx::subc(0u, 0u);  // all ones if t < m
#pragma unroll
  for (int i = 0; i < W; ++i) out[i] = borrow ? t[i] : d[i];
}

// s = a + b as W words (no carry out: callers keep a + b < R)
template <int W>
__device__ __forceinline__ void add_words(uint32_t* s, const uint32_t* a,
                                          const uint32_t* b) {
  s[0] = ptx::add_cc(a[0], b[0]);
#pragma unroll
  for (int i = 1; i < W - 1; ++i) s[i] = ptx::addc_cc(a[i], b[i]);
  s[W - 1] = ptx::addc(a[W - 1], b[W - 1]);
}

// out = a - b, plus m if that borrowed   (a, b < m; out may alias a or b)
template <int W>
__device__ __forceinline__ void sub_add_back(uint32_t* out, const uint32_t* a,
                                             const uint32_t* b,
                                             const uint32_t* m) {
  uint32_t d[W];
  d[0] = ptx::sub_cc(a[0], b[0]);
#pragma unroll
  for (int i = 1; i < W; ++i) d[i] = ptx::subc_cc(a[i], b[i]);
  const uint32_t mask = ptx::subc(0u, 0u);  // all ones if a < b
  out[0] = ptx::add_cc(d[0], m[0] & mask);
#pragma unroll
  for (int i = 1; i < W - 1; ++i) out[i] = ptx::addc_cc(d[i], m[i] & mask);
  out[W - 1] = ptx::addc(d[W - 1], m[W - 1] & mask);
}

// ------------------------------------------------------------ strict

// out = a + b mod p   (a, b < p; a + b < 2p < R)
template <int W>
__device__ __forceinline__ void add_mod(uint32_t* out, const uint32_t* a,
                                        const uint32_t* b, const uint32_t* p) {
  uint32_t s[W];
  add_words<W>(s, a, b);
  cond_sub<W>(out, s, p);
}

// out = a - b mod p   (a, b < p)
template <int W>
__device__ __forceinline__ void sub_mod(uint32_t* out, const uint32_t* a,
                                        const uint32_t* b, const uint32_t* p) {
  sub_add_back<W>(out, a, b, p);
}

// a <- -a mod p   (a < p)
template <int W>
__device__ __forceinline__ void neg_mod(uint32_t* a, const uint32_t* p) {
  uint32_t zero[W] = {0};
  sub_mod<W>(a, zero, a, p);
}

// t[0..W] = a b R^-1 (mod p) before any final subtraction, CIOS with carry
// chains.  t < 2p when a b < R p (strict: a < R, b < p; lazy: a, b < 2p
// with 4p < R).
template <int W>
__device__ __forceinline__ void mont_mul_raw(uint32_t* t, const uint32_t* a,
                                             const uint32_t* b,
                                             const FieldConsts<W>& c) {
  uint32_t hi;  // word W + 1 of the running sum (0 or 1 between rows)
  // row 0: t = a b[0], then the same reduction as every row
  {
    const uint32_t bi = b[0];
#pragma unroll
    for (int j = 0; j < W; ++j) t[j] = ptx::mul_lo(a[j], bi);
    t[1] = ptx::mad_hi_cc(a[0], bi, t[1]);
#pragma unroll
    for (int j = 1; j < W - 1; ++j) t[j + 1] = ptx::madc_hi_cc(a[j], bi, t[j + 1]);
    t[W] = ptx::madc_hi(a[W - 1], bi, 0u);
    hi = 0;
  }
#pragma unroll
  for (int i = 0; i < W; ++i) {
    if (i > 0) {
      // t += a b[i]: the low halves into words 0..W-1, then the high halves
      // into words 1..W
      const uint32_t bi = b[i];
      t[0] = ptx::mad_lo_cc(a[0], bi, t[0]);
#pragma unroll
      for (int j = 1; j < W; ++j) t[j] = ptx::madc_lo_cc(a[j], bi, t[j]);
      t[W] = ptx::addc_cc(t[W], 0u);
      hi = ptx::addc(0u, 0u);
      t[1] = ptx::mad_hi_cc(a[0], bi, t[1]);
#pragma unroll
      for (int j = 1; j < W; ++j) t[j + 1] = ptx::madc_hi_cc(a[j], bi, t[j + 1]);
      hi = ptx::addc(hi, 0u);
    }
    // t += m p with m = t[0] n0, so that word 0 becomes 0; then shift down
    const uint32_t m = t[0] * c.n0;
    (void)ptx::mad_lo_cc(m, c.p[0], t[0]);
#pragma unroll
    for (int j = 1; j < W; ++j) t[j] = ptx::madc_lo_cc(m, c.p[j], t[j]);
    t[W] = ptx::addc_cc(t[W], 0u);
    hi = ptx::addc(hi, 0u);
    t[1] = ptx::mad_hi_cc(m, c.p[0], t[1]);
#pragma unroll
    for (int j = 1; j < W; ++j) t[j + 1] = ptx::madc_hi_cc(m, c.p[j], t[j + 1]);
    hi = ptx::addc(hi, 0u);
#pragma unroll
    for (int j = 0; j < W; ++j) t[j] = t[j + 1];
    t[W] = hi;
  }
}

// out = a b R^-1 mod p, canonical.  For a < R and b < p the pre-subtraction
// value is below 2p, so one conditional subtraction makes it canonical; this
// is what lets K8 take one multiplicand anywhere below R.
template <int W>
__device__ __forceinline__ void mont_mul(uint32_t* out, const uint32_t* a,
                                         const uint32_t* b,
                                         const FieldConsts<W>& c) {
  uint32_t t[W + 2];
  mont_mul_raw<W>(t, a, b, c);
  // t < 2p < R, so word W is 0 and the subtraction needs W words only
  cond_sub<W>(out, t, c.p);
}

// ------------------------------------------------------------ lazy (4p < R)

// out = a b R^-1 mod p in [0, 2p)   (a, b < 2p)
template <int W>
__device__ __forceinline__ void mont_mul_lazy(uint32_t* out, const uint32_t* a,
                                              const uint32_t* b,
                                              const FieldConsts<W>& c) {
  uint32_t t[W + 2];
  mont_mul_raw<W>(t, a, b, c);
#pragma unroll
  for (int i = 0; i < W; ++i) out[i] = t[i];
}

// out = a + b mod p in [0, 2p)   (a, b < 2p; p2 = 2p)
template <int W>
__device__ __forceinline__ void add_lazy(uint32_t* out, const uint32_t* a,
                                         const uint32_t* b, const uint32_t* p2) {
  uint32_t s[W];
  add_words<W>(s, a, b);   // < 4p < R
  cond_sub<W>(out, s, p2);
}

// out = a - b mod p in [0, 2p)   (a, b < 2p; p2 = 2p)
template <int W>
__device__ __forceinline__ void sub_lazy(uint32_t* out, const uint32_t* a,
                                         const uint32_t* b, const uint32_t* p2) {
  sub_add_back<W>(out, a, b, p2);
}

// out = k x mod p in [0, 2p) for a small integer 1 <= k < 16   (x < 2p), by
// doublings and additions from the top bit of k.  k is uniform across the
// launch, so its branches never diverge.
template <int W>
__device__ __forceinline__ void mul_small_lazy(uint32_t* out, const uint32_t* x,
                                               uint32_t k, const uint32_t* p2) {
  uint32_t r[W];
#pragma unroll
  for (int i = 0; i < W; ++i) r[i] = x[i];
  int top = 3;
  while (top > 0 && !((k >> top) & 1u)) --top;
  for (int bit = top - 1; bit >= 0; --bit) {
    add_lazy<W>(r, r, r, p2);
    if ((k >> bit) & 1u) add_lazy<W>(r, r, x, p2);
  }
#pragma unroll
  for (int i = 0; i < W; ++i) out[i] = r[i];
}

template <int W>
__device__ __forceinline__ void copy(uint32_t* out, const uint32_t* a) {
#pragma unroll
  for (int i = 0; i < W; ++i) out[i] = a[i];
}

}  // namespace ap

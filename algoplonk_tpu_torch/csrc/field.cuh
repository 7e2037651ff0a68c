// Montgomery field core inlined by every kernel of msm_kernels.cu.
//
// Replaces algoplonk_tpu/ops/field_pallas.py:FieldVals (with field_consts,
// field_mats and sub_bias_limbs), the field arithmetic that the TPU kernels
// inline.  On the TPU a multiply is Karatsuba column products on the MXU in
// bf16 plus a coarse REDC over 12-bit limbs, because the VPU has no wide
// integer multiply.  Hopper has one: a 32x32 -> 64-bit product is a pair of
// IMADs, so this is the textbook CIOS Montgomery multiply over W 32-bit words
// (the shape of algoplonk_tpu/native/csrc/apmath.cc, at half the word size).
//
// What bounds it on the H100: 32-bit integer multiply throughput (a W = 8
// multiply is ~2 W^2 + W = 136 wide products, ~270 IMAD-class instructions)
// and registers (an RCB add keeps ~100 words live per lane).  The design keeps
// every value strict (canonical, < p) so no lazy-reduction bookkeeping occupies
// registers, fully unrolls the word loops so all words stay in registers, and
// leaves lazy reduction to a later change.
//
// Everything is templated on W: BN254 uses W = 8 (R = 2^256); BLS12-381's
// base field needs W = 12.  Requires p < R / 2.

#pragma once

#include <cstdint>

namespace ap {

template <int W>
struct FieldConsts {
  uint32_t p[W];    // modulus, little-endian words
  uint32_t n0;      // -p^-1 mod 2^32
  uint32_t one[W];  // R mod p (Montgomery one)
};

template <int W>
__device__ __forceinline__ bool is_zero(const uint32_t* a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) acc |= a[i];
  return acc == 0;
}

// out = t - p if t >= p else t   (t < 2p)
template <int W>
__device__ __forceinline__ void cond_sub_p(uint32_t* out, const uint32_t* t,
                                           const uint32_t* p) {
  uint32_t d[W];
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    uint64_t cur = (uint64_t)t[i] - p[i] - borrow;
    d[i] = (uint32_t)cur;
    borrow = (cur >> 32) & 1;
  }
#pragma unroll
  for (int i = 0; i < W; ++i) out[i] = borrow ? t[i] : d[i];
}

// out = a + b mod p   (a, b < p; a + b < 2p < R)
template <int W>
__device__ __forceinline__ void add_mod(uint32_t* out, const uint32_t* a,
                                        const uint32_t* b, const uint32_t* p) {
  uint32_t s[W];
  uint64_t carry = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    uint64_t cur = (uint64_t)a[i] + b[i] + carry;
    s[i] = (uint32_t)cur;
    carry = cur >> 32;
  }
  cond_sub_p<W>(out, s, p);
}

// out = a - b mod p   (a, b < p)
template <int W>
__device__ __forceinline__ void sub_mod(uint32_t* out, const uint32_t* a,
                                        const uint32_t* b, const uint32_t* p) {
  uint32_t d[W];
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    uint64_t cur = (uint64_t)a[i] - b[i] - borrow;
    d[i] = (uint32_t)cur;
    borrow = (cur >> 32) & 1;
  }
  uint64_t carry = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    uint64_t cur = (uint64_t)d[i] + (borrow ? p[i] : 0u) + carry;
    out[i] = (uint32_t)cur;
    carry = cur >> 32;
  }
}

// out = a b R^-1 mod p, CIOS.  For a < R and b < p the pre-subtraction value
// is below 2p, so one conditional subtraction makes it canonical; this is what
// lets the canonicalising kernel take any W-word input.
template <int W>
__device__ __forceinline__ void mont_mul(uint32_t* out, const uint32_t* a,
                                         const uint32_t* b,
                                         const FieldConsts<W>& c) {
  uint32_t t[W + 2];
#pragma unroll
  for (int i = 0; i < W + 2; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      uint64_t cur = (uint64_t)a[j] * b[i] + t[j] + carry;
      t[j] = (uint32_t)cur;
      carry = cur >> 32;
    }
    uint64_t cur = (uint64_t)t[W] + carry;
    t[W] = (uint32_t)cur;
    t[W + 1] = (uint32_t)(cur >> 32);

    uint32_t m = t[0] * c.n0;
    carry = ((uint64_t)m * c.p[0] + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < W; ++j) {
      uint64_t cur2 = (uint64_t)m * c.p[j] + t[j] + carry;
      t[j - 1] = (uint32_t)cur2;
      carry = cur2 >> 32;
    }
    uint64_t cur3 = (uint64_t)t[W] + carry;
    t[W - 1] = (uint32_t)cur3;
    t[W] = t[W + 1] + (uint32_t)(cur3 >> 32);
  }
  cond_sub_p<W>(out, t, c.p);
}

template <int W>
__device__ __forceinline__ void copy(uint32_t* out, const uint32_t* a) {
#pragma unroll
  for (int i = 0; i < W; ++i) out[i] = a[i];
}

}  // namespace ap

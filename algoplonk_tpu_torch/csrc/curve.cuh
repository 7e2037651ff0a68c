// Complete RCB point additions and doubling on short Weierstrass curves
// with a = 0, per lane, in registers.
//
// Device-function counterparts of algoplonk_tpu/ops/curve_pallas.py
// _mixed_add_body and _jac_add_body (and of ops/curve.py jac_add_affine /
// jac_add / jac_double, whose operation sequence they follow exactly; the
// doubling runs in the MSM's phase 4, msm_kernels.cu).  They run on the
// lazy field core (field.cuh: values in [0, 2p), valid for 4p < R, which
// BN254's and BLS12-381's base fields meet), so each intermediate is the
// plain version's field element, not always its canonical word.  A kernel
// makes its output canonical once, when it stores it (lanes.cuh
// store_proj), and the stored words then equal the plain version's.
//
// The plain version multiplies by 3b in Montgomery form; here 3b is the
// small integer k3b of CurveConsts (9 on BN254, 12 on BLS12-381), and each
// product by it is four lazy additions.
//
// What bounds them on the H100: a mixed add is 11 Montgomery multiplies, a
// doubling 8 and a projective add 12 (field.cuh: 272 multiply instructions
// each at W = 8, 600 at W = 12), on about 100 (W = 8) or 150 (W = 12) words
// of live state per lane.  The formulas therefore run in registers, one
// lane a thread, with no shared memory; mixed_add_roles spreads one mixed
// add over two warps, which exchange its products through shared
// memory.  ptxas's report (printed by chip_smoke.py) gives each kernel's
// registers.

#pragma once

#include "field.cuh"

namespace ap {

template <int W>
struct CurveConsts {
  FieldConsts<W> f;
  uint32_t p2[W];   // 2p, the bound of the lazy values
  uint32_t k3b;     // 3b as a small integer
};

template <int W>
struct Proj {
  uint32_t x[W], y[W], z[W];
};

// acc <- acc + (x2, y2)   (RCB mixed add, 11 multiplies; (0, 0) is infinity
// and leaves acc unchanged).  acc lazy, (x2, y2) canonical; q_inf must come
// from the raw coordinates.
template <int W>
__device__ __forceinline__ void mixed_add(Proj<W>& acc, const uint32_t* X2,
                                          const uint32_t* Y2, bool q_inf,
                                          const CurveConsts<W>& cc) {
  const FieldConsts<W>& c = cc.f;
  const uint32_t* p2 = cc.p2;
  uint32_t t0[W], t1[W], t2[W], t3[W], t4[W], t5[W], u[W], v[W];
  uint32_t x3[W], y3[W], z3[W];
  mont_mul_lazy<W>(t0, acc.x, X2, c);
  mont_mul_lazy<W>(t1, acc.y, Y2, c);
  add_lazy<W>(u, acc.x, acc.y, p2);
  add_lazy<W>(v, X2, Y2, p2);
  mont_mul_lazy<W>(t3, u, v, c);
  add_lazy<W>(u, t0, t1, p2);
  sub_lazy<W>(t3, t3, u, p2);           // X1Y2 + X2Y1
  mont_mul_lazy<W>(u, Y2, acc.z, c);
  add_lazy<W>(t4, u, acc.y, p2);        // Y1 + Y2Z1
  mont_mul_lazy<W>(u, X2, acc.z, c);
  add_lazy<W>(t5, u, acc.x, p2);        // X1 + X2Z1
  add_lazy<W>(u, t0, t0, p2);
  add_lazy<W>(t0, u, t0, p2);           // 3 X1X2
  mul_small_lazy<W>(t2, acc.z, cc.k3b, p2);   // b3 Z1
  add_lazy<W>(z3, t1, t2, p2);
  sub_lazy<W>(t1, t1, t2, p2);
  mul_small_lazy<W>(y3, t5, cc.k3b, p2);      // b3 (X1 + X2Z1)
  mont_mul_lazy<W>(u, t3, t1, c);
  mont_mul_lazy<W>(v, t4, y3, c);
  sub_lazy<W>(x3, u, v, p2);
  mont_mul_lazy<W>(u, t1, z3, c);
  mont_mul_lazy<W>(v, y3, t0, c);
  add_lazy<W>(y3, u, v, p2);
  mont_mul_lazy<W>(u, z3, t4, c);
  mont_mul_lazy<W>(v, t0, t3, c);
  add_lazy<W>(z3, u, v, p2);
  if (!q_inf) {
    copy<W>(acc.x, x3);
    copy<W>(acc.y, y3);
    copy<W>(acc.z, z3);
  }
}

// Slot `slot` of lane l in a group's exchange area of shared memory, laid
// out [slot][word][lane] over 32 lanes, so that a warp's accesses fall in
// distinct banks.
template <int W>
__device__ __forceinline__ void put_slot(uint32_t* ex, int slot, int l,
                                         const uint32_t* v) {
#pragma unroll
  for (int w = 0; w < W; ++w) ex[(slot * W + w) * 32 + l] = v[w];
}

template <int W>
__device__ __forceinline__ void get_slot(uint32_t* v, const uint32_t* ex,
                                         int slot, int l) {
#pragma unroll
  for (int w = 0; w < W; ++w) v[w] = ex[(slot * W + w) * 32 + l];
}

// Exchange slots mixed_add_roles needs per lane.
constexpr int kRoleSlots = 6;

// acc <- acc + (x2, y2) as mixed_add, spread over the two warps of a group
// that share 32 lanes.  The RCB mixed add has two stages of independent
// multiplies, and the warp of role 0 or 1 (the same on all its threads, so
// no branch here diverges) computes its share of each:
//   stage 1, five products:  role 0 X1X2, Y1Y2, X2Z1; role 1
//     (X1+Y1)(X2+Y2), Y2Z1.
//   stage 2, two products per output coordinate:  role 0 makes x3 and z3's
//     first product, role 1 y3 and z3's second, which it hands to role 0.
// The dependent chain drops from 11 multiplies to 6.  Products go between
// the warps through `ex` (kRoleSlots slots of lane l, put_slot's layout),
// with the block's barriers between the stages, so every thread of the
// block must call this.  Every product and every add is mixed_add's
// operation on the same lazy operands, so the stored words are mixed_add's.
// On return acc holds the sum in x and z on role 0, in y on role 1, and is
// unspecified in the other coordinates.
template <int W>
__device__ __forceinline__ void mixed_add_roles(Proj<W>& acc,
                                                const uint32_t* X2,
                                                const uint32_t* Y2, bool q_inf,
                                                int role, uint32_t* ex, int l,
                                                const CurveConsts<W>& cc) {
  const FieldConsts<W>& c = cc.f;
  const uint32_t* p2 = cc.p2;
  uint32_t t0[W], t1[W], t2[W], t3[W], t4[W], t5[W], u[W], v[W];
  uint32_t x3[W], y3[W], z3[W];
  // stage 1 (slots: 0 X1X2, 1 Y1Y2, 2 (X1+Y1)(X2+Y2), 3 Y2Z1, 4 X2Z1)
  if (role == 0) {
    mont_mul_lazy<W>(u, acc.x, X2, c);
    put_slot<W>(ex, 0, l, u);
    mont_mul_lazy<W>(u, acc.y, Y2, c);
    put_slot<W>(ex, 1, l, u);
    mont_mul_lazy<W>(u, X2, acc.z, c);
    put_slot<W>(ex, 4, l, u);
  } else {
    add_lazy<W>(u, acc.x, acc.y, p2);
    add_lazy<W>(v, X2, Y2, p2);
    mont_mul_lazy<W>(t3, u, v, c);
    put_slot<W>(ex, 2, l, t3);
    mont_mul_lazy<W>(u, Y2, acc.z, c);
    put_slot<W>(ex, 3, l, u);
  }
  __syncthreads();
  // mixed_add's additions, on both roles
  get_slot<W>(t0, ex, 0, l);
  get_slot<W>(t1, ex, 1, l);
  get_slot<W>(t3, ex, 2, l);
  add_lazy<W>(u, t0, t1, p2);
  sub_lazy<W>(t3, t3, u, p2);           // X1Y2 + X2Y1
  get_slot<W>(u, ex, 3, l);
  add_lazy<W>(t4, u, acc.y, p2);        // Y1 + Y2Z1
  get_slot<W>(u, ex, 4, l);
  add_lazy<W>(t5, u, acc.x, p2);        // X1 + X2Z1
  add_lazy<W>(u, t0, t0, p2);
  add_lazy<W>(t0, u, t0, p2);           // 3 X1X2
  mul_small_lazy<W>(t2, acc.z, cc.k3b, p2);   // b3 Z1
  add_lazy<W>(z3, t1, t2, p2);
  sub_lazy<W>(t1, t1, t2, p2);
  mul_small_lazy<W>(y3, t5, cc.k3b, p2);      // b3 (X1 + X2Z1)
  // stage 2: x3 = t3 t1 - t4 y3, y3 = t1 z3 + y3 t0, z3 = z3 t4 + t0 t3
  if (role == 0) {
    mont_mul_lazy<W>(u, t3, t1, c);
    mont_mul_lazy<W>(v, t4, y3, c);
    sub_lazy<W>(x3, u, v, p2);
    mont_mul_lazy<W>(u, z3, t4, c);
  } else {
    mont_mul_lazy<W>(u, t1, z3, c);
    mont_mul_lazy<W>(v, y3, t0, c);
    add_lazy<W>(y3, u, v, p2);
    mont_mul_lazy<W>(v, t0, t3, c);
    put_slot<W>(ex, 5, l, v);
  }
  __syncthreads();
  if (role == 0) {
    get_slot<W>(v, ex, 5, l);
    add_lazy<W>(z3, u, v, p2);
  }
  if (!q_inf) {
    if (role == 0) {
      copy<W>(acc.x, x3);
      copy<W>(acc.z, z3);
    } else {
      copy<W>(acc.y, y3);
    }
  }
}

// out <- a + b   (complete projective add, 12 multiplies; lazy in and out;
// out may alias a or b)
template <int W>
__device__ __forceinline__ void jac_add(Proj<W>& out, const Proj<W>& a,
                                        const Proj<W>& b,
                                        const CurveConsts<W>& cc) {
  const FieldConsts<W>& c = cc.f;
  const uint32_t* p2 = cc.p2;
  uint32_t t0[W], t1[W], t2[W], t3[W], t4[W], t5[W], u[W], v[W];
  uint32_t x3[W], y3[W], z3[W];
  mont_mul_lazy<W>(t0, a.x, b.x, c);
  mont_mul_lazy<W>(t1, a.y, b.y, c);
  mont_mul_lazy<W>(t2, a.z, b.z, c);
  add_lazy<W>(u, a.x, a.y, p2);
  add_lazy<W>(v, b.x, b.y, p2);
  mont_mul_lazy<W>(t3, u, v, c);
  add_lazy<W>(u, t0, t1, p2);
  sub_lazy<W>(t3, t3, u, p2);           // X1Y2 + X2Y1
  add_lazy<W>(u, a.y, a.z, p2);
  add_lazy<W>(v, b.y, b.z, p2);
  mont_mul_lazy<W>(t4, u, v, c);
  add_lazy<W>(u, t1, t2, p2);
  sub_lazy<W>(t4, t4, u, p2);           // Y1Z2 + Y2Z1
  add_lazy<W>(u, a.x, a.z, p2);
  add_lazy<W>(v, b.x, b.z, p2);
  mont_mul_lazy<W>(t5, u, v, c);
  add_lazy<W>(u, t0, t2, p2);
  sub_lazy<W>(t5, t5, u, p2);           // X1Z2 + X2Z1
  add_lazy<W>(u, t0, t0, p2);
  add_lazy<W>(t0, u, t0, p2);           // 3 X1X2
  mul_small_lazy<W>(t2, t2, cc.k3b, p2);      // b3 Z1Z2
  add_lazy<W>(z3, t1, t2, p2);          // Y1Y2 + b3 Z1Z2
  sub_lazy<W>(t1, t1, t2, p2);          // Y1Y2 - b3 Z1Z2
  mul_small_lazy<W>(y3, t5, cc.k3b, p2);      // b3 (X1Z2 + X2Z1)
  mont_mul_lazy<W>(u, t3, t1, c);
  mont_mul_lazy<W>(v, t4, y3, c);
  sub_lazy<W>(x3, u, v, p2);
  mont_mul_lazy<W>(u, t1, z3, c);
  mont_mul_lazy<W>(v, y3, t0, c);
  add_lazy<W>(y3, u, v, p2);
  mont_mul_lazy<W>(u, z3, t4, c);
  mont_mul_lazy<W>(v, t0, t3, c);
  add_lazy<W>(z3, u, v, p2);
  copy<W>(out.x, x3);
  copy<W>(out.y, y3);
  copy<W>(out.z, z3);
}

// out <- 2 a   (complete projective doubling, dbl-2015-rcb: 8 multiplies;
// lazy in and out; out may alias a).  The sequence of ops/curve.py
// jac_double, so the stored words equal the plain version's.
template <int W>
__device__ __forceinline__ void jac_double(Proj<W>& out, const Proj<W>& a,
                                           const CurveConsts<W>& cc) {
  const FieldConsts<W>& c = cc.f;
  const uint32_t* p2 = cc.p2;
  uint32_t t0[W], t1[W], t2[W], x3[W], y3[W], z3[W];
  mont_mul_lazy<W>(t0, a.y, a.y, c);
  add_lazy<W>(z3, t0, t0, p2);
  add_lazy<W>(z3, z3, z3, p2);
  add_lazy<W>(z3, z3, z3, p2);          // 8 Y^2
  mont_mul_lazy<W>(t1, a.y, a.z, c);
  mont_mul_lazy<W>(t2, a.z, a.z, c);
  mul_small_lazy<W>(t2, t2, cc.k3b, p2);      // b3 Z^2
  mont_mul_lazy<W>(x3, t2, z3, c);
  add_lazy<W>(y3, t0, t2, p2);
  mont_mul_lazy<W>(z3, t1, z3, c);
  add_lazy<W>(t1, t2, t2, p2);
  add_lazy<W>(t2, t1, t2, p2);
  sub_lazy<W>(t0, t0, t2, p2);
  mont_mul_lazy<W>(y3, t0, y3, c);
  add_lazy<W>(y3, x3, y3, p2);
  mont_mul_lazy<W>(t1, a.x, a.y, c);
  mont_mul_lazy<W>(x3, t0, t1, c);
  add_lazy<W>(x3, x3, x3, p2);
  copy<W>(out.x, x3);
  copy<W>(out.y, y3);
  copy<W>(out.z, z3);
}

}  // namespace ap

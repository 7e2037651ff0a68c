// Complete RCB point additions on short Weierstrass curves with a = 0,
// per lane, in registers.
//
// Device-function counterparts of algoplonk_tpu/ops/curve_pallas.py
// _mixed_add_body and _jac_add_body (and of ops/curve.py jac_add_affine /
// jac_add, whose operation sequence they follow exactly).  The TPU bodies run
// lazily reduced limbs; here every value is canonical, so a kernel output is
// word-for-word the plain PyTorch result (algoplonk_tpu_torch/ops/curve.py).
//
// What bounds them on the H100: a mixed add is 11 Montgomery multiplies and a
// projective add 12 (field.cuh: ~270 integer instructions each at W = 8), on
// about 100 words of live state per lane.  The formulas therefore run in
// registers with no shared memory, and keep the reference's operation order
// so that every intermediate is the plain version's; ptxas fits each kernel
// without spills (106-146 registers).

#pragma once

#include "field.cuh"

namespace ap {

template <int W>
struct CurveConsts {
  FieldConsts<W> f;
  uint32_t b3[W];  // 3 b, Montgomery form
};

template <int W>
struct Proj {
  uint32_t x[W], y[W], z[W];
};

// acc <- acc + (x2, y2)   (12M-class RCB mixed add; (0, 0) is infinity and
// leaves acc unchanged).  q_inf must come from the raw coordinates.
template <int W>
__device__ __forceinline__ void mixed_add(Proj<W>& acc, const uint32_t* X2,
                                          const uint32_t* Y2, bool q_inf,
                                          const CurveConsts<W>& cc) {
  const FieldConsts<W>& c = cc.f;
  const uint32_t* p = c.p;
  uint32_t t0[W], t1[W], t2[W], t3[W], t4[W], t5[W], u[W], v[W];
  uint32_t x3[W], y3[W], z3[W];
  mont_mul<W>(t0, acc.x, X2, c);
  mont_mul<W>(t1, acc.y, Y2, c);
  add_mod<W>(u, acc.x, acc.y, p);
  add_mod<W>(v, X2, Y2, p);
  mont_mul<W>(t3, u, v, c);
  add_mod<W>(u, t0, t1, p);
  sub_mod<W>(t3, t3, u, p);            // X1Y2 + X2Y1
  mont_mul<W>(u, Y2, acc.z, c);
  add_mod<W>(t4, u, acc.y, p);         // Y1 + Y2Z1
  mont_mul<W>(u, X2, acc.z, c);
  add_mod<W>(t5, u, acc.x, p);         // X1 + X2Z1
  add_mod<W>(u, t0, t0, p);
  add_mod<W>(t0, u, t0, p);            // 3 X1X2
  mont_mul<W>(t2, cc.b3, acc.z, c);    // b3 Z1
  add_mod<W>(z3, t1, t2, p);
  sub_mod<W>(t1, t1, t2, p);
  mont_mul<W>(y3, cc.b3, t5, c);
  mont_mul<W>(u, t3, t1, c);
  mont_mul<W>(v, t4, y3, c);
  sub_mod<W>(x3, u, v, p);
  mont_mul<W>(u, t1, z3, c);
  mont_mul<W>(v, y3, t0, c);
  add_mod<W>(y3, u, v, p);
  mont_mul<W>(u, z3, t4, c);
  mont_mul<W>(v, t0, t3, c);
  add_mod<W>(z3, u, v, p);
  if (!q_inf) {
    copy<W>(acc.x, x3);
    copy<W>(acc.y, y3);
    copy<W>(acc.z, z3);
  }
}

// out <- a + b   (complete projective add, 12M; out may alias a)
template <int W>
__device__ __forceinline__ void jac_add(Proj<W>& out, const Proj<W>& a,
                                        const Proj<W>& b,
                                        const CurveConsts<W>& cc) {
  const FieldConsts<W>& c = cc.f;
  const uint32_t* p = c.p;
  uint32_t t0[W], t1[W], t2[W], t3[W], t4[W], t5[W], u[W], v[W];
  uint32_t x3[W], y3[W], z3[W];
  mont_mul<W>(t0, a.x, b.x, c);
  mont_mul<W>(t1, a.y, b.y, c);
  mont_mul<W>(t2, a.z, b.z, c);
  add_mod<W>(u, a.x, a.y, p);
  add_mod<W>(v, b.x, b.y, p);
  mont_mul<W>(t3, u, v, c);
  add_mod<W>(u, t0, t1, p);
  sub_mod<W>(t3, t3, u, p);            // X1Y2 + X2Y1
  add_mod<W>(u, a.y, a.z, p);
  add_mod<W>(v, b.y, b.z, p);
  mont_mul<W>(t4, u, v, c);
  add_mod<W>(u, t1, t2, p);
  sub_mod<W>(t4, t4, u, p);            // Y1Z2 + Y2Z1
  add_mod<W>(u, a.x, a.z, p);
  add_mod<W>(v, b.x, b.z, p);
  mont_mul<W>(t5, u, v, c);
  add_mod<W>(u, t0, t2, p);
  sub_mod<W>(t5, t5, u, p);            // X1Z2 + X2Z1
  add_mod<W>(u, t0, t0, p);
  add_mod<W>(t0, u, t0, p);            // 3 X1X2
  mont_mul<W>(u, cc.b3, t2, c);
  copy<W>(t2, u);                      // b3 Z1Z2
  add_mod<W>(z3, t1, t2, p);           // Y1Y2 + b3 Z1Z2
  sub_mod<W>(t1, t1, t2, p);           // Y1Y2 - b3 Z1Z2
  mont_mul<W>(y3, cc.b3, t5, c);       // b3 (X1Z2 + X2Z1)
  mont_mul<W>(u, t3, t1, c);
  mont_mul<W>(v, t4, y3, c);
  sub_mod<W>(x3, u, v, p);
  mont_mul<W>(u, t1, z3, c);
  mont_mul<W>(v, y3, t0, c);
  add_mod<W>(y3, u, v, p);
  mont_mul<W>(u, z3, t4, c);
  mont_mul<W>(v, t0, t3, c);
  add_mod<W>(z3, u, v, p);
  copy<W>(out.x, x3);
  copy<W>(out.y, y3);
  copy<W>(out.z, z3);
}

}  // namespace ap

"""Host-side pairings for BN254 and BLS12-381 (exact python ints).

Used by the native proof self-check (the reference calls gnark's plonk.Verify
after every Prove, algoplonk.go:93) and by on-chain-equation
tests.  Only a handful of pairings run per proof, so a clear, exact host
implementation is the right tool — bulk compute stays on the TPU.

Tower: Fp2 = Fp[u]/(u^2+1), Fp6 = Fp2[v]/(v^3 - xi), Fp12 = Fp6[w]/(w^2 - v).
xi = 9 + u (BN254) or 1 + u (BLS12-381).  Miller loops run on the untwisted
curve over Fp12 with affine arithmetic; the final exponentiation uses the
generic integer (p^4 - p^2 + 1) / r hard part (slow-but-exact; fine at this
call volume).

Copied from ``algoplonk_tpu/host/pairing.py`` so that the port imports nothing of the
JAX package.
"""

from __future__ import annotations

import functools

from ..fields.params import BLS12_381, BN254, CurveParams
from .fp import GF2


class Fp6:
    def __init__(self, f2: GF2, xi):
        self.f2 = f2
        self.xi = xi

    def zero(self):
        z = self.f2.zero()
        return (z, z, z)

    def one(self):
        return (self.f2.one(), self.f2.zero(), self.f2.zero())

    def add(self, a, b):
        f = self.f2
        return tuple(f.add(x, y) for x, y in zip(a, b))

    def sub(self, a, b):
        f = self.f2
        return tuple(f.sub(x, y) for x, y in zip(a, b))

    def neg(self, a):
        f = self.f2
        return tuple(f.neg(x) for x in a)

    def mul(self, a, b):
        f = self.f2
        a0, a1, a2 = a
        b0, b1, b2 = b
        t0 = f.mul(a0, b0)
        t1 = f.mul(a1, b1)
        t2 = f.mul(a2, b2)
        c0 = f.add(t0, f.mul(self.xi, f.sub(f.mul(f.add(a1, a2), f.add(b1, b2)), f.add(t1, t2))))
        c1 = f.add(f.sub(f.mul(f.add(a0, a1), f.add(b0, b1)), f.add(t0, t1)), f.mul(self.xi, t2))
        c2 = f.add(f.sub(f.mul(f.add(a0, a2), f.add(b0, b2)), f.add(t0, t2)), t1)
        return (c0, c1, c2)

    def sqr(self, a):
        return self.mul(a, a)

    def mul_by_v(self, a):
        """a * v  (v^3 = xi)."""
        f = self.f2
        a0, a1, a2 = a
        return (f.mul(self.xi, a2), a0, a1)

    def inv(self, a):
        f = self.f2
        c0, c1, c2 = a
        t0 = f.sub(f.mul(c0, c0), f.mul(self.xi, f.mul(c1, c2)))
        t1 = f.sub(f.mul(self.xi, f.mul(c2, c2)), f.mul(c0, c1))
        t2 = f.sub(f.mul(c1, c1), f.mul(c0, c2))
        d = f.add(
            f.mul(c0, t0),
            f.mul(self.xi, f.add(f.mul(c2, t1), f.mul(c1, t2))),
        )
        di = f.inv(d)
        return (f.mul(t0, di), f.mul(t1, di), f.mul(t2, di))


class Fp12:
    def __init__(self, curve: CurveParams):
        p = curve.fp.modulus
        self.p = p
        self.f2 = GF2(p, curve.fp2_nonresidue)
        if curve.name == "bn254":
            self.xi = (9, 1)
        else:
            self.xi = (1, 1)
        self.f6 = Fp6(self.f2, self.xi)
        # Frobenius constants: gamma_k = xi^(k*(p-1)/6), k = 1..5 (in Fp2)
        e = (p - 1) // 6
        self.gammas = [self.f2.pow(self.xi, k * e) for k in range(6)]

    def zero(self):
        return (self.f6.zero(), self.f6.zero())

    def one(self):
        return (self.f6.one(), self.f6.zero())

    def add(self, a, b):
        return (self.f6.add(a[0], b[0]), self.f6.add(a[1], b[1]))

    def sub(self, a, b):
        return (self.f6.sub(a[0], b[0]), self.f6.sub(a[1], b[1]))

    def mul(self, a, b):
        f6 = self.f6
        a0, a1 = a
        b0, b1 = b
        t0 = f6.mul(a0, b0)
        t1 = f6.mul(a1, b1)
        c0 = f6.add(t0, f6.mul_by_v(t1))
        c1 = f6.sub(f6.sub(f6.mul(f6.add(a0, a1), f6.add(b0, b1)), t0), t1)
        return (c0, c1)

    def sqr(self, a):
        return self.mul(a, a)

    def neg(self, a):
        return (self.f6.neg(a[0]), self.f6.neg(a[1]))

    def conj(self, a):
        """Conjugation = Frobenius^6 (w -> -w)."""
        return (a[0], self.f6.neg(a[1]))

    def inv(self, a):
        f6 = self.f6
        a0, a1 = a
        t = f6.inv(f6.sub(f6.sqr(a0), f6.mul_by_v(f6.sqr(a1))))
        return (f6.mul(a0, t), f6.neg(f6.mul(a1, t)))

    def eq(self, a, b):
        f = self.f2
        return all(
            f.eq(x, y) for ax, bx in zip(a, b) for x, y in zip(ax, bx)
        )

    def is_one(self, a):
        return self.eq(a, self.one())

    def pow(self, a, e: int):
        if e < 0:
            return self.pow(self.inv(a), -e)
        result = self.one()
        base = a
        while e:
            if e & 1:
                result = self.mul(result, base)
            base = self.sqr(base)
            e >>= 1
        return result

    def frobenius(self, a):
        """x -> x^p.  Element = sum_{i<3,j<2} c_{ij} v^i w^j;
        pi(c v^i w^j) = conj(c) gamma_{2i+j} v^i w^j."""
        f2 = self.f2
        (c00, c01, c02), (c10, c11, c12) = a
        g = self.gammas
        d0 = (
            f2.conj(c00),
            f2.mul(f2.conj(c01), g[2]),
            f2.mul(f2.conj(c02), g[4]),
        )
        d1 = (
            f2.mul(f2.conj(c10), g[1]),
            f2.mul(f2.conj(c11), g[3]),
            f2.mul(f2.conj(c12), g[5]),
        )
        return (d0, d1)

    # Fp2 scalar embedding: x in Fp2 -> Fp12
    def from_fp2(self, x):
        z = self.f2.zero()
        return ((x, z, z), self.f6.zero())

    def from_int(self, v):
        return self.from_fp2(self.f2.from_int(v))

    def mul_by_w_pow(self, a, k: int):
        """Multiply by w^k, k in [0, 6); w^2 = v, w^6 = xi... via repeated w."""
        out = a
        for _ in range(k % 12):
            out = self._mul_w(out)
        return out

    def _mul_w(self, a):
        """a * w: (a0 + a1 w) w = a1 v + a0 w."""
        return (self.f6.mul_by_v(a[1]), a[0])


class Pairing:
    """Optimal ate pairing on BN254 / BLS12-381."""

    def __init__(self, curve: CurveParams):
        self.curve = curve
        self.p = curve.fp.modulus
        self.r = curve.fr.modulus
        self.fp12 = Fp12(curve)
        if curve.name == "bn254":
            self.x = 4965661367192848881
            self.loop = 6 * self.x + 2
            self.twist = "D"  # untwist (x, y) -> (x w^2, y w^3)
        else:
            self.x = -0xD201000000010000
            self.loop = abs(self.x)
            self.twist = "M"  # untwist (x, y) -> (x / w^2, y / w^3)
        # generic hard part exponent of the final exponentiation
        p = self.p
        self.hard_exp = (p**4 - p**2 + 1) // self.r

    # ------------------------------------------------------------ untwist

    def untwist(self, Q):
        """G2 point ((x0,x1),(y0,y1)) on the twist -> point over Fp12."""
        if Q is None:
            return None
        f12 = self.fp12
        x = f12.from_fp2(Q[0])
        y = f12.from_fp2(Q[1])
        if self.twist == "D":
            X = f12.mul_by_w_pow(x, 2)
            Y = f12.mul_by_w_pow(y, 3)
        else:
            # divide by w^2 / w^3: w^-1 = w^11 / xi  (w^12 = xi^2 ... compute
            # via inverse of w embedding)
            w = f12._mul_w(f12.one())
            w2i = f12.inv(f12.mul(w, w))
            w3i = f12.mul(w2i, f12.inv(w))
            X = f12.mul(x, w2i)
            Y = f12.mul(y, w3i)
        return (X, Y)

    # ------------------------------------------------------- curve over Fp12

    def _add_step(self, T, Q, P12):
        """Affine chord step: returns (T+Q, line_{T,Q}(P))."""
        f = self.fp12
        (x1, y1), (x2, y2) = T, Q
        xp, yp = P12
        if f.eq(x1, x2) and f.eq(y1, y2):
            return self._double_step(T, P12)
        if f.eq(x1, x2):
            # vertical line x - x1 evaluated at P
            return None, f.sub(xp, x1)
        lam = f.mul(f.sub(y2, y1), f.inv(f.sub(x2, x1)))
        x3 = f.sub(f.sub(f.sqr(lam), x1), x2)
        y3 = f.sub(f.mul(lam, f.sub(x1, x3)), y1)
        line = f.sub(f.sub(yp, y1), f.mul(lam, f.sub(xp, x1)))
        return (x3, y3), line

    def _double_step(self, T, P12):
        f = self.fp12
        x1, y1 = T
        xp, yp = P12
        lam = f.mul(
            f.mul(f.from_int(3), f.sqr(x1)),
            f.inv(f.mul(f.from_int(2), y1)),
        )
        x3 = f.sub(f.sub(f.sqr(lam), x1), x1)
        y3 = f.sub(f.mul(lam, f.sub(x1, x3)), y1)
        line = f.sub(f.sub(yp, y1), f.mul(lam, f.sub(xp, x1)))
        return (x3, y3), line

    def _frob_point(self, Pt, k=1):
        f = self.fp12
        x, y = Pt
        for _ in range(k):
            x = f.frobenius(x)
            y = f.frobenius(y)
        return (x, y)

    # ------------------------------------------------------------- miller

    def miller_loop(self, P, Q):
        """P in G1 (affine int pair), Q in G2 (affine Fp2 pairs)."""
        f = self.fp12
        if P is None or Q is None:
            return f.one()
        P12 = (f.from_int(P[0]), f.from_int(P[1]))
        QU = self.untwist(Q)
        T = QU
        acc = f.one()
        bits = bin(self.loop)[3:]  # skip MSB
        for b in bits:
            T, line = self._double_step(T, P12)
            acc = f.mul(f.sqr(acc), line)
            if b == "1":
                T, line = self._add_step(T, QU, P12)
                acc = f.mul(acc, line)
        if self.curve.name == "bn254":
            # two extra steps with Frobenius images of Q
            Q1 = self._frob_point(QU, 1)
            Q2 = self._frob_point(QU, 2)
            Q2 = (Q2[0], f.neg(Q2[1]))
            T, line = self._add_step(T, Q1, P12)
            acc = f.mul(acc, line)
            T, line = self._add_step(T, Q2, P12)
            acc = f.mul(acc, line)
        else:
            if self.x < 0:
                acc = f.conj(acc)
        return acc

    def final_exp(self, fval):
        f = self.fp12
        # easy part: f^((p^6-1)(p^2+1))
        t = f.mul(f.conj(fval), f.inv(fval))
        t = f.mul(f.frobenius(f.frobenius(t)), t)
        # hard part (generic, exact): t^((p^4 - p^2 + 1)/r)
        return f.pow(t, self.hard_exp)

    def pairing(self, P, Q):
        return self.final_exp(self.miller_loop(P, Q))

    def pairing_check(self, pairs) -> bool:
        """prod e(P_i, Q_i) == 1, pairs = [(G1 affine, G2 affine), ...]."""
        f = self.fp12
        acc = f.one()
        for P, Q in pairs:
            acc = f.mul(acc, self.miller_loop(P, Q))
        return f.is_one(self.final_exp(acc))


@functools.lru_cache(maxsize=None)
def pairing_engine(curve_name: str) -> Pairing:
    return Pairing(BN254 if curve_name == "bn254" else BLS12_381)

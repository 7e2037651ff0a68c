"""Host-side pairings for BN254 and BLS12-381 (exact python ints).

Used by the native proof self-check (the reference calls gnark's plonk.Verify
after every Prove, algoplonk.go:93) and by on-chain-equation
tests.  Only a handful of pairings run per proof, so a clear, exact host
implementation is the right tool — bulk compute stays on the card.

Tower: Fp2 = Fp[u]/(u^2+1), Fp6 = Fp2[v]/(v^3 - xi), Fp12 = Fp6[w]/(w^2 - v).
xi = 9 + u (BN254) or 1 + u (BLS12-381).

The Miller loop runs on the twist E'(Fp2) in homogeneous projective
coordinates (no inversion), one loop for all the pairs of a product with one
squaring of the accumulator a step.  Each line is evaluated at P and
multiplied in sparsely: BN254's D-type twist gives lines on 1, w and w^3,
BLS12-381's M-type twist lines on 1, w^2 and w^3 (the untwisted line times
w^3).  These lines differ from the affine ones on the untwisted curve by
factors in Fp4 or Fp6, which the final exponentiation sends to 1, so the
pairing's value is the same.  The final exponentiation's hard part is the
exact exponent (p^4 - p^2 + 1)/r, written through the curve's x and powers
of p, with cyclotomic squarings (Granger-Scott) inside the powers:
  BN254:     l0 + l1 p + l2 p^2 + p^3, l2 = 6x^2 + 1,
             l1 = -36x^3 - 18x^2 - 12x + 1, l0 = -36x^3 - 30x^2 - 18x - 2;
  BLS12-381: ((x - 1)^2 / 3) (x + p) (x^2 + p^2 - 1) + 1.

Adapted from ``algoplonk_tpu/host/pairing.py`` (affine Miller loops on the
untwisted curve, the hard part by the integer exponent), so that the port
imports nothing of the JAX package; it returns the same pairing values.
"""

from __future__ import annotations

import functools

from ..fields.params import BLS12_381, BN254, CurveParams
from .fp import GF2


class Fp2(GF2):
    """GF2 with u^2 = -1, as on both curves: a product in four multiplies
    and two reductions."""

    def __init__(self, p: int):
        super().__init__(p, p - 1)

    def mul(self, a, b):
        a0, a1 = a
        b0, b1 = b
        p = self.p
        return ((a0 * b0 - a1 * b1) % p, (a0 * b1 + a1 * b0) % p)

    def sqr(self, a):
        a0, a1 = a
        p = self.p
        return ((a0 + a1) * (a0 - a1) % p, 2 * a0 * a1 % p)


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

    def mul_by_01(self, a, b0, b1):
        """a * (b0 + b1 v)."""
        f = self.f2
        a0, a1, a2 = a
        t0 = f.mul(a0, b0)
        t1 = f.mul(a1, b1)
        c0 = f.add(f.mul(self.xi, f.mul(a2, b1)), t0)
        c1 = f.sub(f.mul(f.add(a0, a1), f.add(b0, b1)), f.add(t0, t1))
        c2 = f.add(f.mul(a2, b0), t1)
        return (c0, c1, c2)

    def mul_by_1(self, a, b1):
        """a * (b1 v)."""
        f = self.f2
        a0, a1, a2 = a
        return (f.mul(self.xi, f.mul(a2, b1)), f.mul(a0, b1), f.mul(a1, b1))

    def mul_by_fp2(self, a, c):
        f = self.f2
        return tuple(f.mul(x, c) for x in a)

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
        if curve.fp2_nonresidue % p != p - 1:
            raise ValueError("the tower needs u^2 = -1")
        self.f2 = Fp2(p)
        if curve.name == "bn254":
            self.xi = (9, 1)
        else:
            self.xi = (1, 1)
        self.f6 = Fp6(self.f2, self.xi)
        # Frobenius constants: gamma_k = xi^(k*(p-1)/6), k = 1..5 (in Fp2)
        e = (p - 1) // 6
        self.gammas = [self.f2.pow(self.xi, k * e) for k in range(6)]

    def one(self):
        return (self.f6.one(), self.f6.zero())

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
        """(a0 + a1 w)^2 = (a0 + a1)(a0 + v a1) - t - v t + 2 t w, t = a0 a1."""
        f6 = self.f6
        a0, a1 = a
        t = f6.mul(a0, a1)
        c0 = f6.sub(f6.mul(f6.add(a0, a1), f6.add(a0, f6.mul_by_v(a1))),
                    f6.add(t, f6.mul_by_v(t)))
        return (c0, f6.add(t, t))

    def cyclotomic_sqr(self, a):
        """a^2 for a of norm 1 over Fp6 and over Fp4 (after the final
        exponentiation's easy part): Granger and Scott, "Faster squaring in
        the cyclotomic subgroup of sixth degree extensions" (PKC 2010)."""
        f = self.f2
        xi = self.xi
        (r0, r4, r3), (r2, r1, r5) = a

        def sq4(x, y):
            # (x + y s)^2 in Fp4 = Fp2[s]/(s^2 - xi)
            t = f.mul(x, y)
            return (f.sub(f.mul(f.add(x, y), f.add(f.mul(xi, y), x)),
                          f.add(t, f.mul(xi, t))),
                    f.add(t, t))

        t0, t1 = sq4(r0, r1)
        t2, t3 = sq4(r2, r3)
        t4, t5 = sq4(r4, r5)

        def minus(t, z):    # 3t - 2z
            return f.add(f.add(t, t), f.sub(t, f.add(z, z)))

        def plus(t, z):     # 3t + 2z
            return f.add(f.add(t, t), f.add(t, f.add(z, z)))

        return ((minus(t0, r0), minus(t2, r4), minus(t4, r3)),
                (plus(f.mul(xi, t5), r2), plus(t1, r1), plus(t3, r5)))

    def cyclotomic_pow(self, a, e: int):
        """a^e, e > 0, for a of the cyclotomic subgroup."""
        out = a
        for bit in bin(e)[3:]:
            out = self.cyclotomic_sqr(out)
            if bit == "1":
                out = self.mul(out, a)
        return out

    def mul_by_034(self, a, c0, c3, c4):
        """a * (c0 + c3 w + c4 w^3): a D-type twist's line."""
        f6 = self.f6
        a0, a1 = a
        t0 = f6.mul_by_fp2(a0, c0)
        t1 = f6.mul_by_01(a1, c3, c4)
        s = f6.mul_by_01(f6.add(a0, a1), self.f2.add(c0, c3), c4)
        return (f6.add(t0, f6.mul_by_v(t1)), f6.sub(s, f6.add(t0, t1)))

    def mul_by_014(self, a, c0, c1, c4):
        """a * (c0 + c1 w^2 + c4 w^3): an M-type twist's line."""
        f6 = self.f6
        a0, a1 = a
        t0 = f6.mul_by_01(a0, c0, c1)
        t1 = f6.mul_by_1(a1, c4)
        s = f6.mul_by_01(f6.add(a0, a1), c0, self.f2.add(c1, c4))
        return (f6.add(t0, f6.mul_by_v(t1)), f6.sub(s, f6.add(t0, t1)))

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

    def frobenius(self, a, k: int = 1):
        """x -> x^(p^k).  Element = sum_{i<3,j<2} c_{ij} v^i w^j;
        pi(c v^i w^j) = conj(c) gamma_{2i+j} v^i w^j."""
        f2 = self.f2
        g = self.gammas
        for _ in range(k):
            (c00, c01, c02), (c10, c11, c12) = a
            a = (
                (f2.conj(c00), f2.mul(f2.conj(c01), g[2]), f2.mul(f2.conj(c02), g[4])),
                (f2.mul(f2.conj(c10), g[1]), f2.mul(f2.conj(c11), g[3]),
                 f2.mul(f2.conj(c12), g[5])),
            )
        return a


def _naf(k: int) -> list:
    """Signed binary digits of k > 0 with no two adjacent non-zero, most
    significant first."""
    out = []
    while k:
        d = (2 - k % 4) if k & 1 else 0
        out.append(d)
        k = (k - d) >> 1
    return out[::-1]


class Pairing:
    """Optimal ate pairing on BN254 / BLS12-381."""

    def __init__(self, curve: CurveParams):
        self.curve = curve
        self.p = curve.fp.modulus
        self.r = curve.fr.modulus
        self.fp12 = Fp12(curve)
        f2 = self.fp12.f2
        self.three_b2 = f2.mul_int(curve.b2, 3)      # 3 b' of the twist
        self.half = pow(2, -1, self.p)
        if curve.name == "bn254":
            self.x = 4965661367192848881
            self.digits = _naf(6 * self.x + 2)[1:]
            self.twist = "D"  # untwist (x, y) -> (x w^2, y w^3)
        else:
            self.x = -0xD201000000010000
            self.digits = [int(b) for b in bin(-self.x)[3:]]
            self.twist = "M"  # untwist (x, y) -> (x / w^2, y / w^3)

    # ---------------------------------------------------- steps on the twist

    def _double(self, T):
        """T <- 2T, T = [X, Y, Z] homogeneous on the twist; returns the
        tangent's (a, b, c), the line a yP + b xP + c (Costello, Lange and
        Naehrig, PKC 2010, as arkworks' bls12/bn g2 prepare it)."""
        f = self.fp12.f2
        X, Y, Z = T
        a = f.mul_int(f.mul(X, Y), self.half)
        b = f.sqr(Y)
        c = f.sqr(Z)
        e = f.mul(self.three_b2, c)
        f3 = f.add(f.add(e, e), e)
        g = f.mul_int(f.add(b, f3), self.half)
        h = f.sub(f.sqr(f.add(Y, Z)), f.add(b, c))
        j = f.sqr(X)
        e2 = f.sqr(e)
        T[0] = f.mul(a, f.sub(b, f3))
        T[1] = f.sub(f.sqr(g), f.add(f.add(e2, e2), e2))
        T[2] = f.mul(b, h)
        return f.neg(h), f.add(f.add(j, j), j), f.sub(e, b)

    def _add(self, T, Q):
        """T <- T + Q, Q affine on the twist; returns the chord's (a, b, c)."""
        f = self.fp12.f2
        X, Y, Z = T
        qx, qy = Q
        theta = f.sub(Y, f.mul(qy, Z))
        lam = f.sub(X, f.mul(qx, Z))
        c = f.sqr(theta)
        d = f.sqr(lam)
        e = f.mul(lam, d)
        g = f.mul(X, d)
        h = f.sub(f.add(e, f.mul(Z, c)), f.add(g, g))
        T[0] = f.mul(lam, h)
        T[1] = f.sub(f.mul(theta, f.sub(g, h)), f.mul(e, Y))
        T[2] = f.mul(Z, e)
        return lam, f.neg(theta), f.sub(f.mul(theta, qx), f.mul(lam, qy))

    def _line(self, acc, coeffs, P):
        """acc * (a yP + b xP + c), placed on the twist's slots."""
        f12, f2 = self.fp12, self.fp12.f2
        a, b, c = coeffs
        ay, bx = f2.mul_int(a, P[1]), f2.mul_int(b, P[0])
        if self.twist == "D":
            return f12.mul_by_034(acc, ay, bx, c)
        return f12.mul_by_014(acc, c, bx, ay)

    def _frob_twist(self, Q):
        """The p-power Frobenius carried to the (D-type) twist."""
        f2, g = self.fp12.f2, self.fp12.gammas
        return (f2.mul(f2.conj(Q[0]), g[2]), f2.mul(f2.conj(Q[1]), g[3]))

    # ------------------------------------------------------------- miller

    def multi_miller_loop(self, pairs):
        """prod_i f_{Q_i}(P_i) over pairs [(G1 affine int pair, G2 affine
        Fp2 pairs)], one squaring a step; a None point gives 1."""
        f12, f2 = self.fp12, self.fp12.f2
        work = [(P, Q, f2.neg(Q[1])) for P, Q in pairs if P is not None and Q is not None]
        Ts = [[Q[0], Q[1], f2.one()] for _, Q, _ in work]
        acc = f12.one()
        if not work:
            return acc
        for i, d in enumerate(self.digits):
            if i:
                acc = f12.sqr(acc)
            for (P, _, _), T in zip(work, Ts):
                acc = self._line(acc, self._double(T), P)
            if d:
                for (P, Q, nqy), T in zip(work, Ts):
                    acc = self._line(acc, self._add(T, Q if d > 0 else (Q[0], nqy)), P)
        if self.curve.name == "bn254":
            # two extra steps with Frobenius images of Q
            for (P, Q, _), T in zip(work, Ts):
                Q1 = self._frob_twist(Q)
                Q2 = self._frob_twist(Q1)
                acc = self._line(acc, self._add(T, Q1), P)
                acc = self._line(acc, self._add(T, (Q2[0], f2.neg(Q2[1]))), P)
        elif self.x < 0:
            acc = f12.conj(acc)
        return acc

    def miller_loop(self, P, Q):
        """P in G1 (affine int pair), Q in G2 (affine Fp2 pairs)."""
        return self.multi_miller_loop([(P, Q)])

    def _exp_x(self, a):
        """a^x in the cyclotomic subgroup (a^-1 is its conjugate)."""
        out = self.fp12.cyclotomic_pow(a, abs(self.x))
        return self.fp12.conj(out) if self.x < 0 else out

    def final_exp(self, fval):
        f = self.fp12
        # easy part: f^((p^6-1)(p^2+1))
        t = f.mul(f.conj(fval), f.inv(fval))
        t = f.mul(f.frobenius(t, 2), t)
        # hard part: t^((p^4 - p^2 + 1)/r), exactly, through x
        mul, cpow, conj = f.mul, f.cyclotomic_pow, f.conj
        if self.curve.name == "bn254":
            tx = self._exp_x(t)
            tx2 = self._exp_x(tx)
            tx3 = self._exp_x(tx2)
            # t^l2, t^l1 and t^l0: l1 = 1 - 6 (6x^3 + 3x^2 + 2x),
            # l0 = l1 - 6 (2x^2 + x) - 3
            l2 = mul(cpow(tx2, 6), t)
            a = mul(mul(cpow(tx3, 6), cpow(tx2, 3)), cpow(tx, 2))
            l1 = mul(conj(cpow(a, 6)), t)
            b = mul(cpow(tx2, 2), tx)
            l0 = mul(l1, conj(mul(cpow(b, 6), cpow(t, 3))))
            return mul(mul(l0, f.frobenius(l1)), mul(f.frobenius(l2, 2), f.frobenius(t, 3)))
        x = self.x
        y = cpow(t, (x - 1) ** 2 // 3)
        z = mul(self._exp_x(y), f.frobenius(y))                     # y^(x + p)
        z = mul(mul(self._exp_x(self._exp_x(z)), f.frobenius(z, 2)), conj(z))  # ^(x^2 + p^2 - 1)
        return mul(z, t)

    def pairing(self, P, Q):
        return self.final_exp(self.miller_loop(P, Q))

    def pairing_check(self, pairs) -> bool:
        """prod e(P_i, Q_i) == 1, pairs = [(G1 affine, G2 affine), ...]."""
        return self.fp12.is_one(self.final_exp(self.multi_miller_loop(pairs)))


@functools.lru_cache(maxsize=None)
def pairing_engine(curve_name: str) -> Pairing:
    return Pairing(BN254 if curve_name == "bn254" else BLS12_381)

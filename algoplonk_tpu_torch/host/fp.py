"""Exact host-side field and curve arithmetic (arbitrary-precision ints).

This is the host reference layer: it handles the handful of G2 points (only
the vk's two G2 points are ever touched, reference setup/setup.go:172-192),
point (de)serialization support math, pairing towers, and golden checks for
the device kernels.  Bulk compute lives on the TPU (ops/), not here.

Copied from ``algoplonk_tpu/host/fp.py`` so that the port imports nothing of the
JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass


class GF:
    """Prime field of python ints."""

    def __init__(self, p: int):
        self.p = p

    def add(self, a, b):
        return (a + b) % self.p

    def sub(self, a, b):
        return (a - b) % self.p

    def mul(self, a, b):
        return (a * b) % self.p

    def sqr(self, a):
        return (a * a) % self.p

    def neg(self, a):
        return (-a) % self.p

    def inv(self, a):
        return pow(a, -1, self.p)

    def eq(self, a, b):
        return (a - b) % self.p == 0

    def is_zero(self, a):
        return a % self.p == 0

    def zero(self):
        return 0

    def one(self):
        return 1

    def from_int(self, v):
        return v % self.p

    def lex_largest(self, a) -> bool:
        """gnark-crypto convention: a > (p-1)/2."""
        return a > (self.p - 1) // 2

    def sqrt(self, a):
        """Square root for p % 4 == 3 (holds for BN254 and BLS12-381 Fp).
        Returns None if a is not a QR."""
        if a % self.p == 0:
            return 0
        assert self.p % 4 == 3
        r = pow(a, (self.p + 1) // 4, self.p)
        return r if (r * r) % self.p == a % self.p else None


class GF2:
    """Quadratic extension Fp[u]/(u^2 - nonresidue); elements (c0, c1)."""

    def __init__(self, p: int, nonresidue: int):
        self.p = p
        self.nr = nonresidue % p
        self.base = GF(p)

    def add(self, a, b):
        return ((a[0] + b[0]) % self.p, (a[1] + b[1]) % self.p)

    def sub(self, a, b):
        return ((a[0] - b[0]) % self.p, (a[1] - b[1]) % self.p)

    def mul(self, a, b):
        a0, a1 = a
        b0, b1 = b
        t0 = a0 * b0 % self.p
        t1 = a1 * b1 % self.p
        c0 = (t0 + self.nr * t1) % self.p
        c1 = ((a0 + a1) * (b0 + b1) - t0 - t1) % self.p
        return (c0, c1)

    def sqr(self, a):
        return self.mul(a, a)

    def neg(self, a):
        return ((-a[0]) % self.p, (-a[1]) % self.p)

    def conj(self, a):
        return (a[0], (-a[1]) % self.p)

    def inv(self, a):
        a0, a1 = a
        norm = (a0 * a0 - self.nr * a1 * a1) % self.p
        ninv = pow(norm, -1, self.p)
        return (a0 * ninv % self.p, (-a1 * ninv) % self.p)

    def eq(self, a, b):
        return (a[0] - b[0]) % self.p == 0 and (a[1] - b[1]) % self.p == 0

    def is_zero(self, a):
        return a[0] % self.p == 0 and a[1] % self.p == 0

    def zero(self):
        return (0, 0)

    def one(self):
        return (1, 0)

    def from_int(self, v):
        return (v % self.p, 0)

    def mul_int(self, a, k: int):
        return (a[0] * k % self.p, a[1] * k % self.p)

    def pow(self, a, e: int):
        result = self.one()
        base = a
        while e > 0:
            if e & 1:
                result = self.mul(result, base)
            base = self.sqr(base)
            e >>= 1
        return result

    def lex_largest(self, a) -> bool:
        """gnark-crypto E2 convention: compare A1 first, fall back to A0."""
        if a[1] % self.p != 0:
            return self.base.lex_largest(a[1])
        return self.base.lex_largest(a[0])

    def sqrt(self, a):
        """Square root in Fp2 for p % 4 == 3 (Adj–Rodriguez). None if no root.
        Requires nonresidue == -1 (true for both supported curves)."""
        if self.is_zero(a):
            return self.zero()
        assert self.p % 4 == 3 and self.nr == self.p - 1
        a1 = self.pow(a, (self.p - 3) // 4)
        x0 = self.mul(a1, a)
        alpha = self.mul(a1, x0)  # a^((p-1)/2)
        if self.eq(alpha, self.neg(self.one())):
            # sqrt(-1) = u  (u^2 = -1)
            x = self.mul((0, 1), x0)
        else:
            b = self.pow(self.add(self.one(), alpha), (self.p - 1) // 2)
            x = self.mul(b, x0)
        return x if self.eq(self.sqr(x), a) else None


# --------------------------------------------------------------------------
# Short-Weierstrass curve ops, generic over the coordinate field.
# Points are affine tuples (x, y) or None for the point at infinity.
# --------------------------------------------------------------------------


def ec_is_on_curve(F, P, b) -> bool:
    if P is None:
        return True
    x, y = P
    return F.eq(F.sqr(y), F.add(F.mul(F.sqr(x), x), b))


def ec_neg(F, P):
    return None if P is None else (P[0], F.neg(P[1]))


def ec_add(F, P, Q):
    if P is None:
        return Q
    if Q is None:
        return P
    x1, y1 = P
    x2, y2 = Q
    if F.eq(x1, x2):
        if F.eq(y1, F.neg(y2)):
            return None
        # double
        lam = F.mul(F.mul(F.from_int(3), F.sqr(x1)), F.inv(F.mul(F.from_int(2), y1)))
    else:
        lam = F.mul(F.sub(y2, y1), F.inv(F.sub(x2, x1)))
    x3 = F.sub(F.sub(F.sqr(lam), x1), x2)
    y3 = F.sub(F.mul(lam, F.sub(x1, x3)), y1)
    return (x3, y3)


def ec_double(F, P):
    return ec_add(F, P, P)


def ec_mul(F, P, k: int):
    if k < 0:
        return ec_mul(F, ec_neg(F, P), -k)
    R = None
    Q = P
    while k > 0:
        if k & 1:
            R = ec_add(F, R, Q)
        Q = ec_add(F, Q, Q)
        k >>= 1
    return R


def ec_msm(F, points, scalars):
    """Tiny host MSM (for golden tests only — the real one is ops/msm.py)."""
    acc = None
    for P, s in zip(points, scalars):
        acc = ec_add(F, acc, ec_mul(F, P, s))
    return acc


@dataclass(frozen=True)
class HostCurve:
    """Bundles the host-side fields/generators of one supported curve."""

    name: str
    g1_field: GF
    g2_field: GF2
    fr: GF
    b: int
    b2: tuple
    g1_gen: tuple
    g2_gen: tuple


def host_curve(curve_params) -> HostCurve:
    from ..fields.params import CurveParams  # noqa: F401

    c = curve_params
    return HostCurve(
        name=c.name,
        g1_field=GF(c.fp.modulus),
        g2_field=GF2(c.fp.modulus, c.fp2_nonresidue),
        fr=GF(c.fr.modulus),
        b=c.b,
        b2=c.b2,
        g1_gen=c.g1,
        g2_gen=(c.g2_x, c.g2_y),
    )

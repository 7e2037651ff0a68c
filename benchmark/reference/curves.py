"""The two curves' constants and G1 arithmetic, in plain Python integers.

The constants are the published ones (BN254: EIP-196; BLS12-381: the
IETF pairing-friendly-curves draft), written out here so that the
reference needs nothing of the program.  The PLONK domain follows the
program's default constants mode: the 2^s roots of unity are generated by
the smallest quadratic non-residue h of Fr raised to (r - 1) / 2^s, and the
permutation's coset shift is k1 = 5 (k2 = 25).

G1 points are affine (x, y) tuples, None for the point at infinity; the
arithmetic runs in Jacobian coordinates (a = 0).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass


@dataclass(frozen=True)
class Curve:
    name: str
    p: int            # base field
    r: int            # scalar field (the PLONK field)
    b: int            # y^2 = x^3 + b
    g1: tuple         # G1 generator
    nb: int           # bytes of one base-field coordinate in the proof
    coset_shift: int = 5

    @property
    def two_adicity(self) -> int:
        s, m = 0, self.r - 1
        while m % 2 == 0:
            s, m = s + 1, m // 2
        return s

    def domain_generator(self, log_n: int) -> int:
        """A primitive 2^log_n-th root of unity of Fr."""
        r = self.r
        h = 2
        while pow(h, (r - 1) // 2, r) != r - 1:
            h += 1
        return pow(h, (r - 1) >> log_n, r)

    def test_tau(self) -> int:
        """The test-only setup's public toxic waste: SHA-256 of a fixed
        label, mod r."""
        seed = hashlib.sha256(b"algoplonk-tpu unsafe test srs tau v1").digest()
        return int.from_bytes(seed, "big") % self.r


BN254 = Curve(
    name="bn254",
    p=21888242871839275222246405745257275088696311157297823662689037894645226208583,
    r=21888242871839275222246405745257275088548364400416034343698204186575808495617,
    b=3,
    g1=(1, 2),
    nb=32,
)

BLS12_381 = Curve(
    name="bls12_381",
    p=int("1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f624"
          "1eabfffeb153ffffb9feffffffffaaab", 16),
    r=int("73eda753299d7d483339d80809a1d80553bda402fffe5bfeffffffff00000001", 16),
    b=4,
    g1=(int("17f1d3a73197d7942695638c4fa9ac0fc3688c4f9774b905a14e3a3f171bac58"
            "6c55e83ff97a1aeffb3af00adb22c6bb", 16),
        int("08b3f481e3aaa0f1a09e30ed741d8ae4fcf5e095d5d00af600db18cb2c04b3ed"
            "d03cc744a2888ae40caa232946c5e7e1", 16)),
    nb=48,
)

CURVES = {c.name: c for c in (BN254, BLS12_381)}


# ------------------------------------------------------------------ G1

def on_curve(c: Curve, P) -> bool:
    if P is None:
        return True
    x, y = P
    return 0 <= x < c.p and 0 <= y < c.p and (y * y - x * x * x - c.b) % c.p == 0


def _to_jac(P):
    return (1, 1, 0) if P is None else (P[0], P[1], 1)


def _to_affine(c: Curve, J):
    X, Y, Z = J
    if Z == 0:
        return None
    p = c.p
    zi = pow(Z, -1, p)
    zi2 = zi * zi % p
    return (X * zi2 % p, Y * zi2 * zi % p)


def _jdouble(p: int, J):
    X, Y, Z = J
    if Z == 0 or Y == 0:
        return (1, 1, 0)
    A = X * X % p
    B = Y * Y % p
    C = B * B % p
    D = 2 * ((X + B) * (X + B) - A - C) % p
    E = 3 * A % p
    X3 = (E * E - 2 * D) % p
    Y3 = (E * (D - X3) - 8 * C) % p
    Z3 = 2 * Y * Z % p
    return (X3, Y3, Z3)


def _jadd(p: int, J1, J2):
    X1, Y1, Z1 = J1
    X2, Y2, Z2 = J2
    if Z1 == 0:
        return J2
    if Z2 == 0:
        return J1
    Z1Z1 = Z1 * Z1 % p
    Z2Z2 = Z2 * Z2 % p
    U1 = X1 * Z2Z2 % p
    U2 = X2 * Z1Z1 % p
    S1 = Y1 * Z2 * Z2Z2 % p
    S2 = Y2 * Z1 * Z1Z1 % p
    if U1 == U2:
        return _jdouble(p, J1) if S1 == S2 else (1, 1, 0)
    H = (U2 - U1) % p
    I = 4 * H * H % p
    J = H * I % p
    rr = 2 * (S2 - S1) % p
    V = U1 * I % p
    X3 = (rr * rr - J - 2 * V) % p
    Y3 = (rr * (V - X3) - 2 * S1 * J) % p
    Z3 = ((Z1 + Z2) * (Z1 + Z2) - Z1Z1 - Z2Z2) * H % p
    return (X3, Y3, Z3)


def mul(c: Curve, P, k: int):
    """k P by double-and-add, k reduced mod r (every point used here is in
    the order-r subgroup)."""
    k %= c.r
    if P is None or k == 0:
        return None
    p = c.p
    base = _to_jac(P)
    acc = (1, 1, 0)
    for bit in bin(k)[2:]:
        acc = _jdouble(p, acc)
        if bit == "1":
            acc = _jadd(p, acc, base)
    return _to_affine(c, acc)


def msm(c: Curve, pairs):
    """The sum of k P over (P, k) pairs."""
    acc = (1, 1, 0)
    for P, k in pairs:
        acc = _jadd(c.p, acc, _to_jac(mul(c, P, k)))
    return _to_affine(c, acc)


# ------------------------------------------------------- proof encodings

ZC_COMPRESSED, ZC_INFINITY = 0x80, 0x40


def encode_g1(c: Curve, P) -> bytes:
    """A G1 point as the proof and the transcript carry it: x || y
    big-endian; infinity is all zeros on BN254 and the 0x40 flag on
    BLS12-381 (gnark's RawBytes)."""
    if P is None:
        out = bytearray(2 * c.nb)
        if c.name == "bls12_381":
            out[0] = ZC_INFINITY
        return bytes(out)
    return P[0].to_bytes(c.nb, "big") + P[1].to_bytes(c.nb, "big")


def decode_g1(c: Curve, data: bytes):
    """The inverse of ``encode_g1``; raises ValueError on a point that is
    not on the curve or not canonical."""
    if len(data) != 2 * c.nb:
        raise ValueError(f"G1 encoding of {len(data)} bytes")
    if c.name == "bls12_381":
        if data[0] & ZC_COMPRESSED:
            raise ValueError("compressed G1 point in a raw encoding")
        if data[0] & ZC_INFINITY:
            if any(data[1:]) or data[0] != ZC_INFINITY:
                raise ValueError("non-canonical infinity")
            return None
    x = int.from_bytes(data[: c.nb], "big")
    y = int.from_bytes(data[c.nb:], "big")
    if c.name == "bn254" and x == 0 and y == 0:
        return None
    if not on_curve(c, (x, y)):
        raise ValueError("G1 point not on the curve")
    return (x, y)

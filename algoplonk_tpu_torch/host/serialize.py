"""gnark-crypto-compatible point and scalar serialization.

Byte-identical to the encodings the reference depends on:
* proof blobs (helper.go:13-110) use uncompressed RawBytes,
* setup files pk.bin/vk.bin (setup/setup.go:196-228) use
  compressed Bytes,
* the generated verifiers re-encode BLS12-381 infinity 0x40 -> 0x00 for the
  AVM opcodes (verifier/verifier.go:93-100).

Flag conventions:
* BN254 ("msb2", gnark-crypto style): two most-significant bits of byte 0 —
  0b00 uncompressed, 0b10 compressed/smallest-y, 0b11 compressed/largest-y,
  0b01 compressed infinity.
* BLS12-381 ("zcash"): bit 0x80 compression, 0x40 infinity, 0x20 sort
  (lexicographically largest y), matching the IETF/zcash format gnark uses.

Copied from ``algoplonk_tpu/host/serialize.py`` so that the port imports nothing of the
JAX package.
"""

from __future__ import annotations

from ..fields.params import CurveParams
from . import fp as hfp

# msb2 flags (values already shifted into the top two bits)
M2_MASK = 0xC0
M2_UNCOMPRESSED = 0x00
M2_COMPRESSED_SMALLEST = 0x80
M2_COMPRESSED_LARGEST = 0xC0
M2_COMPRESSED_INFINITY = 0x40

# zcash flags
ZC_COMPRESSED = 0x80
ZC_INFINITY = 0x40
ZC_SORT = 0x20


class PointCodec:
    """Point codec for one curve (G1 over Fp, G2 over Fp2)."""

    def __init__(self, curve: CurveParams):
        self.curve = curve
        self.nb = curve.fp.nbytes  # coordinate byte size (32 or 48)
        self.style = curve.flag_style
        self.F1 = hfp.GF(curve.fp.modulus)
        self.F2 = hfp.GF2(curve.fp.modulus, curve.fp2_nonresidue)

    # ------------------------------------------------------------ G1 raw

    def g1_raw_bytes(self, P) -> bytes:
        nb = self.nb
        if P is None:
            out = bytearray(2 * nb)
            if self.style == "zcash":
                out[0] = ZC_INFINITY
            return bytes(out)
        x, y = P
        return x.to_bytes(nb, "big") + y.to_bytes(nb, "big")

    def g1_from_raw_bytes(self, data: bytes):
        nb = self.nb
        assert len(data) == 2 * nb, f"bad G1 raw size {len(data)}"
        first = data[0]
        if self.style == "zcash" and (first & ZC_INFINITY) and not (first & ZC_COMPRESSED):
            return None
        x = int.from_bytes(data[:nb], "big")
        y = int.from_bytes(data[nb:], "big")
        if self.style == "msb2" and x == 0 and y == 0:
            return None
        P = (x, y)
        if not hfp.ec_is_on_curve(self.F1, P, self.curve.b):
            raise ValueError("G1 point not on curve")
        return P

    # ------------------------------------------------------- G1 compressed

    def g1_compressed(self, P) -> bytes:
        nb = self.nb
        if P is None:
            out = bytearray(nb)
            out[0] = (
                M2_COMPRESSED_INFINITY if self.style == "msb2" else ZC_COMPRESSED | ZC_INFINITY
            )
            return bytes(out)
        x, y = P
        out = bytearray(x.to_bytes(nb, "big"))
        largest = self.F1.lex_largest(y)
        if self.style == "msb2":
            out[0] |= M2_COMPRESSED_LARGEST if largest else M2_COMPRESSED_SMALLEST
        else:
            out[0] |= ZC_COMPRESSED | (ZC_SORT if largest else 0)
        return bytes(out)

    def g1_from_compressed(self, data: bytes):
        nb = self.nb
        assert len(data) == nb, f"bad compressed G1 size {len(data)}"
        first = data[0]
        if self.style == "msb2":
            flags = first & M2_MASK
            if flags == M2_COMPRESSED_INFINITY:
                return None
            if flags not in (M2_COMPRESSED_SMALLEST, M2_COMPRESSED_LARGEST):
                raise ValueError(f"bad BN254 compression flags {flags:#x}")
            largest = flags == M2_COMPRESSED_LARGEST
            x = int.from_bytes(bytes([first & ~M2_MASK & 0xFF]) + data[1:], "big")
        else:
            if not (first & ZC_COMPRESSED):
                raise ValueError("expected compressed BLS12-381 point")
            if first & ZC_INFINITY:
                return None
            largest = bool(first & ZC_SORT)
            x = int.from_bytes(bytes([first & 0x1F]) + data[1:], "big")
        y = self.F1.sqrt((x * x % self.F1.p * x + self.curve.b) % self.F1.p)
        if y is None:
            raise ValueError("G1 x-coordinate not on curve")
        if self.F1.lex_largest(y) != largest:
            y = self.F1.p - y
        return (x, y)

    # ------------------------------------------------------------ G2

    def g2_raw_bytes(self, P) -> bytes:
        nb = self.nb
        if P is None:
            out = bytearray(4 * nb)
            if self.style == "zcash":
                out[0] = ZC_INFINITY
            return bytes(out)
        (x0, x1), (y0, y1) = P
        # gnark stores each Fp2 as A1 || A0
        return (
            x1.to_bytes(nb, "big")
            + x0.to_bytes(nb, "big")
            + y1.to_bytes(nb, "big")
            + y0.to_bytes(nb, "big")
        )

    def g2_from_raw_bytes(self, data: bytes):
        nb = self.nb
        assert len(data) == 4 * nb
        first = data[0]
        if self.style == "zcash" and (first & ZC_INFINITY) and not (first & ZC_COMPRESSED):
            return None
        x1 = int.from_bytes(data[:nb], "big")
        x0 = int.from_bytes(data[nb : 2 * nb], "big")
        y1 = int.from_bytes(data[2 * nb : 3 * nb], "big")
        y0 = int.from_bytes(data[3 * nb :], "big")
        if self.style == "msb2" and x0 == x1 == y0 == y1 == 0:
            return None
        P = ((x0, x1), (y0, y1))
        if not hfp.ec_is_on_curve(self.F2, P, self.curve.b2):
            raise ValueError("G2 point not on curve")
        return P

    def g2_compressed(self, P) -> bytes:
        nb = self.nb
        if P is None:
            out = bytearray(2 * nb)
            out[0] = (
                M2_COMPRESSED_INFINITY if self.style == "msb2" else ZC_COMPRESSED | ZC_INFINITY
            )
            return bytes(out)
        (x0, x1), y = P
        out = bytearray(x1.to_bytes(nb, "big") + x0.to_bytes(nb, "big"))
        largest = self.F2.lex_largest(y)
        if self.style == "msb2":
            out[0] |= M2_COMPRESSED_LARGEST if largest else M2_COMPRESSED_SMALLEST
        else:
            out[0] |= ZC_COMPRESSED | (ZC_SORT if largest else 0)
        return bytes(out)

    def g2_from_compressed(self, data: bytes):
        nb = self.nb
        assert len(data) == 2 * nb, f"bad compressed G2 size {len(data)}"
        first = data[0]
        if self.style == "msb2":
            flags = first & M2_MASK
            if flags == M2_COMPRESSED_INFINITY:
                return None
            largest = flags == M2_COMPRESSED_LARGEST
            x1 = int.from_bytes(bytes([first & ~M2_MASK & 0xFF]) + data[1:nb], "big")
        else:
            if not (first & ZC_COMPRESSED):
                raise ValueError("expected compressed BLS12-381 point")
            if first & ZC_INFINITY:
                return None
            largest = bool(first & ZC_SORT)
            x1 = int.from_bytes(bytes([first & 0x1F]) + data[1:nb], "big")
        x0 = int.from_bytes(data[nb:], "big")
        x = (x0, x1)
        rhs = self.F2.add(self.F2.mul(self.F2.sqr(x), x), self.curve.b2)
        y = self.F2.sqrt(rhs)
        if y is None:
            raise ValueError("G2 x-coordinate not on curve")
        if self.F2.lex_largest(y) != largest:
            y = self.F2.neg(y)
        return (x, y)

    # ------------------------------------------------------------ AVM form

    def g1_avm_bytes(self, P) -> bytes:
        """AVM encoding for generated verifiers: like RawBytes but the BLS
        infinity flag byte 0x40 is cleared (reference verifier/verifier.go:94-100);
        infinity is all-zero bytes on both curves."""
        if P is None:
            return bytes(2 * self.nb)
        return self.g1_raw_bytes(P)


def fr_bytes(curve: CurveParams, v: int) -> bytes:
    """Scalar canonical encoding: 32-byte big-endian (gnark fr.Bytes())."""
    return (v % curve.fr.modulus).to_bytes(32, "big")


def fp_bytes(curve: CurveParams, v: int) -> bytes:
    return (v % curve.fp.modulus).to_bytes(curve.fp.nbytes, "big")

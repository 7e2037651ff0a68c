"""sha256 Fiat-Shamir transcript, byte-compatible with the generated
on-chain verifiers (reference templateLogicSigBN254.go:131-140,281-286,323).

Challenge derivation: digest = sha256(name || prev_digest? || bound bytes),
value = int(digest) mod r.  The *unreduced* 32-byte digest chains into the
next challenge (beta binds gamma's digest, etc.), exactly as the verifier
recomputes it.

Point encodings bound into the transcript are gnark RawBytes — for BLS12-381
that includes the 0x40 infinity flag (the on-chain verifier re-applies it via
its fs() helper before hashing, templateLogicSigBLS12_381.go:402-407).

Copied from ``algoplonk_tpu/plonk/transcript.py`` so that the port imports nothing of the
JAX package.
"""

from __future__ import annotations

import hashlib

from ..fields.params import CurveParams
from ..host.serialize import PointCodec, fr_bytes


class Transcript:
    def __init__(self, curve: CurveParams):
        self.curve = curve
        self.codec = PointCodec(curve)
        self.r = curve.fr.modulus

    def _digest(self, name: bytes, chunks) -> bytes:
        h = hashlib.sha256()
        h.update(name)
        for c in chunks:
            h.update(c)
        return h.digest()

    def point(self, P) -> bytes:
        """G1 point in gnark RawBytes form (Fiat-Shamir encoding)."""
        return self.codec.g1_raw_bytes(P)

    def scalar(self, v: int) -> bytes:
        return fr_bytes(self.curve, v)

    def challenge(self, name: bytes, chunks) -> tuple[bytes, int]:
        d = self._digest(name, chunks)
        return d, int.from_bytes(d, "big") % self.r

    # ------------------------------------------------ named PLONK challenges

    def gamma(self, vk, public_inputs, l_com, r_com, o_com):
        chunks = [
            self.point(vk.s1),
            self.point(vk.s2),
            self.point(vk.s3),
            self.point(vk.ql),
            self.point(vk.qr),
            self.point(vk.qm),
            self.point(vk.qo),
            self.point(vk.qk),
        ]
        chunks += [self.point(q) for q in vk.qcp]
        chunks += [self.scalar(x) for x in public_inputs]
        chunks += [self.point(l_com), self.point(r_com), self.point(o_com)]
        return self.challenge(b"gamma", chunks)

    def beta(self, gamma_digest: bytes):
        return self.challenge(b"beta", [gamma_digest])

    def alpha(self, beta_digest: bytes, bsb_commitments, z_com):
        chunks = [beta_digest]
        chunks += [self.point(p) for p in bsb_commitments]
        chunks.append(self.point(z_com))
        return self.challenge(b"alpha", chunks)

    def zeta(self, alpha_digest: bytes, h0_com, h1_com, h2_com):
        return self.challenge(
            b"zeta",
            [alpha_digest, self.point(h0_com), self.point(h1_com), self.point(h2_com)],
        )

    def fold(self, zeta_val, lin_com, l_com, r_com, o_com, vk,
             lin_at_z, l_at_z, r_at_z, o_at_z, s1_at_z, s2_at_z,
             qcp_at_z, z_omega_at_z):
        """Batch-opening fold challenge (name 'gamma' again —
        reference templateLogicSigBN254.go:281-286)."""
        chunks = [self.scalar(zeta_val), self.point(lin_com),
                  self.point(l_com), self.point(r_com), self.point(o_com),
                  self.point(vk.s1), self.point(vk.s2)]
        chunks += [self.point(q) for q in vk.qcp]
        chunks += [self.scalar(lin_at_z), self.scalar(l_at_z),
                   self.scalar(r_at_z), self.scalar(o_at_z),
                   self.scalar(s1_at_z), self.scalar(s2_at_z)]
        chunks += [self.scalar(q) for q in qcp_at_z]
        chunks.append(self.scalar(z_omega_at_z))
        return self.challenge(b"gamma", chunks)

    def multipoint(self, digest_point, batch_opening, z_com, opening_z_omega,
                   zeta_val, fold_val):
        """Second folding challenge for combining the two opening proofs
        (no name prefix — reference templateLogicSigBN254.go:323-324)."""
        chunks = [
            self.point(digest_point),
            self.point(batch_opening),
            self.point(z_com),
            self.point(opening_z_omega),
            self.scalar(zeta_val),
            self.scalar(fold_val),
        ]
        return self.challenge(b"", chunks)


def hash_fr_bsb22(curve: CurveParams, point_bytes: bytes) -> int:
    """gnark fr.Hash with DST 'BSB22-Plonk' (sha256 expand_msg_xmd, 48 bytes),
    as re-implemented by the on-chain verifiers
    (reference templateLogicSigBN254.go:386-398)."""
    dst_prime = b"BSB22-Plonk\x0b"
    b0 = hashlib.sha256(bytes(64) + point_bytes + b"\x00\x30\x00" + dst_prime).digest()
    b1 = hashlib.sha256(b0 + b"\x01" + dst_prime).digest()
    b2 = hashlib.sha256(
        bytes(x ^ y for x, y in zip(b0, b1)) + b"\x02" + dst_prime
    ).digest()
    r = curve.fr.modulus
    res = int.from_bytes(b1, "big") * (1 << 128) % r
    return (res + int.from_bytes(b2[:16], "big")) % r

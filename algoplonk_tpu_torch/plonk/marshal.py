"""Proof blob serialization — byte-identical to the reference's exports.

Host port of the reference module ``algoplonk_tpu/plonk/marshal.py`` (which
imports the jax prover for its Proof type); this one is duck-typed on the
Proof fields.

BN254 layout (gnark MarshalSolidity, reference helper.go:17 and the offsets
hard-coded in templateLogicSigBN254.go:75-108):
  64B L | 64B R | 64B O | 64B H0 | 64B H1 | 64B H2 |
  32B l(z) r(z) o(z) s1(z) s2(z) | 64B Z | 32B z(wz) |
  64B batch opening | 64B opening at wz |
  [32B qcp_i(z)]... | [64B BSB commitment_i]...
  => (24 + 3*nb_commitments) 32-byte words.

BLS12-381 layout (reference helper.go:27-88): same shape with 96-byte
uncompressed G1 points (gnark RawBytes incl. the 0x40 infinity flag)
  => (33 + 4*nb_commitments) words.
"""

from __future__ import annotations

from .._ref.fields.params import CurveParams
from .._ref.host.serialize import PointCodec, fr_bytes


def marshal_proof(curve: CurveParams, proof) -> bytes:
    codec = PointCodec(curve)
    pt = codec.g1_raw_bytes
    sc = lambda v: fr_bytes(curve, v)  # noqa: E731

    out = b"".join(
        [
            pt(proof.l_com), pt(proof.r_com), pt(proof.o_com),
            pt(proof.h0), pt(proof.h1), pt(proof.h2),
            sc(proof.l_at_z), sc(proof.r_at_z), sc(proof.o_at_z),
            sc(proof.s1_at_z), sc(proof.s2_at_z),
            pt(proof.z_com),
            sc(proof.z_omega_at_z),
            pt(proof.batch_opening),
            pt(proof.opening_z_omega),
        ]
    )
    out += b"".join(sc(v) for v in proof.qcp_at_z)
    out += b"".join(pt(p) for p in proof.bsb_commitments)
    return out


def expected_proof_len(curve: CurveParams, nb_commitments: int) -> int:
    if curve.name == "bn254":
        return (24 + 3 * nb_commitments) * 32
    return (33 + 4 * nb_commitments) * 32

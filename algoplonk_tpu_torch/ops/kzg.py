"""Standalone KZG commitment scheme over the device kernels.

Counterpart of the reference ``ops/kzg.py``.  The reference consumes
gnark-crypto's kzg package (SRS types, commit/open inside plonk.Prove,
verification in plonk.Verify).  The PLONK pipeline calls these building
blocks through plonk/prove.py; this module packages them as a component:
commit (monomial or Lagrange basis), open, and verification on the host
through the pairing engine.  The device is the SRS tensor's: on the card a
commit above ``HOST_MSM_MAX`` points runs the MSM kernels, and ``open``'s
quotient the field kernels.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..fields.params import CurveParams
from ..host import fp as hfp
from ..host.pairing import pairing_engine
from .curve import curve_ops
from .field import field_ops
from .msm import msm_ctx
from . import poly as polyops


@dataclass
class KzgOpening:
    value: int          # p(z)
    proof: tuple        # commitment to (p(X) - p(z)) / (X - z), affine ints


class KZG:
    def __init__(self, curve: CurveParams, srs_g1_dev, vk_g1, vk_g2):
        dev = srs_g1_dev.device
        self.curve = curve
        self.f = field_ops(curve.fr, dev)
        self.ops = curve_ops(curve, dev)
        self.msm = msm_ctx(curve, dev)
        self.srs = srs_g1_dev          # [n, 2, W] monomial basis
        self.vk_g1 = vk_g1
        self.vk_g2 = vk_g2             # ([1] G2, [tau] G2)

    def commit(self, coeffs) -> tuple:
        """Monomial-basis commit of [d, W] Montgomery coefficients."""
        return self.msm.msm_to_affine_int(
            self.srs[: coeffs.shape[0]], coeffs, kind="mont"
        )

    def commit_lagrange(self, evals, lagrange_srs_dev) -> tuple:
        """Eval-basis commit against a Lagrange SRS (see ops/gntt.py)."""
        return self.msm.msm_to_affine_int(
            lagrange_srs_dev[: evals.shape[0]], evals, kind="mont"
        )

    def open(self, coeffs, z: int) -> KzgOpening:
        """p(z) and the commitment to the quotient, which is zero-padded to
        a power of two rows (``poly.kzg_quotient``) and committed against
        that many SRS points."""
        zw = self.f.encode([z % self.curve.fr.modulus])[0]
        q, p_at_z = polyops.kzg_quotient(self.f, coeffs, zw)
        value = self.f.decode(p_at_z[None])[0]
        return KzgOpening(value=value, proof=self.commit(q))

    def verify_opening(self, commitment, opening: KzgOpening, z: int) -> bool:
        """e(C - y G1 + z W, G2) * e(-W, tau G2) == 1."""
        r = self.curve.fr.modulus
        F1 = hfp.GF(self.curve.fp.modulus)
        lhs = hfp.ec_add(
            F1, commitment, hfp.ec_mul(F1, self.vk_g1, (-opening.value) % r)
        )
        lhs = hfp.ec_add(F1, lhs, hfp.ec_mul(F1, opening.proof, z % r))
        eng = pairing_engine(self.curve.name)
        return eng.pairing_check(
            [
                (lhs, self.vk_g2[0]),
                (hfp.ec_neg(F1, opening.proof), self.vk_g2[1]),
            ]
        )

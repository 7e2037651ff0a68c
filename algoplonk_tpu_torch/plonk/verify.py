"""Native PLONK verification — the plonk.Verify equivalent the reference
calls after every Prove (algoplonk.go:93).

Host port of the reference module ``algoplonk_tpu/plonk/verify.py`` (which
imports the jax prover and keys); this one is duck-typed on the Proof and
VerifyingKey fields.

Implements, in exact host integer arithmetic, the same verification algorithm
the generated on-chain verifiers run (documented step-by-step in SURVEY.md
section 3.5; reference templateLogicSigBN254.go:110-356), ending in the
2-pairing product check.  Keeping this math identical to the templates means
a proof accepted here is accepted on-chain.
"""

from __future__ import annotations

from ..host import fp as hfp
from ..host.pairing import pairing_engine
from ..plonk.transcript import Transcript, hash_fr_bsb22


class VerificationError(Exception):
    pass


def verify(vk, proof, public_inputs: list) -> bool:
    curve = vk.curve
    r = curve.fr.modulus
    F1 = hfp.GF(curve.fp.modulus)
    tr = Transcript(curve)
    n = vk.size
    omega = vk.generator
    k1 = vk.coset_shift
    k2 = k1 * k1 % r

    if len(public_inputs) != vk.nb_public:
        raise VerificationError("wrong number of public inputs")

    # scalar well-formedness (template :110-124)
    for s in [proof.l_at_z, proof.r_at_z, proof.o_at_z, proof.s1_at_z,
              proof.s2_at_z, proof.z_omega_at_z, *proof.qcp_at_z,
              *public_inputs]:
        if not (0 <= s < r):
            return False

    # Fiat-Shamir (template :131-140)
    gamma_d, gamma = tr.gamma(vk, public_inputs, proof.l_com, proof.r_com, proof.o_com)
    beta_d, beta = tr.beta(gamma_d)
    alpha_d, alpha = tr.alpha(beta_d, proof.bsb_commitments, proof.z_com)
    zeta_d, zeta = tr.zeta(alpha_d, proof.h0, proof.h1, proof.h2)

    zh_z = (pow(zeta, n, r) - 1) % r
    zn = zh_z * pow(n, -1, r) % r

    # public input interpolation (template :149-194)
    pi = 0
    w_ = 1
    for x in public_inputs:
        li = w_ * zn % r * pow((zeta - w_) % r, -1, r) % r
        pi = (pi + li * x) % r
        w_ = w_ * omega % r
    for idx, com in zip(vk.commitment_indexes, proof.bsb_commitments):
        w_pow = pow(omega, vk.nb_public + idx, r)
        li = w_pow * zn % r * pow((zeta - w_pow) % r, -1, r) % r
        h = hash_fr_bsb22(curve, tr.point(com))
        pi = (pi + h * li) % r

    # alpha^2 L1(zeta) (template :196-201)
    alpha2_l1 = (
        pow((zeta - 1) % r, -1, r) * zn % r * alpha % r * alpha % r
    )

    # claimed linearization value (template :204-218)
    u = (proof.s1_at_z * beta + gamma + proof.l_at_z) % r
    v = (proof.s2_at_z * beta + gamma + proof.r_at_z) % r
    o_ = (proof.o_at_z + gamma) % r
    s1t = u * v % r * o_ % r * alpha % r * proof.z_omega_at_z % r
    lin_at_z = (-(s1t + pi - alpha2_l1)) % r

    # folded H (template :221-229)
    zn2 = pow(zeta, n + 2, r)
    folded_h = hfp.ec_mul(F1, proof.h2, zn2)
    folded_h = hfp.ec_add(F1, folded_h, proof.h1)
    folded_h = hfp.ec_mul(F1, folded_h, zn2)
    folded_h = hfp.ec_add(F1, folded_h, proof.h0)
    folded_h = hfp.ec_mul(F1, folded_h, zh_z)
    folded_h = hfp.ec_neg(F1, folded_h)

    # linearization commitment (template :231-278)
    uu = proof.z_omega_at_z * beta % r
    vv = (proof.s1_at_z * beta + proof.l_at_z + gamma) % r
    ww = (proof.s2_at_z * beta + proof.r_at_z + gamma) % r
    s1c = uu * vv % r * ww % r * alpha % r

    betazeta = beta * zeta % r
    uu2 = (betazeta + proof.l_at_z + gamma) % r
    vv2 = (betazeta * k1 + proof.r_at_z + gamma) % r
    ww2 = (betazeta * k2 + proof.o_at_z + gamma) % r
    s2c = (-(uu2 * vv2 % r * ww2 % r) * alpha + alpha2_l1) % r

    lin_com = hfp.ec_mul(F1, vk.ql, proof.l_at_z)
    lin_com = hfp.ec_add(F1, lin_com, hfp.ec_mul(F1, vk.qr, proof.r_at_z))
    lin_com = hfp.ec_add(F1, lin_com, hfp.ec_mul(F1, vk.qo, proof.o_at_z))
    lin_com = hfp.ec_add(
        F1, lin_com, hfp.ec_mul(F1, vk.qm, proof.l_at_z * proof.r_at_z % r)
    )
    lin_com = hfp.ec_add(F1, lin_com, vk.qk)
    for com, qcp_z in zip(proof.bsb_commitments, proof.qcp_at_z):
        lin_com = hfp.ec_add(F1, lin_com, hfp.ec_mul(F1, com, qcp_z))
    lin_com = hfp.ec_add(F1, lin_com, hfp.ec_mul(F1, vk.s3, s1c))
    lin_com = hfp.ec_add(F1, lin_com, hfp.ec_mul(F1, proof.z_com, s2c))
    lin_com = hfp.ec_add(F1, lin_com, folded_h)

    # fold challenge + folded digest/claims (template :281-321)
    fold_d, fold_r = tr.fold(
        zeta, lin_com, proof.l_com, proof.r_com, proof.o_com, vk,
        lin_at_z, proof.l_at_z, proof.r_at_z, proof.o_at_z,
        proof.s1_at_z, proof.s2_at_z, proof.qcp_at_z, proof.z_omega_at_z,
    )
    digest = lin_com
    claims = lin_at_z
    r_acc = fold_r
    items = [
        (proof.l_com, proof.l_at_z),
        (proof.r_com, proof.r_at_z),
        (proof.o_com, proof.o_at_z),
        (vk.s1, proof.s1_at_z),
        (vk.s2, proof.s2_at_z),
    ] + list(zip(vk.qcp, proof.qcp_at_z))
    for com, val in items:
        digest = hfp.ec_add(F1, digest, hfp.ec_mul(F1, com, r_acc))
        claims = (claims + val * r_acc) % r
        r_acc = r_acc * fold_r % r

    # second challenge + pairing inputs (template :323-356)
    _, rp = tr.multipoint(
        digest, proof.batch_opening, proof.z_com, proof.opening_z_omega,
        zeta, fold_r,
    )
    quotient = hfp.ec_add(
        F1, proof.batch_opening, hfp.ec_mul(F1, proof.opening_z_omega, rp)
    )
    digest = hfp.ec_add(F1, digest, hfp.ec_mul(F1, proof.z_com, rp))
    claims = (claims + proof.z_omega_at_z * rp) % r
    claims_com = hfp.ec_mul(F1, vk.kzg_g1, claims)
    digest = hfp.ec_add(F1, digest, hfp.ec_neg(F1, claims_com))

    points_quotient = hfp.ec_mul(F1, proof.batch_opening, zeta)
    zeta_omega = zeta * omega % r
    rp_zw = rp * zeta_omega % r
    points_quotient = hfp.ec_add(
        F1, points_quotient, hfp.ec_mul(F1, proof.opening_z_omega, rp_zw)
    )
    digest = hfp.ec_add(F1, digest, points_quotient)
    quotient = hfp.ec_neg(F1, quotient)

    eng = pairing_engine(curve.name)
    return eng.pairing_check(
        [(digest, vk.kzg_g2[0]), (quotient, vk.kzg_g2[1])]
    )

"""Native PLONK verification — the plonk.Verify equivalent the reference
calls after every Prove (algoplonk.go:93).

Host port of the reference module ``algoplonk_tpu/plonk/verify.py`` (which
imports the jax prover and keys); this one is duck-typed on the Proof and
VerifyingKey fields.

Checks, in exact host integer arithmetic, the equation the generated
on-chain verifiers check (SURVEY.md section 3.5; reference
templateLogicSigBN254.go:110-356), with the same Fiat-Shamir transcript and
the same 2-pairing product, so a proof accepted here is accepted on-chain.
It does not follow the templates call for call: each point the transcript
or the pairing takes is one multi-scalar multiplication
(``ops/msm.py:host_msm``, Jacobian, one inversion), four a proof, each in a
``self_verify.msm`` span, and the product check is one multi-Miller loop
(``host/pairing.py``) in a ``self_verify.pairing`` span.  An affine point
is unique, so the points the transcript hashes are those of the templates'
chains of scalar multiplications.
"""

from __future__ import annotations

from ..host import fp as hfp
from ..host.pairing import pairing_engine
from ..ops.msm import host_msm
from ..plonk.transcript import Transcript, hash_fr_bsb22
from ..utils import profiling


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

    def msm(points, scalars):
        """sum s_i P_i, scalars mod r; a None point is the identity."""
        with profiling.span("self_verify.msm"):
            return host_msm(curve, points, [s % r for s in scalars])

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

    # one sum, the folded H -zh (h0 + zn2 h1 + zn2^2 h2) (template :221-229)
    # through its scalars
    zn2 = pow(zeta, n + 2, r)
    lin_com = msm(
        [vk.ql, vk.qr, vk.qo, vk.qm, vk.qk, *proof.bsb_commitments, vk.s3, proof.z_com,
         proof.h0, proof.h1, proof.h2],
        [proof.l_at_z, proof.r_at_z, proof.o_at_z, proof.l_at_z * proof.r_at_z, 1,
         *proof.qcp_at_z, s1c, s2c, -zh_z, -zh_z * zn2, -zh_z * zn2 * zn2],
    )

    # fold challenge + folded digest/claims (template :281-321)
    fold_d, fold_r = tr.fold(
        zeta, lin_com, proof.l_com, proof.r_com, proof.o_com, vk,
        lin_at_z, proof.l_at_z, proof.r_at_z, proof.o_at_z,
        proof.s1_at_z, proof.s2_at_z, proof.qcp_at_z, proof.z_omega_at_z,
    )
    claims = lin_at_z
    r_acc = fold_r
    points, scalars = [lin_com], [1]
    items = [
        (proof.l_com, proof.l_at_z),
        (proof.r_com, proof.r_at_z),
        (proof.o_com, proof.o_at_z),
        (vk.s1, proof.s1_at_z),
        (vk.s2, proof.s2_at_z),
    ] + list(zip(vk.qcp, proof.qcp_at_z))
    for com, val in items:
        points.append(com)
        scalars.append(r_acc)
        claims = (claims + val * r_acc) % r
        r_acc = r_acc * fold_r % r
    digest = msm(points, scalars)

    # second challenge + pairing inputs (template :323-356)
    _, rp = tr.multipoint(
        digest, proof.batch_opening, proof.z_com, proof.opening_z_omega,
        zeta, fold_r,
    )
    quotient = msm([proof.batch_opening, proof.opening_z_omega], [1, rp])
    claims = (claims + proof.z_omega_at_z * rp) % r
    digest = msm(
        [digest, proof.z_com, vk.kzg_g1, proof.batch_opening, proof.opening_z_omega],
        [1, rp, -claims, zeta, rp * zeta % r * omega],
    )

    with profiling.span("self_verify.pairing"):
        return pairing_engine(curve.name).pairing_check(
            [(digest, vk.kzg_g2[0]), (hfp.ec_neg(F1, quotient), vk.kzg_g2[1])]
        )

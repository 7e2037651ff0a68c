"""PLONK setup: selector and permutation polynomials and the verifying key.

Counterpart of the reference ``plonk/setup.py`` (:42-189), on the same gnark
conventions: domain n = NextPow2(constraints + public); public-input rows
first (ql = -1, qk = 0, completed by the prover), then the gates, then zero
padding; sigma over the 3n wire slots with coset ids (1, k1, k1^2); KZG
commitments in the monomial basis through the device MSM.
"""

from __future__ import annotations

import numpy as np

from ..fields.params import domain_generator
from ..frontend.api import CompiledConstraintSystem
from ..setups.registry import SRS, next_power_of_two
from ..ops.field import field_ops
from ..ops.msm import msm_ctx
from ..ops.ntt import ntt_plan
from .keys import ProvingKey, VerifyingKey


def setup(ccs: CompiledConstraintSystem, srs: SRS) -> tuple[ProvingKey, VerifyingKey]:
    """``srs.g1_limbs`` must hold the port's [N, 2, W] word tensor; the keys
    live on its device."""
    curve = ccs.curve
    r = curve.fr.modulus
    npub = ccs.nb_public
    n = next_power_of_two(ccs.nb_constraints + npub)
    log_n = n.bit_length() - 1
    omega = domain_generator(curve.name, log_n)
    k1 = curve.coset_shift
    k2 = k1 * k1 % r

    if srs.g1_count < n + 3:
        raise ValueError(f"SRS too small: need {n + 3} G1 points, have {srs.g1_count}")
    srs_dev = srs.g1_limbs[: n + 3]
    device = srs_dev.device

    # ------------------------------------------------------ selector vectors
    ql, qr, qm, qo, qk = ([0] * n for _ in range(5))
    commitment_rows = {c.constraint_index for c in ccs.commitments}
    for i in range(npub):
        ql[i] = r - 1
    for j, g in enumerate(ccs.gates):
        row = npub + j
        ql[row], qr[row], qm[row], qo[row] = g.ql, g.qr, g.qm, g.qo
        qk[row] = 0 if j in commitment_rows else g.qc

    # BSB22 qcp selectors: indicators of each commitment's linking rows
    qcp_vecs = []
    for c in ccs.commitments:
        v = [0] * n
        for row in c.linking_rows:
            v[npub + row] = 1
        qcp_vecs.append(v)

    # ------------------------------------------------------- wire slot table
    slots = np.full((3, n), -1, dtype=np.int64)
    slots[:, :npub] = np.arange(npub)
    for j, g in enumerate(ccs.gates):
        slots[:, npub + j] = (g.l, g.r, g.o)

    # ------------------------------------------------------------ sigma
    var_slots: dict[int, list[tuple[int, int]]] = {}
    for col in range(3):
        for row in range(n):
            v = slots[col, row]
            if v >= 0:
                var_slots.setdefault(int(v), []).append((col, row))
    sigma_col = np.tile(np.arange(3)[:, None], (1, n))
    sigma_row = np.tile(np.arange(n)[None, :], (3, 1))
    for slist in var_slots.values():
        m = len(slist)
        for t, (col, row) in enumerate(slist):
            sigma_col[col, row], sigma_row[col, row] = slist[(t + 1) % m]

    omega_pows = [1] * n
    for i in range(1, n):
        omega_pows[i] = omega_pows[i - 1] * omega % r
    ks = [1, k1, k2]
    s_vecs = [
        [ks[sigma_col[col, row]] * omega_pows[sigma_row[col, row]] % r for row in range(n)]
        for col in range(3)
    ]

    # --------------------------------------------------- device conversions
    f = field_ops(curve.fr, device)
    plan = ntt_plan(curve.name, log_n, device)
    evs, coeffs = {}, {}
    for name, vec in [
        ("ql", ql), ("qr", qr), ("qm", qm), ("qo", qo), ("qk", qk),
        ("s1", s_vecs[0]), ("s2", s_vecs[1]), ("s3", s_vecs[2]),
    ]:
        evs[name] = f.encode(vec)
        coeffs[name] = plan.intt(evs[name])
    qcp_ev = [f.encode(v) for v in qcp_vecs]
    qcp_c = [plan.intt(ev) for ev in qcp_ev]

    # ----------------------------------------------------------- commitments
    ctx = msm_ctx(curve, device)

    def commit(c):
        return ctx.msm_to_affine_int(srs_dev[: c.shape[0]], c, kind="mont")

    coms = {name: commit(coeffs[name]) for name in ("ql", "qr", "qm", "qo", "qk", "s1", "s2", "s3")}
    vk = VerifyingKey(
        curve=curve,
        size=n,
        size_inv=pow(n, -1, r),
        generator=omega,
        coset_shift=k1,
        nb_public=npub,
        qcp=[commit(c) for c in qcp_c],
        commitment_indexes=[c.constraint_index for c in ccs.commitments],
        kzg_g1=srs.vk_g1,
        kzg_g2=srs.vk_g2,
        **coms,
    )
    pk = ProvingKey(
        curve=curve, n=n, log_n=log_n, omega=omega, coset_shift=k1, nb_public=npub,
        qk_ev=evs["qk"], s1_ev=evs["s1"], s2_ev=evs["s2"], s3_ev=evs["s3"],
        ql_c=coeffs["ql"], qr_c=coeffs["qr"], qm_c=coeffs["qm"],
        qo_c=coeffs["qo"], qk_c=coeffs["qk"],
        s1_c=coeffs["s1"], s2_c=coeffs["s2"], s3_c=coeffs["s3"],
        srs_g1=srs_dev, qcp_ev=qcp_ev, qcp_c=qcp_c, vk=vk,
    )
    return pk, vk

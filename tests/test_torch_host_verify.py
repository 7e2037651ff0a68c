"""The port's self-verify on the CPU: the pairing (a projective multi-Miller
loop on the twist, the hard part of the final exponentiation through x)
equals the reference's affine one value for value; the four point sums of
``plonk/verify.py`` are ``host_msm`` calls equal to the affine sums of
scalar multiplications, identity points, zero scalars and repeated points
included; and ``verify`` gives the reference's boolean on blinded and
unblinded proofs, with and without a BSB22 commitment, and on tampered
ones."""

import dataclasses
import random

import pytest

from algoplonk_tpu.host import pairing as ref_pairing
from algoplonk_tpu.plonk import verify as ref_verify
import algoplonk_tpu_torch as apt
from algoplonk_tpu_torch.frontend import witness as witness_mod
from algoplonk_tpu_torch.host import fp as hfp
from algoplonk_tpu_torch.host.pairing import pairing_engine
from algoplonk_tpu_torch.ops import msm as M
from algoplonk_tpu_torch.plonk import verify as V
from algoplonk_tpu_torch.plonk.prove import Prover
from torch_parity import one_commit, one_torch_thread, pythagorean  # noqa: F401

CURVES = {"bn254": apt.BN254, "bls12_381": apt.BLS12_381}
SETUPS = {"bn254": apt.SetupName.TEST_ONLY_BN254,
          "bls12_381": apt.SetupName.TEST_ONLY_BLS12_381}


def fields(curve):
    return hfp.GF(curve.fp.modulus), hfp.GF2(curve.fp.modulus, curve.fp2_nonresidue)


def g2(curve):
    return (curve.g2_x, curve.g2_y)


def affine_sum(curve, points, scalars):
    F1 = hfp.GF(curve.fp.modulus)
    acc = None
    for P, s in zip(points, scalars):
        acc = hfp.ec_add(F1, acc, hfp.ec_mul(F1, P, s))
    return acc


# ------------------------------------------------------------------ pairing

@pytest.mark.parametrize("case", ["random", "g1_identity", "g2_identity"])
@pytest.mark.parametrize("name", list(CURVES))
def test_pairing_equals_reference(name, case):
    curve = CURVES[name]
    F1, F2 = fields(curve)
    rng = random.Random(f"{name}-{case}")
    r = curve.fr.modulus
    P = hfp.ec_mul(F1, curve.g1, rng.randrange(1, r))
    Q = hfp.ec_mul(F2, g2(curve), rng.randrange(1, r))
    if case == "g1_identity":
        P = None
    elif case == "g2_identity":
        Q = None
    got = pairing_engine(name).pairing(P, Q)
    want = ref_pairing.pairing_engine(name).pairing(P, Q)
    assert got == want
    assert (case != "random") == pairing_engine(name).fp12.is_one(got)


@pytest.mark.parametrize("name", list(CURVES))
def test_final_exp_is_the_exact_exponent(name):
    """On an arbitrary Fp12 element (not a Miller loop's value), the hard
    part through x equals the integer exponent (p^4 - p^2 + 1) / r."""
    eng = pairing_engine(name)
    f12 = eng.fp12
    p, r = eng.p, eng.r
    rng = random.Random(name)
    a = tuple(tuple((rng.randrange(p), rng.randrange(p)) for _ in range(3)) for _ in range(2))
    easy = f12.mul(f12.conj(a), f12.inv(a))
    easy = f12.mul(f12.frobenius(easy, 2), easy)
    assert f12.cyclotomic_sqr(easy) == f12.sqr(easy) == f12.mul(easy, easy)
    assert eng.final_exp(a) == f12.pow(easy, (p**4 - p**2 + 1) // r)


@pytest.mark.parametrize("case", ["one", "not_one", "with_identity"])
@pytest.mark.parametrize("name", list(CURVES))
def test_pairing_check_matches_reference(name, case):
    """e(aP, Q) e(-P, aQ) == 1; with bQ in place of aQ it is not; a pair
    with the identity adds nothing."""
    curve = CURVES[name]
    F1, F2 = fields(curve)
    rng = random.Random(f"check-{name}")
    r = curve.fr.modulus
    a = rng.randrange(2, r)
    P = hfp.ec_mul(F1, curve.g1, rng.randrange(1, r))
    Q = hfp.ec_mul(F2, g2(curve), rng.randrange(1, r))
    b = a + 1 if case == "not_one" else a
    pairs = [(hfp.ec_mul(F1, P, a), Q), (hfp.ec_neg(F1, P), hfp.ec_mul(F2, Q, b))]
    if case == "with_identity":
        pairs.insert(1, (None, Q))
    got = pairing_engine(name).pairing_check(pairs)
    assert got == ref_pairing.pairing_engine(name).pairing_check(pairs)
    assert got == (case != "not_one")


# ---------------------------------------------------------------- point sums

# the four sums of plonk/verify.py, by their number of points with one BSB22
# commitment: lin_com, the folded digest, the quotient, the last digest
STAGES = {"lin_com": 11, "digest": 7, "quotient": 2, "last_digest": 5}


@pytest.mark.parametrize("stage", list(STAGES))
@pytest.mark.parametrize("name", list(CURVES))
def test_msm_stage_equals_affine_sums(name, stage):
    """host_msm at each stage's size equals the sum of ec_mul's: with random
    scalars, then with an identity point, a zero scalar, a repeated point
    and a pair that cancels to the identity."""
    curve = CURVES[name]
    F1, _ = fields(curve)
    r = curve.fr.modulus
    rng = random.Random(f"{name}-{stage}")
    n = STAGES[stage]
    pts = [hfp.ec_mul(F1, curve.g1, rng.randrange(1, r)) for _ in range(n)]
    scal = [rng.randrange(r) for _ in range(n)]
    cases = [(pts, scal)]
    edge_pts, edge_scal = list(pts), list(scal)
    edge_pts[0] = None
    edge_scal[-1] = 0
    if n > 2:
        edge_pts[1] = edge_pts[-2]
    cases.append((edge_pts, edge_scal))
    k = rng.randrange(1, r)
    cases.append(([pts[0], pts[0]], [k, r - k]))            # P k + P (r - k) = identity
    cases.append(([pts[0], pts[0]], [k, k]))                # doubling inside a bucket
    cases.append(([None] * n, scal))
    for points, scalars in cases:
        assert M.host_msm(curve, points, scalars) == affine_sum(curve, points, scalars)
    assert M.host_msm(curve, [pts[0], pts[0]], [k, r - k]) is None


# ------------------------------------------------------------------ verify

CIRCUITS = {"plain": (pythagorean, dict(a=3, b=4, c=5), [3, 4]),
            "bsb22": (one_commit, dict(x=49, y=7), [49])}


@pytest.fixture(scope="module")
def proofs():
    """(curve, circuit, blinded) -> (vk, proof, public inputs), proved once."""
    keys, out = {}, {}

    def get(name, circuit, blinded):
        if (name, circuit, blinded) not in out:
            factory, assign, public = CIRCUITS[circuit]
            if (name, circuit) not in keys:
                C = factory(apt)
                keys[name, circuit] = (C, apt.compile(C, CURVES[name], SETUPS[name],
                                                      device="cpu"))
            C, cc = keys[name, circuit]
            prover = Prover(cc.pk, cc.ccs, rng=None if blinded else False)
            wit = witness_mod.solve(cc.ccs, C(**assign), commitment_solver=prover.bsb_solver)
            out[name, circuit, blinded] = (cc.vk, prover.prove(wit), public)
        return out[name, circuit, blinded]

    return get


@pytest.mark.parametrize("blinded", [True, False], ids=["blinded", "unblinded"])
@pytest.mark.parametrize("circuit", list(CIRCUITS))
@pytest.mark.parametrize("name", list(CURVES))
def test_verify_accepts_with_four_msms(proofs, monkeypatch, name, circuit, blinded):
    """verify accepts as the reference does, through four host_msm calls,
    each equal to the affine sum of its points."""
    vk, proof, public = proofs(name, circuit, blinded)
    calls = []

    def recorded(curve, points, scalars):
        out = M.host_msm(curve, points, scalars)
        calls.append((points, scalars, out))
        return out

    monkeypatch.setattr(V, "host_msm", recorded)
    assert V.verify(vk, proof, public)
    assert ref_verify.verify(vk, proof, public)
    assert [len(c[0]) for c in calls] == [10 + len(vk.qcp), 6 + len(vk.qcp), 2, 5]
    for points, scalars, out in calls:
        assert out == affine_sum(vk.curve, points, scalars)


def tampered(vk, proof, public, how):
    r = vk.curve.fr.modulus
    if how == "public":
        return proof, [(public[0] + 1) % r] + public[1:]
    if how == "commitment":
        if proof.bsb_commitments:
            return dataclasses.replace(proof, bsb_commitments=[proof.l_com]), public
        return dataclasses.replace(proof, l_com=proof.z_com, z_com=proof.l_com), public
    return dataclasses.replace(proof, s1_at_z=(proof.s1_at_z + 1) % r), public


@pytest.mark.parametrize("how", ["public", "commitment", "evaluation"])
@pytest.mark.parametrize("circuit", list(CIRCUITS))
@pytest.mark.parametrize("name", list(CURVES))
def test_verify_rejects_tampered(proofs, name, circuit, how):
    """A flipped public input, a swapped commitment and an altered
    evaluation are rejected, as the reference rejects them."""
    vk, proof, public = proofs(name, circuit, False)
    bad, pub = tampered(vk, proof, public, how)
    assert (bad, pub) != (proof, public)
    assert not V.verify(vk, bad, pub)
    assert not ref_verify.verify(vk, bad, pub)

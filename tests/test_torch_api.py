"""The port's own API on the CPU: compile, prove with self-verification,
marshal and export; tampered proofs and wrong witnesses rejected; BSB22
commitments; explicit blinding sources; the unique-rows guard of the
prover's scatters; the top-level names the reference exports.  Byte parity
with the JAX prover is in tests/test_torch_prove.py."""

import dataclasses
import random

import pytest
import torch

import algoplonk_tpu as ap
import algoplonk_tpu_torch as apt
from algoplonk_tpu_torch.frontend import witness as witness_mod
from algoplonk_tpu_torch.plonk import verify as V
from algoplonk_tpu_torch.plonk.marshal import expected_proof_len, marshal_proof
from algoplonk_tpu_torch.plonk.prove import Prover, _scatter_rows
from torch_parity import one_commit, one_torch_thread, pythagorean  # noqa: F401

TPyth = pythagorean(apt)
ASSIGN = dict(a=3, b=4, c=5)
PUBLIC = [3, 4]


@pytest.fixture(scope="module")
def port_pyth():
    return apt.compile(TPyth, apt.BN254, apt.SetupName.TEST_ONLY_BN254, device="cpu")


def prove(cc, rng):
    prover = Prover(cc.pk, cc.ccs, rng=rng)
    wit = witness_mod.solve(cc.ccs, TPyth(**ASSIGN), commitment_solver=prover.bsb_solver)
    return prover.prove(wit)


def test_tampered_proof_rejected(port_pyth):
    proof = prove(port_pyth, False)
    vk = port_pyth.vk
    assert V.verify(vk, proof, PUBLIC)
    assert not V.verify(vk, proof, [3, 5])
    r = apt.BN254.fr.modulus
    for field, value in (("l_at_z", (proof.l_at_z + 1) % r),
                         ("z_omega_at_z", (proof.z_omega_at_z + 1) % r),
                         ("h1", proof.h0),
                         ("l_com", proof.r_com)):
        bad = dataclasses.replace(proof, **{field: value})
        assert not V.verify(vk, bad, PUBLIC), field


def test_compile_verify_export(port_pyth, tmp_path, monkeypatch):
    """The user's path: compile, verify (prove blinded + self-verify),
    marshal and export.  A proof that the self-verify rejects (here one
    made for other public inputs) raises."""
    vp = port_pyth.verify(TPyth(**ASSIGN))
    blob = vp.marshal_proof()
    assert len(blob) == expected_proof_len(apt.BN254, 0) == 24 * 32
    unblinded = prove(port_pyth, False)
    assert blob != marshal_proof(apt.BN254, unblinded)  # blinded
    assert set(vp.phase_seconds) == {"r1", "r2", "r3", "r4", "r5"}
    assert vp.marshal_public_inputs() == b"".join(v.to_bytes(32, "big") for v in PUBLIC)
    proof_path, pub_path = tmp_path / "proof.bin", tmp_path / "public.bin"
    vp.export_proof_and_public_inputs(str(proof_path), str(pub_path))
    assert proof_path.read_bytes() == blob
    assert pub_path.read_bytes() == vp.marshal_public_inputs()
    with pytest.raises(ValueError, match="not satisfied"):
        port_pyth.verify(TPyth(a=3, b=4, c=6))
    monkeypatch.setattr(Prover, "prove", lambda self, wit: unblinded)
    with pytest.raises(RuntimeError, match="^proof failed native verification$"):
        port_pyth.verify(TPyth(a=5, b=12, c=13))


def test_compile_rejects_mismatched_setup():
    """Both curves compile; a setup of the other curve is refused."""
    cc = apt.compile(TPyth, apt.BLS12_381, apt.SetupName.TEST_ONLY_BLS12_381, device="cpu")
    assert cc.curve is apt.BLS12_381 and cc.pk.srs_g1.shape[-1] == 12
    with pytest.raises(ValueError, match="does not match"):
        apt.compile(TPyth, apt.BN254, apt.SetupName.TEST_ONLY_BLS12_381, device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        apt.compile(TPyth, apt.BLS12_381, apt.SetupName.TEST_ONLY_BN254, device="cpu")


def test_scatter_rows_must_be_unique():
    base = torch.zeros((6, 8), dtype=torch.int32)
    vals = torch.arange(16, dtype=torch.int32).reshape(2, 8)
    out = _scatter_rows(base, [4, 1], vals)
    assert torch.equal(out[4], vals[0]) and torch.equal(out[1], vals[1])
    assert not out[[0, 2, 3, 5]].any() and not base.any()
    with pytest.raises(ValueError, match="not unique"):
        _scatter_rows(base, [2, 2], vals)


def test_bsb22_prove_verify():
    """A BSB22 commitment circuit, proved and verified by the port alone."""
    TOne = one_commit(apt)
    cc = apt.compile(TOne, apt.BN254, apt.SetupName.TEST_ONLY_BN254, device="cpu")
    assert len(cc.vk.qcp) == 1
    vp = cc.verify(TOne(x=49, y=7))
    assert len(vp.proof.bsb_commitments) == len(vp.proof.qcp_at_z) == 1
    assert len(vp.marshal_proof()) == expected_proof_len(apt.BN254, 1) == 27 * 32
    assert not V.verify(cc.vk, vp.proof, [50])


def test_random_blinding_source_is_explicit(port_pyth):
    """A seeded random.Random gives a reproducible blinded proof."""
    blobs = []
    for _ in range(2):
        proof = prove(port_pyth, random.Random(7))
        assert V.verify(port_pyth.vk, proof, PUBLIC)
        blobs.append(marshal_proof(apt.BN254, proof))
    assert blobs[0] == blobs[1]


@pytest.mark.parametrize("curve", ["BN254", "BLS12_381"])
def test_test_only_setup_names_the_reference_setup(curve):
    assert apt.test_only_setup(getattr(apt, curve)).name == \
        ap.test_only_setup(getattr(ap, curve)).name
    assert apt.test_only_setup(getattr(apt, curve)) in apt.SetupName


def test_verified_proof_built_as_the_reference_builds_it(port_pyth):
    """VerifiedProof(proof, witness, curve), as the reference's API and batch
    prover build it; phase_seconds defaults to empty."""
    prover = Prover(port_pyth.pk, port_pyth.ccs, rng=False)
    wit = witness_mod.solve(port_pyth.ccs, TPyth(**ASSIGN), commitment_solver=prover.bsb_solver)
    proof = prover.prove(wit)
    vp = apt.VerifiedProof(proof, wit, apt.BN254)
    assert vp.phase_seconds == {}
    assert vp.marshal_proof() == marshal_proof(apt.BN254, proof)
    assert vp.marshal_public_inputs() == b"".join(v.to_bytes(32, "big") for v in PUBLIC)


def test_exports_the_reference_api():
    """Every name of the reference's __all__."""
    assert set(ap.__all__) <= set(apt.__all__)
    for name in apt.__all__:
        assert hasattr(apt, name), name

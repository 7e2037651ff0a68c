"""The BLS12-381 slice end to end against the JAX reference, on the CPU.

The Basic circuit of tests/test_bls_e2e.py on the bundled Ethereum KZG
ceremony: with blinding off (``Prover(rng=False)``) the port's
``marshal_proof`` must be the JAX prover's, byte for byte (33 words), the
port's setup must give the JAX keys value for value, and the port's verifier
must accept the proof and reject a wrong public input.  Then the port alone:
a BSB22 circuit with one commitment on the test SRS (33 + 4 words), and a
prove after the gnark-compat toggle in both packages, whose keys must carry
gnark's coset shift 7."""

import pytest
import torch

import algoplonk_tpu as ap
import algoplonk_tpu_torch as apt
from algoplonk_tpu.frontend import witness as jax_witness
from algoplonk_tpu.plonk.marshal import marshal_proof as jax_marshal
from algoplonk_tpu.plonk.prove import Prover as JaxProver
from algoplonk_tpu_torch.frontend import witness as witness_mod
from algoplonk_tpu_torch.plonk import verify as V
from algoplonk_tpu_torch.plonk.keys import proving_key_from_jax
from algoplonk_tpu_torch.plonk.marshal import expected_proof_len, marshal_proof
from algoplonk_tpu_torch.plonk.prove import Prover
from torch_parity import one_commit, one_torch_thread, pythagorean  # noqa: F401

JBasic, TBasic = pythagorean(ap), pythagorean(apt)
ASSIGN = dict(a=3, b=4, c=5)
PUBLIC = [3, 4]
CEREMONY = "ETHEREUM_KZG_CEREMONY_BLS12_381"


def port_proof(cc, assignment):
    prover = Prover(cc.pk, cc.ccs, rng=False)
    wit = witness_mod.solve(cc.ccs, assignment, commitment_solver=prover.bsb_solver)
    return prover.prove(wit)


@pytest.fixture(scope="module")
def jax_basic():
    cc = ap.compile(JBasic, ap.BLS12_381, getattr(ap.SetupName, CEREMONY))
    prover = JaxProver(cc.pk, cc.ccs, rng=False)
    wit = jax_witness.solve(cc.ccs, JBasic(**ASSIGN), commitment_solver=prover.bsb_solver)
    return cc, jax_marshal(ap.BLS12_381, prover.prove(wit))


@pytest.fixture(scope="module")
def port_basic():
    return apt.compile(TBasic, apt.BLS12_381, getattr(apt.SetupName, CEREMONY), device="cpu")


def test_ceremony_setup_matches_jax_keys(jax_basic, port_basic):
    jcc = jax_basic[0]
    carried = proving_key_from_jax(jcc.pk, "cpu")
    pk = port_basic.pk
    assert pk.srs_g1.shape == (pk.n + 3, 2, 12)
    for name in ("qk_ev", "s1_ev", "s2_ev", "s3_ev", "ql_c", "qr_c", "qm_c",
                 "qo_c", "qk_c", "s1_c", "s2_c", "s3_c", "srs_g1"):
        assert torch.equal(getattr(pk, name), getattr(carried, name)), name
    for name in ("size", "size_inv", "generator", "coset_shift", "nb_public",
                 "ql", "qr", "qm", "qo", "qk", "s1", "s2", "s3", "qcp",
                 "commitment_indexes", "kzg_g1", "kzg_g2"):
        assert getattr(port_basic.vk, name) == getattr(jcc.vk, name), name


def test_ceremony_proof_bytes_match_jax(jax_basic, port_basic):
    proof = port_proof(port_basic, TBasic(**ASSIGN))
    blob = marshal_proof(apt.BLS12_381, proof)
    assert len(blob) == expected_proof_len(apt.BLS12_381, 0) == 33 * 32
    assert blob == jax_basic[1]
    assert V.verify(port_basic.vk, proof, PUBLIC)
    assert not V.verify(port_basic.vk, proof, [3, 5])


def test_bsb22_on_test_srs():
    TOne = one_commit(apt)
    cc = apt.compile(TOne, apt.BLS12_381, apt.SetupName.TEST_ONLY_BLS12_381, device="cpu")
    vp = cc.verify(TOne(x=49, y=7))
    assert len(vp.proof.bsb_commitments) == 1
    assert len(vp.marshal_proof()) == expected_proof_len(apt.BLS12_381, 1) == (33 + 4) * 32
    assert V.verify(cc.vk, vp.proof, [49]) and not V.verify(cc.vk, vp.proof, [50])


@pytest.fixture
def gnark_mode():
    ap.set_gnark_compat(True)
    apt.set_gnark_compat(True)
    yield
    ap.set_gnark_compat(False)
    apt.set_gnark_compat(False)


def test_gnark_compat_prove(gnark_mode):
    """In gnark's constants mode BLS12-381 takes another domain root and the
    coset shift 7; a prove then verifies with the keys of that mode."""
    cc = apt.compile(TBasic, apt.BLS12_381, getattr(apt.SetupName, CEREMONY), device="cpu")
    assert cc.vk.coset_shift == cc.pk.coset_shift == 7
    assert cc.vk.generator == apt.fields.params.domain_generator("bls12_381", cc.pk.log_n)
    vp = cc.verify(TBasic(**ASSIGN))
    assert len(vp.marshal_proof()) == 33 * 32
    assert not V.verify(cc.vk, vp.proof, [3, 5])

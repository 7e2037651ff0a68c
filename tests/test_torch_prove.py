"""The port's prover end to end against the JAX reference's.

With blinding off (``Prover(rng=False)``) a proof is a function of the
circuit, the witness and the SRS alone, so the port's ``marshal_proof`` must
be byte-for-byte the JAX prover's, and the port's verifier must accept it.
The keys come either from the JAX package (``proving_key_from_jax``) or from
the port's own setup on its own test SRS; the MSMs run either on host ints
(the default below 1024 points) or through the device pipeline with its
four kernels' plain versions."""

import pytest
import torch

import algoplonk_tpu as ap
import algoplonk_tpu_torch as apt
from algoplonk_tpu.frontend import witness as jax_witness
from algoplonk_tpu.plonk.marshal import marshal_proof as jax_marshal
from algoplonk_tpu.plonk.prove import Prover as JaxProver
from algoplonk_tpu_torch.frontend import witness as witness_mod
from algoplonk_tpu_torch.ops import msm as M
from algoplonk_tpu_torch.plonk import verify as V
from algoplonk_tpu_torch.plonk.keys import proving_key_from_jax
from algoplonk_tpu_torch.plonk.marshal import marshal_proof
from algoplonk_tpu_torch.plonk.prove import Prover
from torch_parity import one_commit, one_torch_thread, pythagorean  # noqa: F401

JPyth, TPyth = pythagorean(ap), pythagorean(apt)
ASSIGN = dict(a=3, b=4, c=5)
PUBLIC = [3, 4]


def jax_proof_bytes(jcls, assignment):
    """Compile with the JAX package and prove with blinding off."""
    cc = ap.compile(jcls, ap.BN254, ap.SetupName.TEST_ONLY_BN254)
    prover = JaxProver(cc.pk, cc.ccs, rng=False)
    wit = jax_witness.solve(cc.ccs, jcls(**assignment), commitment_solver=prover.bsb_solver)
    return cc, wit, jax_marshal(ap.BN254, prover.prove(wit))


def port_proof(pk, ccs, assignment_obj):
    prover = Prover(pk, ccs, rng=False)
    wit = witness_mod.solve(ccs, assignment_obj, commitment_solver=prover.bsb_solver)
    return prover.prove(wit)


@pytest.fixture(scope="module")
def jax_pyth():
    return jax_proof_bytes(JPyth, ASSIGN)


@pytest.fixture(scope="module")
def port_pyth():
    return apt.compile(TPyth, apt.BN254, apt.SetupName.TEST_ONLY_BN254, device="cpu")


def test_port_setup_matches_jax_keys(jax_pyth, port_pyth):
    """The port's test SRS and setup give the JAX keys, value for value."""
    jcc = jax_pyth[0]
    carried = proving_key_from_jax(jcc.pk, "cpu")
    pk = port_pyth.pk
    for name in ("qk_ev", "s1_ev", "s2_ev", "s3_ev", "ql_c", "qr_c", "qm_c",
                 "qo_c", "qk_c", "s1_c", "s2_c", "s3_c", "srs_g1"):
        assert torch.equal(getattr(pk, name), getattr(carried, name)), name
    assert (pk.n, pk.log_n, pk.omega, pk.coset_shift, pk.nb_public) == (
        jcc.pk.n, jcc.pk.log_n, jcc.pk.omega, jcc.pk.coset_shift, jcc.pk.nb_public)
    for name in ("size", "size_inv", "generator", "coset_shift", "nb_public",
                 "ql", "qr", "qm", "qo", "qk", "s1", "s2", "s3", "qcp",
                 "commitment_indexes", "kzg_g1", "kzg_g2"):
        assert getattr(port_pyth.vk, name) == getattr(jcc.vk, name), name


@pytest.mark.parametrize(
    "key,host_max",
    [("jax_key", 1024), ("jax_key", 0), ("port_key", 1024)],
    ids=["jax_key-host_msm", "jax_key-device_msm", "port_key-host_msm"],
)
def test_proof_bytes_match_jax(jax_pyth, port_pyth, monkeypatch, key, host_max):
    monkeypatch.setattr(M, "HOST_MSM_MAX", host_max)
    jcc, _, want = jax_pyth
    if key == "jax_key":
        pk, ccs = proving_key_from_jax(jcc.pk, "cpu"), apt.compile_circuit(TPyth, apt.BN254)
    else:
        pk, ccs = port_pyth.pk, port_pyth.ccs
    proof = port_proof(pk, ccs, TPyth(**ASSIGN))
    assert marshal_proof(apt.BN254, proof) == want
    assert V.verify(pk.vk, proof, PUBLIC)


@pytest.mark.slow
def test_bsb22_bytes_match_jax():
    jcc, _, want = jax_proof_bytes(one_commit(ap), dict(x=49, y=7))
    TOne = one_commit(apt)
    pk = proving_key_from_jax(jcc.pk, "cpu")
    proof = port_proof(pk, apt.compile_circuit(TOne, apt.BN254), TOne(x=49, y=7))
    assert marshal_proof(apt.BN254, proof) == want
    assert V.verify(pk.vk, proof, [49])

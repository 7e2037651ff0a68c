"""The port's example programs (examples_torch/) and its BSB22
configuration (BASELINE.json config 3, ``RangeCommit``) on the CPU.

Each example's ``main(device="cpu", outdir=...)`` runs to an accepting
emitted verifier under the AVM mock, with blobs of the expected lengths:
basic at its size (n = 8, BLS12-381), Merkle at MERKLE_DEPTH=1 (about 1,000
constraints, n = 2^10, BN254).  The examples' circuits, and ``RangeCommit``,
give ``Prover(rng=False)`` proofs byte-equal to the JAX package's (its
circuits loaded from examples/ by path, its keys carried across with
``proving_key_from_jax``; tolerance: exact bytes).  ``RangeCommit(4)`` (778
constraints, n = 2^10, one commitment) proves through both quotient paths
to the same bytes, verifies, rejects a flipped ``total`` and a 65-bit
amount, and its emitted logicsig and contract accept its proof under the
mock.

Every commit of these circuits runs the host MSM (``HOST_MSM_MAX`` raised
for the module): on the CPU the device pipeline's plain versions take about
13 s a 1,026-point commit, and test_torch_prove.py and test_torch_msm.py
hold that pipeline to the JAX package.  The JAX package proves a 2^10-row
circuit in about ten minutes on the CPU, so those two parity tests are
marked slow."""

import importlib
import importlib.util
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

import algoplonk_tpu as ap
import algoplonk_tpu_torch as apt
from algoplonk_tpu_torch.chain import algopy_mock as mock
from algoplonk_tpu_torch.frontend import witness as witness_mod
from algoplonk_tpu_torch.ops import msm as M
from algoplonk_tpu_torch.plonk import prove as prove_mod
from algoplonk_tpu_torch.plonk import verify as V
from algoplonk_tpu_torch.plonk.keys import proving_key_from_jax
from algoplonk_tpu_torch.plonk.marshal import expected_proof_len, marshal_proof
from algoplonk_tpu_torch.plonk.prove import Prover
from test_torch_prove import jax_proof_bytes, port_proof
from torch_parity import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
BN254, BLS = apt.BN254, apt.BLS12_381
RANGE_N = 4
MERKLE_DEPTH = "1"


def range_commit(pkg, n: int):
    """BASELINE.json config 3: public ``total`` and secret ``amounts[n]``,
    each amount held to 64 bits by the rangecheck gadget, their sum equal
    to ``total``, and one BSB22 commitment to the amounts whose value is
    used (as gnark's rangecheck commits once).  The copy of chip_smoke.py's;
    one class per package."""
    rangecheck = importlib.import_module(f"{pkg.__name__}.frontend.gadgets.rangecheck")

    class RangeCommit(pkg.Circuit):
        total = pkg.PublicInput()
        amounts = pkg.SecretInput(shape=n)

        def define(self, api):
            for a in self.amounts:
                rangecheck.assert_bit_length(api, a, 64)
            api.assert_is_equal(api.add(*self.amounts), self.total)
            v = api.commit(*self.amounts)
            api.assert_is_different(v, 0)

    return RangeCommit


def range_values(n: int, seed: int = 15) -> dict:
    """The range check's edges 0 and 2^64 - 1, then seeded uint64s."""
    rest = np.random.default_rng(seed).integers(0, 2**64, size=n - 2, dtype=np.uint64)
    amounts = [0, 2**64 - 1] + [int(a) for a in rest]
    return dict(total=sum(amounts), amounts=amounts)


@pytest.fixture(autouse=True, scope="module")
def host_msm():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(M, "HOST_MSM_MAX", 1 << 12)
        yield


# ------------------------------------------------------------ examples


EXAMPLES = {   # module -> (curve, public inputs)
    "basic.logicsig_verifier": (BLS, 2),
    "basic.smart_contract_verifier": (BLS, 2),
    "merkle.logicsig_verifier": (BN254, 1),
    "merkle.smart_contract_verifier": (BN254, 1),
}


def example(monkeypatch, name: str):
    """examples_torch.<name>, imported afresh with MERKLE_DEPTH=1 (the
    Merkle modules read it at import)."""
    monkeypatch.setenv("MERKLE_DEPTH", MERKLE_DEPTH)
    for mod in [m for m in sys.modules if m.startswith("examples_torch.")]:
        monkeypatch.delitem(sys.modules, mod)
    return importlib.import_module(f"examples_torch.{name}")


def jax_example(name: str, monkeypatch):
    """The JAX package's examples/<name>.py, loaded by path."""
    monkeypatch.setenv("MERKLE_DEPTH", MERKLE_DEPTH)
    spec = importlib.util.spec_from_file_location(
        "jax_example_" + name.replace("/", "_"), REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_to_accepted(monkeypatch, tmp_path, name):
    curve, nb_public = EXAMPLES[name]
    got = example(monkeypatch, name).main(device="cpu", outdir=str(tmp_path))
    assert got["accepted"] is True
    assert got["opcode_budget"] > 0
    assert {pathlib.Path(got[k]).parent for k in ("verifier", "proof", "public_inputs")} == {
        tmp_path}
    assert os.path.getsize(got["proof"]) == expected_proof_len(curve, 0)
    assert os.path.getsize(got["public_inputs"]) == 32 * nb_public


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_without_card_raises(monkeypatch, tmp_path, name):
    """No fallback to the CPU: without a card and without device="cpu"
    the example stops at compile."""
    mod = example(monkeypatch, name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(outdir=str(tmp_path))


def test_basic_circuit_bytes_match_jax(monkeypatch):
    """The basic examples' circuit on BLS12-381's test SRS."""
    JBasic = jax_example("basic/logicsig_verifier", monkeypatch).BasicCircuit
    TBasic = example(monkeypatch, "basic.logicsig_verifier").BasicCircuit
    values = dict(a=3, b=4, c=5)
    jcc, _, want = jax_proof_bytes(JBasic, values, ap.BLS12_381,
                                   ap.SetupName.TEST_ONLY_BLS12_381)
    pk = proving_key_from_jax(jcc.pk, "cpu")
    proof = port_proof(pk, apt.compile_circuit(TBasic, BLS), TBasic(**values))
    assert marshal_proof(BLS, proof) == want
    assert V.verify(pk.vk, proof, [3, 4])


@pytest.mark.slow
def test_merkle_circuit_bytes_match_jax(monkeypatch):
    """The Merkle examples' circuit at depth 1 on BN254's test SRS."""
    JMerkle = jax_example("merkle/logicsig_verifier", monkeypatch).MerkleCircuit
    ported = example(monkeypatch, "merkle.logicsig_verifier")
    values, _ = ported.inclusion(5)
    jcc, _, want = jax_proof_bytes(JMerkle, values)
    pk = proving_key_from_jax(jcc.pk, "cpu")
    TMerkle = ported.MerkleCircuit
    proof = port_proof(pk, apt.compile_circuit(TMerkle, BN254), TMerkle(**values))
    assert marshal_proof(BN254, proof) == want
    assert V.verify(pk.vk, proof, [values["root"]])


# ------------------------------------------------------ RangeCommit(4)


@pytest.fixture(scope="module")
def range4():
    """RangeCommit(4) compiled on the CPU, its Prover(rng=False) proofs
    through each quotient path ("0" batch-major, "1" four-step), forced by
    prove.LM_MIN_LOG (64: above any coset), and its public-input blob."""
    TRange = range_commit(apt, RANGE_N)
    cc = apt.compile(TRange, BN254, apt.SetupName.TEST_ONLY_BN254, device="cpu")
    proofs = {}
    with pytest.MonkeyPatch.context() as mp:
        for lm, min_log in (("0", 64), ("1", 0)):
            mp.setattr(prove_mod, "LM_MIN_LOG", min_log)
            prover = Prover(cc.pk, cc.ccs, rng=False)
            assert prover._use_lm_quotient() == (lm == "1")
            wit = witness_mod.solve(cc.ccs, TRange(**range_values(RANGE_N)),
                                    commitment_solver=prover.bsb_solver)
            proofs[lm] = prover.prove(wit)
    return cc, TRange, proofs, wit.public_inputs_blob()


def test_range_commit_quotient_paths_agree(range4):
    cc, _, proofs, _ = range4
    total = range_values(RANGE_N)["total"]
    assert cc.ccs.nb_constraints == 778 and cc.pk.n == 1 << 10
    blobs = {lm: marshal_proof(BN254, p) for lm, p in proofs.items()}
    assert blobs["0"] == blobs["1"]
    assert len(blobs["1"]) == expected_proof_len(BN254, 1)
    assert len(proofs["1"].bsb_commitments) == 1
    assert V.verify(cc.vk, proofs["1"], [total])
    assert not V.verify(cc.vk, proofs["1"], [total + 1])


def test_range_commit_refuses_65_bit_amount(range4):
    cc, TRange, _, _ = range4
    values = range_values(RANGE_N)
    values["amounts"][1] += 1   # 2^64
    values["total"] += 1
    prover = Prover(cc.pk, cc.ccs, rng=False)
    with pytest.raises(ValueError, match="not satisfied"):
        witness_mod.solve(cc.ccs, TRange(**values), commitment_solver=prover.bsb_solver)


@pytest.mark.parametrize("ctype", list(apt.ContractType), ids=lambda c: c.value)
def test_range_commit_emitted_verifier_accepts(range4, tmp_path, ctype):
    cc, _, proofs, publics = range4
    proof = marshal_proof(BN254, proofs["1"])
    flipped = publics[:31] + bytes([publics[31] ^ 1])
    path = tmp_path / "Verifier.py"
    cc.write_puyapy_verifier(str(path), ctype)
    ns = mock.exec_verifier_source(path.read_text())
    run = mock.run_logicsig if ctype is apt.ContractType.LOGIC_SIG else mock.run_contract_verify
    assert run(ns, proof, publics) is True
    assert run(ns, proof, flipped) is False


@pytest.mark.slow
def test_range_commit_bytes_match_jax(range4):
    """The port's RangeCommit(4) proof is the JAX package's, byte for
    byte, on the JAX keys and on the port's own."""
    cc, TRange, proofs, _ = range4
    values = range_values(RANGE_N)
    jcc, _, want = jax_proof_bytes(range_commit(ap, RANGE_N), values)
    assert marshal_proof(BN254, proofs["0"]) == want
    pk = proving_key_from_jax(jcc.pk, "cpu")
    assert marshal_proof(BN254, port_proof(pk, cc.ccs, TRange(**values))) == want

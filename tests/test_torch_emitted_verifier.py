"""Execute the port's emitted PuyaPy verifiers on proofs the port made.

The port's counterpart of tests/test_emitted_verifier.py: a circuit proved
on the CPU by the port; its emitted logicsig and contract, run as plain
Python under the port's offline AVM mock (``chain/algopy_mock.py``), accept
the proof, reject a flipped public-input byte and a swapped G1 point, and
refuse a rekey; each run's opcode budget is within +-15% of the reference's
published figure.  Cross-check: the reference's emitted verifier, under the
reference's mock, accepts the port's proof too."""

import io

import pytest

import algoplonk_tpu_torch as apt
from algoplonk_tpu.chain import algopy_mock as ref_mock
from algoplonk_tpu.verifier import codegen as ref_codegen
from algoplonk_tpu_torch.chain import algopy_mock as mock
from algoplonk_tpu_torch.host import fp as hfp
from algoplonk_tpu_torch.verifier.codegen import ContractType, write_python_code
from test_torch_codegen import SETUPS, WithCommitment, WithTwoCommitments, reference_vk
from torch_parity import one_torch_thread  # noqa: F401


class Basic(apt.Circuit):
    a = apt.PublicInput()
    b = apt.PublicInput()
    c = apt.SecretInput()

    def define(self, api):
        api.assert_is_equal(
            api.add(api.mul(self.a, self.a), api.mul(self.b, self.b)),
            api.mul(self.c, self.c),
        )


SLOW = [pytest.mark.slow, pytest.mark.mid]


@pytest.fixture(
    scope="module",
    params=["bn254", pytest.param("bls12_381", marks=SLOW)],
    ids=lambda k: k,
)
def proven(request):
    """One Basic circuit per curve, compiled and proved by the port on the CPU."""
    curve, setup = SETUPS[request.param]
    cc = apt.compile(Basic, curve, setup, device="cpu")
    vp = cc.verify(Basic(a=3, b=4, c=5))
    return curve, cc, vp.marshal_proof(), vp.marshal_public_inputs()


def emit(vk, contract_type, mock_module=mock, writer=write_python_code) -> dict:
    buf = io.StringIO()
    writer(vk, contract_type, buf)
    return mock_module.exec_verifier_source(buf.getvalue())


def mutate(blob: bytes, pos: int) -> bytes:
    return blob[:pos] + bytes([blob[pos] ^ 1]) + blob[pos + 1 :]


# The reference's published budgets per (curve, BSB22 commitment count)
# (reference README.md:25-30), as tests/test_emitted_verifier.py holds them
_PUBLISHED = {
    ("bn254", 0): 145_000, ("bn254", 1): 175_000, ("bn254", 2): 210_000,
    ("bls12_381", 0): 185_000, ("bls12_381", 1): 221_000,
    ("bls12_381", 2): 261_000,
}


def _check_budget(curve, variant, ncom=0, budget=mock.budget):
    used = budget.consumed()
    ref = _PUBLISHED[(curve.name, ncom)]
    print(f"[opcode budget] {curve.name} {variant} ncom={ncom}: {used} "
          f"(published on-chain total ~{ref}, {used / ref - 1:+.1%})")
    assert 0.85 * ref < used < 1.15 * ref, (curve.name, variant, ncom, used, ref)


def test_emitted_logicsig_executes(proven):
    curve, cc, proof, publics = proven
    ns = emit(cc.vk, ContractType.LOGIC_SIG)
    mock.budget.reset()
    assert mock.run_logicsig(ns, proof, publics) is True
    _check_budget(curve, "logicsig")

    # flipped public input byte -> rejected
    assert mock.run_logicsig(ns, proof, mutate(publics, 31)) is False
    # first G1 commitment overwritten with the second -> rejected
    point = 64 if curve is apt.BN254 else 96
    swapped = proof[point : 2 * point] * 2 + proof[2 * point :]
    assert mock.run_logicsig(ns, swapped, publics) is False
    # rekey attempt -> rejected (assert in the program)
    with pytest.raises(AssertionError):
        mock.run_logicsig(ns, proof, publics, rekey=True)


def test_emitted_smart_contract_executes(proven):
    curve, cc, proof, publics = proven
    ns = emit(cc.vk, ContractType.SMART_CONTRACT)
    mock.budget.reset()
    assert mock.run_contract_verify(ns, proof, publics) is True
    _check_budget(curve, "smart_contract")
    assert mock.run_contract_verify(ns, mutate(proof, 600), publics) is False
    assert mock.run_contract_verify(ns, proof, mutate(publics, 31)) is False


@pytest.mark.parametrize("ctype", list(ContractType), ids=lambda c: c.value)
def test_reference_verifier_accepts_port_proof(proven, ctype):
    """The reference's emitted program for the same key, under the
    reference's mock, accepts the port's proof and rejects a flipped public
    input, within the same budget."""
    curve, cc, proof, publics = proven
    ns = emit(reference_vk(cc.vk), ref_codegen.ContractType(ctype.value), ref_mock,
              ref_codegen.write_python_code)
    run = (ref_mock.run_logicsig if ctype is ContractType.LOGIC_SIG
           else ref_mock.run_contract_verify)
    ref_mock.budget.reset()
    assert run(ns, proof, publics) is True
    _check_budget(curve, f"reference {ctype.value}", budget=ref_mock.budget)
    assert run(ns, proof, mutate(publics, 31)) is False


@pytest.mark.parametrize("key", ["bn254", pytest.param("bls12_381", marks=SLOW)])
def test_emitted_bsb22_executes(key):
    """BSB22 path: exercises hash_fr + qcp parsing in the emitted program."""
    curve, setup = SETUPS[key]
    cc = apt.compile(WithCommitment, curve, setup, device="cpu")
    vp = cc.verify(WithCommitment(a=7, x=7))
    proof, publics = vp.marshal_proof(), vp.marshal_public_inputs()
    words = 24 if curve is apt.BN254 else 33
    point = 64 if curve is apt.BN254 else 96
    assert len(proof) == words * 32 + 32 + point  # 1 commitment

    ns = emit(cc.vk, ContractType.LOGIC_SIG)
    mock.budget.reset()
    assert mock.run_logicsig(ns, proof, publics) is True
    _check_budget(curve, "logicsig", ncom=1)
    # corrupt the BSB22 commitment point -> rejected
    assert mock.run_logicsig(ns, mutate(proof, len(proof) - 5), publics) is False


@pytest.mark.mid
@pytest.mark.slow  # two extra proves; budget parity for the 2-commitment row
@pytest.mark.parametrize("key", ["bn254", "bls12_381"])
def test_emitted_two_commitments_budget(key):
    """2-commitment variant: proof layout (2 qcp scalars + 2 points) and the
    published ~210k / ~261k budgets."""
    curve, setup = SETUPS[key]
    cc = apt.compile(WithTwoCommitments, curve, setup, device="cpu")
    vp = cc.verify(WithTwoCommitments(a=7, x=7, y=7))
    proof, publics = vp.marshal_proof(), vp.marshal_public_inputs()
    words = 24 if curve is apt.BN254 else 33
    point = 64 if curve is apt.BN254 else 96
    assert len(proof) == words * 32 + 2 * 32 + 2 * point  # 2 commitments

    ns = emit(cc.vk, ContractType.LOGIC_SIG)
    mock.budget.reset()
    assert mock.run_logicsig(ns, proof, publics) is True
    _check_budget(curve, "logicsig", ncom=2)


def test_mock_is_not_circular():
    """The mock's EC ops come from host/fp + host/pairing, not from the
    prover's device code, so acceptance is a genuine cross-check; check the
    mock's own EC ops."""
    F = hfp.GF(apt.BN254.fp.modulus)
    g = apt.BN254.g1
    g2 = hfp.ec_double(F, g)
    enc = mock._encode_g1(mock.EC.BN254g1, g)
    assert mock._decode_g1(mock.EC.BN254g1, enc) == g
    out = mock.EllipticCurve.add(mock.EC.BN254g1, enc, enc)
    assert mock._decode_g1(mock.EC.BN254g1, out) == g2


def test_emitted_invert_preserves_x_width(proven):
    """Point negation must keep the fixed-width x bytes (reference
    verifier/templates_test.go:8-59): run the emitted ``invert`` under the
    mock on the generator, whose x = 1 has 31 leading zero bytes."""
    curve, cc, _, _ = proven
    if curve is not apt.BN254:
        pytest.skip("BN254 generator has the leading-zero x")
    invert = emit(cc.vk, ContractType.LOGIC_SIG)["invert"]
    F = hfp.GF(curve.fp.modulus)
    g = curve.g1
    enc = mock._encode_g1(mock.EC.BN254g1, g)
    out = invert(enc)
    assert out.length == 64
    assert mock._decode_g1(mock.EC.BN254g1, out) == hfp.ec_neg(F, g)
    # infinity passes through unchanged
    zero = mock.bzero(64)
    assert invert(zero) == zero

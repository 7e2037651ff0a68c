"""The port's PuyaPy verifier codegen against the reference's.

For each curve (the test-only setups), each contract type and 0, 1 and 2
BSB22 commitments, the port compiles a circuit on the CPU and renders its
verifier; the reference renders the same key, rebuilt from the port's host
ints as a reference ``VerifyingKey`` (no JAX compile).  The two sources must
be byte-equal.  Then the reference's golden-substring checks
(tests/test_codegen.py), on the port's source, and the file that
``CompiledCircuit.write_puyapy_verifier`` writes."""

import ast
import io

import pytest

import algoplonk_tpu_torch as apt
from algoplonk_tpu.fields.params import CURVES as REF_CURVES
from algoplonk_tpu.plonk.keys import VerifyingKey as RefVerifyingKey
from algoplonk_tpu.verifier import codegen as ref_codegen
from algoplonk_tpu_torch.host.serialize import PointCodec
from algoplonk_tpu_torch.verifier.codegen import ContractType, write_python_code
from torch_parity import one_torch_thread  # noqa: F401


class Square(apt.Circuit):
    x = apt.PublicInput()
    y = apt.SecretInput()

    def define(self, api):
        api.assert_is_equal(api.mul(self.y, self.y), self.x)


class WithCommitment(apt.Circuit):
    a = apt.PublicInput()
    x = apt.SecretInput()

    def define(self, api):
        com = api.commit(self.x)
        api.assert_is_equal(api.mul(com, self.x), api.mul(com, self.a))


class WithTwoCommitments(apt.Circuit):
    a = apt.PublicInput()
    x = apt.SecretInput()
    y = apt.SecretInput()

    def define(self, api):
        c1 = api.commit(self.x)
        c2 = api.commit(self.y)
        api.assert_is_equal(api.mul(c1, self.x), api.mul(c1, self.a))
        api.assert_is_equal(api.mul(c2, self.y), api.mul(c2, self.a))


CIRCUITS = {0: Square, 1: WithCommitment, 2: WithTwoCommitments}
SETUPS = {"bn254": (apt.BN254, apt.SetupName.TEST_ONLY_BN254),
          "bls12_381": (apt.BLS12_381, apt.SetupName.TEST_ONLY_BLS12_381)}


@pytest.fixture(scope="module")
def compiled():
    """(curve name, commitments) -> the port's CompiledCircuit on the CPU,
    compiled at first use."""
    cache = {}

    def get(curve_name, ncom):
        if (curve_name, ncom) not in cache:
            curve, setup = SETUPS[curve_name]
            cache[curve_name, ncom] = apt.compile(CIRCUITS[ncom], curve, setup, device="cpu")
        return cache[curve_name, ncom]

    return get


def reference_vk(vk) -> RefVerifyingKey:
    """The reference's VerifyingKey with the port key's host ints."""
    fields = {name: getattr(vk, name) for name in RefVerifyingKey.__dataclass_fields__}
    fields["curve"] = REF_CURVES[vk.curve.name]
    return RefVerifyingKey(**fields)


def render(vk, ctype, writer=write_python_code):
    buf = io.StringIO()
    writer(vk, ctype, buf)
    return buf.getvalue()


@pytest.mark.parametrize("ctype", list(ContractType), ids=lambda c: c.value)
@pytest.mark.parametrize("ncom", [0, 1, 2])
@pytest.mark.parametrize("curve_name", ["bn254", "bls12_381"])
def test_emitted_source_equals_reference(compiled, curve_name, ncom, ctype):
    vk = compiled(curve_name, ncom).vk
    assert len(vk.qcp) == len(vk.commitment_indexes) == ncom
    ours = render(vk, ctype)
    theirs = render(reference_vk(vk), ref_codegen.ContractType(ctype.value),
                    ref_codegen.write_python_code)
    assert ours == theirs
    ast.parse(ours)


def test_bn254_logicsig_structure(compiled):
    vk = compiled("bn254", 0).vk
    src = render(vk, ContractType.LOGIC_SIG)
    for needle in [
        "assert proof.length == 24 * 32",
        "assert public_inputs.length == 1 * 32",
        "L_COM = proof[0:64]",
        "H_2 = proof[320:384]",
        "L_AT_Z = proof[384:416]",
        "GRAND_PRODUCT = proof[544:608]",
        "BATCH_OPENING_AT_Z = proof[640:704]",
        "OPENING_AT_Z_OMEGA = proof[704:768]",
        "gamma_pre = sha256(b'gamma' + VK_S1 + VK_S2 + VK_S3 + VK_QL + VK_QR",
        "beta_pre = sha256(b'beta' + gamma_pre)",
        "zeta_pre = sha256(b'zeta' + alpha_pre + H_0 + H_1 + H_2)",
        "assert py.Txn.rekey_to == py.Global.zero_address",
        "ec.pairing_check(EC.BN254g1, digest + quotient, g2)",
        f"VK_DOMAIN_SIZE = BigUInt({vk.size})",
        f"VK_OMEGA = BigUInt({vk.generator})",
    ]:
        assert needle in src, f"missing: {needle}"
    assert "hash_fr" not in src  # no BSB22 commitments in this circuit


def test_bn254_smart_contract_structure(compiled):
    src = render(compiled("bn254", 0).vk, ContractType.SMART_CONTRACT)
    for needle in [
        "class Verifier(arc4.ARC4Contract):",
        "def make_immutable(self) -> None:",
        "-> arc4.Bool:",
        "return arc4.Bool(check)",
    ]:
        assert needle in src, f"missing: {needle}"


def test_vk_constants_are_valid_points(compiled):
    src = render(compiled("bn254", 0).vk, ContractType.LOGIC_SIG)
    codec = PointCodec(apt.BN254)
    checked = 0
    for line in src.splitlines():
        line = line.strip()
        if (line.startswith("VK_Q") or line.startswith("VK_S")) and 'Bytes.from_hex("' in line:
            codec.g1_from_raw_bytes(bytes.fromhex(line.split('"')[1]))  # raises if invalid
            checked += 1
    assert checked == 8


@pytest.mark.parametrize("ctype", list(ContractType), ids=lambda c: c.value)
def test_write_puyapy_verifier_writes_the_source(compiled, tmp_path, ctype):
    cc = compiled("bn254", 1)
    path = tmp_path / "Verifier.py"
    cc.write_puyapy_verifier(str(path), ctype)
    assert path.read_text() == render(cc.vk, ctype)

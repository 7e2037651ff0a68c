"""The port's chain layer, offline: the reference's tests/test_chain.py
(ARC56 schema parsing, ABI method selectors, SDK gating; reference
algosdkwrapper/interact.go:147-184; the networked flows require a localnet)
against ``algoplonk_tpu_torch.chain``, and ``testutils.test_circuit_native``
on the CPU."""

import json

import pytest

import algoplonk_tpu_torch as apt
from algoplonk_tpu_torch.chain import algosdk_wrapper as sdkw
from algoplonk_tpu_torch.chain import testutils as tu
from torch_parity import one_torch_thread, pythagorean  # noqa: F401

ARC56_DOC = {
    "name": "Arc4AppWithVerifyMethod",
    "state": {
        "schema": {
            "global": {"ints": 0, "bytes": 1},
            "local": {"ints": 0, "bytes": 0},
        }
    },
    "source": {"approval": "YXBw", "clear": "Y2xy"},
    "methods": [
        {
            "name": "create",
            "args": [{"type": "string", "name": "name"}],
            "returns": {"type": "void"},
        },
        {
            "name": "verify",
            "args": [
                {"type": "byte[32][]", "name": "proof"},
                {"type": "byte[32][]", "name": "public_inputs"},
            ],
            "returns": {"type": "bool"},
        },
    ],
}


def test_read_arc56_schema(tmp_path):
    p = tmp_path / "app.arc56.json"
    p.write_text(json.dumps(ARC56_DOC))
    s = sdkw.read_arc56_schema(str(p))
    assert s.name == "Arc4AppWithVerifyMethod"
    assert s.global_bytes == 1 and s.global_ints == 0
    assert s.approval_b64 == "YXBw" and s.clear_b64 == "Y2xy"
    v = s.method("verify")
    assert v.signature == "verify(byte[32][],byte[32][])bool"
    assert len(v.selector) == 4
    # ARC4 selector = sha512/256(signature)[:4] — stable golden
    import hashlib

    want = hashlib.new(
        "sha512_256", b"verify(byte[32][],byte[32][])bool"
    ).digest()[:4]
    assert v.selector == want
    with pytest.raises(KeyError):
        s.method("nope")


def test_sdk_gating():
    """Without py-algorand-sdk installed, every networked entry point raises
    ChainUnavailable with an actionable message."""
    if sdkw.HAVE_ALGOSDK:
        pytest.skip("algosdk installed; gating not applicable")
    with pytest.raises(sdkw.ChainUnavailable):
        sdkw.get_clients()
    with pytest.raises(sdkw.ChainUnavailable):
        sdkw.get_indexer_client()
    with pytest.raises(sdkw.ChainUnavailable):
        sdkw.deploy_arc4_app_if_needed(None, "x", ".", "addr", "sk")


def test_verify_app_source_shape():
    """The inline app source mirrors the reference's
    Arc4AppWithVerifyMethod (testutils/testutils.go:155-183)."""
    src = tu.VERIFY_APP_SOURCE
    assert "class Arc4AppWithVerifyMethod" in src
    assert 'abimethod(create="require")' in src
    assert "UpdateApplication" in src and "DeleteApplication" in src
    assert "def verify(" in src and "Bool(True)" in src
    import ast

    ast.parse(src)


def test_verify_app_source_equals_reference():
    from algoplonk_tpu.chain import testutils as ref_tu

    assert tu.VERIFY_APP_SOURCE == ref_tu.VERIFY_APP_SOURCE
    assert tu.DUMMY_APP_SOURCE == ref_tu.DUMMY_APP_SOURCE


def test_circuit_native_on_the_cpu():
    """Compile, prove and natively verify with no chain, on the device
    passed (the CPU here)."""
    Pyth = pythagorean(apt)
    vp = tu.test_circuit_native(Pyth, apt.BN254, apt.SetupName.TEST_ONLY_BN254,
                                Pyth(a=3, b=4, c=5), device="cpu")
    assert len(vp.marshal_proof()) == 24 * 32
    assert vp.marshal_public_inputs() == (3).to_bytes(32, "big") + (4).to_bytes(32, "big")

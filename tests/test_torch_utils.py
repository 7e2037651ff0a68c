"""The port's utils: ABI encoding and toolchain staleness logic (the
reference's tests/test_utils.py), the compiled-circuit cache (a round trip
proves byte-equal; a file naming a reference class is refused without
importing it), the trace with the recorder's span rows, and the kernel
build cache."""

import io
import json
import os
import pathlib
import pickle
import subprocess
import sys
import time

import pytest
import torch

import algoplonk_tpu_torch as apt
from algoplonk_tpu.fields.params import CURVES as REF_CURVES
from algoplonk_tpu.plonk.keys import VerifyingKey as RefVerifyingKey
from algoplonk_tpu_torch.frontend import witness as witness_mod
from algoplonk_tpu_torch.plonk import verify as verify_mod
from algoplonk_tpu_torch.plonk.marshal import marshal_proof
from algoplonk_tpu_torch.plonk.prove import Prover
from algoplonk_tpu_torch.utils import cache, compile_cache, profiling, toolchain
from test_torch_no_jax import BLOCK_IMPORTS
from torch_parity import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_chunks_and_abi_encoding():
    blob = bytes(range(64))
    cs = toolchain.chunks32(blob)
    assert len(cs) == 2 and cs[0] == blob[:32]
    with pytest.raises(ValueError):
        toolchain.chunks32(b"x" * 33)

    enc = toolchain.abi_encode_byte32_array(blob)
    assert enc[:2] == (2).to_bytes(2, "big")
    assert enc[2:] == blob

    proof_args = toolchain.abi_encode_proof_and_public_inputs(blob, blob[:32])
    assert proof_args[1][:2] == (1).to_bytes(2, "big")

    composer = toolchain.proof_and_public_inputs_for_atomic_composer(blob, blob[:32])
    assert len(composer[0]) == 2 and len(composer[1]) == 1


def test_should_recompile(tmp_path):
    src = tmp_path / "v.py"
    art = tmp_path / "v.teal"
    src.write_text("x")
    assert toolchain.should_recompile(str(src), str(art))  # artifact missing
    art.write_text("y")
    os.utime(str(art), (src.stat().st_mtime + 10, src.stat().st_mtime + 10))
    assert not toolchain.should_recompile(str(src), str(art))
    os.utime(str(src), (src.stat().st_mtime + 100, src.stat().st_mtime + 100))
    assert toolchain.should_recompile(str(src), str(art))


def test_rename_puyapy_output(tmp_path):
    (tmp_path / "Verifier.teal").write_text("t")
    (tmp_path / "Verifier.arc56.json").write_text("{}")
    toolchain.rename_puyapy_output("Verifier", "MyV", str(tmp_path))
    assert (tmp_path / "MyV.teal").exists()
    assert (tmp_path / "MyV.arc56.json").exists()
    assert not (tmp_path / "Verifier.teal").exists()


class Tiny(apt.Circuit):
    x = apt.PublicInput()
    y = apt.SecretInput()

    def define(self, api):
        api.assert_is_equal(api.mul(self.y, self.y), self.x)


def unblinded_proof(cc) -> bytes:
    """Prover(rng=False)'s proof of Tiny(x=9, y=3), checked by the verifier."""
    prover = Prover(cc.pk, cc.ccs, rng=False)
    wit = witness_mod.solve(cc.ccs, Tiny(x=9, y=3), commitment_solver=prover.bsb_solver)
    proof = prover.prove(wit)
    assert verify_mod.verify(cc.vk, proof, [9])
    return marshal_proof(cc.curve, proof)


@pytest.fixture(scope="module")
def tiny():
    return apt.compile(Tiny, apt.BN254, apt.SetupName.TEST_ONLY_BN254, device="cpu")


def test_circuit_cache_roundtrip(tiny, tmp_path):
    path = tmp_path / "tiny.ccc"
    cache.write_compiled_circuit(tiny, str(path))
    cc2 = cache.read_compiled_circuit(str(path), device="cpu")
    assert cc2.vk == tiny.vk
    assert cc2.curve is cc2.vk.curve is cc2.ccs.curve is apt.BN254
    for name in ("qk_ev", "s1_c", "srs_g1"):
        assert torch.equal(getattr(cc2.pk, name), getattr(tiny.pk, name))
    assert unblinded_proof(cc2) == unblinded_proof(tiny)


def test_cache_refuses_another_layout(tiny):
    blob = pickle.loads(cache.serialize_compiled_circuit(tiny))
    del blob["meta"]["layout"]
    with pytest.raises(ValueError, match="not a cache file of algoplonk_tpu_torch"):
        cache.deserialize_compiled_circuit(pickle.dumps(blob), device="cpu")


def global_pickle(module: str, name: str) -> bytes:
    """A protocol-4 pickle of the object ``module``.``name`` (STACK_GLOBAL)."""
    def utf8(text):
        raw = text.encode()
        return b"\x8c" + bytes([len(raw)]) + raw
    return b"\x80\x04" + utf8(module) + utf8(name) + b"\x93."


@pytest.mark.parametrize("module,name", [
    ("algoplonk_tpu_torch.utils.toolchain", "subprocess.run"),  # what a module imports
    ("algoplonk_tpu_torch.utils.toolchain", "subprocess"),  # a module
    ("algoplonk_tpu_torch.utils.toolchain", "should_recompile"),  # a function
    ("algoplonk_tpu_torch.utils.profiling", "deque"),  # a class from elsewhere
    ("builtins", "eval"),
])
def test_cache_refuses_what_is_not_a_package_class(module, name):
    """Only classes defined in the port resolve, so a file cannot reach a
    function, a module, or anything a port module imports."""
    with pytest.raises(ValueError, match=f"it names {module}.{name}"):
        cache.deserialize_compiled_circuit(global_pickle(module, name), device="cpu")


def test_cache_resolves_package_classes():
    loaded = cache._Unpickler(io.BytesIO(global_pickle(
        "algoplonk_tpu_torch.plonk.keys", "VerifyingKey"))).load()
    assert loaded is apt.plonk.keys.VerifyingKey


READ_REFERENCE_PICKLE = BLOCK_IMPORTS + r"""
from algoplonk_tpu_torch.utils import cache

try:
    cache.read_compiled_circuit(sys.argv[1], device="cpu")
except ValueError as e:
    print("refused:", e)
loaded = sorted(m for m in sys.modules if reference_or_jax(m))
print("loaded:", loaded)
sys.exit(1 if loaded else 0)
"""


def test_cache_refuses_reference_classes(tiny, tmp_path):
    """A file in the reference's layout, whose meta holds a reference
    VerifyingKey (built from host ints), is refused with ValueError in a
    process where jax and algoplonk_tpu cannot be imported, and neither
    was."""
    fields = {name: getattr(tiny.vk, name) for name in RefVerifyingKey.__dataclass_fields__}
    fields["curve"] = REF_CURVES["bn254"]
    meta = {"curve": "bn254", "vk": RefVerifyingKey(**fields)}
    path = tmp_path / "reference.ccc"
    path.write_bytes(pickle.dumps({"meta": meta, "arrays": b""}))
    proc = subprocess.run(
        [sys.executable, "-c", READ_REFERENCE_PICKLE, str(path)], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert ("refused: not a cache file of algoplonk_tpu_torch: it names "
            "algoplonk_tpu.plonk.keys.VerifyingKey") in proc.stdout
    assert "loaded: []" in proc.stdout


def test_torch_trace_holds_the_span_rows(tmp_path):
    """torch_trace records the block's requests and writes their spans into
    trace.json as rows of their own, on the trace's clock: each span row
    lies around the operator it encloses, 20 ms inside it."""
    with profiling.torch_trace(str(tmp_path)):
        with profiling.request("verify"):
            with profiling.span("solve"):
                time.sleep(0.02)
                torch.ones(8).mul_(2)
                time.sleep(0.02)
    with open(tmp_path / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    rows = {e["name"]: e for e in events if e.get("cat") == "ap_span"}
    assert set(rows) == {"verify", "solve"}
    assert rows["solve"]["args"] == {"request": rows["verify"]["args"]["request"],
                                     "parent": "verify"}
    mul = next(e for e in events if e.get("name") == "aten::mul_")
    for row in rows.values():
        assert row["ts"] <= mul["ts"] and mul["ts"] + mul["dur"] <= row["ts"] + row["dur"]


def test_persistent_cache_needs_a_card(monkeypatch):
    """With a CUDA device it builds or loads the kernel library once; without
    one, or with AP_PERSIST_CACHE=0, nothing is built."""
    from algoplonk_tpu_torch.ops import _build

    built = []
    monkeypatch.setattr(_build, "library", lambda: built.append(1))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert compile_cache.enable_persistent_cache() is False
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert compile_cache.enable_persistent_cache() is True and built == [1]
    monkeypatch.setenv("AP_PERSIST_CACHE", "0")
    assert compile_cache.enable_persistent_cache() is False and built == [1]


def test_prover_warms_the_kernel_library_on_cuda_only(tiny, monkeypatch):
    """The Prover calls enable_persistent_cache where the reference's does,
    and only for a CUDA proving key: a CPU prover builds nothing."""
    from algoplonk_tpu_torch.plonk import prove as prove_mod

    class Warmed(Exception):
        pass

    def warm():
        raise Warmed

    monkeypatch.setattr(prove_mod, "enable_persistent_cache", warm)
    Prover(tiny.pk, tiny.ccs, rng=False)
    # a CUDA key: the call comes before the prover puts anything on the device
    monkeypatch.setattr(type(tiny.pk), "device", property(lambda pk: torch.device("cuda")))
    with pytest.raises(Warmed):
        Prover(tiny.pk, tiny.ccs, rng=False)

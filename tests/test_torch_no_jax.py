"""The port must run where jax is not installed: it imports torch and never
jax, nor any module of the reference package, not even a jax-free one.

A fresh interpreter, in which ``jax`` and ``algoplonk_tpu`` cannot be
imported at all, imports every module of the port and proves and verifies a
circuit on each curve on the CPU, and runs the BN254 proof through its
emitted verifier under the port's AVM mock; afterwards neither is in
``sys.modules`` and no loaded module comes from the reference's directory.  The entry points
run on the card by default, and refuse to start without one."""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

import algoplonk_tpu_torch as apt

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "algoplonk_tpu_torch"

# the head of a script in which jax and algoplonk_tpu cannot be imported
BLOCK_IMPORTS = r"""
import importlib
import importlib.abc
import pathlib
import sys


def reference_or_jax(name):
    return name.split(".")[0] in ("jax", "jaxlib", "algoplonk_tpu")


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if reference_or_jax(name):
            raise ImportError(f"blocked import: {name}")
        return None


sys.meta_path.insert(0, Block())


# the loaded modules of jax or the reference, and those loaded from the
# reference's directory (the script runs from the repo's root)
def reference_modules():
    loaded = sorted(m for m in sys.modules if reference_or_jax(m))
    ref_dir = str(pathlib.Path.cwd().resolve() / "algoplonk_tpu") + "/"
    from_ref = sorted(
        name for name, m in list(sys.modules.items())
        if str(pathlib.Path(getattr(m, "__file__", None) or "/").resolve()).startswith(ref_dir)
    )
    return loaded, from_ref
"""

SCRIPT = BLOCK_IMPORTS + r"""
import os
import tempfile

import torch

torch.set_num_threads(1)
import algoplonk_tpu_torch as apt

root = pathlib.Path(apt.__file__).parent
for path in sorted(root.rglob("*.py")):
    parts = path.relative_to(root.parent).with_suffix("").parts
    importlib.import_module(".".join(p for p in parts if p != "__init__"))


class Pythagorean(apt.Circuit):
    a = apt.PublicInput()
    b = apt.PublicInput()
    c = apt.SecretInput()

    def define(self, api):
        a2 = api.mul(self.a, self.a)
        b2 = api.mul(self.b, self.b)
        c2 = api.mul(self.c, self.c)
        api.assert_is_equal(api.add(a2, b2), c2)


from algoplonk_tpu_torch.chain import algopy_mock

sizes, accepted = [], None
for curve, setup in ((apt.BN254, apt.SetupName.TEST_ONLY_BN254),
                     (apt.BLS12_381, apt.SetupName.ETHEREUM_KZG_CEREMONY_BLS12_381)):
    cc = apt.compile(Pythagorean, curve, setup, device="cpu")
    vp = cc.verify(Pythagorean(a=3, b=4, c=5))
    sizes.append(len(vp.marshal_proof()))
    if accepted is None:   # BN254: its emitted verifier under the port's mock
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "Verifier.py")
            cc.write_puyapy_verifier(path, apt.ContractType.LOGIC_SIG)
            ns = algopy_mock.exec_verifier_source(open(path).read())
        accepted = algopy_mock.run_logicsig(ns, vp.marshal_proof(), vp.marshal_public_inputs())
loaded, from_ref = reference_modules()
print("loaded:", loaded, "from reference:", from_ref, "proof bytes:", sizes,
      "emitted verifier accepts:", accepted)
sys.exit(1 if loaded or from_ref or sizes != [768, 1056] or accepted is not True else 0)
"""


EXAMPLES_SCRIPT = BLOCK_IMPORTS + r"""
import os
import tempfile

import torch

torch.set_num_threads(1)
os.environ["MERKLE_DEPTH"] = "1"
for name in ("basic.logicsig_verifier", "basic.smart_contract_verifier",
             "merkle.logicsig_verifier", "merkle.smart_contract_verifier"):
    importlib.import_module("examples_torch." + name)
from examples_torch.basic import logicsig_verifier as basic

with tempfile.TemporaryDirectory() as tmp:
    accepted = basic.main(device="cpu", outdir=tmp)["accepted"]
loaded, from_ref = reference_modules()
print("loaded:", loaded, "from reference:", from_ref, "basic example accepted:", accepted)
sys.exit(1 if loaded or from_ref or accepted is not True else 0)
"""


def test_port_proves_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert ("loaded: [] from reference: [] proof bytes: [768, 1056] "
            "emitted verifier accepts: True") in proc.stdout


def test_examples_run_without_jax():
    """Every program of examples_torch/ imports, and the basic logicsig
    example proves on the CPU to an accepting verifier, in an interpreter
    where jax and algoplonk_tpu cannot be imported."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", EXAMPLES_SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "loaded: [] from reference: [] basic example accepted: True" in proc.stdout


def test_port_sources_import_no_jax():
    """No module of the port or of examples_torch/, and not chip_smoke.py,
    names jax or the reference package in an import statement, and the port has no alias
    package onto the reference's directory."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|algoplonk_tpu)\b", re.M)
    offenders = [
        str(path.relative_to(REPO))
        for root in (PORT, REPO / "examples_torch")
        for path in sorted(root.rglob("*.py"))
        if pattern.search(path.read_text())
    ]
    assert offenders == []
    assert not (PORT / "_ref").exists()
    assert not any("__path__" in path.read_text() for path in PORT.rglob("*.py"))
    assert (REPO / "chip_smoke.py").exists()
    assert not pattern.search((REPO / "chip_smoke.py").read_text())


class Pythagorean(apt.Circuit):
    a = apt.PublicInput()
    b = apt.PublicInput()
    c = apt.SecretInput()

    def define(self, api):
        api.assert_is_equal(api.add(api.mul(self.a, self.a), api.mul(self.b, self.b)),
                            api.mul(self.c, self.c))


@pytest.mark.parametrize("device", [None, "cuda"], ids=["default", "cuda"])
def test_compile_without_card_raises(monkeypatch, device):
    """The entry point runs on the card unless the caller asks for the CPU:
    without one it raises instead of proving on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kwargs = {} if device is None else {"device": device}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        apt.compile(Pythagorean, apt.BN254, apt.SetupName.TEST_ONLY_BN254, **kwargs)

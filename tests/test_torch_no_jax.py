"""The port must run where jax is not installed: it imports torch and never
jax, not even through the reference package's ``__init__``.

A fresh interpreter, in which ``jax`` and ``algoplonk_tpu`` cannot be
imported at all, imports every module of the port and proves and verifies a
circuit on the CPU; afterwards neither is in ``sys.modules``."""

import os
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "algoplonk_tpu_torch"

SCRIPT = r"""
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

import torch

torch.set_num_threads(1)
import algoplonk_tpu_torch as apt

root = pathlib.Path(apt.__file__).parent
for path in sorted(root.rglob("*.py")):
    parts = path.relative_to(root.parent).with_suffix("").parts
    if "_ref" not in parts:
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


cc = apt.compile(Pythagorean, apt.BN254, apt.SetupName.TEST_ONLY_BN254, device="cpu")
blob = cc.verify(Pythagorean(a=3, b=4, c=5)).marshal_proof()
loaded = sorted(m for m in sys.modules if reference_or_jax(m))
print("loaded:", loaded, "proof bytes:", len(blob))
sys.exit(1 if loaded or len(blob) != 768 else 0)
"""


def test_port_proves_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "loaded: [] proof bytes: 768" in proc.stdout


def test_port_sources_import_no_jax():
    """No module of the port names jax or the reference package in an
    import statement (``_ref`` reaches the reference files by path)."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|algoplonk_tpu)\b", re.M)
    offenders = [
        str(path.relative_to(REPO))
        for path in sorted(PORT.rglob("*.py"))
        if pattern.search(path.read_text())
    ]
    assert offenders == []
    assert (REPO / "chip_smoke.py").exists()
    assert not pattern.search((REPO / "chip_smoke.py").read_text())

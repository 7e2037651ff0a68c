"""Import hygiene, by whole top-level module names (the port's name,
algoplonk_tpu_torch, begins with the JAX package's): nothing a run of the
harness loads is JAX or the JAX package, and the reference and the
circuits load nothing of the program."""

import ast
import os
import subprocess
import sys

from benchmark.core.cell import FORBIDDEN
from benchmark.tests.conftest import BENCH, REPO, cpu_run

PROGRAM = ("algoplonk_tpu_torch",)


def test_forbidden_names_compare_whole(monkeypatch):
    from benchmark.core import cell

    monkeypatch.setitem(sys.modules, "algoplonk_tpu_torch_fake.sub", object())
    assert cell.forbidden_modules() == [] or all(
        m.split(".")[0] in FORBIDDEN for m in cell.forbidden_modules())
    assert "algoplonk_tpu_torch_fake.sub" not in cell.forbidden_modules()
    monkeypatch.setitem(sys.modules, "algoplonk_tpu.fake", object())
    assert "algoplonk_tpu.fake" in cell.forbidden_modules()


def test_a_run_loads_no_jax(tiny_root):
    _, loaded = cpu_run(tiny_root, "tiny_rangecommit.bn254.seq", trace=1)
    assert "algoplonk_tpu_torch" in loaded and "benchmark" in loaded
    assert not set(loaded) & set(FORBIDDEN)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_reference_sources_import_nothing_of_the_program():
    for sub in ("reference", "circuits"):
        for f in os.listdir(os.path.join(BENCH, sub)):
            if f.endswith(".py"):
                names = set(_imports(os.path.join(BENCH, sub, f)))
                assert not names & set(FORBIDDEN + PROGRAM + ("torch",)), (sub, f, names)


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark.reference import curves, frontend, plonk\n"
            "from benchmark.circuits import rangecommit, squarechain\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))" % REPO)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    loaded = set(p.stdout.split())
    assert "benchmark" in loaded
    assert not loaded & set(FORBIDDEN + PROGRAM + ("torch",))

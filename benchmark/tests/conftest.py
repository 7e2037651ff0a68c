"""Fixtures of the benchmark's own tests: a temporary checkout holding
BENCHMARK.json and benchmark/ with test-only configurations, traffic, an
entry and a metric added as new files and entries, and a runner of cells
on the CPU.
The card is looked for in a fixture, never at import."""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(REPO, "benchmark")

TINY_CONFIGS = {
    "tiny_squarechain.bn254": {"circuit": "squarechain", "curve": "bn254",
                               "setup": "TEST_ONLY_BN254", "log_n": 4},
    "tiny_rangecommit.bn254": {"circuit": "rangecommit", "curve": "bn254",
                               "setup": "TEST_ONLY_BN254", "amounts": 3, "bits": 8},
}
PAIR = {"entry": "prove_batch", "batch": 2, "streams": 2,
        "warmup_requests": 0}
SOLO = {"entry": "verify_again", "batch": 1, "streams": 1, "warmup_requests": 1}
VERIFY_AGAIN = '''"""verify_again (test only): an entry added as a new file, which proves
each assignment by CompiledCircuit.verify."""

import time


def request(run, cc, P, items):
    for item in items:
        t0 = time.perf_counter()
        vp = cc.verify(P(**item.assignment))
        item.call_s = time.perf_counter() - t0
        run.marshal(vp, item)
'''
PROOF_COUNT = '''"""proof_count (test only): proofs completed in the window."""


def read(run):
    return float(len(run.done))
'''


def add_tiny(root: str) -> None:
    """Add the test-only cells to the checkout at ``root`` as new files
    and new BENCHMARK.json entries; no existing file's content changes
    but BENCHMARK.json's lists grow."""
    bench = os.path.join(root, "benchmark")
    spec_path = os.path.join(root, "BENCHMARK.json")
    with open(spec_path) as fh:
        spec = json.load(fh)
    for name, cfg in TINY_CONFIGS.items():
        rel = f"benchmark/configs/{name}.json"
        with open(os.path.join(root, rel), "w") as fh:
            json.dump(cfg, fh)
        spec["configs"].append({"name": name, "source": "test only", "file": rel,
                                "reduced": [], "why": "test only"})
    with open(os.path.join(bench, "traffic", "pair.json"), "w") as fh:
        json.dump(PAIR, fh)
    with open(os.path.join(bench, "traffic", "solo.json"), "w") as fh:
        json.dump(SOLO, fh)
    with open(os.path.join(bench, "entries", "verify_again.py"), "w") as fh:
        fh.write(VERIFY_AGAIN)
    with open(os.path.join(bench, "metrics", "proof_count.py"), "w") as fh:
        fh.write(PROOF_COUNT)
    cells = [("tiny_squarechain.bn254.seq", "tiny_squarechain.bn254", "solo"),
             ("tiny_rangecommit.bn254.seq", "tiny_rangecommit.bn254", "seq"),
             ("tiny_rangecommit.bn254.pair", "tiny_rangecommit.bn254", "pair")]
    for name, config, traffic in cells:
        spec["workloads"].append({"name": name, "config": config, "traffic": traffic,
                                  "chips": 1, "why": "test only"})
    names = [c[0] for c in cells]
    for m in spec["end_to_end"]:
        if m["name"] == "proofs_per_s":
            m["workloads"] += names[:2]
    # the batch cell's metrics, whose readers the benchmark keeps for a
    # batch cell: entries only
    spec["end_to_end"].insert(1, {"name": "batch_proofs_per_s", "unit": "proofs/s",
                                  "better": "higher", "bound": 0.25, "source": "host_clock",
                                  "workloads": names[2:]})
    for name, unit, better, source, layer in (
            ("inflight_proofs.batch", "proofs", "higher", "program_span", "batch proving"),
            ("idle_share.batch", "%", "lower", "device_trace", "device")):
        spec["per_layer"].append({"name": name, "unit": unit, "better": better, "source": source,
                                  "layer": layer, "moves": "batch_proofs_per_s",
                                  "workloads": names[2:]})
    for m in spec["per_layer"]:
        if m["name"] in ("glue_s", "r1_s", "r3_s", "launches_per_proof"):
            m["workloads"] += names[:2]
        if m["name"] in ("compile_s", "first_prove_s"):
            m["workloads"] += names
    spec["per_layer"].append({"name": "proof_count", "unit": "proofs", "better": "higher",
                              "source": "host_clock", "layer": "api",
                              "moves": "proofs_per_s", "workloads": names[:2]})
    with open(spec_path, "w") as fh:
        json.dump(spec, fh, indent=1)


def copy_checkout(dst: str) -> str:
    os.makedirs(dst, exist_ok=True)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dst)
    shutil.copytree(BENCH, os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    root = copy_checkout(str(tmp_path_factory.mktemp("checkout")))
    add_tiny(root)
    return root


def cpu_run(root, workload, seed=1234567890123, seconds=0.5, trace=0, control=""):
    """(result, loaded top-level module names) of one CPU run."""
    cmd = [sys.executable, os.path.join(BENCH, "tests", "cpu_run.py"), "--root", root,
           "--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
           "--trace", str(trace)]
    if control:
        cmd += ["--with", control]
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    lines = p.stdout.strip().splitlines()
    return json.loads(lines[-2]), json.loads(lines[-1])


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")

"""The harness: BENCHMARK.json against its format's limits, every name
resolving to its files, a new cell added by files and entries alone, the
arithmetic of rates, rooflines and traces on fixed numbers, and the runner
refusing to run without a card."""

import hashlib
import json
import os
import re
import statistics
import subprocess
import sys

import pytest

from benchmark.core import endtoend, readers, roofline, spec, trace
from benchmark.core.cell import Proofed, Run
from benchmark.tests.conftest import BENCH, REPO, copy_checkout, cpu_run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def spec_json():
    return spec.load_spec(REPO)


def test_benchmark_json_shape(spec_json):
    d = spec_json
    assert set(d) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert d["command"] == ["python3", "benchmark/run.py"] and d["paths"] == ["benchmark"]
    assert isinstance(d["run_seconds"], int) and 1 <= d["run_seconds"] <= 51
    assert 1 <= len(d["configs"]) <= 24 and 1 <= len(d["workloads"]) <= 24
    for c in d["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert c["file"].startswith("benchmark/")
    pairs = set()
    for w in d["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs and len(w["why"]) <= 200
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"]: m for m in d["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in d["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in d["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    names = [x["name"] for x in d["end_to_end"] + d["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for m in d["end_to_end"] + d["per_layer"])
    for w in d["workloads"]:
        mine = [m for m in d["end_to_end"] if spec.applies(m, w["name"])]
        assert "setup_s" in [m["name"] for m in mine] and len(mine) >= 2
        layer = [m for m in d["per_layer"] if spec.applies(m, w["name"])]
        assert layer and all(spec.applies(e2e[m["moves"]], w["name"]) for m in layer)
    assert len(json.dumps(d)) < 64 * 1024


def test_every_name_resolves_to_its_files(spec_json):
    for c in spec_json["configs"]:
        with open(os.path.join(REPO, c["file"])) as fh:
            cfg = json.load(fh)
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        assert os.path.exists(spec.circuit_file(cfg))
        assert cfg["setup"].startswith("TEST_ONLY")
    for w in spec_json["workloads"]:
        cell = spec.cell(spec_json, w["name"])
        assert cell.circuit.circuit and cell.circuit.assignment and cell.circuit.publics
        assert os.path.exists(spec.entry_file(cell.traffic["entry"]))
        assert callable(cell.entry.request)
        for m in cell.end_to_end:
            assert m["name"] in endtoend.READERS
        for m in cell.per_layer:
            assert hasattr(spec.metric_reader(m["name"]), "read")


def _digests(root):
    out = {}
    for dirpath, _, files in os.walk(os.path.join(root, "benchmark")):
        for f in files:
            if "__pycache__" in dirpath:
                continue
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_added_cell_needs_no_edit(tiny_root):
    """The test-only configurations, traffic, entry and metric of
    conftest.py were added as files and BENCHMARK.json entries: every file
    the benchmark had is unchanged, and a run of the new cell, through the
    new entry, reports the new metric."""
    before = _digests(REPO)
    after = _digests(tiny_root)
    for rel, digest in before.items():
        if not rel.startswith("benchmark/tests/"):
            assert after[rel] == digest, rel
    added = set(after) - set(before)
    assert {"benchmark/configs/tiny_squarechain.bn254.json", "benchmark/traffic/pair.json",
            "benchmark/traffic/solo.json", "benchmark/entries/verify_again.py",
            "benchmark/metrics/proof_count.py"} <= added
    out, _ = cpu_run(tiny_root, "tiny_squarechain.bn254.seq", trace=1)
    assert out["correct"] and out["metrics"]["proof_count"]["value"] == out["attempted"] >= 1
    for name in ("compile_s", "first_prove_s", "glue_s", "r1_s", "r3_s"):
        assert out["metrics"][name]["value"] > 0
    assert list(out)[-1] == "checks"


def test_rate_arithmetic():
    run = Run(cell=None, seed=0, seconds=10.0, trace=False, devices=["cpu"])
    run.window_s = 12.5
    run.proofs = [Proofed({}, proof=b"x", publics=b"y") for _ in range(5)]
    run.proofs.append(Proofed({}, error="RuntimeError: boom"))
    run.setup_s = 3.25
    assert endtoend.proofs_per_s(run) == 5 / 12.5
    assert endtoend.setup_s(run) == 3.25


def test_roofline_arithmetic():
    peaks = roofline.PEAKS["NVIDIA H100 80GB HBM3"]
    b = roofline.Bound(peaks)
    assert b.imul_per_s == 132 * 64 * 1980e6
    # one W = 8 Montgomery multiply is 2 (2 64 + 8) = 272 32-bit multiplies
    assert roofline.Bound.imuls(8, 1) == 272
    # 2^20 rows of K8 at W = 8: bytes (3 x 32 MiB) bound it
    rows = 1 << 20
    ops_s = 272 * rows / b.imul_per_s
    bytes_s = 3 * rows * 32 / 3.35e12
    assert bytes_s > ops_s and b.seconds(8, rows, 3 * rows * 32) == bytes_s
    torch = pytest.importorskip("torch")
    a = torch.zeros(1024, 8, dtype=torch.int32)
    k = torch.zeros(8, dtype=torch.int32).expand(1024, 8)
    assert roofline.nbytes(a, k) == 1024 * 32 + 32


def test_roofline_share_reads_only_a_whole_trace():
    run = Run(cell=None, seed=0, seconds=1.0, trace=True, devices=["cpu"])
    run.kind = "NVIDIA H100 80GB HBM3"
    b = roofline.Bound(roofline.PEAKS[run.kind])
    run.records["field_mul"] = [(8, 1 << 20, 3 * 32 << 20)] * 2
    least = b.seconds(8, 1 << 20, 3 * 32 << 20)
    dur = int(least * 2e9)                      # each launch at half its roofline
    run.probe_records = [("void field_mul_kernel<8>(int)", 0, dur),
                         ("void field_mul_kernel<8>(int)", dur, 2 * dur)]
    assert readers.roofline_share(run, "field_mul", "field_mul_kernel") == pytest.approx(50, rel=1e-4)
    run.probe_records.pop()                    # a lost record: nothing is read
    assert readers.roofline_share(run, "field_mul", "field_mul_kernel") is None
    run.kind = "some other card"
    assert readers.roofline_share(run, "field_mul", "field_mul_kernel") is None


def test_trace_reduction():
    assert trace.kernel_ident("at::cuda::(anonymous namespace)::spin_kernel(long)") == "spin_kernel"
    assert trace.kernel_ident("void field_mul_kernel<8>(unsigned int const*)") == "field_mul_kernel"
    assert trace.kernel_ident("Memcpy HtoD (Pageable -> Device)") == "Memcpy HtoD"
    recs = [("a", 10, 20), ("b", 15, 30), ("c", 40, 50), ("a", 45, 60)]
    merged = trace.union(recs)
    assert merged == [[10, 30], [40, 60]]
    assert trace.busy_ns(trace.clip(merged, 0, 100)) == 40
    assert trace.gaps(merged, 0, 100) == [[0, 10], [30, 40], [60, 100]]
    ops = trace.device_ops(recs)
    assert [k for k, _ in ops] == ["a", "b", "c"]
    assert [v for _, v in ops] == pytest.approx([25e-9, 15e-9, 10e-9])
    spans = [("prove", 0, 50, 1), ("msm", 20, 35, 1), ("marshal", 70, 80, 1)]
    segs = trace.label_timeline(spans)
    assert segs == [(0, 20, "prove"), (20, 35, "msm"), (35, 50, "prove"), (50, 70, "harness"),
                    (70, 80, "marshal")]
    idle = [[0, 10], [30, 40], [60, 100]]
    got = dict(trace.idle_by_label(idle, segs))
    assert got == pytest.approx({"prove": 15e-9, "msm": 5e-9, "harness": 30e-9, "marshal": 10e-9})
    # markers at host 1000 and 2000 ns, the device clock 10^6 ns ahead
    recs = [("spin_kernel(long)", 1_001_005, 1_001_006), ("spin_kernel(long)", 1_002_005, 1_002_006),
            ("void field_mul_kernel<8>(int)", 1_001_100, 1_001_600)]
    td = trace.reduce(recs, [1005, 2005], [("prove", 1050, 1950, 1)], 1050, 1950)
    assert td["offset_ns"] == 1_000_000 and td["drift_ns"] == 0
    assert td["busy_s"] == pytest.approx(500e-9) and td["window_s"] == pytest.approx(900e-9)
    assert dict(td["idle_gaps"]) == pytest.approx({"prove": 400e-9})
    assert trace.reduce(recs[2:], [1005, 2005], [], 1050, 1950) is None


def test_span_readers():
    """msm_s sums the window's msm spans per proof done; the probe's
    records are those inside its host span, on the device's clock."""
    run = Run(cell=None, seed=0, seconds=1.0, trace=True, devices=["cpu"])
    run.proofs = [Proofed({}, proof=b"x", publics=b"y") for _ in range(2)]
    for lo, hi in ((0, 300), (500, 600), (700, 1100)):
        run.spans.add("msm", lo * 10**6, hi * 10**6)
    run.spans.add("prove", 0, 2 * 10**9)
    msm_s = spec.metric_reader("msm_s")
    assert msm_s.read(run) == pytest.approx(0.4)
    run.proofs = []
    assert msm_s.read(run) is None
    recs = [("spin_kernel(long)", 1000, 1001), ("a", 1100, 1200), ("b", 1250, 1400),
            ("c", 1600, 1700)]
    assert trace.within(recs, 1000, 150, 300) == [("a", 1100, 1200), ("b", 1250, 1400)]


def test_spread_is_the_quartile_distance():
    """The spread the bounds were set from: (Q3 - Q1) / median, with the
    quartiles of statistics.quantiles(values, n=4)."""
    vals = [0.50, 0.52, 0.51, 0.49, 0.53, 0.50]
    q1, _, q3 = statistics.quantiles(vals, n=4)
    assert (q3 - q1) / statistics.median(vals) == pytest.approx((0.5225 - 0.4975) / 0.505)


def _run_py(cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "rangecommit640.bn254.2p17.seq", "--seed", "3000000000",
                           "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_run_refuses_without_a_card():
    p = _run_py(REPO)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_run_refuses_in_a_checkout_of_the_benchmark_alone(tmp_path):
    root = copy_checkout(str(tmp_path / "alone"))
    assert sorted(os.listdir(root)) == ["BENCHMARK.json", "benchmark"]
    p = _run_py(root)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_config_sizes_are_their_circuits(spec_json):
    """Each configuration's stated constraints, domain and commitments are
    those of its circuit as the reference's frontend compiles it."""
    from benchmark.reference import curves as RC
    from benchmark.reference import frontend as RF
    from benchmark.reference.plonk import next_pow2

    for c in spec_json["configs"]:
        cell = spec.cell(spec_json, next(w["name"] for w in spec_json["workloads"]
                                         if w["config"] == c["name"]))
        cfg = cell.cfg
        ccs = RF.compile_circuit(cell.circuit.circuit(RF, cfg), RC.CURVES[cfg["curve"]])
        assert ccs.nb_constraints == cfg["constraints"]
        assert next_pow2(ccs.nb_constraints + ccs.nb_public) == 1 << cfg["log_n"]
        assert len(ccs.commitments) == cfg["commitments"]

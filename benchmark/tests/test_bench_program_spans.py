"""The readers of the program's own spans (core/program_spans.py and the
six metrics that use it) on fixed numbers: the window's requests, a
missing request, each metric's arithmetic, round 3's idle share from
hand-made device records, a program without the recorder; and the files
the benchmark had before these readers, unchanged."""

import hashlib
import json
import os

import pytest

from algoplonk_tpu_torch.utils import profiling
from benchmark.core import program_spans, spec
from benchmark.core.cell import Proofed, Run
from benchmark.tests.conftest import REPO

MS = 10**6

# sha256 of every file of benchmark/ before the program's spans were read,
# and of BENCHMARK.json's object (sorted keys) without the six entries
# appended for them: none of them changes.
FILES = {
    "benchmark/__init__.py":
        "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855",
    "benchmark/circuits/__init__.py":
        "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855",
    "benchmark/circuits/rangecommit.py":
        "be941a7e270e841830d6339d8dd02306e68ec635b66770c226f23e734f340843",
    "benchmark/circuits/squarechain.py":
        "9a60aa662b7efc15746272d31a7a547b00e5adba52b1e72148fae41c762a1b0f",
    "benchmark/configs/rangecommit640.bn254.2p17.json":
        "a9d0f38c848847f3d4320665238704f5c76f6f2fb0d89538e7d9e46eff932d2a",
    "benchmark/configs/squarechain.bls12_381.2p20.json":
        "dbbe16680adee33d6cebeaac93478c11680d694c6ab58db70ec993113d2f4c31",
    "benchmark/control.py":
        "d1a3d8eb93d629e588ac0e32a5353e912344185b50541348b99c64c691f43808",
    "benchmark/core/__init__.py":
        "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855",
    "benchmark/core/cell.py":
        "5881d7342c7d2287190580a4fec9fabf3d4ec13c1c4db2db12c50cae3c724943",
    "benchmark/core/check.py":
        "59a5020a287ce29c6ccd4d2c7d31c702a788812e47d6065f060cc539295ed74c",
    "benchmark/core/endtoend.py":
        "a8cd10bf761886e46b6dd23fa1df374c1563cf56257bc25b44a61bb426c9a6a7",
    "benchmark/core/probes.py":
        "5e5a4844eb936fe36f872b2d4b2b1e5aa91055ff819e4520c52086476d1c6928",
    "benchmark/core/readers.py":
        "574b15c41c6cfc349a2a4436fe82b02821e87fa655c73511ab6514ac2f1e5cc4",
    "benchmark/core/roofline.py":
        "ef6c251be9578c96c4c1e83c1157a6716e3fb0822d75ec70dd4822bb8f9a34d5",
    "benchmark/core/spec.py":
        "ded4d0d1927401c2a18efc10848cff85c8bd719f0388a31c3782ff63903b4000",
    "benchmark/core/trace.py":
        "fd1ac5cf629056d2a733a9402102b125c666b31350b0f57361a48a7ed448f95a",
    "benchmark/entries/prove_batch.py":
        "98c92ea5cd03b87c2226fefd8d5118bb4f906caaceec75c530d9200a8bc775ca",
    "benchmark/entries/verify.py":
        "887a041dbc7596b3bf47d17295b1af10e2c17e700988e5d36b648d7967ae6c66",
    "benchmark/metrics/compile_s.py":
        "34cbbfd162cbb47b01d7fc21c20e92bc6dc4014a5e3d357705231cbf150cbd9d",
    "benchmark/metrics/field_mul_roofline.py":
        "fd5666355f5b4794e5d0e6e8068c5f289a313ba59bd6171e05e06062c92097c0",
    "benchmark/metrics/first_prove_s.py":
        "0d37cadcb262c0df0ca9329b62c86c7c660c2eada9a3b5af0fe93db6d20e6f3f",
    "benchmark/metrics/glue_s.py":
        "7a78006c0abc3eb4f71ea54027f9dd3413fe1f5f65426f5707a5ad6c9291afd1",
    "benchmark/metrics/idle_share.batch.py":
        "1411fe90df29abc66cd4e5977ec99d87da451a0515ee8c6461da45d6fff38211",
    "benchmark/metrics/idle_share.seq.py":
        "748a0dfcc6be0ba864886b99ffea7f6ca70af037bf1045ab766f140a971ad88b",
    "benchmark/metrics/inflight_proofs.batch.py":
        "56da5289e0a321180978f0f6c9a67ba6bdb19089108bd7b714194bd452160d8d",
    "benchmark/metrics/launches_per_proof.py":
        "bd310b7281dffa0986c3c8b6f10a048ea4e10b3306e62970733b1b759a73b2c0",
    "benchmark/metrics/mixed_add_signed_multi_roofline.py":
        "10b8bf906788ac38e3e08badb94c7b11547061a8cf1ad9f2869479f4142cf613",
    "benchmark/metrics/msm_s.py":
        "01e58e24ac71a71471bb75c4786e86925436c0272ecd11fd47fdf33ea5b3d5db",
    "benchmark/metrics/r1_s.py":
        "c10864e3c94df53e472165c5650366f824a742e910c458f5532fca61f5bab9d2",
    "benchmark/metrics/r3_s.py":
        "f7593ada6c31f690e4c16ac3f2ff5694c9f7df22e314ee7165ca01021c1854ba",
    "benchmark/reference/__init__.py":
        "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855",
    "benchmark/reference/curves.py":
        "00a23b6ee1d4f0178846e419407e9c839bc79444069508b38603316c87a3dcd4",
    "benchmark/reference/frontend.py":
        "a75b4a3646ebebdc12edb4ac2b72ef72a8b15c4d8fbc00a2a78e54a51a0c639f",
    "benchmark/reference/plonk.py":
        "92d1ec02e79155ca07297cf9f683bc02efda552f67b42e882daed7cfdf73711c",
    "benchmark/run.py":
        "40b286f8eb1de3cf0e99384b35712db93f50e8680ecdead4fee00fc0143eeceb",
    "benchmark/tests/__init__.py":
        "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855",
    "benchmark/tests/conftest.py":
        "e197119c580f574e23b45576e7bc7173b94d6f004c262f74e81f9f1c1cd02117",
    "benchmark/tests/cpu_run.py":
        "25e6044130ddf37d15a4deaa3b78b7cbfca64092df22af8658ca4179c706ac5a",
    "benchmark/tests/test_bench_controls.py":
        "dbb7cf04ff19cbe7b12fbcfba4364f38393d3d9e37b4e275a2873ecb9bdaf59c",
    "benchmark/tests/test_bench_harness.py":
        "384db0b90bbc1bf4185615fa1f310dcb7703e432ef0e6163c1ad1fd5ea5f3673",
    "benchmark/tests/test_bench_imports.py":
        "465215f5c0a45b7ad40f532db6c160a500a20bfefbf83bb245ae19672d1949d1",
    "benchmark/tests/test_bench_reference.py":
        "5581d1e6411bdcd812ceb02c23f77e45e430d55d43ed6605f32b13acd9c8fcc8",
    "benchmark/traffic/batch4.json":
        "fdbf3fdd03431b35d78df92d22b7ee974b24819a0545b8eeb0aff651480164aa",
    "benchmark/traffic/seq.json":
        "4405a5dacb9ce0e99a6981dd22ce0f3d8f643d6db8e4df1d792e41d407ab1932",
}
SPEC_BEFORE = "4bac949f6c9001decb376bea923e4213ef82e4f50e113a88e6b0679025e0a8d3"
NEW_METRICS = ("solve_s", "self_verify_s", "wires_s", "msm_fold_s", "dispatch_s",
               "r3_idle_share")


def make_request(rid: int, tree: list) -> profiling.Request:
    """A finished request from (name, start ms, end ms, parent index,
    launches, dispatch ns) rows, the root first."""
    q = profiling.Request(rid, 1)
    for name, lo, hi, parent, launches, disp in tree:
        sp = profiling.Span(name, lo * MS, q.spans[parent] if parent is not None else None,
                            rid, 1, None)
        sp.end = hi * MS
        sp.launches = dict(launches)
        sp.dispatch_ns = disp
        q.spans.append(sp)
    return q


def proof_tree(rid: int, t: int) -> profiling.Request:
    """One verify request starting at t ms: solve 10 ms (bsb_commit 4),
    prove 60 (r1 with wires 5 and an msm whose fold is 2; r3 20), and a
    self-verify of 15; launches in r1 and r3."""
    return make_request(rid, [
        ("verify", t, t + 100, None, {}, 0),
        ("solve", t + 2, t + 12, 0, {}, 0),
        ("bsb_commit", t + 6, t + 10, 1, {"ntt_pass": 2}, 1000),
        ("prove", t + 12, t + 72, 0, {}, 0),
        ("r1", t + 12, t + 30, 3, {"field_mul": 3}, 3000),
        ("wires", t + 12, t + 17, 4, {}, 0),
        ("msm", t + 20, t + 30, 4, {"mixed_add_signed_multi": 5}, 5000),
        ("msm.fold", t + 28, t + 30, 6, {}, 0),
        ("r3", t + 40, t + 60, 3, {"ntt_pass": 4}, 4000),
        ("self_verify", t + 75, t + 90, 0, {}, 0),
    ])


@pytest.fixture
def recorder(monkeypatch):
    rec = profiling.Recorder()
    monkeypatch.setattr(profiling, "RECORDER", rec)
    return rec


def window_run(n_done: int) -> Run:
    """A traced run whose spans around the program's calls (the
    benchmark's own) run from 1002 to 1390 ms, with ``n_done`` proofs
    done; the probe request's proof after the window is marshalled at
    1601 ms."""
    run = Run(cell=None, seed=0, seconds=0.4, trace=True, devices=["cpu"])
    run.proofs = [Proofed({}, proof=b"x", publics=b"y") for _ in range(n_done)]
    run.spans.add("solve", 1002 * MS, 1012 * MS)
    run.spans.add("self_verify", 1275 * MS, 1290 * MS)
    run.spans.add("marshal", 1290 * MS, 1291 * MS)
    run.spans.add("marshal", 1601 * MS, 1602 * MS)
    return run


def fill(rec, requests) -> None:
    for q in requests:
        rec._done.append(q)


def test_window_keeps_its_requests_only(recorder):
    """A request before the window and the probe after it are left out; a
    root that opens before the benchmark's first span is kept."""
    fill(recorder, [proof_tree(1, 700), proof_tree(2, 1000), proof_tree(3, 1200),
                    proof_tree(4, 1500)])
    run = window_run(2)
    reqs = program_spans.window_requests(run)
    assert [q.id for q in reqs] == [2, 3]
    read = {m: spec.metric_reader(m).read(run) for m in NEW_METRICS[:5]}
    assert read == pytest.approx({"solve_s": 0.010, "self_verify_s": 0.015, "wires_s": 0.005,
                                  "msm_fold_s": 0.002, "dispatch_s": 13e-6})


def test_a_missing_request_reads_nothing(recorder):
    fill(recorder, [proof_tree(2, 1000)])
    run = window_run(2)
    assert program_spans.window_requests(run) is None
    assert all(spec.metric_reader(m).read(run) is None for m in NEW_METRICS)
    run.proofs.pop()
    assert spec.metric_reader("solve_s").read(run) == pytest.approx(0.010)


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    monkeypatch.delattr(profiling, "RECORDER")
    run = window_run(1)
    assert all(spec.metric_reader(m).read(run) is None for m in NEW_METRICS)


def test_wires_are_read_inside_round_one_only(recorder):
    q = proof_tree(2, 1000)
    stray = profiling.Span("wires", 1041 * MS, q.spans[8], 2, 1, None)   # inside r3
    stray.end = 1049 * MS
    q.spans.append(stray)
    fill(recorder, [q])
    assert spec.metric_reader("wires_s").read(window_run(1)) == pytest.approx(0.005)


def test_launches_by_round():
    q = proof_tree(2, 1000)
    assert program_spans.by_round([q]) == {"solve": [2, 1000], "r1": [8, 8000],
                                           "r3": [4, 4000]}
    segs = program_spans.innermost_segments([q])
    assert segs[:3] == [(1000 * MS, 1002 * MS, "verify"), (1002 * MS, 1006 * MS, "verify/solve"),
                        (1006 * MS, 1010 * MS, "verify/solve/bsb_commit")]
    assert sum(b - a for a, b, _ in segs) == 100 * MS
    assert all(a < b for a, b, _ in segs) and all(
        segs[i][1] <= segs[i + 1][0] for i in range(len(segs) - 1))


def test_r3_idle_share_from_records(recorder):
    """r3 runs 1040-1060 ms on the host's clock, the device's clock 5 ms
    ahead: kernels busy 1046-1050 and 1062-1070 on the device's clock, 7
    ms of r3's 1045-1065, so r3 is 65% idle; read only where the trace
    holds the launches the counters saw."""
    fill(recorder, [proof_tree(2, 1000)])
    run = window_run(1)
    off = 5 * MS
    name = "void ntt_pass_kernel<8>(int)"
    records = [(name, 1046 * MS, 1048 * MS), (name, 1047 * MS, 1050 * MS),
               (name, 1062 * MS, 1070 * MS), ("Memcpy HtoD", 1010 * MS, 1020 * MS)]
    run.trace_data = {"records": records, "offset_ns": off}
    run.launches = {("ntt_pass", 8): 3}
    r3 = spec.metric_reader("r3_idle_share")
    assert r3.read(run) == pytest.approx(100 * (1 - (4 + 3) / 20))
    run.launches = {("ntt_pass", 8): 4}            # a record lost: nothing is read
    assert r3.read(run) is None
    run.launches = {("ntt_pass", 8): 3}
    run.trace_data = None
    assert r3.read(run) is None


def test_files_the_benchmark_had_are_unchanged():
    for rel, digest in FILES.items():
        with open(os.path.join(REPO, rel), "rb") as fh:
            assert hashlib.sha256(fh.read()).hexdigest() == digest, rel
    d = spec.load_spec(REPO)
    added = [m for m in d["per_layer"] if m["name"] in NEW_METRICS]
    assert [m["name"] for m in added] == list(NEW_METRICS)
    assert d["per_layer"][-len(NEW_METRICS):] == added
    for m in added:
        assert m["moves"] == "proofs_per_s" and m["workloads"] == [
            "rangecommit640.bn254.2p17.seq", "squarechain.bls12_381.2p20.seq"]
    d["per_layer"] = d["per_layer"][:-len(NEW_METRICS)]
    assert hashlib.sha256(json.dumps(d, sort_keys=True).encode()).hexdigest() == SPEC_BEFORE

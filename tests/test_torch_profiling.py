"""The port's recorder (utils/profiling.py): spans nest with their parents
and requests, each thread builds its own tree, the store is bounded,
nothing is recorded while it is off, a torch profiler switches it on, a
CPU ``CompiledCircuit.verify`` and a ``prove_batch`` build whole trees
whose rounds are ``phase_seconds``, recording leaves the proof bytes as
they are, and the launch counters stay exact under threads."""

import sys
import threading

import pytest
import torch

import algoplonk_tpu_torch as apt
from algoplonk_tpu_torch.frontend import witness as witness_mod
from algoplonk_tpu_torch.ops import curve_kernels as ck
from algoplonk_tpu_torch.ops import field_kernels as fk
from algoplonk_tpu_torch.ops import ntt_kernels as nk
from algoplonk_tpu_torch.parallel import prove_batch
from algoplonk_tpu_torch.plonk.marshal import marshal_proof
from algoplonk_tpu_torch.plonk.prove import Prover
from algoplonk_tpu_torch.utils import profiling
from torch_parity import one_torch_thread, pythagorean  # noqa: F401

ROUNDS = ["r1", "r2", "r3", "r4", "r5"]


@pytest.fixture
def recorder(monkeypatch):
    """A fresh recorder in place of the program's."""
    rec = profiling.Recorder()
    monkeypatch.setattr(profiling, "RECORDER", rec)
    monkeypatch.delenv("AP_PROVE_PROFILE", raising=False)
    return rec


def names(q) -> list:
    return [(sp.name, sp.parent.name if sp.parent else None) for sp in q.spans]


def test_spans_nest_with_parents_and_requests(recorder):
    with recorder.recording():
        for _ in range(2):
            with profiling.request("verify") as root:
                with profiling.span("solve"):
                    with profiling.span("bsb_commit"):
                        pass
                with profiling.request("prove"):      # inside a request: a span
                    sp = profiling.open_span("r1")
                    t = profiling.clock()
                    profiling.close_span(sp, t)
                    assert sp.end == t and profiling.open_span("r2", t).start == t
                assert root is not None and root.end is None
    a, b = recorder.requests()
    assert names(a) == [("verify", None), ("solve", "verify"), ("bsb_commit", "solve"),
                        ("prove", "verify"), ("r1", "prove"), ("r2", "prove")]
    assert a.id != b.id and {sp.request for sp in a.spans} == {a.id}
    assert {sp.thread for sp in a.spans} == {threading.get_ident()}
    assert all(sp.end is not None for sp in a.spans)      # r2 closed with its parent
    assert a.spans[4].parent is a.spans[3] and profiling.LIVE == 0


def test_threads_build_separate_trees(recorder):
    barrier = threading.Barrier(2)

    def work(tag):
        with profiling.request(f"root{tag}"):
            for i in range(3):
                with profiling.span(f"a{tag}"):
                    barrier.wait(timeout=10)
                    with profiling.span(f"b{tag}"):
                        barrier.wait(timeout=10)

    with recorder.recording():
        threads = [threading.Thread(target=work, args=(k,)) for k in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
    assert not any(th.is_alive() for th in threads)
    got = recorder.requests()
    assert len(got) == 2
    for q in got:
        k = q.root.name[-1]
        assert names(q) == [(f"root{k}", None)] + [(f"a{k}", f"root{k}"), (f"b{k}", f"a{k}")] * 3
        assert len({sp.thread for sp in q.spans}) == 1


def test_store_keeps_the_last_requests(monkeypatch):
    recorder = profiling.Recorder(keep=3)
    monkeypatch.setattr(profiling, "RECORDER", recorder)
    with recorder.recording():
        for i in range(5):
            with profiling.request(f"q{i}"):
                pass
    got = recorder.requests()
    assert [q.root.name for q in got] == ["q2", "q3", "q4"]
    assert [q.root.name for q in recorder.requests(last=2)] == ["q3", "q4"]
    assert recorder.requests(last=0) == []
    assert [q.root.name for q in recorder.requests(since_ns=got[2].start)] == ["q4"]


def test_off_records_nothing(recorder):
    assert not recorder.wanted()
    with profiling.request("verify"):
        assert profiling.open_span("solve") is None
        with profiling.request("prove") as inner, profiling.span("r1") as sp:
            assert inner is None and sp is None
            assert profiling.entry_ns() == 0
            profiling.charge("field_mul", 1)
    assert recorder.requests() == [] and profiling.LIVE == 0


def test_a_torch_profiler_switches_recording_on(recorder):
    """Pins the private flag the recorder reads against a torch upgrade."""
    assert torch.autograd.profiler._is_profiler_enabled is False
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert recorder.wanted()
        with profiling.request("verify"):
            assert profiling.entry_ns() > 0
            profiling.charge("field_mul", profiling.clock())
    (q,) = recorder.requests()
    assert q.root.launches == {"field_mul": 1} and q.root.dispatch_ns >= 0
    assert not recorder.wanted()


@pytest.fixture(scope="module")
def circuit():
    T = pythagorean(apt)
    return apt.compile(T, apt.BN254, apt.SetupName.TEST_ONLY_BN254, device="cpu"), T


def test_verify_tree_and_phase_seconds(circuit, recorder):
    cc, T = circuit
    with recorder.recording():
        vp = cc.verify(T(a=3, b=4, c=5))
    (q,) = recorder.requests()
    tops = [sp.name for sp in q.spans if sp.parent is q.root]
    assert q.root.name == "verify" and tops == ["solve", "prove", "self_verify"]
    prove = q.spans[[sp.name for sp in q.spans].index("prove")]
    rounds = [sp for sp in q.spans if sp.parent is prove]
    assert [sp.name for sp in rounds] == ROUNDS == list(vp.phase_seconds)
    assert {sp.name: sp.seconds for sp in rounds} == vp.phase_seconds
    assert all(a.end == b.start for a, b in zip(rounds, rounds[1:]))
    inside = {sp.name for sp in q.spans if sp.parent is not None and sp.parent.name == "r1"}
    assert {"wires", "msm"} <= inside
    assert sum(sp.name == "transcript" for sp in q.spans) == 5
    # round 3's Fiat-Shamir step lies in its first sub-phase, r3.qk
    assert {sp.parent.name if sp.parent.name in ROUNDS else sp.parent.parent.name
            for sp in q.spans if sp.name == "transcript"} == set(ROUNDS[1:])
    # the self-verify's four point sums and its one pairing check
    verify_parts = [(sp.name, sp.parent.name) for sp in q.spans
                    if sp.name.startswith("self_verify.")]
    assert verify_parts == [("self_verify.msm", "self_verify")] * 4 + [
        ("self_verify.pairing", "self_verify")]


def test_recording_leaves_the_bytes_and_each_batch_tree_whole(circuit, recorder):
    """Prover(rng=False) bytes with recording off equal prove_batch's with
    it on, two workers on the CPU each building one request a proof."""
    cc, T = circuit
    prover = Prover(cc.pk, cc.ccs, rng=False)
    wit = witness_mod.solve(cc.ccs, T(a=3, b=4, c=5), commitment_solver=prover.bsb_solver)
    want = marshal_proof(apt.BN254, prover.prove(wit))
    assert recorder.requests() == []
    with recorder.recording():
        vps = prove_batch(cc, [T(a=3, b=4, c=5)] * 2, devices=["cpu"] * 2, rng=False,
                          self_verify=False)
    assert [vp.marshal_proof() for vp in vps] == [want, want]
    got = recorder.requests()
    assert len(got) == 2 and len({q.thread for q in got}) == 2
    for q in got:
        assert [sp.name for sp in q.spans if sp.parent is q.root] == ["solve", "prove"]
        assert [sp.name for sp in q.spans if sp.parent and sp.parent.name == "prove"] == ROUNDS
        assert {sp.thread for sp in q.spans} == {q.thread}


def test_launch_counters_are_exact_under_threads(recorder):
    """Four threads count at once, each inside a recorded request: every
    counter is exact, and equals the sum of the spans' launches."""
    saved = (dict(ck.LAUNCHES), dict(ck.LAUNCHES_BY_WIDTH), dict(fk.LAUNCHES),
             dict(fk.LAUNCHES_BY_WIDTH), dict(fk.LAUNCHES_BY_FIELD), dict(nk.LAUNCHES))
    n = 2000
    switch = sys.getswitchinterval()

    def work():
        with profiling.request("verify"):
            for _ in range(n):
                t0 = profiling.entry_ns()
                ck._count("jac_add", 8, t0)
                fk._count("field_mul", 12, "bls12_381_fr", t0)
                nk._count("ntt_pass", t0)

    try:
        sys.setswitchinterval(1e-6)
        for mod in (ck, fk, nk):
            mod.reset_launch_counts()
        with recorder.recording():
            threads = [threading.Thread(target=work) for _ in range(4)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        assert ck.LAUNCHES["jac_add"] == ck.LAUNCHES_BY_WIDTH["jac_add", 8] == 4 * n
        assert fk.LAUNCHES["field_mul"] == fk.LAUNCHES_BY_WIDTH["field_mul", 12] == 4 * n
        assert fk.LAUNCHES_BY_FIELD == {("field_mul", "bls12_381_fr"): 4 * n}
        assert nk.LAUNCHES["ntt_pass"] == 4 * n
        spans = {}
        for q in recorder.requests():
            for k, v in q.root.launches.items():
                spans[k] = spans.get(k, 0) + v
        assert spans == {"jac_add": 4 * n, "field_mul": 4 * n, "ntt_pass": 4 * n}
    finally:
        sys.setswitchinterval(switch)
        for live, old in zip((ck.LAUNCHES, ck.LAUNCHES_BY_WIDTH, fk.LAUNCHES,
                              fk.LAUNCHES_BY_WIDTH, fk.LAUNCHES_BY_FIELD, nk.LAUNCHES), saved):
            live.clear()
            live.update(old)

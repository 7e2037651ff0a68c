"""The benchmark's Merkle configuration (benchmark/configs/merkle16.bn254.2p14.json
and benchmark/circuits/merkle.py) against the program's MiMC and its
Merkle example, with small proofs judged by the benchmark's reference;
and the spans that configuration reads: round 3's sub-phases on the
batch-major quotient, one ``ntt.radix2`` a radix-2 transform, and the
reader of ``radix2_ntt_s``."""

import importlib.util
import json
import pathlib
import random

import pytest

import algoplonk_tpu_torch as apt
from algoplonk_tpu_torch.frontend import witness as witness_mod
from algoplonk_tpu_torch.frontend.api import compile_circuit
from algoplonk_tpu_torch.host import mimc as hm
from algoplonk_tpu_torch.ops import ntt as ntt_mod
from algoplonk_tpu_torch.plonk.marshal import marshal_proof
from algoplonk_tpu_torch.plonk import prove as prove_mod
from algoplonk_tpu_torch.plonk.prove import Prover
from algoplonk_tpu_torch.utils import profiling
from benchmark.core import check as check_mod
from benchmark.core import program_spans
from benchmark.core import spec
from benchmark.reference import curves as RC
from benchmark.reference import frontend as RF
from torch_parity import one_torch_thread, pythagorean  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
CFG = json.loads((REPO / "benchmark" / "configs" / "merkle16.bn254.2p14.json").read_text())
MERKLE = spec.load_module(spec.circuit_file(CFG), "bench_circuit_merkle")
R = apt.BN254.fr.modulus
BATCH_MAJOR_R3 = ["r3.qk", "r3.lifts", "r3.gate", "r3.perm", "r3.inv", "r3.combine",
                  "r3.intt", "r3.commits"]
FOUR_STEP_R3 = ["r3.qk", "r3.lifts", "r3.gate", "r3.inv", "r3.perm", "r3.combine",
                "r3.intt", "r3.commits"]


# ------------------------------------------------------------ the configuration

def test_host_mimc_matches_the_program():
    """The circuit file's MiMC, root and paths are host/mimc.py's on a
    tree of depth 3; its assignment's directions are the index's bits."""
    rng = random.Random(20)
    leaves = [rng.randrange(R) for _ in range(8)]
    root = hm.merkle_root(apt.BN254, leaves)
    assert MERKLE.round_constants("bn254", R) == hm.round_constants("bn254", R)
    assert MERKLE.mimc("bn254", R, leaves[:2]) == hm.mimc_hash(apt.BN254, leaves[:2])
    for index in range(8):
        sibs, dirs = hm.merkle_path(apt.BN254, leaves, index)
        assert dirs == [(index >> i) & 1 for i in range(3)]
        assert MERKLE.root_of("bn254", R, leaves[index], sibs, dirs) == root
    a = MERKLE.assignment({**CFG, "depth": 3}, R, random.Random(3))
    assert set(a["directions"]) <= {0, 1} and len(a["siblings"]) == 3
    assert MERKLE.publics({**CFG, "depth": 3}, R, a) == [a["root"]]


def example_circuit(monkeypatch):
    """examples_torch/merkle's MerkleCircuit at the example's depth, 16
    (the module reads MERKLE_DEPTH at import)."""
    monkeypatch.setenv("MERKLE_DEPTH", "16")
    path = REPO / "examples_torch" / "merkle" / "logicsig_verifier.py"
    sp = importlib.util.spec_from_file_location("merkle_example_depth16", path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.MerkleCircuit


def gates(ccs) -> list:
    return [(g.ql, g.qr, g.qm, g.qo, g.qc, g.l, g.r, g.o) for g in ccs.gates]


@pytest.mark.parametrize("frontend", ["program", "reference"])
def test_depth16_compiles_to_the_configured_size(monkeypatch, frontend):
    """15,985 constraints and 1 public row (n = 2^14) under either
    frontend: the example's own circuit, gate for gate."""
    want = compile_circuit(example_circuit(monkeypatch), apt.BN254)
    if frontend == "program":
        got = compile_circuit(MERKLE.circuit(apt, CFG), apt.BN254)
    else:
        got = RF.compile_circuit(MERKLE.circuit(RF, CFG), RC.CURVES["bn254"])
    assert got.nb_constraints == want.nb_constraints == CFG["constraints"] == 15985
    assert got.nb_public == want.nb_public == 1
    assert (got.nb_constraints + got.nb_public - 1).bit_length() == CFG["log_n"]
    assert gates(got) == gates(want)


def test_depth2_proofs_pass_the_reference_check(monkeypatch):
    """Two fresh paths proved through CompiledCircuit.verify on the CPU are
    judged sound by the benchmark's check; one flipped byte counts one.
    MiMC runs 2 of its rounds here (n = 64), in the circuit, the assignment
    and the reference's account alike: the plain kernels take minutes for
    a proof at 110 rounds (n = 2^11), and the tests above hold the 110."""
    full = MERKLE.round_constants
    monkeypatch.setattr(MERKLE, "round_constants", lambda curve, r: full(curve, r)[:2])
    cfg = {**CFG, "depth": 2}
    P = MERKLE.circuit(apt, cfg)
    cc = apt.compile(P, apt.BN254, apt.SetupName.TEST_ONLY_BN254, device="cpu")
    rng = random.Random(2**31 + 11)
    items = []
    for _ in range(2):
        a = MERKLE.assignment(cfg, R, rng)
        vp = cc.verify(P(**a))
        items.append((a, vp.marshal_proof(), vp.marshal_public_inputs()))
    verdict = check_mod.check(cfg, MERKLE, items, 5)
    assert verdict["bad_proofs"] == 0 and verdict["blinding_checked"] == 2
    a, proof, pub = items[0]
    flipped = bytearray(proof)
    flipped[len(flipped) // 2] ^= 0x01
    verdict = check_mod.check(cfg, MERKLE, [(a, bytes(flipped), pub), items[1]], 5)
    assert verdict["bad_proofs"] == 1


# ------------------------------------------------------------ the spans

@pytest.fixture(scope="module")
def proved():
    """Prover(rng=False) proofs of a small circuit on each quotient path,
    with recording off and on: {path: (bytes off, bytes on, the recorded
    request, the log2 size of each radix-2 transform called)}."""
    T = pythagorean(apt)
    cc = apt.compile(T, apt.BN254, apt.SetupName.TEST_ONLY_BN254, device="cpu")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(profiling, "RECORDER", profiling.Recorder())
        mp.delenv("AP_PROVE_PROFILE", raising=False)
        calls = []
        transform = ntt_mod.NttPlan._transform

        def counted(plan, a, inverse):
            calls.append(plan.log_n)
            return transform(plan, a, inverse)

        mp.setattr(ntt_mod.NttPlan, "_transform", counted)
        # LM_MIN_LOG 64: above any coset
        for path, min_log in (("batch_major", 64), ("four_step", 0)):
            mp.setattr(prove_mod, "LM_MIN_LOG", min_log)
            proofs = []
            for on in (False, True):
                calls.clear()
                prover = Prover(cc.pk, cc.ccs, rng=False)
                wit = witness_mod.solve(cc.ccs, T(a=3, b=4, c=5),
                                        commitment_solver=prover.bsb_solver)
                if on:
                    profiling.RECORDER.enable()
                proofs.append(marshal_proof(apt.BN254, prover.prove(wit)))
                profiling.RECORDER.disable()
            (q,) = profiling.RECORDER.requests(last=1)
            out[path] = (*proofs, q, list(calls))
        assert len(profiling.RECORDER.requests()) == 2
    return cc.pk.log_n, out


@pytest.mark.parametrize("path,want", [("batch_major", BATCH_MAJOR_R3),
                                       ("four_step", FOUR_STEP_R3)])
def test_round3_sub_phases_on_either_path(proved, path, want):
    _, out = proved
    q = out[path][2]
    r3 = next(sp for sp in q.spans if sp.name == "r3")
    subs = [sp for sp in q.spans if sp.parent is r3]
    assert [sp.name for sp in subs] == want
    assert all(a.end == b.start for a, b in zip(subs, subs[1:]))
    assert sum(sp.name == "transcript" and sp.parent.name == "r3.qk" for sp in q.spans) == 1


def test_each_radix2_transform_is_one_span(proved):
    """One ``ntt.radix2`` a call of the plan's transform: on the
    batch-major path round 3's 4n lifts and coset iNTT among them, on the
    four-step path the size-n iNTTs alone."""
    log_n, out = proved
    *_, q, calls = out["batch_major"]
    spans = [sp for sp in q.spans if sp.name == "ntt.radix2"]
    # r1's three iNTTs, r2's z and r3's qk at n; thirteen lifts and the
    # iNTT at 4n
    assert calls == [log_n] * 5 + [log_n + 2] * 14 and len(spans) == len(calls)
    assert [sp.parent.name for sp in spans] == ["r1"] * 3 + ["r2", "r3.qk"] + (
        ["r3.lifts"] * 3 + ["r3.gate"] * 5 + ["r3.perm"] * 5 + ["r3.intt"])
    *_, q, calls = out["four_step"]
    spans = [sp for sp in q.spans if sp.name == "ntt.radix2"]
    assert calls == [log_n] * 5 and len(spans) == 5
    rec = profiling.Recorder()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(profiling, "RECORDER", rec)
        with rec.recording(), profiling.request("verify"):
            plan = ntt_mod.ntt_plan("bn254", 3, "cpu")
            plan.intt(plan.coset_ntt(plan.tw_fwd.new_zeros((8, plan.f.W)), 5))
    assert [sp.name for sp in rec.requests()[0].spans] == ["verify"] + ["ntt.radix2"] * 2


@pytest.mark.parametrize("path", ["batch_major", "four_step"])
def test_recording_leaves_the_bytes(proved, path):
    off, on, *_ = proved[1][path]
    assert on == off


def test_radix2_reader(proved, monkeypatch):
    """benchmark/metrics/radix2_ntt_s.py: the window's ``ntt.radix2``
    seconds per proof, and None from requests without the span or from no
    requests."""
    _, out = proved
    reader = spec.metric_reader("radix2_ntt_s")
    reqs = [out[path][2] for path in ("batch_major", "four_step")]
    monkeypatch.setattr(program_spans, "window_requests", lambda run: reqs)
    want = sum(sp.seconds for q in reqs for sp in q.spans if sp.name == "ntt.radix2") / 2
    assert want > 0 and reader.read(None) == pytest.approx(want)
    bare = profiling.Request(1, 1)
    bare.spans.append(reqs[0].root)
    monkeypatch.setattr(program_spans, "window_requests", lambda run: [bare])
    assert reader.read(None) is None
    monkeypatch.setattr(program_spans, "window_requests", lambda run: None)
    assert reader.read(None) is None

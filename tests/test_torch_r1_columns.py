"""Round 1's columns and the blinding, as the prover builds them on the
device: the wire columns gathered from the witness encoded once
(``plonk/prove.py:wire_columns`` by ``frontend/witness.py:wire_index``)
word for word ``FieldOps.encode`` of ``wire_values``' host columns; the
sparse ``Prover._blind`` against the dense formula coeffs + (b_0 + b_1 X +
...)(X^n - 1) on host ints and against the dense device sum; the key's
index maps through setup, ``ProvingKey.to`` and a cache file; seeded proofs
whose bytes are pinned; and the recorder's ``host_ints`` count of what the
host still packs, with the benchmark's reader of it.

The file imports no jax; its ``cuda`` tests run on the card with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_r1_columns.py
"""

import hashlib
import random

import pytest
import torch

import algoplonk_tpu_torch as apt
from algoplonk_tpu_torch.frontend import witness as witness_mod
from algoplonk_tpu_torch.frontend.api import compile_circuit
from algoplonk_tpu_torch.ops import poly as polyops
from algoplonk_tpu_torch.ops.field import field_ops
from algoplonk_tpu_torch.plonk import verify as V
from algoplonk_tpu_torch.plonk.marshal import marshal_proof
from algoplonk_tpu_torch.plonk.prove import Prover, wire_columns
from algoplonk_tpu_torch.setups.registry import next_power_of_two
from algoplonk_tpu_torch.utils import profiling
from algoplonk_tpu_torch.utils.cache import read_compiled_circuit, write_compiled_circuit
from torch_parity import cuda_device, one_commit, one_torch_thread, pythagorean  # noqa: F401

TPyth, TOne = pythagorean(apt), one_commit(apt)
SETUPS = {"BN254": "TEST_ONLY_BN254", "BLS12_381": "TEST_ONLY_BLS12_381"}
CIRCUITS = {"pythagorean": (TPyth, dict(a=3, b=4, c=5)), "one_commit": (TOne, dict(x=49, y=7))}

# sha256 of marshal_proof of Prover(rng=random.Random(seed)) proofs, made by
# the prover that encoded n-row host columns and blinded with dense ones
SEEDED = {
    ("BN254", "pythagorean", 7):
        "60d004a60eb41b706654e538d5a390714580e4ce1c590d2021a4a7f8dc675013",
    ("BN254", "pythagorean", 2**40 + 3):
        "300aded489ae30f5c1bbb3567f5c4b0a83b235a1c430afeb807bdce9b6bba88d",
    ("BLS12_381", "pythagorean", 7):
        "9dd7b3d02a9417e69865c0114cf710db830cdd87466a29851fa27241ea9efddc",
    ("BN254", "one_commit", 7):
        "8a14caf93cdfd5fb9fe627c89d838a5c1d68ae3405847c81aa6472b61e83e0f2",
    ("BN254", "one_commit", 2**40 + 3):
        "c03caecf6415155ec38fe93c32e4fc6e9106ae41e493d7ba67a386059cc45c0a",
}


def solved(curve: str, circuit: str):
    """(ccs, witness, n) of a circuit without keys: the commitment's value is
    any field element (the solver's check skips its rows)."""
    cls, assign = CIRCUITS[circuit]
    ccs = compile_circuit(cls, getattr(apt, curve))
    wit = witness_mod.solve(ccs, cls(**assign), commitment_solver=lambda info, vals: 12345)
    return ccs, wit, next_power_of_two(ccs.nb_constraints + ccs.nb_public)


def check_columns(curve: str, circuit: str, device) -> None:
    ccs, wit, n = solved(curve, circuit)
    f = field_ops(getattr(apt, curve).fr, device)
    rows = torch.from_numpy(witness_mod.wire_index(ccs, n)).to(device)
    got = wire_columns(f, wit.values, rows)
    want = witness_mod.wire_values(ccs, wit, n)
    for col, ints in zip(got, want):
        assert col.shape == (n, f.W) and col.is_contiguous()
        assert torch.equal(col, f.encode(ints))


@pytest.mark.parametrize("circuit", list(CIRCUITS))
@pytest.mark.parametrize("curve", list(SETUPS))
def test_wire_columns_equal_encoded_wire_values(curve, circuit):
    """Public rows, the gates (a BSB22 commitment's among them) and padding
    rows, on the CPU's FieldOps."""
    ccs, _, n = solved(curve, circuit)
    assert ccs.nb_public >= 1 and ccs.nb_public + len(ccs.gates) < n
    assert bool(ccs.commitments) == (circuit == "one_commit")
    check_columns(curve, circuit, "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("curve", list(SETUPS))
def test_wire_columns_on_the_card(cuda_device, curve):
    for circuit in CIRCUITS:
        check_columns(curve, circuit, cuda_device)


def test_wire_index_reads_what_wire_values_writes():
    ccs, wit, n = solved("BN254", "one_commit")
    idx = witness_mod.wire_index(ccs, n)
    vals = wit.values + [0]
    assert idx.shape == (3, n) and idx.dtype.name == "int64"
    assert [[vals[v] for v in col] for col in idx] == [
        list(c) for c in witness_mod.wire_values(ccs, wit, n)]
    assert (idx[:, ccs.nb_public + len(ccs.gates):] == ccs.nb_vars).all()


@pytest.fixture(scope="module", params=list(SETUPS))
def compiled(request):
    curve = request.param
    return curve, apt.compile(TPyth, getattr(apt, curve), getattr(apt.SetupName, SETUPS[curve]),
                              device="cpu")


def dense_blind(prover, coeffs, bs):
    """The blinding as it was: an n + nb row column of host ints, encoded and
    added whole."""
    n, r = prover.pk.n, prover.r
    ext = [0] * (n + len(bs))
    for i, b in enumerate(bs):
        ext[i] = (ext[i] - b) % r
        ext[n + i] = (ext[n + i] + b) % r
    return prover.f.add(polyops.pad_rows(coeffs, n + len(bs)), prover.f.encode(ext))


def check_blind(cc, device, nb: int, seed: int) -> None:
    pk = cc.pk.to(device)
    prover = Prover(pk, cc.ccs, rng=random.Random(seed))
    n, r, f = pk.n, prover.r, prover.f
    draw = random.Random(seed)
    bs = [draw.randrange(r) for _ in range(nb)]
    vals = random.Random(seed + 1)
    ints = [vals.randrange(r) for _ in range(n)]
    ints[:3] = [0, 1, r - 1]
    coeffs = f.encode(ints)
    out = prover._blind(coeffs, nb)
    want = [(c + sum(bs[k] for k in range(nb) if i - k == n) - (bs[i] if i < nb else 0)) % r
            for i, c in enumerate(ints + [0] * nb)]
    assert out.shape == (n + nb, f.W)
    assert f.decode(out) == want
    assert torch.equal(out, dense_blind(prover, coeffs, bs))
    assert torch.equal(coeffs, f.encode(ints))          # the input is left as it was


@pytest.mark.parametrize("nb", [2, 3])
def test_blind_equals_the_dense_formula(compiled, nb):
    """coeffs + (b_0 + b_1 X + ...)(X^n - 1) on host ints, and the dense
    device sum word for word, with the prover's own seeded draws."""
    check_blind(compiled[1], "cpu", nb, seed=2**33 + nb)


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [2, 3])
def test_blind_on_the_card(cuda_device, compiled, nb):
    check_blind(compiled[1], cuda_device, nb, seed=2**35 + nb)


def test_unblinded_prover_returns_the_input(compiled):
    cc = compiled[1]
    prover = Prover(cc.pk, cc.ccs, rng=False)
    coeffs = prover.f.encode(list(range(cc.pk.n)))
    assert prover._blind(coeffs, 2) is coeffs and prover._blind(coeffs, 3) is coeffs


def test_the_key_carries_its_wire_rows(compiled, tmp_path):
    """Setup builds the maps, ``to`` moves them, a key read from a cache
    file (which holds none) gets them from its first Prover, once."""
    cc = compiled[1]
    want = torch.from_numpy(witness_mod.wire_index(cc.ccs, cc.pk.n))
    assert torch.equal(cc.pk.wire_rows, want) and cc.pk.wire_rows.dtype == torch.long
    moved = cc.pk.to("meta")
    assert moved.wire_rows.device.type == "meta" and cc.pk.wire_rows.device.type == "cpu"
    path = str(tmp_path / "cc.bin")
    write_compiled_circuit(cc, path)
    read = read_compiled_circuit(path, device="cpu")
    assert read.pk.wire_rows is None
    Prover(read.pk, read.ccs, rng=False)
    built = read.pk.wire_rows
    assert torch.equal(built, want)
    Prover(read.pk, read.ccs, rng=False)
    assert read.pk.wire_rows is built


@pytest.mark.parametrize("curve,circuit,seed", list(SEEDED), ids=[
    f"{c}-{k}-{s}" for c, k, s in SEEDED])
def test_seeded_proof_bytes_are_pinned(curve, circuit, seed):
    cls, assign = CIRCUITS[circuit]
    c = getattr(apt, curve)
    cc = apt.compile(cls, c, getattr(apt.SetupName, SETUPS[curve]), device="cpu")
    prover = Prover(cc.pk, cc.ccs, rng=random.Random(seed))
    wit = witness_mod.solve(cc.ccs, cls(**assign), commitment_solver=prover.bsb_solver)
    proof = prover.prove(wit)
    assert V.verify(cc.vk, proof, wit.public_values)
    assert hashlib.sha256(marshal_proof(c, proof)).hexdigest() == SEEDED[(curve, circuit, seed)]


@pytest.fixture
def recorder(monkeypatch):
    rec = profiling.Recorder()
    monkeypatch.setattr(profiling, "RECORDER", rec)
    monkeypatch.delenv("AP_PROVE_PROFILE", raising=False)
    return rec


def test_host_ints_charged_by_span(recorder):
    """A BSB22 ``CompiledCircuit.verify``: ``wires`` packs the witness once,
    r1 and r2 pack at most nb_vars + 64 ints, and the solve's commitment
    packs its committed values."""
    cc = apt.compile(TOne, apt.BN254, apt.SetupName.TEST_ONLY_BN254, device="cpu")
    with recorder.recording():
        vp = cc.verify(TOne(x=49, y=7))
    (q,) = recorder.requests()
    ints: dict = {}
    for sp in q.spans:
        ints[sp.name] = ints.get(sp.name, 0) + sp.host_ints
    nb_vars = cc.ccs.nb_vars
    assert ints["wires"] == nb_vars
    assert ints["r1"] == 3 * 2 * 2                      # three blinds of 2 nb words
    r12 = sum(sp.host_ints for sp in q.spans if in_round(sp, ("r1", "r2")))
    assert nb_vars < r12 <= nb_vars + 64
    assert ints["bsb_commit"] == len(cc.ccs.commitments[0].committed_vars)
    assert V.verify(cc.vk, vp.proof, [49])


def in_round(sp, rounds) -> bool:
    while sp is not None:
        if sp.name in rounds:
            return True
        sp = sp.parent
    return False


def test_host_ints_count_nothing_while_off(recorder):
    f = field_ops(apt.BN254.fr, "cpu")
    f.encode([1, 2, 3])
    with recorder.recording():
        with profiling.request("verify"):
            f.encode([4, 5])
            with profiling.span("wires"):
                f.encode([6, 7, 8])
    (q,) = recorder.requests()
    assert [(sp.name, sp.host_ints) for sp in q.spans] == [("verify", 2), ("wires", 3)]


def test_host_ints_reader(recorder, monkeypatch):
    """benchmark/metrics/host_ints_per_proof.py: the ints of the window's
    requests per proof, and None from spans without the count."""
    from benchmark.core import spec

    reader = spec.metric_reader("host_ints_per_proof")
    reqs = []
    for rid, wires in ((1, 100), (2, 300)):
        q = profiling.Request(rid, 1)
        for name, parent, n in (("verify", None, 4), ("prove", 0, 0), ("r1", 1, 12),
                                ("wires", 2, wires)):
            sp = profiling.Span(name, rid, q.spans[parent] if parent is not None else None,
                                rid, 1, None)
            sp.end, sp.host_ints = rid + 1, n
            q.spans.append(sp)
        reqs.append(q)
    monkeypatch.setitem(reader.read.__globals__, "window_requests", lambda run: reqs)
    assert reader.read(None) == (4 + 12 + 100 + 4 + 12 + 300) / 2

    class Bare:                     # a span of a program without the count
        __slots__ = ("name", "parent")

    reqs[0].spans.append(Bare())
    assert reader.read(None) is None
    monkeypatch.setitem(reader.read.__globals__, "window_requests", lambda run: None)
    assert reader.read(None) is None

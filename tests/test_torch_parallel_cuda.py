"""The checks of tests/test_torch_parallel.py and
tests/test_torch_parallel_prove.py on the card: a mesh of four shards on
one GPU (``Mesh([cuda:0] * 4)``), whose sharded NTT and MSM run the real
kernels (K9; K1-K3 and the field kernels), held to the single-device
results on the same card and to host arithmetic, and batch proving with
one CUDA stream per worker.

These tests need an NVIDIA GPU and skip elsewhere.  The file imports no
jax, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_parallel_cuda.py
"""

import random

import pytest
import torch

import algoplonk_tpu_torch as apt
from algoplonk_tpu_torch.frontend import witness as witness_mod
from algoplonk_tpu_torch.ops import msm as M
from algoplonk_tpu_torch.ops import ntt_kernels as nk
from algoplonk_tpu_torch.ops.field import field_ops
from algoplonk_tpu_torch.ops.ntt import ntt_plan
from algoplonk_tpu_torch.parallel import Mesh, all_gather, prove_batch, sharded_ntt_fn
from algoplonk_tpu_torch.parallel.msm_sharded import sharded_commit
from algoplonk_tpu_torch.plonk import prove as prove_mod
from algoplonk_tpu_torch.plonk import verify as V
from algoplonk_tpu_torch.plonk.marshal import marshal_proof
from algoplonk_tpu_torch.plonk.prove import Prover
from torch_parity import cuda_device, sample_points  # noqa: F401

pytestmark = pytest.mark.cuda

NDEV = 4
CURVES = {"bn254": apt.BN254, "bls12_381": apt.BLS12_381}


@pytest.fixture
def mesh(cuda_device):
    return Mesh([cuda_device] * NDEV)


@pytest.mark.parametrize("coset", [False, True], ids=["plain", "coset"])
@pytest.mark.parametrize("inverse", [False, True], ids=["ntt", "intt"])
@pytest.mark.parametrize("name", ["bn254", "bls12_381"])
def test_sharded_ntt_on_card(cuda_device, mesh, name, inverse, coset):
    """Equal word for word to the single-device radix-2 plan, in two K9
    launches per shard."""
    curve = CURVES[name]
    log_n = 12
    g = curve.coset_shift if coset else None
    f = field_ops(curve.fr, cuda_device)
    rng = random.Random(log_n + 2 * inverse + coset)
    x = f.encode([rng.randrange(curve.fr.modulus) for _ in range(1 << log_n)])
    fn, (n1, n2) = sharded_ntt_fn(name, mesh, "x", log_n, inverse=inverse, coset_shift=g)
    before = nk.LAUNCHES["ntt_pass"]
    parts = fn(mesh.shard(x.reshape(n1, n2, f.W).transpose(0, 1), 0))
    assert nk.LAUNCHES["ntt_pass"] - before == 2 * NDEV
    got = all_gather(parts, cuda_device).reshape(-1, f.W)
    plan = ntt_plan(name, log_n, cuda_device)
    if coset:
        want = plan.coset_intt(x, g) if inverse else plan.coset_ntt(x, g)
    else:
        want = plan.intt(x) if inverse else plan.ntt(x)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", [37, 4099])
@pytest.mark.parametrize("name", ["bn254", "bls12_381"])
def test_sharded_msm_on_card(cuda_device, mesh, name, n):
    """The prover's bucket padding; equal to the single-device MSM (host
    Pippenger at n = 37, the kernel path at n = 4,099) and at n = 37 to the
    host Pippenger directly."""
    curve = CURVES[name]
    pts = sample_points(random.Random(n), curve, 64)
    pts = (pts * (-(-n // 64)))[:n]
    ctx = M.msm_ctx(curve, cuda_device)
    points = ctx.ops.encode_affine(pts)
    rng = random.Random(n + 1)
    scalars = [rng.randrange(curve.fr.modulus) for _ in range(n)]
    mont = ctx.fr.encode(scalars)
    got = sharded_commit(curve, mesh, "x", points, mont)
    assert got == ctx.msm_to_affine_int(points, mont, kind="mont")
    if n <= M.HOST_MSM_MAX:
        assert got == M.host_msm(curve, pts, scalars)


def square_chain(log_n: int):
    chain = (1 << log_n) - 3

    class SquareChain(apt.Circuit):
        y = apt.PublicInput()
        x = apt.SecretInput()

        def define(self, api):
            t = self.x
            for _ in range(chain):
                t = api.mul(t, t)
            api.assert_is_equal(t, self.y)

    return SquareChain, chain


def test_sharded_prove_on_card(cuda_device, mesh):
    """Byte-equal to the single-device prove, every NTT sharded."""
    SquareChain, chain = square_chain(10)
    r = apt.BN254.fr.modulus
    cc = apt.compile(SquareChain, apt.BN254, apt.SetupName.TEST_ONLY_BN254, device=cuda_device)
    assignment = SquareChain(x=0xBEEF, y=pow(0xBEEF, 1 << chain, r))
    proofs = {}
    for m in (None, mesh):
        prover = Prover(cc.pk, cc.ccs, rng=False, mesh=m)
        wit = witness_mod.solve(cc.ccs, assignment, commitment_solver=prover.bsb_solver)
        proofs[m is None] = prover.prove(wit)
    assert prover.sharded_ntt_hits == 19
    assert marshal_proof(apt.BN254, proofs[False]) == marshal_proof(apt.BN254, proofs[True])
    assert V.verify(cc.vk, proofs[False], wit.public_values)


@pytest.mark.parametrize("workers", [1, 4])
def test_prove_batch_on_card(cuda_device, workers):
    """Four witnesses on one card, one stream per worker: each proof is the
    sequential prover's byte for byte."""
    SquareChain, chain = square_chain(10)
    r = apt.BN254.fr.modulus
    cc = apt.compile(SquareChain, apt.BN254, apt.SetupName.TEST_ONLY_BN254, device=cuda_device)
    xs = [0xA1607 + i for i in range(4)]
    ys = [pow(x, 1 << chain, r) for x in xs]
    vps = prove_batch(cc, [SquareChain(x=x, y=y) for x, y in zip(xs, ys)],
                      devices=[cuda_device] * workers, rng=False)
    for x, y, vp in zip(xs, ys, vps):
        prover = Prover(cc.pk, cc.ccs, rng=False)
        wit = witness_mod.solve(cc.ccs, SquareChain(x=x, y=y), commitment_solver=prover.bsb_solver)
        assert marshal_proof(apt.BN254, prover.prove(wit)) == vp.marshal_proof()
        assert int.from_bytes(vp.marshal_public_inputs(), "big") == y


def test_prove_batch_evicting_quotient_on_card(cuda_device, monkeypatch):
    """Two workers on one card share the four-step plan of the round-3
    quotient while each evicts its tables at every prove (EVICT_MIN_LOG
    0): every proof is the sequential prover's
    without eviction, byte for byte."""
    SquareChain, chain = square_chain(12)
    r = apt.BN254.fr.modulus
    cc = apt.compile(SquareChain, apt.BN254, apt.SetupName.TEST_ONLY_BN254, device=cuda_device)
    xs = [0xA1607 + i for i in range(6)]
    assignments = [SquareChain(x=x, y=pow(x, 1 << chain, r)) for x in xs]
    monkeypatch.setenv("AP_QUOTIENT_LM", "1")
    want = []
    for a in assignments:
        prover = Prover(cc.pk, cc.ccs, rng=False)
        wit = witness_mod.solve(cc.ccs, a, commitment_solver=prover.bsb_solver)
        want.append(marshal_proof(apt.BN254, prover.prove(wit)))
    drops = []
    keep = nk.FourStepPlan.drop_tables

    def spy(plan, inverse=None):
        drops.append(inverse)
        keep(plan, inverse)

    monkeypatch.setattr(nk.FourStepPlan, "drop_tables", spy)
    monkeypatch.setattr(prove_mod, "EVICT_MIN_LOG", 0)
    vps = prove_batch(cc, assignments, devices=[cuda_device] * 2, rng=False)
    assert len(drops) == 2 * len(assignments)
    assert [vp.marshal_proof() for vp in vps] == want


def test_prove_batch_records_a_tree_a_proof_on_card(cuda_device):
    """Four workers on one card with the recorder on: one request a proof,
    each whole on its worker's thread (solve, prove with r1..r5,
    self-verify), and the launch counters, exact under the threads, equal
    the launches charged to the spans."""
    from algoplonk_tpu_torch.ops import curve_kernels as ck
    from algoplonk_tpu_torch.ops import field_kernels as fk
    from algoplonk_tpu_torch.utils import profiling

    SquareChain, chain = square_chain(10)
    r = apt.BN254.fr.modulus
    cc = apt.compile(SquareChain, apt.BN254, apt.SetupName.TEST_ONLY_BN254, device=cuda_device)
    xs = [0xA1607 + i for i in range(4)]

    def launched():
        return sum(ck.LAUNCHES.values()) + sum(fk.LAUNCHES.values()) + sum(nk.LAUNCHES.values())

    before = launched()
    since = profiling.clock()
    with profiling.RECORDER.recording():
        prove_batch(cc, [SquareChain(x=x, y=pow(x, 1 << chain, r)) for x in xs],
                    devices=[cuda_device] * 4, rng=False)
    torch.cuda.synchronize()
    reqs = profiling.RECORDER.requests(since_ns=since)
    assert len(reqs) == 4 and len({q.thread for q in reqs}) == 4
    for q in reqs:
        assert [sp.name for sp in q.spans if sp.parent is q.root] == ["solve", "prove",
                                                                      "self_verify"]
        assert [sp.name for sp in q.spans if sp.parent and sp.parent.name == "prove"] == [
            "r1", "r2", "r3", "r4", "r5"]
        assert {sp.thread for sp in q.spans} == {q.thread}
    charged = sum(sum(sp.launches.values()) for q in reqs for sp in q.spans)
    assert charged == launched() - before > 0


def test_prove_batch_default_devices(cuda_device):
    """Without a device list the batch runs on every card torch finds."""
    SquareChain, chain = square_chain(4)
    r = apt.BN254.fr.modulus
    cc = apt.compile(SquareChain, apt.BN254, apt.SetupName.TEST_ONLY_BN254, device=cuda_device)
    vps = prove_batch(cc, [SquareChain(x=3, y=pow(3, 1 << chain, r))])
    assert len(vps) == 1 and V.verify(cc.vk, vps[0].proof, vps[0].witness.public_values)

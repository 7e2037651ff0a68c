"""The port's sharded NTT, sharded MSM and batch proving
(algoplonk_tpu_torch/parallel/) against the JAX reference, on a mesh of
four CPU shards (``Mesh(["cpu"] * 4)``) beside the reference's 4-device
virtual CPU mesh (tests/conftest.py).  Inputs come from numpy seeds, and
every comparison is of decoded ints, exact.  The sharded prove is in
tests/test_torch_parallel_prove.py, the same checks on the card in
tests/test_torch_parallel_cuda.py."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh, NamedSharding, PartitionSpec as P

import algoplonk_tpu as ap
import algoplonk_tpu_torch as apt
from algoplonk_tpu.ops.msm import host_msm as jax_host_msm
from algoplonk_tpu.ops.ntt import ntt_plan as jax_ntt_plan
from algoplonk_tpu.parallel.ntt_sharded import sharded_ntt_fn as jax_sharded_ntt_fn
from algoplonk_tpu_torch.frontend import witness as witness_mod
from algoplonk_tpu_torch.host import fp as hfp
from algoplonk_tpu_torch.ops import msm as M
from algoplonk_tpu_torch.ops.curve import curve_ops
from algoplonk_tpu_torch.ops.field import field_ops
from algoplonk_tpu_torch.parallel import (
    Mesh, all_gather, all_to_all, prove_batch, sharded_msm_fn, sharded_ntt_fn)
from algoplonk_tpu_torch.parallel.msm_sharded import sharded_commit
from algoplonk_tpu_torch.parallel.ntt_sharded import output_to_natural, reference_layout
from algoplonk_tpu_torch.plonk.marshal import marshal_proof
from algoplonk_tpu_torch.plonk.prove import Prover
from torch_parity import one_torch_thread, pythagorean  # noqa: F401

NDEV = 4
CURVES = {"bn254": (ap.BN254, apt.BN254), "bls12_381": (ap.BLS12_381, apt.BLS12_381)}


@pytest.fixture(scope="module")
def jax_mesh():
    devs = jax.devices("cpu")
    if len(devs) < NDEV:
        pytest.skip("needs the virtual 8-device CPU mesh of tests/conftest.py")
    return JaxMesh(np.array(devs[:NDEV]), ("x",))


@pytest.fixture(scope="module")
def mesh():
    return Mesh(["cpu"] * NDEV)


def residues(seed: int, n: int, modulus: int) -> list[int]:
    """n residues below modulus from a numpy seed (four 64-bit draws each)."""
    words = np.random.default_rng(seed).integers(0, 1 << 63, size=(n, 4), dtype=np.int64)
    return [int(sum(int(w) << (63 * k) for k, w in enumerate(row))) % modulus for row in words]


def matrix_layout(xs, n1, n2):
    """x[j1 n2 + j2] -> the [j2, j1] order, flattened."""
    return reference_layout(xs, n1, n2).reshape(-1).tolist()


def port_sharded(curve, mesh, log_n, xs, inverse=False, coset_shift=None):
    """The port's sharded transform of the flat vector xs -> flat ints."""
    fn, (n1, n2) = sharded_ntt_fn(curve.name, mesh, "x", log_n, inverse=inverse,
                                  coset_shift=coset_shift)
    f = field_ops(curve.fr, "cpu")
    x = f.encode(matrix_layout(xs, n1, n2)).reshape(n2, n1, f.W)
    return f.decode(output_to_natural(all_gather(fn(mesh.shard(x, 0)), "cpu")))


@pytest.mark.parametrize("split_dim,concat_dim", [(1, 0), (0, 1), (2, 1)])
def test_all_to_all_matches_jax(jax_mesh, mesh, split_dim, concat_dim):
    """The collective's layout is jax.lax.all_to_all's with tiled=False."""
    local = [2, 3, 5]
    local[split_dim] = NDEV
    x = np.random.default_rng(7).integers(-(1 << 31), 1 << 31, size=[NDEV * local[0]] + local[1:],
                                          dtype=np.int64).astype(np.int32)
    step = jax.shard_map(
        lambda v: jax.lax.all_to_all(v, "x", split_dim, concat_dim, tiled=False),
        mesh=jax_mesh, in_specs=P("x"), out_specs=P("x"), check_vma=False)
    want = np.asarray(step(jax.device_put(x, NamedSharding(jax_mesh, P("x")))))
    got = all_gather(all_to_all(mesh.shard(torch.from_numpy(x), 0), split_dim, concat_dim), "cpu")
    assert np.array_equal(got.numpy(), want)


def test_sharded_ntt_matches_reference(jax_mesh, mesh):
    """Forward, BN254, log_n = 6: the port's sharded NTT equals the
    reference's sharded_ntt_fn, in the same [j2, j1] -> [k2, k1] layout."""
    jcurve, curve = CURVES["bn254"]
    log_n = 6
    xs = residues(60, 1 << log_n, curve.fr.modulus)
    jfn, (n1, n2) = jax_sharded_ntt_fn("bn254", jax_mesh, "x", log_n)
    jf = jax_ntt_plan("bn254", log_n).f
    jx = jf.encode(matrix_layout(xs, n1, n2)).reshape(n2, n1, jf.L)
    want = jf.decode(np.asarray(jfn(jax.device_put(jx, NamedSharding(jax_mesh, P("x")))))
                     .reshape(-1, jf.L))
    assert port_sharded(curve, mesh, log_n, xs) == want


@pytest.mark.parametrize("coset", [False, True], ids=["plain", "coset"])
@pytest.mark.parametrize("inverse", [False, True], ids=["ntt", "intt"])
@pytest.mark.parametrize("name", ["bn254", "bls12_381"])
def test_sharded_transforms_match_reference_plan(mesh, name, inverse, coset):
    """Each variant equals the reference's single-device plan (ntt, intt,
    coset_ntt, coset_intt), and the opposite sharded transform brings the
    input back exactly."""
    jcurve, curve = CURVES[name]
    log_n = 6
    g = curve.coset_shift if coset else None
    xs = residues(61 + 2 * inverse + coset, 1 << log_n, curve.fr.modulus)
    got = port_sharded(curve, mesh, log_n, xs, inverse, g)
    jp = jax_ntt_plan(name, log_n)
    jx = jp.f.encode(xs)
    if coset:
        want = jp.coset_intt(jx, g) if inverse else jp.coset_ntt(jx, g)
    else:
        want = jp.intt(jx) if inverse else jp.ntt(jx)
    assert got == jp.f.decode(want)
    assert port_sharded(curve, mesh, log_n, got, not inverse, g) == xs


@pytest.mark.parametrize("n", [8 * NDEV, 37], ids=["n32-c5", "n37-bucket256"])
@pytest.mark.parametrize("name", ["bn254", "bls12_381"])
def test_sharded_msm_matches_host(mesh, name, n):
    """The sharded MSM equals hfp.ec_mul of the summed scalar and the
    reference's host_msm: straight at c = 5 where the shards divide n (as
    tests/test_parallel.py), else as the prover commits (``sharded_commit``:
    the bucket of 256 points, zero padding, c = 7)."""
    jcurve, curve = CURVES[name]
    F = hfp.GF(curve.fp.modulus)
    pts = [hfp.ec_mul(F, curve.g1, i + 1) for i in range(n)]
    scalars = residues(70 + n, n, curve.fr.modulus)
    points = curve_ops(curve, "cpu").encode_affine(pts)
    if n % NDEV == 0:
        digits = torch.from_numpy(M.scalar_digits(scalars, c=5))
        fn = sharded_msm_fn(curve, mesh, "x", n, digits.shape[0], 5)
        got = fn(mesh.shard(points, 0), mesh.shard(digits, 1))
    else:
        got = sharded_commit(curve, mesh, "x", points, field_ops(curve.fr, "cpu").encode(scalars))
    want = hfp.ec_mul(F, curve.g1, sum(s * (i + 1) for i, s in enumerate(scalars)) % curve.fr.modulus)
    assert got == want
    assert got == jax_host_msm(jcurve, pts, scalars)


def test_sharded_msm_refuses_indivisible_n(mesh):
    with pytest.raises(ValueError, match="do not split"):
        sharded_msm_fn(apt.BN254, mesh, "x", 8 * NDEV + 2, M.num_windows(5), 5)


def test_sharded_ntt_refuses_indivisible_factors(mesh):
    with pytest.raises(ValueError, match="do not split"):
        sharded_ntt_fn("bn254", mesh, "x", 2)   # 2 x 2 over 4 shards


@pytest.mark.parametrize("what", ["mesh", "prove_batch"])
def test_cuda_without_card_raises(monkeypatch, what):
    """No fallback: a CUDA mesh, or a batch on the default devices, raises
    where torch finds no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if what == "mesh":
            Mesh(["cuda:0"] * NDEV)
        else:
            prove_batch(None, [])


def test_prove_batch_matches_sequential(monkeypatch):
    """Four witnesses over two CPU workers, blinding off: each proof is the
    sequential prover's byte for byte, in assignment order, with its
    public inputs.  A proof that the self-verify rejects (here one made for
    other public inputs) raises, naming its index; without the self-verify
    it is returned."""
    Pyth = pythagorean(apt)
    cc = apt.compile(Pyth, apt.BN254, apt.SetupName.TEST_ONLY_BN254, device="cpu")
    triples = [(3, 4, 5), (5, 12, 13), (8, 15, 17), (7, 24, 25)]
    vps = prove_batch(cc, [Pyth(a=a, b=b, c=c) for a, b, c in triples],
                      devices=["cpu"] * 2, rng=False)
    assert len(vps) == len(triples)
    for (a, b, c), vp in zip(triples, vps):
        pub = vp.marshal_public_inputs()
        assert (int.from_bytes(pub[:32], "big"), int.from_bytes(pub[32:], "big")) == (a, b)
        prover = Prover(cc.pk, cc.ccs, rng=False)
        wit = witness_mod.solve(cc.ccs, Pyth(a=a, b=b, c=c), commitment_solver=prover.bsb_solver)
        assert marshal_proof(apt.BN254, prover.prove(wit)) == vp.marshal_proof()
    monkeypatch.setattr(Prover, "prove", lambda self, wit: vps[0].proof)
    second = [Pyth(a=a, b=b, c=c) for a, b, c in triples[:2]]
    with pytest.raises(RuntimeError, match="^proof 1 failed native verification$"):
        prove_batch(cc, second, devices=["cpu"])
    (stale,) = prove_batch(cc, second[1:], devices=["cpu"], self_verify=False)
    assert stale.proof is vps[0].proof

"""The four CUDA MSM kernels (csrc/msm_kernels.cu) on the GPU, word for
word against their plain PyTorch versions, and the device MSM and a small
proof against host arithmetic and the CPU.

These tests need an NVIDIA GPU and skip elsewhere.  The file imports no jax,
so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py
"""

import random

import pytest
import torch

import algoplonk_tpu_torch as apt
from algoplonk_tpu_torch._ref.frontend import witness as witness_mod
from algoplonk_tpu_torch._ref.host import fp as hfp
from algoplonk_tpu_torch.ops import curve_kernels as ck
from algoplonk_tpu_torch.ops import msm as M
from algoplonk_tpu_torch.ops.curve import curve_ops
from algoplonk_tpu_torch.plonk import verify as V
from algoplonk_tpu_torch.plonk.marshal import marshal_proof
from algoplonk_tpu_torch.plonk.prove import Prover
from torch_parity import cuda_device, pythagorean, sample_points  # noqa: F401

pytestmark = pytest.mark.cuda

BN254 = apt.BN254
LANES = 1000      # not a multiple of the 128-thread block


def random_projective(ops, gen, table, lanes):
    """Doubled table rows (Z != 1), the identity among them."""
    idx = torch.randint(0, table.shape[0], (lanes,), generator=gen).to(table.device)
    p = ops.jac_double(ops.affine_to_jac(table[idx]))
    return p.permute(1, 2, 0).contiguous()


@pytest.fixture
def setup(cuda_device):
    ops = curve_ops(BN254, cuda_device)
    pts = sample_points(random.Random(1), BN254, 63) + [None]
    table = ops.encode_affine(pts)                            # row 63: identity
    return ops, table, torch.Generator().manual_seed(2)


def run_and_compare(name, kernel, plain):
    before = ck.LAUNCHES[name]
    got = kernel()
    torch.cuda.synchronize()
    assert ck.LAUNCHES[name] == before + 1
    assert torch.equal(got, plain())
    assert ck.LAUNCHES[name] == before + 1


def test_k1_mixed_add_signed_multi(setup):
    ops, table, gen = setup
    acc = random_projective(ops, gen, table, LANES)
    rows = torch.randint(0, table.shape[0] + 3, (M.FUSE_STEPS, LANES), generator=gen)
    sign = torch.randint(0, 2, (M.FUSE_STEPS, LANES), generator=gen)
    packed = (rows | (sign << ck.SIGN_SHIFT)).to(torch.int32).to(table.device)
    flat = table.reshape(table.shape[0], -1).contiguous()
    run_and_compare(
        "mixed_add_signed_multi",
        lambda: ck.mixed_add_signed_multi(ops, acc, flat, packed),
        lambda: ck.plain_mixed_add_signed_multi(ops, acc, flat, packed),
    )


def test_k2_jac_add_multi_scan(setup):
    ops, table, gen = setup
    acc = random_projective(ops, gen, table, LANES)
    qs = torch.cat([random_projective(ops, gen, table, LANES) for _ in range(M.SUPER)])
    run_and_compare(
        "jac_add_multi_scan",
        lambda: ck.jac_add_multi_scan(ops, acc, qs),
        lambda: ck.plain_jac_add_multi_scan(ops, acc, qs),
    )


def test_k3_jac_add(setup):
    ops, table, gen = setup
    p = random_projective(ops, gen, table, LANES)
    q = random_projective(ops, gen, table, LANES)
    q[:, :, :64] = p[:, :, :64]                               # doublings
    q[1, :, 64:128] = ops.f.neg(p[1, :, 64:128].T).T          # cancellations
    run_and_compare(
        "jac_add", lambda: ck.jac_add(ops, p, q), lambda: ck.plain_jac_add(ops, p, q)
    )


def test_k4_canon(setup):
    ops, _, gen = setup
    x = torch.randint(-(2**31), 2**31, (3, ops.W, LANES), generator=gen, dtype=torch.int64)
    x = x.to(torch.int32).to(ops.device).contiguous()
    run_and_compare("canon", lambda: ck.canon(ops, x), lambda: ck.plain_canon(ops, x))


def test_wrappers_check_inputs(setup):
    ops, table, _ = setup
    p = torch.zeros((3, ops.W, LANES), dtype=torch.int32, device=ops.device)
    with pytest.raises(TypeError):
        ck.jac_add(ops, p, p.to(torch.int64))
    with pytest.raises(ValueError, match="shape"):
        ck.jac_add(ops, p, p[:, :, :-1].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        ck.canon(ops, p.transpose(0, 1).contiguous().transpose(0, 1))


def test_device_msm_two_level(cuda_device):
    """4,100 points: 257 blocks of 16, so phase 2 takes two levels and every
    kernel runs; the result equals host Pippenger."""
    rng = random.Random(3)
    n = 4100
    pts = sample_points(rng, BN254, n)
    scalars = [rng.randrange(BN254.fr.modulus) for _ in range(n)]
    ctx = M.msm_ctx(BN254, cuda_device)
    ck.reset_launch_counts()
    got = ctx.msm_to_affine_int(ctx.ops.encode_affine(pts), ctx.fr.encode(scalars), kind="mont")
    assert all(ck.LAUNCHES[k] > 0 for k in ck.KERNELS), ck.LAUNCHES
    assert got == M.host_msm(BN254, pts, scalars)


def test_small_proof_gpu_equals_cpu(cuda_device, monkeypatch):
    """With every commit through the device MSM, the GPU's proof bytes are
    the CPU's."""
    monkeypatch.setattr(M, "HOST_MSM_MAX", 0)
    P = pythagorean(apt)
    blobs = []
    for device in (cuda_device, torch.device("cpu")):
        cc = apt.compile(P, BN254, apt.SetupName.TEST_ONLY_BN254, device=device)
        prover = Prover(cc.pk, cc.ccs, rng=False)
        wit = witness_mod.solve(cc.ccs, P(a=3, b=4, c=5), commitment_solver=prover.bsb_solver)
        proof = prover.prove(wit)
        assert V.verify(cc.vk, proof, [3, 4])
        blobs.append(marshal_proof(BN254, proof))
    assert blobs[0] == blobs[1]


def test_device_msm_of_digits(cuda_device):
    """Digit scalars take the device pipeline at any size."""
    F = hfp.GF(BN254.fp.modulus)
    pts = sample_points(random.Random(4), BN254, 5)
    ctx = M.msm_ctx(BN254, cuda_device)
    digits = torch.from_numpy(M.scalar_digits([1, 2, 3, 4, 5])).to(cuda_device)
    got = ctx.msm_to_affine_int(ctx.ops.encode_affine(pts), digits, kind="digits")
    assert got == hfp.ec_msm(F, pts, [1, 2, 3, 4, 5])

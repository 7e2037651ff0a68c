"""The CUDA kernels on the GPU, word for word against their plain PyTorch
versions: the MSM kernels K1-K3 (csrc/msm_kernels.cu) at W = 8 (BN254)
and W = 12 (BLS12-381), K1 on a commit-sized table, K2 at every thread
count per lane, K3's window scan and phase-4 entries at the window sizes
of the MSM, K4-K7 (csrc/curve_kernels.cu) on both curves (K4 on every
edge of its ladder, by 16-byte vectors and one lane a thread; K5 and K6
at every thread count per lane), K8 and
field_add_sub (csrc/field_kernels.cu) on every field at every operand
layout the prover gives them, and the NTT pass kernel K9 and the HBM stage
ntt_stage (csrc/ntt_kernels.cu), alone and composed above K9's C; then ``FieldOps`` on the card against the CPU's, the
device MSM, the four-step transform and small proofs against host
arithmetic and the CPU.  Every plain version is checked to launch nothing.

These tests need an NVIDIA GPU and skip elsewhere.  The file imports no jax,
so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py
"""

import random
import time

import pytest
import torch

import algoplonk_tpu_torch as apt
from algoplonk_tpu_torch.fields.words import ints_to_words, words_to_ints
from algoplonk_tpu_torch.frontend import witness as witness_mod
from algoplonk_tpu_torch.host import fp as hfp
from algoplonk_tpu_torch.ops import curve_kernels as ck
from algoplonk_tpu_torch.ops import field_kernels as fk
from algoplonk_tpu_torch.ops import msm as M
from algoplonk_tpu_torch.ops import ntt_kernels as nk
from algoplonk_tpu_torch.ops.curve import curve_ops
from algoplonk_tpu_torch.ops.field import field_ops, plain_add, plain_mul, plain_neg, plain_sub
from algoplonk_tpu_torch.ops.ntt import ntt_plan
from algoplonk_tpu_torch.plonk import prove as prove_mod
from algoplonk_tpu_torch.plonk import verify as V
from algoplonk_tpu_torch.plonk.marshal import marshal_proof
from algoplonk_tpu_torch.plonk.prove import Prover
from torch_parity import canon_edge_values, cuda_device, pythagorean, sample_points  # noqa: F401

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


def all_launches():
    return {**ck.LAUNCHES, **nk.LAUNCHES, **fk.LAUNCHES}


def run_and_compare(name, kernel, plain):
    """One launch of kernel ``name``, equal word for word to its plain
    version, which launches no kernel at all."""
    before = all_launches()
    got = kernel()
    torch.cuda.synchronize()
    after = all_launches()
    assert after[name] == before[name] + 1
    want = plain()
    torch.cuda.synchronize()
    assert all_launches() == after, "the plain version launched a kernel"
    assert torch.equal(got, want)


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


@pytest.fixture
def bls_setup(cuda_device):
    ops = curve_ops(apt.BLS12_381, cuda_device)
    pts = sample_points(random.Random(5), apt.BLS12_381, 63) + [None]
    return ops, ops.encode_affine(pts), torch.Generator().manual_seed(6)


@pytest.mark.parametrize("kernel", ["k1", "k2", "k3", "k4"])
def test_msm_kernels_at_w12(bls_setup, kernel):
    """K1-K4 on BLS12-381's 12-word base field, with identity, doubling and
    cancelling lanes, at both fuse depths for K1."""
    ops, table, gen = bls_setup
    assert ops.W == 12
    p = random_projective(ops, gen, table, LANES)
    if kernel == "k1":
        flat = table.reshape(table.shape[0], -1).contiguous()
        for steps in (8, 16):
            rows = torch.randint(0, table.shape[0] + 3, (steps, LANES), generator=gen)
            sign = torch.randint(0, 2, (steps, LANES), generator=gen)
            packed = (rows | (sign << ck.SIGN_SHIFT)).to(torch.int32).to(table.device)
            run_and_compare(
                "mixed_add_signed_multi",
                lambda: ck.mixed_add_signed_multi(ops, p, flat, packed),
                lambda: ck.plain_mixed_add_signed_multi(ops, p, flat, packed),
            )
    elif kernel == "k2":
        qs = torch.cat([random_projective(ops, gen, table, LANES) for _ in range(M.SUPER)])
        run_and_compare("jac_add_multi_scan", lambda: ck.jac_add_multi_scan(ops, p, qs),
                        lambda: ck.plain_jac_add_multi_scan(ops, p, qs))
    elif kernel == "k3":
        q = random_projective(ops, gen, table, LANES)
        q[:, :, :64] = p[:, :, :64]
        q[1, :, 64:128] = ops.f.neg(p[1, :, 64:128].T).T
        run_and_compare("jac_add", lambda: ck.jac_add(ops, p, q), lambda: ck.plain_jac_add(ops, p, q))
    else:
        x = torch.randint(-(2**31), 2**31, (3, ops.W, LANES), generator=gen, dtype=torch.int64)
        x = x.to(torch.int32).to(ops.device).contiguous()
        run_and_compare("canon", lambda: ck.canon(ops, x), lambda: ck.plain_canon(ops, x))


@pytest.mark.parametrize("E", [1, 64, 257, 513, 1024])
@pytest.mark.parametrize("curve", ["bn254", "bls12_381"])
def test_k3_window_scan(cuda_device, curve, E):
    """K3's scan over 3 windows of E lanes plus padding, with p + p and
    p + (-p) neighbours in round 1."""
    c = apt.fields.params.CURVES[curve]
    ops = curve_ops(c, cuda_device)
    table = ops.encode_affine(sample_points(random.Random(20), c, 31) + [None])
    gen = torch.Generator().manual_seed(21 + E)
    nwin = 3
    x = random_projective(ops, gen, table, nwin * E + 77)
    if E > 4:
        x[:, :, E + 1] = x[:, :, E]                              # doubling
        x[:, :, 2 * E + 1] = x[:, :, 2 * E]
        x[1, :, 2 * E + 1] = ops.f.neg(x[1, :, 2 * E].contiguous())  # cancellation
    run_and_compare("jac_add_window_scan", lambda: ck.jac_add_window_scan(ops, x, nwin, E),
                    lambda: ck.plain_jac_add_window_scan(ops, x, nwin, E))


@pytest.mark.parametrize("nw,c", [(24, 11), (5, 4), (2, 12), (3, 1)],
                         ids=["D1024", "D8", "D2048", "D1"])
@pytest.mark.parametrize("curve", ["bn254", "bls12_381"])
def test_k3_window_combine(cuda_device, curve, nw, c):
    """K3's phase 4 at the commit's 24 windows of D = 1024, at D = 8 and at
    the widest and narrowest windows the wrapper takes, with a doubling and
    a cancellation in the P[e_d] add (window 1's P[e_D] is the identity)
    and an identity lane."""
    cp = apt.fields.params.CURVES[curve]
    ops = curve_ops(cp, cuda_device)
    table = ops.encode_affine(sample_points(random.Random(22), cp, 31) + [None])
    gen = torch.Generator().manual_seed(23 + c)
    D = 1 << (c - 1)
    B = M._pad_lanes(nw * (D + 1))
    base = random_projective(ops, gen, table, B)
    in_block = random_projective(ops, gen, table, B)
    in_block[:, :, 0] = base[:, :, 0]                            # doubling
    top = D + 1 + D                                              # window 1, lane D
    in_block[:, :, top] = base[:, :, top]
    in_block[1, :, top] = ops.f.neg(base[1, :, top].contiguous())   # cancellation
    base[:, :, 3] = in_block[:, :, 3] = ck.inf_lm(ops, 1)[:, :, 0]
    run_and_compare("window_combine",
                    lambda: ck.window_combine(ops, base, in_block, nw, c),
                    lambda: ck.plain_window_combine(ops, base, in_block, nw, c))


@pytest.mark.parametrize("T", ck.SCAN_THREADS)
@pytest.mark.parametrize("curve", ["bn254", "bls12_381"])
def test_k2_every_thread_count(monkeypatch, cuda_device, curve, T):
    """K2 with T threads per lane equals its plain version in the same
    association, word for word, at both widths; lanes not a multiple of
    the block."""
    monkeypatch.setattr(ck, "scan_threads", lambda B, g: T)
    c = apt.fields.params.CURVES[curve]
    ops = curve_ops(c, cuda_device)
    table = ops.encode_affine(sample_points(random.Random(11), c, 31) + [None])
    gen = torch.Generator().manual_seed(12 + T)
    acc = random_projective(ops, gen, table, LANES)
    qs = torch.cat([random_projective(ops, gen, table, LANES) for _ in range(M.SUPER)])
    qs[3:6, :, :64] = acc[:, :, :64]                          # doublings at step 1
    run_and_compare("jac_add_multi_scan", lambda: ck.jac_add_multi_scan(ops, acc, qs),
                    lambda: ck.plain_jac_add_multi_scan(ops, acc, qs, T))


@pytest.mark.parametrize("curve", ["bn254", "bls12_381"])
def test_k1_commit_sized_table(cuda_device, curve):
    """K1 gathering from a table of a commit's size (2^16 + 4 rows at W = 8,
    2^14 + 4 at W = 12), random rows, both signs, the identity row last."""
    c = apt.fields.params.CURVES[curve]
    ops = curve_ops(c, cuda_device)
    gen = torch.Generator().manual_seed(13)
    base = ops.encode_affine(sample_points(random.Random(13), c, 63) + [None])
    nrows = (1 << 16 if ops.W == 8 else 1 << 14) + 4
    pick = torch.randint(0, base.shape[0], (nrows,), generator=gen).to(cuda_device)
    pick[-1] = base.shape[0] - 1
    flat = base[pick].reshape(nrows, 2 * ops.W).contiguous()
    acc = random_projective(ops, gen, base, 4 * LANES)
    rows = torch.randint(0, nrows, (M.FUSE_STEPS, 4 * LANES), generator=gen)
    sign = torch.randint(0, 2, (M.FUSE_STEPS, 4 * LANES), generator=gen)
    packed = (rows | (sign << ck.SIGN_SHIFT)).to(torch.int32).to(cuda_device)
    run_and_compare(
        "mixed_add_signed_multi",
        lambda: ck.mixed_add_signed_multi(ops, acc, flat, packed),
        lambda: ck.plain_mixed_add_signed_multi(ops, acc, flat, packed),
    )


@pytest.mark.parametrize("curve", ["bn254", "bls12_381"])
def test_k5_k6_k7(cuda_device, curve):
    """K5, K6 and K7 at the curve's width, on identity, doubling and
    cancelling lanes."""
    c = apt.fields.params.CURVES[curve]
    ops = curve_ops(c, cuda_device)
    pts = sample_points(random.Random(8), c, 63) + [None]
    table = ops.encode_affine(pts)
    gen = torch.Generator().manual_seed(9)
    acc = random_projective(ops, gen, table, LANES)
    idx = torch.randint(0, table.shape[0], (LANES,), generator=gen).to(cuda_device)
    aff = table[idx]                                          # [LANES, 2, W]
    aff[:64] = ops.to_affine(acc.permute(2, 0, 1)[:64])       # doublings
    aff[64:128] = ops.to_affine(acc.permute(2, 0, 1)[64:128])
    aff[64:128, 1] = ops.f.neg(aff[64:128, 1])                # cancellations
    pts_lm = aff.permute(1, 2, 0).contiguous()
    neg = torch.randint(0, 2, (1, LANES), generator=gen).to(torch.int32).to(cuda_device)
    neg[0, :128] = 0
    run_and_compare("mixed_add", lambda: ck.mixed_add(ops, acc, pts_lm),
                    lambda: ck.plain_mixed_add(ops, acc, pts_lm))
    run_and_compare("mixed_add_signed", lambda: ck.mixed_add_signed(ops, acc, pts_lm, neg),
                    lambda: ck.plain_mixed_add_signed(ops, acc, pts_lm, neg))
    qs = torch.cat([random_projective(ops, gen, table, LANES) for _ in range(M.SUPER)])
    run_and_compare("jac_add_multi", lambda: ck.jac_add_multi(ops, acc, qs),
                    lambda: ck.plain_jac_add_multi(ops, acc, qs))


K7_LANES = 1001   # at every T, the last block and the last warp partly empty


def curve_setup(curve, device, seed):
    c = apt.fields.params.CURVES[curve]
    ops = curve_ops(c, device)
    table = ops.encode_affine(sample_points(random.Random(seed), c, 31) + [None])
    return ops, table, torch.Generator().manual_seed(seed + 1)


def affine_of(ops, out_lm):
    return ops.decode_affine(ops.to_affine(out_lm.permute(2, 0, 1)))


@pytest.mark.parametrize("T", ck.MULTI_THREADS)
@pytest.mark.parametrize("curve", ["bn254", "bls12_381"])
def test_k7_every_thread_count(monkeypatch, cuda_device, curve, T):
    """K7 with T threads per lane equals its plain version at the same T
    word for word, and T = 1 as points, at both widths: identity lanes,
    doublings and cancellations at step 0, 16 steps."""
    monkeypatch.setattr(ck, "multi_threads", lambda B, g: T)
    ops, table, gen = curve_setup(curve, cuda_device, 30 + T)
    acc = random_projective(ops, gen, table, K7_LANES)
    qs = torch.cat([random_projective(ops, gen, table, K7_LANES) for _ in range(M.SUPER)])
    qs[0:3, :, :64] = acc[:, :, :64]                              # doublings
    qs[0:3, :, 64:128] = acc[:, :, 64:128]
    qs[1, :, 64:128] = ops.f.neg(acc[1, :, 64:128].T).T           # cancellations
    run_and_compare("jac_add_multi", lambda: ck.jac_add_multi(ops, acc, qs),
                    lambda: ck.plain_jac_add_multi(ops, acc, qs, T))
    assert affine_of(ops, ck.jac_add_multi(ops, acc, qs)) == affine_of(
        ops, ck.plain_jac_add_multi(ops, acc, qs, 1))


@pytest.mark.parametrize("g", [0, 1, 3, 6])
def test_k7_steps_that_rule_out_thread_counts(monkeypatch, cuda_device, g):
    """At g steps K7 takes every T of MULTI_THREADS that divides g (T = 1
    at g = 0), word-equal to its plain version; the wrapper and the plain
    version refuse the others."""
    ops, table, gen = curve_setup("bn254", cuda_device, 40 + g)
    acc = random_projective(ops, gen, table, K7_LANES)
    qs = torch.cat([acc[:0]] + [random_projective(ops, gen, table, K7_LANES) for _ in range(g)])
    for T in ck.MULTI_THREADS:
        monkeypatch.setattr(ck, "multi_threads", lambda B, g, T=T: T)
        if T <= max(g, 1) and g % T == 0:
            run_and_compare("jac_add_multi", lambda: ck.jac_add_multi(ops, acc, qs),
                            lambda: ck.plain_jac_add_multi(ops, acc, qs, T))
        else:
            with pytest.raises(ValueError):
                ck.jac_add_multi(ops, acc, qs)
            with pytest.raises(ValueError):
                ck.plain_jac_add_multi(ops, acc, qs, T)


def test_k6_k7_entries_refuse_bad_thread_counts(setup):
    """The C entries return cudaErrorInvalidValue (1) and launch nothing for
    a K7 T that is not a power of two <= 16 dividing g, or a K6 T_m outside
    1-2."""
    from algoplonk_tpu_torch.ops._build import stream_of

    ops, table, gen = setup
    acc = random_projective(ops, gen, table, 64)
    qs = torch.cat([random_projective(ops, gen, table, 64) for _ in range(6)])
    pts = ops.to_affine(acc.permute(2, 0, 1)).permute(1, 2, 0).contiguous()
    neg = torch.zeros((1, 64), dtype=torch.int32, device=acc.device)
    out = torch.empty_like(acc)
    k7, k6 = ck._kernel("jac_add_multi", ops.W), ck._kernel("mixed_add_signed", ops.W)
    consts, stream = ck._consts(ops), stream_of(acc)
    for g, T in ((6, 0), (6, 3), (6, 4), (6, 32), (0, 2), (16, 32)):
        assert k7(acc.data_ptr(), qs.data_ptr(), out.data_ptr(), 64, g, T, consts, stream) == 1
    for Tm in (0, 3, 4, -1):
        assert k6(acc.data_ptr(), pts.data_ptr(), neg.data_ptr(), out.data_ptr(), 64, Tm,
                  consts, stream) == 1
    torch.cuda.synchronize()


K6_LANES = {8: 98688, 12: 24960}   # the kernel-test path's widths (chip_smoke.py)


@pytest.mark.parametrize("lanes", ["kernel-test", "ragged"])
@pytest.mark.parametrize("Tm", ck.MIXED_THREADS)
@pytest.mark.parametrize("curve", ["bn254", "bls12_381"])
def test_k6_every_thread_count(monkeypatch, cuda_device, curve, Tm, lanes):
    """K6 with T_m threads per lane equals plain_mixed_add_signed word for
    word at both widths, at the kernel-test width and at 1,001 lanes: every
    coordinate a residue over all of [0, p) with edge values, then on-curve
    lanes: doublings, cancellations (the point negated by neg), identity
    accumulators, and identity points with and without neg."""
    monkeypatch.setattr(ck, "mixed_threads", lambda W: Tm)
    ops, table, gen = curve_setup(curve, cuda_device, 50 + Tm)
    f, W = ops.f, ops.W
    B = K6_LANES[W] if lanes == "kernel-test" else K7_LANES
    acc = random_residues(f, 3 * B, gen).reshape(3, B, W).permute(0, 2, 1).contiguous()
    pts = random_residues(f, 2 * B, gen).reshape(2, B, W).permute(0, 2, 1).contiguous()
    neg = torch.randint(0, 2, (1, B), generator=gen).to(torch.int32).to(cuda_device)
    on_curve = random_projective(ops, gen, table, 256)             # identities among them
    acc[:, :, :256] = on_curve
    aff = ops.to_affine(on_curve.permute(2, 0, 1)).permute(1, 2, 0)
    pts[:, :, :128] = aff[:, :, :128]
    neg[0, :64] = 0                                                # doublings
    neg[0, 64:128] = 1                                             # cancellations
    pts[:, :, 128:136] = 0                                         # identity points
    neg[0, 128:132] = 1
    neg[0, 132:136] = 0
    run_and_compare("mixed_add_signed", lambda: ck.mixed_add_signed(ops, acc, pts, neg),
                    lambda: ck.plain_mixed_add_signed(ops, acc, pts, neg))


@pytest.mark.parametrize("lanes", ["kernel-test", "ragged"])
@pytest.mark.parametrize("Tm", ck.MIXED_THREADS)
@pytest.mark.parametrize("curve", ["bn254", "bls12_381"])
def test_k5_every_thread_count(monkeypatch, cuda_device, curve, Tm, lanes):
    """K5 (K6's kernel without the sign) with T_m threads per lane equals
    plain_mixed_add word for word at both widths, at the kernel-test width
    and at 1,001 lanes: every coordinate a residue over all of [0, p) with
    edge values, then on-curve lanes: doublings, cancellations, identity
    accumulators, identity points, and both identities at once."""
    monkeypatch.setattr(ck, "mixed_threads", lambda W: Tm)
    ops, table, gen = curve_setup(curve, cuda_device, 70 + Tm)
    f, W = ops.f, ops.W
    B = K6_LANES[W] if lanes == "kernel-test" else K7_LANES
    acc = random_residues(f, 3 * B, gen).reshape(3, B, W).permute(0, 2, 1).contiguous()
    pts = random_residues(f, 2 * B, gen).reshape(2, B, W).permute(0, 2, 1).contiguous()
    on_curve = random_projective(ops, gen, table, 256)             # identities among them
    acc[:, :, :256] = on_curve
    aff = ops.to_affine(on_curve.permute(2, 0, 1)).permute(1, 2, 0)
    pts[:, :, :128] = aff[:, :, :128]                              # doublings
    pts[1, :, 64:128] = f.neg(aff[1, :, 64:128].T).T               # cancellations
    pts[:, :, 128:136] = 0                                         # identity points
    acc[:, :, 136:144] = ck.inf_lm(ops, 8)                         # identity accumulators
    pts[:, :, 140:144] = 0                                         # ... plus the identity
    run_and_compare("mixed_add", lambda: ck.mixed_add(ops, acc, pts),
                    lambda: ck.plain_mixed_add(ops, acc, pts))


@pytest.mark.parametrize("layout", ["vectors", "ragged", "unaligned"])
@pytest.mark.parametrize("curve", ["bn254", "bls12_381"])
def test_k4_canon_edges(cuda_device, curve, layout):
    """K4 equals its plain version word for word, and x mod p on host
    integers, on every edge of its ladder (torch_parity.canon_edge_values)
    and seeded random words, at both widths: 1,000 lanes (16-byte vectors of
    4 lanes), 1,001 lanes and a view one word past an aligned buffer (one
    lane a thread)."""
    ops = curve_ops(apt.fields.params.CURVES[curve], cuda_device)
    W, p = ops.W, ops.wf.modulus
    B = K7_LANES if layout == "ragged" else 1000
    vals = canon_edge_values(p, W, random.Random(60), 3 * B)
    x = torch.from_numpy(ints_to_words(vals, W)).reshape(3, B, W).permute(0, 2, 1)
    x = x.contiguous().to(cuda_device)
    if layout == "unaligned":
        x = unaligned(x)
        assert x.data_ptr() % 16
    run_and_compare("canon", lambda: ck.canon(ops, x), lambda: ck.plain_canon(ops, x))
    got = ck.canon(ops, x).permute(0, 2, 1).reshape(-1, W).cpu().numpy()
    assert words_to_ints(got) == [v % p for v in vals]


def test_k4_k5_entries_refuse_bad_arguments(setup):
    """The C entries return cudaErrorInvalidValue (1) and launch nothing for
    a K4 ladder of another length than the width's kernel was compiled for,
    or a K5 T_m outside 1-2."""
    from algoplonk_tpu_torch.ops._build import stream_of

    ops, table, gen = setup
    acc = random_projective(ops, gen, table, 64)
    pts = ops.to_affine(acc.permute(2, 0, 1)).permute(1, 2, 0).contiguous()
    out = torch.empty_like(acc)
    stream = stream_of(acc)
    k4, k5 = ck._kernel("canon", ops.W), ck._kernel("mixed_add", ops.W)
    steps, ladder = ck._canon_ladder(ops)
    for bad in (0, steps - 1, steps + 1):
        assert k4(acc.data_ptr(), out.data_ptr(), 3, 64, bad, ladder, stream) == 1
    for Tm in (0, 3, 4, -1):
        assert k5(acc.data_ptr(), pts.data_ptr(), out.data_ptr(), 64, Tm, ck._consts(ops),
                  stream) == 1
    torch.cuda.synchronize()


@pytest.mark.parametrize("field", ["bn254_fr", "bn254_fp", "bls12_381_fr", "bls12_381_fp"])
def test_k8_field_mul(cuda_device, field):
    c = apt.fields.params.CURVES[field.rsplit("_", 1)[0]]
    f = field_ops(c.fr if field.endswith("fr") else c.fp, cuda_device)
    rng = random.Random(10)
    n = 3000
    vals = [rng.randrange(f.modulus) for _ in range(2 * n - 4)] + [0, 1, f.modulus - 1, 2]
    a, b = f.encode(vals[:n]), f.encode(vals[n:])
    run_and_compare("field_mul", lambda: fk.field_mul(f, a, b), lambda: plain_mul(f, a, b))


FIELDS = ["bn254_fr", "bn254_fp", "bls12_381_fr", "bls12_381_fp"]
FIELD_ROWS = [1, 255, 256, 257, 1 << 18]


def field_named(name, device):
    c = apt.fields.params.CURVES[name.rsplit("_", 1)[0]]
    return field_ops(c.fr if name.endswith("fr") else c.fp, device)


def canonical_words(f, n, gen):
    """n canonical residues [n, W] on f's device: random words with the top
    word cut below p's top bit, and 0, 1 and p - 1 in front."""
    x = torch.randint(-(2**31), 2**31, (n, f.W), generator=gen, dtype=torch.int64)
    x[:, -1] &= (1 << (f.fp.nbits - 1 - 32 * (f.W - 1))) - 1
    x = x.to(torch.int32).to(f.device)
    edges = f.encode([0, 1, f.modulus - 1])[: n]
    x[: edges.shape[0]] = edges
    return x


def any_words(f, n, gen):
    """n arbitrary W-word values [n, W] (below R, not reduced)."""
    x = torch.randint(-(2**31), 2**31, (n, f.W), generator=gen, dtype=torch.int64)
    return x.to(torch.int32).to(f.device)


LAYOUTS = ["contiguous", "element-batch", "batch-element", "ntt-halves", "ntt-twiddles",
           "every-other-row", "k-n-by-1-n", "nb-1-by-1-b", "point-coordinates",
           "words-not-contiguous", "three-batch-dims", "unaligned-rows", "unaligned-element"]


def unaligned(x):
    """x's values in a contiguous view one word past the start of its
    buffer, so that no row of it is 16-byte aligned."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    buf[1:] = x.reshape(-1)
    return buf[1:].view(x.shape)


def operand_layout(f, n, gen, layout):
    """Operands a, b of one layout the prover gives the field ops, with
    about n rows ("words-not-contiguous", "three-batch-dims" and the
    unaligned ones are those the wrapper must copy)."""
    W = f.W

    def r(m):
        return canonical_words(f, m, gen)

    h = min(n & -n, 64)
    stage = r(2 * n).reshape(n // h, 2, h, W)
    pts = r(3 * n).reshape(n, 3, W)
    rows = r(2 * n)
    return {
        "contiguous": lambda: (r(n), r(n)),
        "element-batch": lambda: (r(1)[0], r(n)),
        "batch-element": lambda: (r(n), r(1)[0]),
        "ntt-halves": lambda: (stage[:, 0], stage[:, 1]),
        "ntt-twiddles": lambda: (stage[:, 1], r(3 * h)[::3]),
        "every-other-row": lambda: (rows[0::2], rows[1::2]),
        "k-n-by-1-n": lambda: (r(3 * n).reshape(3, n, W), r(n)[None]),
        "nb-1-by-1-b": lambda: (r(n)[:, None], r(3)[None]),
        "point-coordinates": lambda: (pts[:, 0], pts[:, 2]),
        "words-not-contiguous": lambda: (r(n).T.contiguous().T, r(n)),
        "three-batch-dims": lambda: (r(6 * n).reshape(2, 3, n, W).transpose(1, 2),
                                     r(3)[None, None]),
        "unaligned-rows": lambda: (unaligned(r(n)), r(n)),
        "unaligned-element": lambda: (r(n), unaligned(r(1)[0])),
    }[layout]()


def host_mont_mul(f, a, b):
    """a b R^-1 mod p of broadcast operands, from host integers -> int32
    words of the broadcast shape on a's device."""
    a, b = torch.broadcast_tensors(a, b)
    xs = words_to_ints(a.reshape(-1, f.W).cpu().numpy())
    ys = words_to_ints(b.reshape(-1, f.W).cpu().numpy())
    p = f.modulus
    r_inv = pow(1 << (32 * f.W), -1, p)
    out = ints_to_words([x * y * r_inv % p for x, y in zip(xs, ys)], f.W)
    return torch.from_numpy(out).reshape(a.shape).to(a.device)


def check_field_kernel(name, f, kernel, plain, operands):
    """One launch, the copies ``fk.layout`` finds for ``operands``, and the
    plain version's words, with no launch in the plain call."""
    before, copied = all_launches(), fk.COPIES
    got = kernel()
    torch.cuda.synchronize()
    after = all_launches()
    assert after[name] == before[name] + 1
    assert fk.COPIES - copied == fk.layout(operands)[-1]
    want = plain()
    torch.cuda.synchronize()
    assert all_launches() == after, "the plain version launched a kernel"
    assert got.is_contiguous() and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("field", FIELDS)
def test_field_kernels_by_layout(cuda_device, field, layout):
    """K8 and field_add_sub (add, sub, neg) against plain_mul, plain_add,
    plain_sub and plain_neg at 1, 255, 256, 257 and 2^18 rows in one operand
    layout of the prover's, the edge values 0, 1 and p - 1 among them; K8
    also with either multiplicand arbitrary below R, against host integers
    (plain_mul's coarse REDC is exact only for canonical operands)."""
    f = field_named(field, cuda_device)
    gen = torch.Generator().manual_seed(len(layout) + f.W)
    for n in FIELD_ROWS:
        a, b = operand_layout(f, n, gen, layout)
        for kname, kern, plain in (("field_mul", fk.field_mul, plain_mul),
                                   ("field_add_sub", fk.field_add, plain_add),
                                   ("field_add_sub", fk.field_sub, plain_sub)):
            check_field_kernel(kname, f, lambda: kern(f, a, b), lambda: plain(f, a, b), (a, b))
        check_field_kernel("field_add_sub", f, lambda: fk.field_neg(f, a),
                           lambda: plain_neg(f, a), (a,))
        arb = any_words(f, a.numel() // f.W, gen).reshape(a.shape)
        want = host_mont_mul(f, arb, b)
        check_field_kernel("field_mul", f, lambda: fk.field_mul(f, arb, b),
                           lambda: want, (arb, b))
        check_field_kernel("field_mul", f, lambda: fk.field_mul(f, b, arb),
                           lambda: want, (b, arb))


@pytest.mark.parametrize("field", FIELDS)
def test_field_ops_on_the_card_equal_the_cpu(cuda_device, field):
    """FieldOps on a CUDA device launches K8 or field_add_sub for every mul,
    add, sub and neg, and gives the CPU FieldOps' words for every op built
    on them."""
    fg, fc = field_named(field, cuda_device), field_named(field, "cpu")
    assert not fg.plain and fg.as_plain().plain
    rng = random.Random(30)
    p = fg.modulus
    xs = [0, 1, p - 1, 2] + [rng.randrange(p) for _ in range(300)]
    ys = [p - 1, 0, 1, p - 2] + [rng.randrange(p) for _ in range(300)]
    before = dict(fk.LAUNCHES)
    ag, bg = fg.encode(xs), fg.encode(ys)
    ac, bc = fc.encode(xs), fc.encode(ys)
    assert torch.equal(ag.cpu(), ac)
    for op in ("mul", "add", "sub"):
        assert torch.equal(getattr(fg, op)(ag, bg).cpu(), getattr(fc, op)(ac, bc)), op
        assert torch.equal(getattr(fg, op)(ag[5], bg).cpu(), getattr(fc, op)(ac[5], bc)), op
    for op in ("neg", "square", "inv", "from_mont", "to_mont"):
        assert torch.equal(getattr(fg, op)(ag).cpu(), getattr(fc, op)(ac)), op
    assert torch.equal(fg.pow(ag, 0xA1607).cpu(), fc.pow(ac, 0xA1607))
    assert fg.decode(ag) == fc.decode(ac) == xs
    assert fk.LAUNCHES["field_mul"] > before["field_mul"]
    assert fk.LAUNCHES["field_add_sub"] >= before["field_add_sub"] + 4


def test_wrappers_check_inputs(setup):
    ops, table, _ = setup
    p = torch.zeros((3, ops.W, LANES), dtype=torch.int32, device=ops.device)
    with pytest.raises(TypeError):
        ck.jac_add(ops, p, p.to(torch.int64))
    with pytest.raises(ValueError, match="shape"):
        ck.jac_add(ops, p, p[:, :, :-1].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        ck.canon(ops, p.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError, match="windows"):
        ck.jac_add_window_scan(ops, p, 1, 1025)
    with pytest.raises(ValueError, match="windows"):
        ck.window_combine(ops, p, p, 1, 13)
    with pytest.raises(ValueError, match="windows"):
        ck.window_combine(ops, p, p, 2, 10)           # 2 windows of 513 > 1000 lanes


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
    assert all(ck.LAUNCHES[k] > 0 for k in ck.MSM_KERNELS), ck.LAUNCHES
    assert got == M.host_msm(BN254, pts, scalars)


def test_device_msm_chunk_sum(monkeypatch, cuda_device):
    """With CHUNK cut to 1,024, 2,600 points run in three pieces on the
    card; each piece after the first is added to the total by one launch of
    K3's jac_add, and the MSM equals host Pippenger."""
    rng = random.Random(6)
    n = 2600
    pts = sample_points(rng, BN254, n)
    scalars = [rng.randrange(BN254.fr.modulus) for _ in range(n)]
    monkeypatch.setattr(M, "HOST_MSM_MAX", 0)
    monkeypatch.setattr(M, "CHUNK", 1024)
    inside = []                    # K3 jac_add launches within each piece
    real = M.window_sums_scan

    def counted(*a, **kw):
        before = ck.LAUNCHES["jac_add"]
        out = real(*a, **kw)
        inside.append(ck.LAUNCHES["jac_add"] - before)
        return out

    monkeypatch.setattr(M, "window_sums_scan", counted)
    ctx = M.msm_ctx(BN254, cuda_device)
    before = ck.LAUNCHES["jac_add"]
    got = ctx.msm_to_affine_int(ctx.ops.encode_affine(pts), ctx.fr.encode(scalars), kind="mont")
    assert len(inside) == 3
    assert ck.LAUNCHES["jac_add"] - before - sum(inside) == 2
    assert got == M.host_msm(BN254, pts, scalars)


def random_residues(f, n: int, gen) -> torch.Tensor:
    """n canonical residues [n, W] made on the device, over all of [0, p):
    random words under a top word below p's (so values in [2^(bits(p) - 1),
    p) come up, where a lazy reduction would fail), and the edge values 0,
    1, 2, p - 1, p - 2, (p - 1) / 2, 2^(bits(p) - 1) and Montgomery one spread
    over the rows."""
    p = f.fp.modulus
    x = torch.randint(-(2**31), 2**31, (n, f.W), generator=gen, dtype=torch.int64)
    x[:, -1] = torch.randint(0, p >> (32 * (f.W - 1)), (n,), generator=gen)
    x = x.to(torch.int32)
    edges = [0, 1, 2, p - 1, p - 2, (p - 1) // 2, 1 << (p.bit_length() - 1), f.wf.r]
    rows = torch.linspace(0, n - 1, len(edges)).long().unique()
    x[rows] = torch.from_numpy(ints_to_words(edges[: len(rows)], f.W))
    return x.to(f.device).contiguous()


FR_FIELDS = {"bn254": BN254.fr, "bls12_381": apt.BLS12_381.fr}
K9_LAYOUTS = ("contiguous", "column", "column_in")


def k9_strides(layout: str, N: int, C: int):
    """(in_strides, out_strides) of a layout: the four-step's column of an
    [C, N / C] array on both sides, or on the input only."""
    col = (N // C, 1)
    return {"contiguous": (None, None), "column": (col, col), "column_in": (col, None)}[layout]


def check_k9(curve, device, N, C, inverse, fused, layout, seed):
    f = field_ops(FR_FIELDS[curve], device)
    gen = torch.Generator().manual_seed(seed)
    x = random_residues(f, N, gen)
    tw = f.encode(nk.stage_twiddles(curve, C, inverse))
    kw = dict(entry=random_residues(f, N, gen), exit_=random_residues(f, N, gen)) if fused else {}
    ins, outs = k9_strides(layout, N, C)
    run_and_compare(
        "ntt_pass",
        lambda: nk.ntt_pass(f, x, tw, C, inverse, **kw, in_strides=ins, out_strides=outs),
        lambda: nk.plain_ntt_pass(f, x, tw, C, inverse, **kw, in_strides=ins, out_strides=outs))


@pytest.mark.parametrize("layout", K9_LAYOUTS)
@pytest.mark.parametrize("fused", [False, True], ids=["bare", "entry_exit"])
@pytest.mark.parametrize("inverse", [False, True], ids=["dif", "dit"])
@pytest.mark.parametrize("C", [2, 4, 8, 16, 64, 256, 512, 1024, 2048])
@pytest.mark.parametrize("field", sorted(FR_FIELDS))
def test_k9_ntt_pass(cuda_device, field, C, inverse, fused, layout):
    """K9 word for word against its plain version at every pass size, both
    directions, bare and fused, on both scalar fields (BN254's lazy, BLS12-
    381's strict), contiguous and in the four-step's column layouts.  N / C
    = 45 sub-transforms: no multiple of the sub-transforms a block takes."""
    check_k9(field, cuda_device, 45 * C, C, inverse, fused, layout, seed=C + 2 * inverse + fused)


@pytest.mark.parametrize("field", sorted(FR_FIELDS))
@pytest.mark.parametrize(
    "C,inverse,fused,layout",
    [(512, False, True, "column"), (1024, False, False, "contiguous"),
     (1024, True, False, "contiguous"), (512, True, True, "column")],
    ids=["p1-dif", "p2-dif", "p2-dit", "p1-dit"])
def test_k9_ntt_pass_main_path(cuda_device, field, C, inverse, fused, layout):
    """The four passes of a four-step transform of 2^19 (the 2^17 prove's
    round 3), at full size."""
    check_k9(field, cuda_device, 1 << 19, C, inverse, fused, layout, seed=C + inverse)


def test_k9_refuses_bad_strides(cuda_device):
    f = field_ops(BN254.fr, cuda_device)
    x = random_residues(f, 64, torch.Generator().manual_seed(3))
    tw = f.encode(nk.stage_twiddles("bn254", 8, False))
    for bad in ((9, 1), (0, 8), (1, 9)):
        with pytest.raises(ValueError):
            nk.ntt_pass(f, x, tw, 8, False, in_strides=bad)
        with pytest.raises(ValueError):
            nk.ntt_pass(f, x, tw, 8, False, out_strides=bad)


@pytest.mark.parametrize("tables", ["bare", "entry", "exit", "entry_exit"])
@pytest.mark.parametrize("layout", ["contiguous", "column"])
@pytest.mark.parametrize("inverse", [False, True], ids=["dif", "dit"])
@pytest.mark.parametrize("h", [1, 8, 64])
@pytest.mark.parametrize("field", sorted(FR_FIELDS))
def test_ntt_stage(cuda_device, field, h, inverse, layout, tables):
    """ntt_stage, one radix-2 stage over HBM, word for word against
    plain_ntt_stage at every kind of half of a C = 128 pass (h = 1: no
    twiddle but one; h = C / 2: the top stage), both directions, on both
    scalar fields (strict on each), contiguous and in the column layout,
    with and without the entry and exit multiplies.  N / C = 45."""
    C = 128
    N = 45 * C
    f = field_ops(FR_FIELDS[field], cuda_device)
    gen = torch.Generator().manual_seed(h + 2 * inverse)
    x = random_residues(f, N, gen)
    tw = f.encode(nk.stage_twiddles(field, C, inverse))
    kw = {}
    if "entry" in tables:
        kw["entry"] = random_residues(f, N, gen)
    if "exit" in tables:
        kw["exit_"] = random_residues(f, N, gen)
    st = (N // C, 1) if layout == "column" else None
    run_and_compare(
        "ntt_stage",
        lambda: nk.ntt_stage(f, x, tw, C, h, inverse, **kw, strides=st),
        lambda: nk.plain_ntt_stage(f, x, tw, C, h, inverse, **kw, strides=st))


def check_split(curve, device, N, C, inverse, fused, layout, seed):
    """ntt_pass above MAX_C: one ntt_stage launch a stage of half MAX_C or
    more and one K9 launch, word for word the whole pass's plain version
    (which launches nothing)."""
    f = field_ops(FR_FIELDS[curve], device)
    gen = torch.Generator().manual_seed(seed)
    x = random_residues(f, N, gen)
    tw = f.encode(nk.stage_twiddles(curve, C, inverse))
    kw = dict(entry=random_residues(f, N, gen), exit_=random_residues(f, N, gen)) if fused else {}
    ins, outs = k9_strides(layout, N, C)
    before = all_launches()
    got = nk.ntt_pass(f, x, tw, C, inverse, **kw, in_strides=ins, out_strides=outs)
    torch.cuda.synchronize()
    after = all_launches()
    assert after["ntt_pass"] == before["ntt_pass"] + 1
    assert after["ntt_stage"] == before["ntt_stage"] + (C // nk.MAX_C).bit_length() - 1
    want = nk.plain_ntt_pass(f, x, tw, C, inverse, **kw, in_strides=ins, out_strides=outs)
    torch.cuda.synchronize()
    assert all_launches() == after, "the plain version launched a kernel"
    assert torch.equal(got, want)


@pytest.mark.parametrize("layout", K9_LAYOUTS)
@pytest.mark.parametrize("fused", [False, True], ids=["bare", "entry_exit"])
@pytest.mark.parametrize("inverse", [False, True], ids=["dif", "dit"])
@pytest.mark.parametrize("C,max_c", [(16, 8), (64, 16), (1024, 128), (4096, 1024)])
@pytest.mark.parametrize("field", sorted(FR_FIELDS))
def test_split_ntt_pass(monkeypatch, cuda_device, field, C, max_c, inverse, fused, layout):
    """With MAX_C lowered, a pass splits into one to three HBM stages and
    K9 on pieces of MAX_C (K9's second sub-transform stride in a column
    layout), on both fields (K9 lazy on BN254's after the strict stages),
    both directions, bare and fused, in every layout.  N / C = 45."""
    monkeypatch.setattr(nk, "MAX_C", max_c)
    check_split(field, cuda_device, 45 * C, C, inverse, fused, layout, seed=C + inverse)


@pytest.mark.parametrize(
    "N,fused,layout", [(1 << 14, True, "column"), (1 << 23, False, "contiguous")],
    ids=["column-2^14", "contiguous-2^23"])
@pytest.mark.parametrize("inverse", [False, True], ids=["dif", "dit"])
@pytest.mark.parametrize("field", sorted(FR_FIELDS))
def test_split_ntt_pass_at_4096(cuda_device, field, inverse, N, fused, layout):
    """C = 4096 at the real MAX_C (one HBM stage, K9 at 2048): in the column
    layout with entry and exit at N = 2^14 (P1 and P1' from a 2^24 coset
    on), and contiguous at N = 2^23 (P2 and P2' of a 2^21-row prove)."""
    assert nk.MAX_C == 2048
    check_split(field, cuda_device, N, 4096, inverse, fused, layout, seed=N + inverse)


def device_kernels(fn, expect: int):
    """Names of the CUDA kernels and copies that one call of fn runs on the
    device (torch.profiler), from the first trace that holds at least
    ``expect`` records.  The profiler has lost a short trace's first
    records, and all of them, so fn runs between idle pads, longer at each
    of four tries."""
    from torch.profiler import ProfilerActivity, profile

    for pad in (0.02, 0.25, 1.0, 3.0):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            fn()
            torch.cuda.synchronize()
            time.sleep(pad)
        names = [e.name() for e in prof.profiler.kineto_results.events()
                 if e.device_type() == torch.autograd.DeviceType.CUDA]
        if len(names) >= expect:
            break
    return names


def dispatched_ops(fn):
    """The PyTorch operators one call of fn dispatches (a TorchDispatchMode
    record on the host, which every PyTorch kernel and copy goes through)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    with Record() as rec:
        fn()
    return rec.ops


def assert_two_k9_passes(fn):
    """fn launches K9 twice and nothing else: two K9 counts, PyTorch
    operators that only allocate, and a device trace with no record but
    K9's (all of its two unless the profiler lost them in every try)."""
    nk.reset_launch_counts()
    ops = dispatched_ops(fn)
    assert nk.LAUNCHES["ntt_pass"] == 2
    assert all(op.startswith("aten.empty") for op in ops), ops
    names = device_kernels(fn, 2)
    assert len(names) <= 2 and all("ntt_pass" in n for n in names), names


@pytest.mark.parametrize("curve", ["bn254", "bls12_381"])
def test_four_step_coset_matches_radix2(cuda_device, curve):
    """A coset transform of 2^12 through K9 equals the radix-2 plan's,
    position for position, and the round trip is the identity; each
    direction is two K9 launches and runs no other kernel and no copy."""
    log_n = 12
    g = apt.fields.params.CURVES[curve].coset_shift
    fsp = nk.four_step_plan(curve, log_n, cuda_device)
    f = fsp.f
    coeffs = random_residues(f, fsp.n, torch.Generator().manual_seed(7))
    fsp.intt_scr(fsp.ntt_scr(coeffs, coset_shift=g), coset_shift=g)   # the plan's tables
    ev = fsp.ntt_scr(coeffs, coset_shift=g)
    assert_two_k9_passes(lambda: fsp.ntt_scr(coeffs, coset_shift=g))
    perm = torch.from_numpy(fsp.scramble_perm()).to(cuda_device)
    assert torch.equal(ev, ntt_plan(curve, log_n, cuda_device).coset_ntt(coeffs, g)[perm])
    back = fsp.intt_scr(ev, coset_shift=g)
    assert_two_k9_passes(lambda: fsp.intt_scr(ev, coset_shift=g))
    assert torch.equal(back, coeffs)


@pytest.mark.parametrize("curve", ["bn254", "bls12_381"])
def test_small_proof_gpu_equals_cpu(cuda_device, monkeypatch, curve):
    """With every commit through the device MSM, the GPU's proof bytes are
    the CPU's, through either quotient path."""
    monkeypatch.setattr(M, "HOST_MSM_MAX", 0)
    c = apt.fields.params.CURVES[curve]
    setup_name = apt.SetupName.TEST_ONLY_BN254 if curve == "bn254" else (
        apt.SetupName.ETHEREUM_KZG_CEREMONY_BLS12_381)
    P = pythagorean(apt)
    blobs = []
    for device in (cuda_device, torch.device("cpu")):
        cc = apt.compile(P, c, setup_name, device=device)
        for min_log in (64, 0):     # above any coset: batch-major; 0: four-step
            monkeypatch.setattr(prove_mod, "LM_MIN_LOG", min_log)
            prover = Prover(cc.pk, cc.ccs, rng=False)
            wit = witness_mod.solve(cc.ccs, P(a=3, b=4, c=5), commitment_solver=prover.bsb_solver)
            proof = prover.prove(wit)
            assert V.verify(cc.vk, proof, [3, 4])
            blobs.append(marshal_proof(c, proof))
    assert len(set(blobs)) == 1


def test_device_msm_of_digits(cuda_device):
    """Digit scalars take the device pipeline at any size."""
    F = hfp.GF(BN254.fp.modulus)
    pts = sample_points(random.Random(4), BN254, 5)
    ctx = M.msm_ctx(BN254, cuda_device)
    digits = torch.from_numpy(M.scalar_digits([1, 2, 3, 4, 5])).to(cuda_device)
    got = ctx.msm_to_affine_int(ctx.ops.encode_affine(pts), digits, kind="digits")
    assert got == hfp.ec_msm(F, pts, [1, 2, 3, 4, 5])

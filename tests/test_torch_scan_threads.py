"""K2's scan with several threads per lane, on the CPU through its plain
version (algoplonk_tpu_torch/ops/curve_kernels.py), on both curves.

The kernel runs T threads per lane and re-associates the scan; its plain
version follows the same association, so the two stay equal word for word
(tests/test_torch_cuda_kernels.py checks that on a GPU).  Here: every T
gives the sequential scan's points (compared projectively, by
cross-multiplication on host ints), T depends on the lane and step counts
alone, the device-pipeline MSM with T forced to 1 and to 16 equals
``host_msm``, and the lazy core's headroom check refuses BLS12-381's Fr."""

import random

import pytest
import torch

from algoplonk_tpu_torch import BLS12_381, BN254
from algoplonk_tpu_torch.fields.words import word_field
from algoplonk_tpu_torch.host import fp as hfp
from algoplonk_tpu_torch.ops import curve_kernels as ck
from algoplonk_tpu_torch.ops import msm as M
from algoplonk_tpu_torch.ops.curve import curve_ops
from torch_parity import one_torch_thread, port_ints, sample_points  # noqa: F401

CURVES = {"bn254": BN254, "bls12_381": BLS12_381}
LANES = 6
STEPS = 16


def projective_ints(out_lm, curve):
    """[3g, W, B] limbs-major words -> [g][B] (X, Y, Z) host ints."""
    W = out_lm.shape[1]
    g, B = out_lm.shape[0] // 3, out_lm.shape[-1]
    flat = port_ints(out_lm.reshape(g, 3, W, B).permute(0, 3, 1, 2), curve.fp)
    return [[tuple(flat[3 * (k * B + b) : 3 * (k * B + b) + 3]) for b in range(B)]
            for k in range(g)]


def same_point(P, Q, p):
    """Projective equality: every 2x2 minor of the two coordinate vectors
    vanishes mod p, and neither vector is zero."""
    (X1, Y1, Z1), (X2, Y2, Z2) = P, Q
    nonzero = any(v % p for v in P) and any(v % p for v in Q)
    return nonzero and all(
        (a * d - b * c) % p == 0
        for a, b, c, d in ((X1, Y1, X2, Y2), (X1, Z1, X2, Z2), (Y1, Z1, Y2, Z2))
    )


def special_scan(curve, seed):
    """acc [3, W, B] and qs [3g, W, B], doubled points (Z != 1), with an
    identity accumulator, identity steps, a doubling and a cancellation."""
    ops = curve_ops(curve, "cpu")
    F = hfp.GF(curve.fp.modulus)
    rng = random.Random(seed)
    base = sample_points(rng, curve, 8)
    A = [rng.choice(base) for _ in range(LANES)]
    Q = [[rng.choice(base) for _ in range(LANES)] for _ in range(STEPS)]
    A[0] = None                                   # identity accumulator
    Q[3][1] = None                                # identity step
    Q[0][2] = A[2]                                # doubling at step 0
    Q[0][3] = hfp.ec_neg(F, A[3])                 # cancellation at step 0
    Q[7][4] = hfp.ec_neg(F, Q[6][4])              # steps 6 and 7 cancel

    def lm(points):
        p = ops.jac_double(ops.affine_to_jac(ops.encode_affine(points)))
        return p.permute(1, 2, 0).contiguous()

    return ops, lm(A), torch.cat([lm(q) for q in Q])


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_every_t_gives_the_sequential_points(curve):
    c = CURVES[curve]
    p = c.fp.modulus
    ops, acc, qs = special_scan(c, 31)
    seq = ck.plain_jac_add_multi_scan(ops, acc, qs, 1)
    want = projective_ints(seq, c)
    for T in ck.SCAN_THREADS[1:]:
        out = ck.plain_jac_add_multi_scan(ops, acc, qs, T)
        assert out.shape == qs.shape
        got = projective_ints(out, c)
        assert all(same_point(a, b, p) for k in range(STEPS) for a, b in zip(got[k], want[k])), T
    # the cancelled lanes reach the identity, Z = 0, at every T
    assert want[0][3][2] == 0


def test_scan_threads_is_a_function_of_shape_alone(monkeypatch):
    """T divides g, grows as lanes shrink, and is read from (B, g) only: no
    device property is consulted (the CPU picks the kernel's T)."""
    def no_device(*a, **k):
        raise AssertionError("scan_threads consulted the device")

    monkeypatch.setattr(torch.cuda, "get_device_properties", no_device)
    monkeypatch.setattr(torch.cuda, "is_available", no_device)
    for g in (1, 2, 3, 8, 16):
        prev = None
        for B in (8, 128, 1664, 6272, 12416, 1 << 16):
            T = ck.scan_threads(B, g)
            assert T in ck.SCAN_THREADS and g % T == 0
            assert ck.scan_threads(B, g) == T
            assert prev is None or T <= prev
            prev = T
    assert ck.scan_threads(1 << 20, 16) == 1
    assert ck.scan_threads(8, 16) == 16 and ck.scan_threads(8, 3) == 1
    # the three commit shapes: BN254 2^17 and 2^16, BLS12-381 2^14
    assert [ck.scan_threads(B, 16) for B in (12416, 6272, 1664)] == [1, 4, 16]


@pytest.mark.parametrize("T", [1, 16])
@pytest.mark.parametrize("curve", sorted(CURVES))
def test_pipeline_msm_at_forced_t_matches_host(monkeypatch, curve, T):
    """260 points in blocks of one entry: 272 blocks, so phase 2 takes two
    levels with super-blocks of 16 and K2 runs 16 steps at T threads per
    lane."""
    c = CURVES[curve]
    monkeypatch.setattr(ck, "scan_threads", lambda B, g: T)
    seen = []
    k2 = M.jac_add_multi_scan
    monkeypatch.setattr(M, "jac_add_multi_scan", lambda *a: seen.append(a[2].shape[0]) or k2(*a))
    rng = random.Random(1000 + T)
    n = 260
    pts = sample_points(rng, c, n)
    pts[9] = None
    scalars = [rng.randrange(c.fr.modulus) for _ in range(n)]
    scalars[4] = 0
    ops = curve_ops(c, "cpu")
    pad = torch.cat([ops.encode_affine(pts), torch.zeros(1, 2, ops.W, dtype=torch.int32)])
    digits = torch.from_numpy(M.scalar_digits(scalars, c=4))
    ws = M.window_sums_scan(ops, pad, digits, c=4, k_block=1)
    assert seen == [3 * M.SUPER]
    assert M.msm_ctx(c, "cpu")._host_fold(ws, 4) == M.host_msm(c, pts, scalars)


def test_lazy_headroom_check():
    """4p < R holds for both base fields (the curve kernels' fields) and
    fails for BLS12-381's Fr at 8 words, which the kernels never take."""
    for c in (BN254, BLS12_381):
        ck.check_lazy_headroom(word_field(c.fp))
    with pytest.raises(ValueError, match="4p"):
        ck.check_lazy_headroom(word_field(BLS12_381.fr))

"""The port's MSM paths (algoplonk_tpu_torch/ops/msm.py) against host EC:
both phase-2 variants of the scan, zero and tiny scalars, the scalar kinds
of msm_to_affine_int on both sides of the host threshold, and chunking.

Phase 2 has two variants: the one-level Kogge-Stone scan, and the
two-level scan (2a K2, 2b, 2c), which every commit of 2^16 points takes; a
smaller super-block makes the second reachable at test size.  Every
comparison is of affine points, exact."""

import random

import pytest
import torch

from algoplonk_tpu_torch import BN254
from algoplonk_tpu_torch.host import fp as hfp
from algoplonk_tpu_torch.ops import curve_kernels as ck
from algoplonk_tpu_torch.ops import msm as M
from algoplonk_tpu_torch.ops.curve import curve_ops
from torch_parity import affine_of, one_torch_thread, port_ints, sample_points  # noqa: F401

R = BN254.fr.modulus
P_MOD = BN254.fp.modulus
F = hfp.GF(P_MOD)


def naive(pts, scalars):
    return hfp.ec_msm(F, pts, scalars)


def port_scan(pts, scalars, c=4, k_block=4):
    """The port's window sums [nw, 3, W] and the same as affine host points."""
    ops = curve_ops(BN254, "cpu")
    pad = torch.cat([ops.encode_affine(pts), torch.zeros(1, 2, ops.W, dtype=torch.int32)])
    digits = torch.from_numpy(M.scalar_digits(scalars, c=c))
    ws = M.window_sums_scan(ops, pad, digits, c=c, k_block=k_block)
    return ws, affine_of(port_ints(ws, BN254.fp), P_MOD)


def fold(ws, c=4):
    return M.msm_ctx(BN254, "cpu")._host_fold(ws, c)


@pytest.mark.parametrize("kind", ["random", "concentrated", "sparse"])
def test_two_level_scan_matches_one_level(monkeypatch, kind):
    """Super-blocks of 2 blocks take the two-level phase 2 from 32 blocks
    on; the default of 16 leaves the same input on one level."""
    rng = random.Random(400)
    n = 130                        # 33 blocks of 4
    pts = sample_points(rng, BN254, n)
    if kind == "random":
        scalars = [rng.randrange(R) for _ in range(n)]
    elif kind == "concentrated":   # every digit of a window in one bucket
        scalars = [rng.randrange(R)] * n
    else:                          # mostly zero, some tiny
        scalars = [rng.choice([0, 0, 0, 1, 2, R - 1]) for _ in range(n)]
    scans = []                     # phase 2a runs only on two levels
    monkeypatch.setattr(
        M, "jac_add_multi_scan", lambda *a: scans.append(1) or ck.jac_add_multi_scan(*a)
    )
    monkeypatch.setattr(M, "SUPER", 2)
    ws2, got2 = port_scan(pts, scalars)
    assert len(scans) == 1
    monkeypatch.setattr(M, "SUPER", 16)
    ws1, got1 = port_scan(pts, scalars)
    assert len(scans) == 1
    assert got2 == got1
    want = naive(pts, scalars)
    assert fold(ws2) == want and fold(ws1) == want


def test_scan_zero_and_tiny():
    rng = random.Random(500)
    pts = sample_points(rng, BN254, 3)
    assert fold(port_scan(pts, [0, 0, 0])[0]) is None
    assert fold(port_scan(pts, [1, 0, 0])[0]) == pts[0]
    want = hfp.ec_add(F, hfp.ec_add(F, pts[0], pts[1]), hfp.ec_neg(F, pts[2]))
    assert fold(port_scan(pts, [1, 1, R - 1])[0]) == want


@pytest.mark.parametrize("host_max", [1024, 0], ids=["host", "device"])
def test_ctx_kinds(monkeypatch, host_max):
    """msm_to_affine_int takes ints, Montgomery words and digits, on both
    sides of the host threshold."""
    monkeypatch.setattr(M, "HOST_MSM_MAX", host_max)
    rng = random.Random(600)
    n = 9
    pts = sample_points(rng, BN254, n)
    pts[4] = None
    scalars = [rng.randrange(R) for _ in range(n)]
    scalars[5] = 0
    ctx = M.msm_ctx(BN254, "cpu")
    points = ctx.ops.encode_affine(pts)
    want = naive(pts, scalars)
    assert ctx.msm_to_affine_int(points, scalars) == want
    assert ctx.msm_to_affine_int(points, ctx.fr.encode(scalars), kind="mont") == want
    digits = torch.from_numpy(M.scalar_digits(scalars, c=3))
    assert ctx.msm_to_affine_int(points, digits, kind="digits", window_bits=3) == want


def test_chunked_msm(monkeypatch):
    """Pieces of CHUNK points, window sums added across pieces."""
    monkeypatch.setattr(M, "HOST_MSM_MAX", 0)
    monkeypatch.setattr(M, "CHUNK", 16)
    rng = random.Random(700)
    n = 40
    pts = sample_points(rng, BN254, n)
    scalars = [rng.randrange(R) for _ in range(n)]
    ctx = M.msm_ctx(BN254, "cpu")
    got = ctx.msm_to_affine_int(ctx.ops.encode_affine(pts), ctx.fr.encode(scalars), kind="mont")
    assert got == naive(pts, scalars)

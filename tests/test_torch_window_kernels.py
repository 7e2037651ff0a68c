"""K3's chains on the CPU (algoplonk_tpu_torch/ops/curve_kernels.py): the
plain versions of ``jac_add_window_scan`` and ``window_combine`` (the
launch-per-round code that ops/msm.py ran before, moved there unchanged)
against host EC arithmetic as points; then ``window_sums_scan`` on both
phase-2 paths against the JAX package's, and the chunk sum of
``msm_to_affine_int`` through K3's wrapper.  Tolerance: exact
everywhere."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import algoplonk_tpu_torch as apt
from algoplonk_tpu.fields.params import CURVES as JCURVES
from algoplonk_tpu.ops import msm as JM
from algoplonk_tpu.ops.curve import curve_ops as jax_curve_ops
from algoplonk_tpu_torch.host import fp as hfp
from algoplonk_tpu_torch.ops import curve_kernels as ck
from algoplonk_tpu_torch.ops import msm as M
from algoplonk_tpu_torch.ops.curve import curve_ops
from torch_parity import affine_of, jax_ints, one_torch_thread, port_ints, sample_points  # noqa: F401

CURVES = {"bn254": apt.BN254, "bls12_381": apt.BLS12_381}


def pad128(n):
    return -(-n // 128) * 128


def host_points(ops, x_lm):
    """Limbs-major [3, W, B] -> affine host points (None for the identity)."""
    return affine_of(port_ints(x_lm.permute(2, 0, 1), ops.curve.fp), ops.curve.fp.modulus)


def random_lanes(ops, rng, lanes, n_base=12):
    """[3, W, lanes] projective points with Z != 1 (doubled), drawn from a
    few random points and the identity."""
    base = sample_points(rng, ops.curve, n_base) + [None]
    pick = [rng.randrange(len(base)) for _ in range(lanes)]
    aff = ops.encode_affine([base[i] for i in pick])
    return ops.jac_double(ops.affine_to_jac(aff)).permute(1, 2, 0).contiguous()


def negate_lane(ops, x, dst, src):
    """x[..., dst] <- -x[..., src]."""
    x[:, :, dst] = x[:, :, src]
    x[1, :, dst] = ops.f.neg(x[1, :, src])


@pytest.mark.parametrize("E,nwin", [(1, 5), (2, 4), (3, 3), (65, 3), (257, 2)])
@pytest.mark.parametrize("curve", ["bn254", "bls12_381"])
def test_window_scan_plain_equals_rolled_loop(curve, E, nwin):
    """The rolled loop's scan, with doubling and cancelling neighbours:
    each window's prefix sums as host points."""
    ops = curve_ops(CURVES[curve], "cpu")
    rng = random.Random(E * 31 + nwin)
    B = pad128(nwin * E)
    x = random_lanes(ops, rng, B)
    if E > 2:
        x[:, :, 1] = x[:, :, 0]                    # p + p in round 1
        negate_lane(ops, x, E + 2, E + 1)          # p + (-p) in round 1
    got = ck.jac_add_window_scan(ops, x, nwin, E)
    assert got.shape == (3, ops.W, nwin * E)
    F = hfp.GF(ops.curve.fp.modulus)
    pts, want = host_points(ops, x), []
    for w in range(nwin):
        acc = None
        for i in range(E):
            acc = hfp.ec_add(F, acc, pts[w * E + i])
            want.append(acc)
    assert host_points(ops, got) == want


@pytest.mark.parametrize("c", [2, 4, 5])
@pytest.mark.parametrize("curve", ["bn254", "bls12_381"])
def test_window_combine_plain_equals_old_phase4(curve, c):
    """The launch-per-round phase 4, with identity lanes, a window whose
    P[e_D] is the identity and a doubling in the P[e_d] add: S_w as host
    points."""
    ops = curve_ops(CURVES[curve], "cpu")
    rng = random.Random(100 + c)
    nw, D = 3, 1 << (c - 1)
    B = pad128(nw * (D + 1))
    base, in_block = random_lanes(ops, rng, B), random_lanes(ops, rng, B)
    inf = ck.inf_lm(ops, 1)
    base[:, :, 0:1] = in_block[:, :, 0:1] = inf             # P[e_0] of window 0
    x_top = D + 1 + D                                        # window 1's lane D
    in_block[:, :, x_top] = base[:, :, x_top]
    in_block[1, :, x_top] = ops.f.neg(base[1, :, x_top])     # P[e_D] = identity
    in_block[:, :, 2 * (D + 1)] = base[:, :, 2 * (D + 1)]    # a doubling
    got = ck.window_combine(ops, base, in_block, nw, c)
    assert got.shape == (nw, 3, ops.W)
    F = hfp.GF(ops.curve.fp.modulus)
    pe = [hfp.ec_add(F, a, b) for a, b in zip(host_points(ops, base), host_points(ops, in_block))]
    assert pe[x_top] is None
    want = []
    for w in range(nw):
        lanes = pe[w * (D + 1) : (w + 1) * (D + 1)]
        s = None
        for p in lanes[:D]:
            s = hfp.ec_add(F, s, p)
        want.append(hfp.ec_add(F, hfp.ec_mul(F, lanes[D], D) if lanes[D] else None,
                               hfp.ec_neg(F, s) if s else None))
    assert affine_of(port_ints(got, ops.curve.fp), ops.curve.fp.modulus) == want


@pytest.mark.parametrize("path", ["one-level", "two-level"])
def test_window_sums_scan_matches_jax(monkeypatch, path):
    """window_sums_scan against the JAX package's (XLA) on the same points
    and digits: one level at n = 13, k_block = 4; two levels at k_block = 1,
    n = 260 (272 blocks, 17 super-blocks of 16); c = 4."""
    n, k_block = (13, 4) if path == "one-level" else (260, 1)
    curve = apt.BN254
    rng = random.Random(800 + n)
    pts = sample_points(rng, curve, n)
    scalars = [rng.randrange(curve.fr.modulus) for _ in range(n)]
    scalars[0] = 0
    pts[1] = None
    ops = curve_ops(curve, "cpu")
    pad = torch.cat([ops.encode_affine(pts), torch.zeros(1, 2, ops.W, dtype=torch.int32)])
    digits = M.scalar_digits(scalars, c=4)
    scans = []                     # phase 2a runs only on two levels
    monkeypatch.setattr(
        M, "jac_add_multi_scan", lambda *a: scans.append(1) or ck.jac_add_multi_scan(*a)
    )
    ws = M.window_sums_scan(ops, pad, torch.from_numpy(digits), c=4, k_block=k_block)
    assert len(scans) == (path == "two-level")
    jops = jax_curve_ops(JCURVES["bn254"])
    jpad = jnp.concatenate([jops.encode_affine(pts), jnp.zeros((1, 2, jops.L), jnp.int32)])
    jws = JM.window_sums_scan(jops, jpad, jnp.asarray(digits), c=4, k_block=k_block)
    p = curve.fp.modulus
    assert affine_of(port_ints(ws, curve.fp), p) == affine_of(
        jax_ints(np.asarray(jws), JCURVES["bn254"].fp), p)


def test_chunk_sum_goes_through_k3(monkeypatch):
    """Pieces of CHUNK points: the window sums of the pieces are added by
    K3's wrapper (the plain version on the CPU), and the MSM equals
    host_msm."""
    monkeypatch.setattr(M, "HOST_MSM_MAX", 0)
    monkeypatch.setattr(M, "CHUNK", 16)
    calls = []
    monkeypatch.setattr(M, "jac_add", lambda *a: calls.append(a[1].shape) or ck.jac_add(*a))
    curve = apt.BN254
    rng = random.Random(900)
    n = 40
    pts = sample_points(rng, curve, n)
    scalars = [rng.randrange(curve.fr.modulus) for _ in range(n)]
    ctx = M.msm_ctx(curve, "cpu")
    got = ctx.msm_to_affine_int(ctx.ops.encode_affine(pts), ctx.fr.encode(scalars), kind="mont")
    assert got == M.host_msm(curve, pts, scalars)
    nw = M.num_windows(M.pick_window_bits(n))
    assert calls == [(3, ctx.ops.W, nw)] * 2      # three pieces, one-level each

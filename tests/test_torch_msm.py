"""The port's MSM (algoplonk_tpu_torch/ops/msm.py) against the reference:
the window digits and the JAX prefix scan at c = 4, k_block = 4 (as
tests/test_msm.py runs it), and ``host_msm`` / naive host EC for whole MSMs.

tests/test_torch_msm_paths.py covers the port's own paths (both phase-2
variants, the kinds of msm_to_affine_int, chunking).  Every comparison is of
affine points or digits, exact."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from algoplonk_tpu.fields.params import BN254 as JBN254
from algoplonk_tpu.ops import msm as JM
from algoplonk_tpu.ops.curve import curve_ops as jax_curve_ops
from algoplonk_tpu_torch import BN254
from algoplonk_tpu_torch.host import fp as hfp
from algoplonk_tpu_torch.ops import msm as M
from algoplonk_tpu_torch.ops.curve import curve_ops
from algoplonk_tpu_torch.ops.field import field_ops
from torch_parity import affine_of, jax_ints, one_torch_thread, port_ints, sample_points  # noqa: F401

R = BN254.fr.modulus
P_MOD = BN254.fp.modulus
F = hfp.GF(P_MOD)


def naive(pts, scalars):
    return hfp.ec_msm(F, pts, scalars)


def port_scan(pts, scalars, c=4, k_block=4):
    """The port's window sums [nw] as affine host points."""
    ops = curve_ops(BN254, "cpu")
    pad = torch.cat([ops.encode_affine(pts), torch.zeros(1, 2, ops.W, dtype=torch.int32)])
    digits = torch.from_numpy(M.scalar_digits(scalars, c=c))
    ws = M.window_sums_scan(ops, pad, digits, c=c, k_block=k_block)
    return ws, affine_of(port_ints(ws, BN254.fp), P_MOD)


def fold(ws, c=4):
    return M.msm_ctx(BN254, "cpu")._host_fold(ws, c)


@pytest.mark.parametrize("c", [4, 11])
def test_scalar_digits_match_reference(c):
    rng = random.Random(c)
    scalars = [0, 1, R - 1, (1 << 254) - 1] + [rng.randrange(R) for _ in range(28)]
    got = M.scalar_digits(scalars, c=c)
    assert np.array_equal(got, JM.scalar_digits(scalars, c=c))
    assert M.num_windows(c) == JM.num_windows(c) == got.shape[0]
    weights = [1 << (c * w) for w in range(got.shape[0])]
    assert [sum(int(d) * wt for d, wt in zip(got[:, i], weights)) for i in range(len(scalars))] == scalars


@pytest.mark.parametrize("c", [3, 4, 11, 12])
def test_digits_from_mont_words(c):
    """The device recode from Montgomery words equals the host recode."""
    rng = random.Random(100 + c)
    scalars = [0, 1, R - 1, R // 2] + [rng.randrange(R) for _ in range(20)]
    f = field_ops(BN254.fr, "cpu")
    got = M.digits_from_mont_limbs(f, f.encode(scalars), c=c)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), M.scalar_digits(scalars, c=c))


def test_pick_window_bits_matches_reference():
    for n in [1, 2, 3, 9, 100, 1025, 1 << 16, (1 << 16) + 3, 1 << 18]:
        assert M.pick_window_bits(n) == JM.pick_window_bits(n)


@pytest.mark.parametrize("n", [1, 2, 7, 40])
def test_host_msm(n):
    rng = random.Random(200 + n)
    pts = sample_points(rng, BN254, n)
    scalars = [rng.randrange(R) for _ in range(n)]
    if n > 2:
        pts[2] = None
        scalars[1] = 0
    want = naive(pts, scalars)
    assert M.host_msm(BN254, pts, scalars) == want
    assert JM.host_msm(JBN254, pts, scalars) == want


@pytest.mark.parametrize("n", [40, 300])
def test_host_msm_repeated_and_cancelling_points(n):
    """The port's Jacobian sums through their edges: a bucket that adds a
    point to itself (a doubling), one that adds a point to its negation
    (the identity), scalars 1, r - 1 and r - 2, and an MSM whose terms all
    cancel; the same points as the reference's affine host_msm."""
    rng = random.Random(400 + n)
    base = sample_points(rng, BN254, 6)
    pts = [rng.choice(base) for _ in range(n)]
    scalars = [rng.choice([1, 2, R - 1, R - 2, rng.randrange(R)]) for _ in range(n)]
    pts[1], scalars[1] = pts[0], scalars[0]
    pts[3], scalars[3] = hfp.ec_neg(F, pts[2]), scalars[2]
    assert M.host_msm(BN254, pts, scalars) == JM.host_msm(JBN254, pts, scalars)
    assert M.host_msm(BN254, pts[2:4], scalars[2:4]) is None
    assert M.host_msm(BN254, pts[:2], scalars[:2]) == hfp.ec_mul(F, pts[0], 2 * scalars[0] % R)


def test_window_sums_match_jax_scan():
    """Per-window sums of the port's scan against the JAX (XLA) scan on the
    same points and digits, n = 13 (not a multiple of the block)."""
    rng = random.Random(300)
    n = 13
    pts = sample_points(rng, BN254, n)
    scalars = [rng.randrange(R) for _ in range(n)]
    scalars[0] = 0
    pts[1] = None
    ws, got = port_scan(pts, scalars)
    jops = jax_curve_ops(JBN254)
    jpad = jnp.concatenate([jops.encode_affine(pts), jnp.zeros((1, 2, jops.L), jnp.int32)])
    jws = JM.window_sums_scan(
        jops, jpad, jnp.asarray(JM.scalar_digits(scalars, c=4)), c=4, k_block=4
    )
    want = affine_of(jax_ints(np.asarray(jws), JBN254.fp), P_MOD)
    assert got == want
    assert fold(ws) == naive(pts, scalars)

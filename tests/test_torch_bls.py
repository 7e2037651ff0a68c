"""BLS12-381 in the port at its own widths: the base field at W = 12 words
(R = 2^384) and the scalar field at W = 8, against the JAX reference's field
ops; the curve adds against host EC arithmetic; and the device-pipeline MSM
(its kernels' plain versions, two-level phase 2) against ``host_msm`` at both
fuse depths of K1, 8 and 16 (the depths of the reference's 33-limb trap,
KNOWN_ISSUES.md).  Every comparison is on decoded ints or affine points, and
exact."""

import random

import pytest
import torch

from algoplonk_tpu.fields.params import BLS12_381_FP, BLS12_381_FR
from algoplonk_tpu.ops.field import field_ops as jax_field_ops
from algoplonk_tpu_torch import BLS12_381
from algoplonk_tpu_torch.fields import params as tparams
from algoplonk_tpu_torch.fields import words as Wd
from algoplonk_tpu_torch.host import fp as hfp
from algoplonk_tpu_torch.ops import msm as M
from algoplonk_tpu_torch.ops.curve import curve_ops
from algoplonk_tpu_torch.ops.field import field_ops
from torch_parity import field_values, one_torch_thread, sample_points  # noqa: F401

FIELDS = [BLS12_381_FP, BLS12_381_FR]
IDS = [fp.name for fp in FIELDS]
R = BLS12_381.fr.modulus
P_MOD = BLS12_381.fp.modulus
F = hfp.GF(P_MOD)


def port_fp(fp):
    return {"bls12_381_fp": tparams.BLS12_381_FP, "bls12_381_fr": tparams.BLS12_381_FR}[fp.name]


def operands(fp, seed):
    rng = random.Random(seed)
    p = fp.modulus
    a = field_values(p, rng) + [p - 1, 0, 1]
    b = list(reversed(field_values(p, rng))) + [p - 1, p - 1, p - 1]
    return a, b


@pytest.mark.parametrize("fp", FIELDS, ids=IDS)
def test_word_widths(fp):
    wf = Wd.word_field(port_fp(fp))
    W = 12 if fp.name == "bls12_381_fp" else 8
    assert wf.W == W and wf.R == 1 << (32 * W)
    assert 2 * fp.modulus < wf.R
    assert (wf.n_prime * fp.modulus) % wf.R == wf.R - 1


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
@pytest.mark.parametrize("fp", FIELDS, ids=IDS)
def test_binary_ops_match_reference(fp, op):
    a, b = operands(fp, 2)
    jf = jax_field_ops(fp)
    tf = field_ops(port_fp(fp), "cpu")
    want = jf.decode(getattr(jf, op)(jf.encode(a), jf.encode(b)))
    assert tf.decode(getattr(tf, op)(tf.encode(a), tf.encode(b))) == want


@pytest.mark.parametrize("op", ["neg", "square", "inv"])
@pytest.mark.parametrize("fp", FIELDS, ids=IDS)
def test_unary_ops_match_reference(fp, op):
    a, _ = operands(fp, 3)
    jf = jax_field_ops(fp)
    tf = field_ops(port_fp(fp), "cpu")
    want = jf.decode(getattr(jf, op)(jf.encode(a)))
    assert tf.decode(getattr(tf, op)(tf.encode(a))) == want


def special_pairs(seed, n=8):
    """P, Q with an identity on each side, a doubling and a cancellation."""
    rng = random.Random(seed)
    P = sample_points(rng, BLS12_381, n)
    Q = sample_points(rng, BLS12_381, n)
    P[0] = None
    Q[1] = None
    Q[2] = P[2]
    Q[3] = hfp.ec_neg(F, P[3])
    return P, Q


@pytest.mark.parametrize("op", ["jac_add", "jac_add_affine", "jac_double"])
def test_curve_ops_match_host(op):
    ops = curve_ops(BLS12_381, "cpu")
    P, Q = special_pairs(21)
    p = ops.jac_double(ops.affine_to_jac(ops.encode_affine(P)))   # Z != 1
    if op == "jac_double":
        out, want = ops.jac_double(p), [hfp.ec_double(F, a) for a in P]
        want = [hfp.ec_double(F, a) for a in want]
    else:
        q = ops.encode_affine(Q)
        out = ops.jac_add(p, ops.affine_to_jac(q)) if op == "jac_add" else ops.jac_add_affine(p, q)
        want = [hfp.ec_add(F, hfp.ec_double(F, a), b) for a, b in zip(P, Q)]
    assert ops.decode_affine(ops.to_affine(out)) == want


@pytest.mark.parametrize("fuse", [8, 16])
def test_scan_two_level_matches_host(monkeypatch, fuse):
    """260 points in 17 blocks of 16, with super-blocks of one block, take
    the two-level phase 2 (K2); K1 adds ``fuse`` of each block's 16 steps
    per launch."""
    rng = random.Random(800 + fuse)
    n = 260
    pts = sample_points(rng, BLS12_381, n)
    pts[7] = None
    scalars = [rng.randrange(R) for _ in range(n)]
    scalars[3] = 0
    monkeypatch.setattr(M, "SUPER", 1)
    monkeypatch.setattr(M, "FUSE_STEPS", fuse)
    steps, scans = [], []
    k1, k2 = M.mixed_add_signed_multi, M.jac_add_multi_scan
    monkeypatch.setattr(
        M, "mixed_add_signed_multi", lambda *a: steps.append(a[3].shape[0]) or k1(*a)
    )
    monkeypatch.setattr(M, "jac_add_multi_scan", lambda *a: scans.append(1) or k2(*a))
    ops = curve_ops(BLS12_381, "cpu")
    pad = torch.cat([ops.encode_affine(pts), torch.zeros(1, 2, ops.W, dtype=torch.int32)])
    digits = torch.from_numpy(M.scalar_digits(scalars, c=4))
    ws = M.window_sums_scan(ops, pad, digits, c=4, k_block=16)
    assert max(steps) == fuse and len(scans) == 1
    assert M.msm_ctx(BLS12_381, "cpu")._host_fold(ws, 4) == M.host_msm(BLS12_381, pts, scalars)


@pytest.mark.parametrize("fuse", [8, 16])
def test_device_pipeline_msm_matches_host(monkeypatch, fuse):
    """msm_to_affine_int with every MSM on the device pipeline (plain
    versions on the CPU), Montgomery scalars, at both fuse depths."""
    monkeypatch.setattr(M, "HOST_MSM_MAX", 0)
    monkeypatch.setattr(M, "FUSE_STEPS", fuse)
    rng = random.Random(900 + fuse)
    n = 40
    pts = sample_points(rng, BLS12_381, n)
    scalars = [rng.randrange(R) for _ in range(n)]
    ctx = M.msm_ctx(BLS12_381, "cpu")
    got = ctx.msm_to_affine_int(ctx.ops.encode_affine(pts), ctx.fr.encode(scalars), kind="mont")
    assert got == M.host_msm(BLS12_381, pts, scalars)
    assert got == hfp.ec_msm(F, pts, scalars)

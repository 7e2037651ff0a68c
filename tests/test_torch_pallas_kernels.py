"""The plain versions of K5-K8 (algoplonk_tpu_torch/ops/curve_kernels.py and
field_kernels.py)
against the JAX package's XLA path, on both curves: the port of
tests/test_pallas_kernels.py without its interpret mode, which that file
marks slow.

K5 ``mixed_add`` and K6 ``mixed_add_signed`` against ``ops.jac_add_affine``
(K6 negating the point on the flagged lanes first), K7 ``jac_add_multi``
against a sequence of ``ops.jac_add``, K8 ``field_mul`` against
``field_ops.mul`` on every field it serves.  Both sides get the same values;
projective X, Y and Z must be equal mod p, exactly, since both run the same
RCB operation sequence, and the affine results must equal host EC
arithmetic.  The lanes cover identity accumulators, identity points,
doublings and cancellations.  The CUDA kernels are held word for word to
these plain versions on the GPU (tests/test_torch_cuda_kernels.py and
chip_smoke.py)."""

import random

import numpy as np
import pytest
import torch

from algoplonk_tpu.fields import params as jparams
from algoplonk_tpu.ops.curve import curve_ops as jax_curve_ops
from algoplonk_tpu.ops.field import field_ops as jax_field_ops
from algoplonk_tpu_torch.fields import params as tparams
from algoplonk_tpu_torch.host import fp as hfp
from algoplonk_tpu_torch.ops import curve_kernels as ck
from algoplonk_tpu_torch.ops import field_kernels as fk
from algoplonk_tpu_torch.ops.curve import curve_ops
from algoplonk_tpu_torch.ops.field import field_ops
from torch_parity import field_values, jax_ints, one_torch_thread, port_ints, sample_points  # noqa: F401

B = 8
CURVES = ["bn254", "bls12_381"]


def curves(name):
    return tparams.CURVES[name], jparams.CURVES[name]


def operand_points(curve, seed):
    rng = random.Random(seed)
    F = hfp.GF(curve.fp.modulus)
    P = sample_points(rng, curve, B)
    Q = sample_points(rng, curve, B)
    P[0] = None                       # identity accumulator
    Q[1] = None                       # identity point (bucket padding)
    Q[2] = P[2]                       # doubling
    Q[3] = hfp.ec_neg(F, P[3])        # cancellation
    return P, Q, F


def port_proj(ops, points):
    """Affine points -> doubled projective, batch-major [B, 3, W] (Z != 1)."""
    return ops.jac_double(ops.affine_to_jac(ops.encode_affine(points)))


def lm(bm):
    return bm.permute(1, 2, 0).contiguous()


def assert_same(curve, jcurve, got_lm, want_bm):
    """Port limbs-major [3, W, B] == reference batch-major [B, 3, L]."""
    got = port_ints(got_lm.permute(2, 0, 1), curve.fp)
    assert got == jax_ints(np.asarray(want_bm), jcurve.fp)


def host_dbl(F, P):
    return [hfp.ec_double(F, a) for a in P]


@pytest.mark.parametrize("name", CURVES)
def test_k5_mixed_add_matches_xla(name):
    curve, jcurve = curves(name)
    ops, jops = curve_ops(curve, "cpu"), jax_curve_ops(jcurve)
    P, Q, F = operand_points(curve, 51)
    acc = port_proj(ops, P)
    got = ck.mixed_add(ops, lm(acc), lm(ops.encode_affine(Q)))
    jacc = jops.jac_double(jops.affine_to_jac(jops.encode_affine(P)))
    assert_same(curve, jcurve, got, jops.jac_add_affine(jacc, jops.encode_affine(Q)))
    want = [hfp.ec_add(F, a, b) for a, b in zip(host_dbl(F, P), Q)]
    assert ops.decode_affine(ops.to_affine(got.permute(2, 0, 1))) == want


@pytest.mark.parametrize("name", CURVES)
def test_k6_mixed_add_signed_matches_xla(name):
    curve, jcurve = curves(name)
    ops, jops = curve_ops(curve, "cpu"), jax_curve_ops(jcurve)
    P, Q, F = operand_points(curve, 61)
    neg = [0, 1, 0, 0, 1, 0, 1, 1]    # lane 1 negates the identity
    acc = port_proj(ops, P)
    got = ck.mixed_add_signed(
        ops, lm(acc), lm(ops.encode_affine(Q)), torch.tensor([neg], dtype=torch.int32)
    )
    signed = [hfp.ec_neg(F, q) if s and q is not None else q for q, s in zip(Q, neg)]
    jacc = jops.jac_double(jops.affine_to_jac(jops.encode_affine(P)))
    assert_same(curve, jcurve, got, jops.jac_add_affine(jacc, jops.encode_affine(signed)))
    want = [hfp.ec_add(F, a, b) for a, b in zip(host_dbl(F, P), signed)]
    assert ops.decode_affine(ops.to_affine(got.permute(2, 0, 1))) == want


@pytest.mark.parametrize("name", CURVES)
def test_k5_is_k6_without_the_sign(name):
    """K5 and K6 share one kernel: K5's words are K6's with no lane
    negated, on identity, doubling and cancelling lanes."""
    curve, _ = curves(name)
    ops = curve_ops(curve, "cpu")
    P, Q, _ = operand_points(curve, 52)
    acc, pts = lm(port_proj(ops, P)), lm(ops.encode_affine(Q))
    no_sign = torch.zeros((1, B), dtype=torch.int32)
    assert torch.equal(ck.mixed_add(ops, acc, pts), ck.mixed_add_signed(ops, acc, pts, no_sign))


@pytest.mark.parametrize("name", CURVES)
def test_k7_jac_add_multi_matches_xla(name):
    curve, jcurve = curves(name)
    ops, jops = curve_ops(curve, "cpu"), jax_curve_ops(jcurve)
    P, Q, F = operand_points(curve, 71)
    Q2 = sample_points(random.Random(72), curve, B)
    Q2[5] = None
    qs = torch.cat([lm(port_proj(ops, Q)), lm(port_proj(ops, Q2))])   # [3g, W, B]
    got = ck.jac_add_multi(ops, lm(port_proj(ops, P)), qs)
    assert got.shape == (3, ops.W, B)

    def jproj(points):
        return jops.jac_double(jops.affine_to_jac(jops.encode_affine(points)))

    want_bm = jops.jac_add(jops.jac_add(jproj(P), jproj(Q)), jproj(Q2))
    assert_same(curve, jcurve, got, want_bm)
    want = [
        hfp.ec_add(F, hfp.ec_add(F, a, b), c)
        for a, b, c in zip(host_dbl(F, P), host_dbl(F, Q), host_dbl(F, Q2))
    ]
    assert ops.decode_affine(ops.to_affine(got.permute(2, 0, 1))) == want


@pytest.mark.parametrize("field", ["bn254_fr", "bn254_fp", "bls12_381_fr", "bls12_381_fp"])
def test_k8_field_mul_matches_xla(field):
    curve = tparams.CURVES[field.rsplit("_", 1)[0]]
    fp = curve.fr if field.endswith("fr") else curve.fp
    jfp = getattr(jparams.CURVES[curve.name], "fr" if field.endswith("fr") else "fp")
    rng = random.Random(81)
    p = fp.modulus
    xs = field_values(p, rng, 12) + [0, p - 1]
    ys = list(reversed(field_values(p, rng, 12))) + [p - 1, 0]
    f, jf = field_ops(fp, "cpu"), jax_field_ops(jfp)
    got = fk.field_mul(f, f.encode(xs), f.encode(ys))
    assert got.shape == (len(xs), f.W)
    assert f.decode(got) == jf.decode(jf.mul(jf.encode(xs), jf.encode(ys)))
    assert f.decode(got) == [x * y % p for x, y in zip(xs, ys)]


def test_wrappers_never_fall_back_off_cpu():
    """A tensor that is not on the CPU never takes the plain version: on a
    device other than CUDA each wrapper refuses it before any build."""
    ops = curve_ops(tparams.BLS12_381, "cpu")
    acc = torch.empty((3, ops.W, B), dtype=torch.int32, device="meta")
    pts = torch.empty((2, ops.W, B), dtype=torch.int32, device="meta")
    neg = torch.empty((1, B), dtype=torch.int32, device="meta")
    for call in (lambda: ck.mixed_add(ops, acc, pts),
                 lambda: ck.mixed_add_signed(ops, acc, pts, neg),
                 lambda: ck.jac_add_multi(ops, acc, acc),
                 lambda: fk.field_mul(ops.f, pts[0], pts[0]),
                 lambda: fk.field_add(ops.f, pts[0], pts[0]),
                 lambda: fk.field_neg(ops.f, pts[0])):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()


def test_curve_kernels_built_once_per_width():
    """The curve sources compile in one nvcc process per width, and an entry
    point of a width that is not built is refused before any build."""
    from algoplonk_tpu_torch.ops import _build

    units = {name: flags for _, flags, name in _build._units()}
    for src in ("curve_kernels.cu", "field_kernels.cu", "msm_kernels.cu"):
        for w in (8, 12):
            assert units[f"{src}.w{w}.o"] == [f"-DAP_W={w}"]
    assert units["ntt_kernels.cu.o"] == []
    with pytest.raises(NotImplementedError, match="built for W"):
        _build.entry("ap_canon", 16)

"""The port's standalone KZG and G1 NTT (ToLagrangeG1) on the CPU.

KZG commit / open / verify_opening on the port's test SRS at 8 coefficients
and at 6 (not a power of two: the quotient is zero-padded to 8 rows), held
to the reference ``KZG`` on the same points (host ints through the
reference's ``encode_affine``) and coefficients.  ``to_lagrange_g1`` at
n = 8 against host arithmetic, out[j] = (1/n) sum_i w^(-ij) P_i, and
commit == commit_lagrange; against the reference's own ``to_lagrange_g1``
in a slow test, as the reference marks its own."""

import dataclasses
import random

import jax.numpy as jnp
import numpy as np
import pytest

import algoplonk_tpu as ap
import algoplonk_tpu_torch as apt
from algoplonk_tpu.ops.curve import curve_ops as ref_curve_ops
from algoplonk_tpu.ops.field import field_ops as ref_field_ops
from algoplonk_tpu.ops.kzg import KZG as RefKZG
from algoplonk_tpu_torch.fields.params import domain_generator
from algoplonk_tpu_torch.host import fp as hfp
from algoplonk_tpu_torch.ops.curve import curve_ops
from algoplonk_tpu_torch.ops.field import field_ops
from algoplonk_tpu_torch.ops.gntt import to_lagrange_g1
from algoplonk_tpu_torch.ops.kzg import KZG
from algoplonk_tpu_torch.ops.ntt import ntt_plan
from algoplonk_tpu_torch.setups import srs as srs_mod
from torch_parity import one_torch_thread  # noqa: F401

CURVE = apt.BN254
LOG_N, N = 3, 8


@pytest.fixture(scope="module")
def srs():
    """The port's test SRS of 8 + 3 points on the CPU."""
    return srs_mod.test_only_srs(CURVE, N + 3, device="cpu")


@pytest.fixture(scope="module")
def kzg(srs):
    return KZG(CURVE, srs.g1_limbs, srs.vk_g1, srs.vk_g2)


@pytest.fixture(scope="module")
def lagrange(srs):
    """The port's Lagrange SRS of the first 8 points, [8, 2, W] on the CPU."""
    return to_lagrange_g1("bn254", srs.g1_limbs[:N], LOG_N)


@pytest.mark.parametrize("n_coeffs", [8, 6])
def test_kzg_commit_open_verify_matches_reference(srs, kzg, n_coeffs):
    rng = random.Random(0xC0 + n_coeffs)
    r = CURVE.fr.modulus
    coeffs_int = [rng.randrange(r) for _ in range(n_coeffs)]
    z = rng.randrange(r)
    f = field_ops(CURVE.fr, "cpu")
    coeffs = f.encode(coeffs_int)
    C = kzg.commit(coeffs)
    opening = kzg.open(coeffs, z)
    assert opening.value == sum(c * pow(z, i, r) for i, c in enumerate(coeffs_int)) % r
    assert kzg.verify_opening(C, opening, z)
    bad = dataclasses.replace(opening, value=(opening.value + 1) % r)
    assert not kzg.verify_opening(C, bad, z)

    points = curve_ops(CURVE, "cpu").decode_affine(srs.g1_limbs)
    ref = RefKZG(ap.BN254, ref_curve_ops(ap.BN254).encode_affine(points),
                 srs.vk_g1, srs.vk_g2)
    ref_coeffs = jnp.asarray(ref_field_ops(ap.BN254.fr).encode(coeffs_int))
    ref_opening = ref.open(ref_coeffs, z)
    assert C == ref.commit(ref_coeffs)
    assert (opening.value, opening.proof) == (ref_opening.value, ref_opening.proof)


def host_intt_g1(points, log_n):
    """out[j] = (1/n) sum_i w^(-ij) P_i on host ints."""
    F = hfp.GF(CURVE.fp.modulus)
    r = CURVE.fr.modulus
    n = 1 << log_n
    w_inv = pow(domain_generator("bn254", log_n), -1, r)
    n_inv = pow(n, -1, r)
    out = []
    for j in range(n):
        acc = None
        for i, P in enumerate(points):
            acc = hfp.ec_add(F, acc, hfp.ec_mul(F, P, pow(w_inv, i * j, r) * n_inv % r))
        out.append(acc)
    return out


def test_to_lagrange_g1_matches_host(srs, lagrange):
    ops = curve_ops(CURVE, "cpu")
    points = ops.decode_affine(srs.g1_limbs[:N])
    assert tuple(lagrange.shape) == (N, 2, ops.W)
    assert ops.decode_affine(lagrange) == host_intt_g1(points, LOG_N)


def test_commit_equals_commit_lagrange(kzg, lagrange):
    """commit_monomial(coeffs) == commit_lagrange(evals) after ToLagrangeG1
    (the property gnark's SRS conversion guarantees, setup/setup.go:124-142)."""
    rng = random.Random(0x1A6)
    f = field_ops(CURVE.fr, "cpu")
    coeffs = f.encode([rng.randrange(CURVE.fr.modulus) for _ in range(N)])
    evals = ntt_plan("bn254", LOG_N, "cpu").ntt(coeffs)
    assert kzg.commit(coeffs) == kzg.commit_lagrange(evals, lagrange)


@pytest.mark.slow  # the reference's to_lagrange_g1 is slow-marked in its own tests
def test_to_lagrange_g1_matches_reference(srs, lagrange):
    from algoplonk_tpu.ops.gntt import to_lagrange_g1 as ref_to_lagrange_g1

    points = curve_ops(CURVE, "cpu").decode_affine(srs.g1_limbs[:N])
    ref_ops = ref_curve_ops(ap.BN254)
    ref = ref_to_lagrange_g1("bn254", ref_ops.encode_affine(points), LOG_N)
    assert ref_ops.decode_affine(np.asarray(ref)) == \
        curve_ops(CURVE, "cpu").decode_affine(lagrange)

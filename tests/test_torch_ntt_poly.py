"""The port's NTT (ops/ntt.py) and polynomial scans (ops/poly.py) against
the JAX reference's ops/ntt.py and ops/poly.py, on BN254's scalar field.
Every comparison is of decoded ints, exact."""

import random

import pytest

from algoplonk_tpu.fields import params as jparams
from algoplonk_tpu.ops import poly as jpoly
from algoplonk_tpu.ops.field import field_ops as jax_field_ops
from algoplonk_tpu.ops.ntt import ntt_plan as jax_ntt_plan
from algoplonk_tpu_torch import BN254
from algoplonk_tpu_torch.fields import params as tparams
from algoplonk_tpu_torch.ops import poly
from algoplonk_tpu_torch.ops.field import field_ops
from algoplonk_tpu_torch.ops.ntt import ntt_plan
from torch_parity import one_torch_thread  # noqa: F401

R = BN254.fr.modulus


def rand_ints(seed, n, zeros=()):
    rng = random.Random(seed)
    xs = [rng.randrange(R) for _ in range(n)]
    for i in zeros:
        xs[i] = 0
    return xs


@pytest.fixture(scope="module")
def fields():
    return jax_field_ops(jparams.BN254.fr), field_ops(BN254.fr, "cpu")


@pytest.mark.parametrize("log_n", [3, 4])
def test_ntt_intt_match_reference(log_n):
    xs = rand_ints(log_n, 1 << log_n)
    jp, tp = jax_ntt_plan("bn254", log_n), ntt_plan("bn254", log_n, "cpu")
    assert tp.omega == jp.omega
    jf, tf = jp.f, tp.f
    evals = tp.ntt(tf.encode(xs))
    assert tf.decode(evals) == jf.decode(jp.ntt(jf.encode(xs)))
    assert tf.decode(tp.intt(tf.encode(xs))) == jf.decode(jp.intt(jf.encode(xs)))
    assert tf.decode(tp.intt(evals)) == xs


@pytest.mark.parametrize("shift", ["coset", 7])
def test_coset_ntt_match_reference(shift):
    shift = BN254.coset_shift if shift == "coset" else shift
    log_n = 4
    xs = rand_ints(40, 1 << log_n)
    jp, tp = jax_ntt_plan("bn254", log_n), ntt_plan("bn254", log_n, "cpu")
    jf, tf = jp.f, tp.f
    evals = tp.coset_ntt(tf.encode(xs), shift)
    assert tf.decode(evals) == jf.decode(jp.coset_ntt(jf.encode(xs), shift))
    assert tf.decode(tp.coset_intt(evals, shift)) == xs


def test_ntt_plans_keyed_on_compat_mode():
    """Twiddles derive from the domain generator, which the gnark-compat
    mode selects: a plan built in one mode is never served in the other.
    The port's params module is its own instance, so both are switched."""
    plain = ntt_plan("bn254", 3, "cpu")
    try:
        tparams.set_gnark_compat(True)
        jparams.set_gnark_compat(True)
        compat = ntt_plan("bn254", 3, "cpu")
        assert compat is not plain
        assert compat.omega == tparams.domain_generator("bn254", 3)
        assert compat.omega == jax_ntt_plan("bn254", 3).omega
    finally:
        tparams.set_gnark_compat(False)
        jparams.set_gnark_compat(False)
    assert ntt_plan("bn254", 3, "cpu") is plain


def test_prefix_products_and_powers(fields):
    jf, tf = fields
    xs = rand_ints(50, 64, zeros=[9])
    want = jf.decode(jpoly.prefix_products(jf, jf.encode(xs)))
    assert tf.decode(poly.prefix_products(tf, tf.encode(xs))) == want
    z = 0xA1607
    for n in (1, 10, 33):
        want = jf.decode(jpoly.powers(jf, jf.encode([z])[0], n))
        assert tf.decode(poly.powers(tf, tf.encode([z])[0], n)) == want
        assert want == [pow(z, i, R) for i in range(n)]


@pytest.mark.parametrize("n,stop", [(37, 4), (64, 256)])
def test_batch_inverse_tree(fields, n, stop):
    jf, tf = fields
    xs = rand_ints(60 + n, n, zeros=[0, 5])
    got = tf.decode(poly.batch_inverse_tree(tf, tf.encode(xs), stop=stop))
    assert got == jf.decode(jpoly.batch_inverse_tree(jf, jf.encode(xs), stop=stop))
    assert got == [pow(x, -1, R) if x else 0 for x in xs]


def test_kzg_quotient_and_horner(fields):
    """(p(X) - p(z)) / (X - z) on a length that is not a power of two."""
    jf, tf = fields
    coeffs = rand_ints(70, 37)
    z = 0xC0FFEE
    tq, tv = poly.kzg_quotient(tf, tf.encode(coeffs), tf.encode([z])[0])
    jq, jv = jpoly.kzg_quotient(jf, jf.encode(coeffs), jf.encode([z])[0])
    q = tf.decode(tq)
    assert q == jf.decode(jq)
    assert tf.decode(tv[None]) == jf.decode(jv[None])
    p_z = sum(c * pow(z, i, R) for i, c in enumerate(coeffs)) % R
    assert tf.decode(tv[None]) == [p_z]
    # q(X) (X - z) + p(z) == p(X)
    prod = [0] * (len(q) + 1)
    for i, c in enumerate(q):
        prod[i + 1] = (prod[i + 1] + c) % R
        prod[i] = (prod[i] - c * z) % R
    prod[0] = (prod[0] + p_z) % R
    assert prod[: len(coeffs)] == coeffs and not any(prod[len(coeffs):])


def test_poly_eval_many(fields, monkeypatch):
    jf, tf = fields
    polys = [rand_ints(80, 16), rand_ints(81, 9), rand_ints(82, 33)]
    z = 0xBEEF
    want = [sum(c * pow(z, i, R) for i, c in enumerate(p)) % R for p in polys]
    jz, tz = jf.encode([z])[0], tf.encode([z])[0]
    assert jf.decode(jpoly.poly_eval_many(jf, [jf.encode(p) for p in polys], jz)) == want
    tpolys = [tf.encode(p) for p in polys]
    assert tf.decode(poly.poly_eval_many(tf, tpolys, tz)) == want
    monkeypatch.setattr(poly, "_EVAL_BLOCK", 8)   # the blocked branch
    assert tf.decode(poly.poly_eval_many(tf, tpolys, tz)) == want

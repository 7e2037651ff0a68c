"""The port's field ops (algoplonk_tpu_torch/ops/field.py) against the JAX
reference's ops/field.py on both BN254 fields.

The two store numbers differently (32-bit words with R = 2^256 against
12-bit limbs with R = 2^264), so every comparison is on decoded canonical
ints, and it is exact."""

import random

import numpy as np
import pytest
import torch

from algoplonk_tpu.fields import limbs as jax_limbs
from algoplonk_tpu.fields.params import BN254_FP, BN254_FR
from algoplonk_tpu.ops.field import field_ops as jax_field_ops
from algoplonk_tpu_torch.fields import params as tparams
from algoplonk_tpu_torch.fields import words as Wd
from algoplonk_tpu_torch.ops.field import field_ops
from torch_parity import field_values, jax_ints, mont_words_to_jax_limbs, one_torch_thread, port_ints  # noqa: F401

FIELDS = [BN254_FR, BN254_FP]
IDS = [fp.name for fp in FIELDS]


def port_fp(fp):
    """The port's instance of the same field (its own params module)."""
    return {"bn254_fr": tparams.BN254_FR, "bn254_fp": tparams.BN254_FP}[fp.name]


def operands(fp, seed):
    rng = random.Random(seed)
    p = fp.modulus
    a = field_values(p, rng)
    b = list(reversed(field_values(p, rng)))
    a += [p - 1, 0, 1]
    b += [p - 1, p - 1, p - 1]
    return a, b


@pytest.mark.parametrize("fp", FIELDS, ids=IDS)
def test_word_constants(fp):
    wf = Wd.word_field(port_fp(fp))
    p = fp.modulus
    assert wf.W == 8 and wf.R == 1 << 256
    assert 2 * p < wf.R                       # the kernels' headroom
    assert (wf.n_prime * p) % wf.R == wf.R - 1
    assert (wf.n0 * p) % (1 << 32) == (1 << 32) - 1
    assert wf.r == wf.R % p and wf.r2 == wf.R * wf.R % p


@pytest.mark.parametrize("fp", FIELDS, ids=IDS)
def test_limbs_words_roundtrip(fp):
    """Reference Montgomery limbs -> port words -> reference limbs keeps
    every value, through canonical ints."""
    a, _ = operands(fp, 1)
    tfp = port_fp(fp)
    wf = Wd.word_field(tfp)
    limbs = jax_limbs.ints_to_mont_limbs(a, fp)
    words = Wd.jax_limbs_to_mont_words(limbs, wf)
    assert words.dtype == np.int32 and words.shape == (len(a), 8)
    assert Wd.mont_words_to_ints(words, wf) == [v % fp.modulus for v in a]
    back = mont_words_to_jax_limbs(words, wf)
    assert jax_limbs.mont_limbs_to_ints(back, fp) == a
    assert jax_ints(limbs, fp) == a


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
@pytest.mark.parametrize("fp", FIELDS, ids=IDS)
def test_binary_ops_match_reference(fp, op):
    a, b = operands(fp, 2)
    jf = jax_field_ops(fp)
    tf = field_ops(port_fp(fp), "cpu")
    want = jf.decode(getattr(jf, op)(jf.encode(a), jf.encode(b)))
    got = tf.decode(getattr(tf, op)(tf.encode(a), tf.encode(b)))
    assert got == want


@pytest.mark.parametrize("op", ["neg", "square", "inv"])
@pytest.mark.parametrize("fp", FIELDS, ids=IDS)
def test_unary_ops_match_reference(fp, op):
    a, _ = operands(fp, 3)
    jf = jax_field_ops(fp)
    tf = field_ops(port_fp(fp), "cpu")
    want = jf.decode(getattr(jf, op)(jf.encode(a)))
    got = tf.decode(getattr(tf, op)(tf.encode(a)))
    assert got == want


@pytest.mark.parametrize("fp", FIELDS, ids=IDS)
def test_pow_mont_conversions(fp):
    a, _ = operands(fp, 4)
    p = fp.modulus
    jf = jax_field_ops(fp)
    tf = field_ops(port_fp(fp), "cpu")
    e = 0xA1607_0001
    want = jf.decode(jf.pow_fixed(jf.encode(a), e))
    assert tf.decode(tf.pow(tf.encode(a), e)) == want
    # to_mont / from_mont are inverse Montgomery multiplies by R^2 and 1
    plain_words = torch.from_numpy(Wd.ints_to_words(a, 8))
    mont = tf.to_mont(plain_words)
    assert port_ints(mont, port_fp(fp)) == [v % p for v in a]
    assert torch.equal(tf.from_mont(mont), plain_words)


@pytest.mark.parametrize("fp", FIELDS, ids=IDS)
def test_select_is_zero(fp):
    a, b = operands(fp, 5)
    tf = field_ops(port_fp(fp), "cpu")
    ta, tb = tf.encode(a), tf.encode(b)
    assert tf.is_zero(ta).tolist() == [v == 0 for v in a]
    cond = torch.tensor([i % 2 == 0 for i in range(len(a))])
    got = tf.decode(tf.select(cond, ta, tb))
    assert got == [x if i % 2 == 0 else y for i, (x, y) in enumerate(zip(a, b))]


@pytest.mark.parametrize("fp", FIELDS, ids=IDS)
def test_encode_reduces_any_int(fp):
    """The port's encoder reduces mod p and takes negative ints, where the
    reference's encode_bytes requires canonical non-negative input."""
    p = fp.modulus
    tf = field_ops(port_fp(fp), "cpu")
    vals = [-1, -p, p, p + 5, 2 * p - 1, 3 * p + 7, -(5 * p) - 3, 1 << 255]
    assert tf.decode(tf.encode(vals)) == [v % p for v in vals]
    assert tf.decode(tf.encode_bytes(vals)) == [v % p for v in vals]


@pytest.mark.parametrize("fp", FIELDS, ids=IDS)
def test_broadcast_and_wide_batches(fp):
    """One element against a batch, and a batch wide enough to take the
    shift-and-add column product instead of the outer product."""
    rng = random.Random(6)
    p = fp.modulus
    tf = field_ops(port_fp(fp), "cpu")
    xs = [rng.randrange(p) for _ in range(300)] + [p - 1, 0]
    k = rng.randrange(p)
    got = tf.decode(tf.mul(tf.encode(xs), tf.encode([k])[0]))
    assert got == [x * k % p for x in xs]
    ys = [rng.randrange(p) for _ in xs]
    got = tf.decode(tf.mul(tf.encode(xs).reshape(2, -1, 8), tf.encode(ys).reshape(2, -1, 8)))
    assert got == [x * y % p for x, y in zip(xs, ys)]

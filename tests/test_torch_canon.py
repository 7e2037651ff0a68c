"""K4 (``canon``) on the CPU: the plain version's ladder of conditional
subtractions (algoplonk_tpu_torch/ops/curve_kernels.py plain_canon, the
CUDA kernel's arithmetic) against the strict Montgomery multiply by R mod p
that it replaces and against the JAX ``pallas_canon`` in interpret mode,
on BN254's Fp (W = 8) and BLS12-381's Fp (W = 12).

The values are every edge of the ladder (0, 1, p - 1, p, k p - 1, k p and
k p + 1 for every k up to the field's largest quotient, 2^(32 W) - 1 and
2^(32 W - 1)) and seeded random words.  The result must be x mod p exactly,
word for word on the port's side and as integers on the reference's.  The
CUDA kernel is held word for word to this plain version on the GPU
(tests/test_torch_cuda_kernels.py and chip_smoke.py)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from algoplonk_tpu.fields import limbs as jax_limbs
from algoplonk_tpu.fields import params as jparams
from algoplonk_tpu.ops import curve_pallas as cp
from algoplonk_tpu_torch.fields import params as tparams
from algoplonk_tpu_torch.fields.words import ints_to_words, words_to_ints
from algoplonk_tpu_torch.ops import curve_kernels as ck
from algoplonk_tpu_torch.ops.curve import curve_ops
from algoplonk_tpu_torch.ops.field import plain_mul
from torch_parity import canon_edge_values, one_torch_thread  # noqa: F401

ROWS, B = 3, 16     # B: two interpret-mode tiles of 8 lanes
STEPS = {"bn254": 3, "bls12_381": 4}


def values(name):
    ops = curve_ops(tparams.CURVES[name], "cpu")
    vals = canon_edge_values(ops.wf.modulus, ops.W, random.Random(40), ROWS * B)
    words = torch.from_numpy(ints_to_words(vals, ops.W))             # [R B, W]
    return ops, vals, words.reshape(ROWS, B, ops.W).permute(0, 2, 1).contiguous()


def ints(lm):
    """[R, W, B] words -> their integers, row by row and lane by lane."""
    return words_to_ints(lm.permute(0, 2, 1).reshape(-1, lm.shape[1]).numpy())


@pytest.mark.parametrize("name", ["bn254", "bls12_381"])
def test_ladder_length_and_multiples(name):
    """Every W-word value is below 2^steps p, and the ladder subtracts
    2^(steps-1) p, ..., 2p, p: 3 steps on BN254's Fp, 4 on BLS12-381's."""
    wf = curve_ops(tparams.CURVES[name], "cpu").wf
    steps = ck.canon_steps(wf)
    assert steps == STEPS[name]
    assert wf.R - 1 < (wf.modulus << steps)
    assert wf.R - 1 >= (wf.modulus << (steps - 1))
    assert ck.canon_ladder(wf) == [wf.modulus << j for j in reversed(range(steps))]


@pytest.mark.parametrize("name", ["bn254", "bls12_381"])
def test_ladder_equals_the_multiply_by_one(name):
    """The ladder's words equal the strict Montgomery multiply by R mod p
    (the port's plain_mul, and host integers x (R mod p) R^-1 mod p), and
    both are x mod p."""
    ops, vals, x = values(name)
    wf, f = ops.wf, ops.f
    got = ck.canon(ops, x)
    assert got.shape == x.shape and got.dtype == torch.int32
    p = wf.modulus
    assert ints(got) == [v % p for v in vals]
    by_one = plain_mul(f, x.transpose(1, 2), f.one).transpose(1, 2)
    assert torch.equal(got, by_one)
    r_inv = pow(wf.R, -1, p)
    assert ints(got) == [v * (wf.R % p) * r_inv % p for v in vals]


@pytest.mark.parametrize("name", ["bn254", "bls12_381"])
def test_ladder_matches_pallas_canon(name):
    """The JAX pallas_canon (interpret mode) takes the same integers as its
    limbs and returns x mod p."""
    ops, vals, x = values(name)
    jfp = jparams.CURVES[name].fp
    limbs = jax_limbs.ints_to_limbs(vals, jfp).reshape(ROWS, B, -1).transpose(0, 2, 1)
    want = cp.pallas_canon(jfp, 8)(jnp.asarray(np.ascontiguousarray(limbs)))
    want_ints = jax_limbs.limbs_to_ints(np.asarray(want).transpose(0, 2, 1))
    assert want_ints == [v % jfp.modulus for v in vals]
    assert ints(ck.canon(ops, x)) == want_ints

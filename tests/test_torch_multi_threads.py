"""K7 with several threads per lane, and K6's threads per lane, on the CPU
through the plain versions (algoplonk_tpu_torch/ops/curve_kernels.py), on
both curves.

K7 runs T threads per lane and re-associates the sum (each thread sums g/T
steps, a tree adds the partial sums); its plain version follows the same
association, so the two stay equal word for word
(tests/test_torch_cuda_kernels.py checks that on a GPU).  Here: every T
that ``multi_threads`` can pick gives the sequential sum's point (compared
projectively on host ints) on lanes with an identity accumulator, an
identity step, a doubling, cancellations and a sum that ends at Z = 0; T = 1
equals the JAX package's sequence of ``ops.jac_add`` exactly, mod p; and
the thread counts of K7 and K6 depend on the shape alone."""

import numpy as np
import pytest
import torch

from algoplonk_tpu.fields import params as jparams
from algoplonk_tpu.ops.curve import curve_ops as jax_curve_ops
from algoplonk_tpu_torch.fields.words import word_field
from algoplonk_tpu_torch.ops import curve_kernels as ck
from test_torch_scan_threads import CURVES, STEPS, projective_ints, same_point, special_scan
from torch_parity import jax_ints, mont_words_to_jax_limbs, one_torch_thread, port_ints  # noqa: F401

ZERO_LANE = 5   # special_scan's lanes 0-4 hold its own cases


def multi_inputs(curve, seed):
    """special_scan's acc and qs, with the last step of lane ZERO_LANE set to
    minus the sum before it, so that the lane's sum is the identity."""
    ops, acc, qs = special_scan(curve, seed)
    head = ck.plain_jac_add_multi(ops, acc, qs[:-3], 1)[:, :, ZERO_LANE]   # [3, W]
    qs[-3:, :, ZERO_LANE] = torch.stack([head[0], ops.f.neg(head[1][None])[0], head[2]])
    return ops, acc, qs


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_every_t_gives_the_sequential_sum(curve):
    c = CURVES[curve]
    p = c.fp.modulus
    ops, acc, qs = multi_inputs(c, 41)
    seq = ck.plain_jac_add_multi(ops, acc, qs, 1)
    assert seq.shape == acc.shape
    want = projective_ints(seq, c)[0]
    assert want[ZERO_LANE][2] == 0
    # T = 1 is the last row of the sequential scan
    assert torch.equal(seq, ck.plain_jac_add_multi_scan(ops, acc, qs, 1)[-3:])
    for T in ck.MULTI_THREADS[1:]:
        got = projective_ints(ck.plain_jac_add_multi(ops, acc, qs, T), c)[0]
        assert all(same_point(a, b, p) for a, b in zip(got, want)), T
        assert got[ZERO_LANE][2] == 0, T


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_t1_equals_the_jax_sequence_of_jac_add(curve):
    """T = 1 against ``ops.jac_add`` of the JAX package applied step by step
    to the same projective inputs: X, Y and Z equal mod p."""
    c = CURVES[curve]
    jops = jax_curve_ops(jparams.CURVES[curve])
    wf = word_field(c.fp)
    ops, acc, qs = multi_inputs(c, 43)

    def to_jax(lm):                          # [3, W, B] -> reference [B, 3, L]
        return mont_words_to_jax_limbs(lm.permute(2, 0, 1).numpy(), wf)

    want = to_jax(acc)
    for k in range(STEPS):
        want = jops.jac_add(want, to_jax(qs[3 * k : 3 * k + 3]))
    got = ck.plain_jac_add_multi(ops, acc, qs, 1)
    assert port_ints(got.permute(2, 0, 1), c.fp) == jax_ints(np.asarray(want), jparams.CURVES[curve].fp)


def test_thread_counts_are_functions_of_shape_alone(monkeypatch):
    """K7's T divides g and shrinks as lanes grow; K6's T_m is one of
    MIXED_THREADS, set by width, and an unmeasured width is refused; neither
    reads the device (the CPU picks the card's association)."""
    def no_device(*a, **k):
        raise AssertionError("a thread count consulted the device")

    monkeypatch.setattr(torch.cuda, "get_device_properties", no_device)
    monkeypatch.setattr(torch.cuda, "is_available", no_device)
    for g in (0, 1, 2, 3, 6, 8, 16, 48):
        prev = None
        for B in (1, 8, 1024, 1664, 6272, 12416, 98688, 1 << 20):
            T = ck.multi_threads(B, g)
            assert T in ck.MULTI_THREADS and T <= max(g, 1) and (g == 0 or g % T == 0)
            assert ck.multi_threads(B, g) == T
            assert prev is None or T <= prev
            prev = T
    assert ck.multi_threads(1 << 20, 16) == 1
    assert ck.multi_threads(8, 16) == 16 and ck.multi_threads(8, 3) == 1
    assert ck.multi_threads(8, 6) == 2 and ck.multi_threads(8, 0) == 1
    assert [ck.mixed_threads(W) for W in (8, 12)] == [1, 2]
    assert set(ck.MIXED_THREADS_BY_WIDTH.values()) <= set(ck.MIXED_THREADS)
    with pytest.raises(ValueError, match="W = 16"):
        ck.mixed_threads(16)


@pytest.mark.parametrize("g,T", [(6, 4), (3, 2), (0, 2)])
def test_plain_refuses_t_not_dividing_g(g, T):
    ops, acc, qs = special_scan(CURVES["bn254"], 45)
    with pytest.raises(ValueError, match="divide"):
        ck.plain_jac_add_multi(ops, acc, qs[: 3 * g], T)

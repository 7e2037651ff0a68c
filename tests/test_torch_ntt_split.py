"""A four-step pass above K9's shared-memory cap (ops/ntt_kernels.py
``MAX_C``): its top stages over HBM (``ntt_stage``), then K9 on the pieces
they leave, against the pass in one piece and against the JAX reference.

On the CPU ``ntt_pass`` runs the same composition as on the card, of the
plain versions ``plain_ntt_stage`` and ``plain_ntt_pass(..., pieces=)``;
``plain_ntt_pass`` at the full C stays the reference of the composition.
``MAX_C`` is set low here so that small passes split once (C / 2) or
twice (C / 4).  The reference's ``_pass_kernel`` and four-step plan run in
interpret mode, as tests/test_ntt_pallas.py runs them.  Inputs hold 0, 1
and p - 1 among random residues; every comparison is exact."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import algoplonk_tpu_torch as apt
from algoplonk_tpu.fields import params as jparams
from algoplonk_tpu.ops.field import field_ops as jax_field_ops
from algoplonk_tpu.ops.ntt_pallas import _pass_kernel
from algoplonk_tpu.ops.ntt_pallas import four_step_plan as jax_four_step_plan
from algoplonk_tpu_torch.ops import ntt_kernels as nk
from algoplonk_tpu_torch.ops.field import field_ops
from torch_parity import jax_ints, one_torch_thread  # noqa: F401

CURVES = ("bn254", "bls12_381")
JAX_FR = {"bn254": jparams.BN254.fr, "bls12_381": jparams.BLS12_381.fr}
PORT_FR = {"bn254": apt.BN254.fr, "bls12_381": apt.BLS12_381.fr}


def rand_ints(curve: str, seed: int, n: int) -> list[int]:
    p = PORT_FR[curve].modulus
    rng = random.Random(seed)
    return [0, 1, p - 1] + [rng.randrange(p) for _ in range(n - 3)]


def to_lm(jf, ints):
    """ints -> the reference's limbs-major [L, n] Montgomery array."""
    return jnp.asarray(np.asarray(jf.encode(ints)).T)


def from_lm(curve, lm) -> list[int]:
    return jax_ints(np.asarray(lm).T, JAX_FR[curve])


class StageCalls:
    """The halves of the stages that ``ntt_pass`` runs over HBM (through
    ``ntt_stage``, whose CPU path is ``plain_ntt_stage``)."""

    def __init__(self, monkeypatch):
        self.halves = []
        real = nk.plain_ntt_stage

        def counted(f, x, tw, C, h, inverse, *a, **kw):
            self.halves.append(h)
            return real(f, x, tw, C, h, inverse, *a, **kw)

        monkeypatch.setattr(nk, "plain_ntt_stage", counted)


LAYOUTS = ("contiguous", "column", "column_in")


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("fused", [False, True], ids=["bare", "entry_exit"])
@pytest.mark.parametrize("inverse", [False, True], ids=["dif", "dit"])
@pytest.mark.parametrize("split", [1, 2], ids=["one_hbm_stage", "two_hbm_stages"])
@pytest.mark.parametrize("curve", CURVES)
def test_split_pass_equals_whole_pass(monkeypatch, curve, split, inverse, fused, layout):
    """With MAX_C at C / 2 or C / 4, ntt_pass (HBM stages, then K9's
    plain version on the pieces; DIT the other way round) equals
    plain_ntt_pass at the full C, word for word: contiguous, in the
    four-step's column layout on both sides, and on the input only."""
    C, N = 32, 128
    f = field_ops(PORT_FR[curve], "cpu")
    x = f.encode(rand_ints(curve, 1 + split, N))
    kw = {}
    if fused:
        kw = dict(entry=f.encode(rand_ints(curve, 2, N)), exit_=f.encode(rand_ints(curve, 3, N)))
    col = (N // C, 1)
    ins, outs = {"contiguous": (None, None), "column": (col, col),
                 "column_in": (col, None)}[layout]
    tw = f.encode(nk.stage_twiddles(curve, C, inverse))
    want = nk.plain_ntt_pass(f, x, tw, C, inverse, **kw, in_strides=ins, out_strides=outs)
    stages = StageCalls(monkeypatch)
    monkeypatch.setattr(nk, "MAX_C", C >> split)
    before = dict(nk.LAUNCHES)
    got = nk.ntt_pass(f, x, tw, C, inverse, **kw, in_strides=ins, out_strides=outs)
    assert torch.equal(got, want)
    top = [C >> k for k in range(1, split + 1)]            # C/2 .. MAX_C
    assert stages.halves == (top[::-1] if inverse else top)
    assert nk.LAUNCHES == before    # CPU tensors: the plain versions


@pytest.mark.parametrize("layout", ["contiguous", "column"])
@pytest.mark.parametrize("inverse", [False, True], ids=["dif", "dit"])
@pytest.mark.parametrize("curve", CURVES)
def test_plain_stage_is_one_stage_of_the_pass(curve, inverse, layout):
    """plain_ntt_stage at each half h, in the pass's order, with the entry
    multiply in the first and the exit multiply in the last, is
    plain_ntt_pass: the stage is one step of the whole pass."""
    C, N = 16, 64
    f = field_ops(PORT_FR[curve], "cpu")
    x, en, ex = (f.encode(rand_ints(curve, s, N)) for s in (4, 5, 6))
    st = (N // C, 1) if layout == "column" else None
    tw = f.encode(nk.stage_twiddles(curve, C, inverse))
    want = nk.plain_ntt_pass(f, x, tw, C, inverse, en, ex, in_strides=st, out_strides=st)
    halves = [1, 2, 4, 8] if inverse else [8, 4, 2, 1]
    for k, h in enumerate(halves):
        x = nk.plain_ntt_stage(f, x, tw, C, h, inverse, en if k == 0 else None,
                               ex if k == len(halves) - 1 else None, strides=st)
    assert torch.equal(x, want)


@pytest.mark.parametrize("fused", [False, True], ids=["bare", "entry_exit"])
@pytest.mark.parametrize("inverse", [False, True], ids=["dif", "dit"])
def test_split_pass_matches_reference_pass_kernel(monkeypatch, inverse, fused):
    """The split pass (MAX_C = 2: two HBM stages, then K9's plain version on
    pieces of 2) equals the reference's _pass_kernel at N = 64, C = 8."""
    curve, N, C = "bn254", 64, 8
    jf, tf = jax_field_ops(JAX_FR[curve]), field_ops(PORT_FR[curve], "cpu")
    xs, en, ex = (rand_ints(curve, s, N) for s in (1, 2, 3))
    run = _pass_kernel(curve, C, N, inverse, fused, fused)
    kw = dict(entry=to_lm(jf, en), exit_=to_lm(jf, ex)) if fused else {}
    want = from_lm(curve, run(to_lm(jf, xs), **kw))
    tw = tf.encode(nk.stage_twiddles(curve, C, inverse))
    tkw = dict(entry=tf.encode(en), exit_=tf.encode(ex)) if fused else {}
    stages = StageCalls(monkeypatch)
    monkeypatch.setattr(nk, "MAX_C", 2)
    got = nk.ntt_pass(tf, tf.encode(xs), tw, C, inverse, **tkw)
    assert tf.decode(got) == want
    assert sorted(stages.halves) == [2, 4]


@pytest.mark.parametrize("curve", CURVES)
def test_split_four_step_plan_matches_reference(monkeypatch, curve):
    """A plan at log 7, where n2 = 2 n1 as in the log-23 plan, with MAX_C
    = 4 so that P1 (C = 8) and P2 (C = 16) both split: ntt_scr and
    intt_scr on a coset equal the reference's ntt_scr_lm and intt_scr_lm,
    and the round trip is the identity."""
    log_n = 7
    jf, tf = jax_field_ops(JAX_FR[curve]), field_ops(PORT_FR[curve], "cpu")
    shift = apt.fields.params.CURVES[curve].coset_shift
    coeffs = rand_ints(curve, 11, 1 << log_n)
    jfs = jax_four_step_plan(curve, log_n)
    tfs = nk.four_step_plan(curve, log_n, "cpu")
    assert (tfs.n1, tfs.n2) == (8, 16)
    stages = StageCalls(monkeypatch)
    monkeypatch.setattr(nk, "MAX_C", 4)
    got = tfs.ntt_scr(tf.encode(coeffs), coset_shift=shift)
    assert stages.halves == [4, 8, 4]                      # P1 once, P2 twice
    want = from_lm(curve, jfs.ntt_scr_lm(to_lm(jf, coeffs), coset_shift=shift))
    assert tf.decode(got) == want
    back = tfs.intt_scr(got, coset_shift=shift)
    assert stages.halves == [4, 8, 4, 4, 8, 4]             # P2' twice, P1' once
    assert tf.decode(back) == coeffs
    assert tf.decode(back) == from_lm(curve, jfs.intt_scr_lm(to_lm(jf, want),
                                                             coset_shift=shift))


def test_log23_plan_splits_p2_once(monkeypatch):
    """The BLS12-381 plan of a 2^23 coset (a 2^21-row circuit) has (n1, n2)
    = (2048, 4096): P1 and P1' run K9 whole at C = 2048, and P2 and P2'
    split into one HBM stage of half 2048 and K9 on pieces of 2048.  Only
    the plan is constructed (no table) and the launches are recorded, not
    run, on zero-stride operands."""
    fsp = nk.FourStepPlan("bls12_381", 23, "cpu")
    assert (fsp.n1, fsp.n2) == (2048, 4096)
    assert nk.MAX_C == 2048
    calls = []

    def stage(f, x, tw, C, h, inverse, entry=None, exit_=None, *, strides=None):
        calls.append(("stage", C, h, inverse, entry is not None, exit_ is not None, strides))
        return x

    def k9(f, x, tw, C, pieces, inverse, entry, exit_, ins, outs):
        calls.append(("k9", C, pieces, inverse, entry is not None, exit_ is not None, ins, outs,
                      tw.shape[0]))
        return x

    monkeypatch.setattr(nk, "ntt_stage", stage)
    monkeypatch.setattr(nk, "_k9", k9)
    x = torch.zeros(1, 8, dtype=torch.int32).expand(fsp.n, 8)
    for C, inverse, fused in ((fsp.n1, False, True), (fsp.n2, False, False),
                              (fsp.n2, True, False), (fsp.n1, True, True)):
        tw = torch.zeros(1, 8, dtype=torch.int32).expand(C, 8)
        st = fsp.column if fused else None
        kw = dict(entry=x, exit_=x) if fused else {}
        nk.ntt_pass(fsp.f, x, tw, C, inverse, **kw, in_strides=st, out_strides=st)
    col = fsp.column
    assert calls == [
        ("k9", 2048, 1, False, True, True, col, col, 2048),           # P1
        ("stage", 4096, 2048, False, False, False, None),             # P2
        ("k9", 2048, 2, False, False, False, None, None, 2048),
        ("k9", 2048, 2, True, False, False, None, None, 2048),        # P2'
        ("stage", 4096, 2048, True, False, False, None),
        ("k9", 2048, 1, True, True, True, col, col, 2048),            # P1'
    ]

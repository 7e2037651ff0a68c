"""K9's strided passes and the four-step transforms that fold their
transposes into them (ops/ntt_kernels.py), on BN254's and BLS12-381's
scalar fields, against the JAX reference's ``ops/ntt_pallas.py``.

The reference's ``_pass_kernel`` runs in interpret mode on the CPU, as
tests/test_ntt_pallas.py runs it, on a contiguous [L, N] array; the port's
``plain_ntt_pass`` (what ``ntt_pass`` runs on a CPU tensor) reads and writes
the same sub-transforms as the columns of a [C, N / C] array.  Inputs hold
0, 1, p - 1, values whose Montgomery words are p - 1, p - 2 and 2^(bits(p)
- 1), and values in [2^(bits(p) - 1), p), where a lazy reduction would fail.
Every comparison is exact, on decoded ints."""

import random

import jax.numpy as jnp
import numpy as np
import pytest

import algoplonk_tpu_torch as apt
from algoplonk_tpu.fields import params as jparams
from algoplonk_tpu.ops.field import field_ops as jax_field_ops
from algoplonk_tpu.ops.ntt_pallas import _pass_kernel
from algoplonk_tpu.ops.ntt_pallas import four_step_plan as jax_four_step_plan
from algoplonk_tpu_torch.fields.words import word_field
from algoplonk_tpu_torch.ops import ntt_kernels as nk
from algoplonk_tpu_torch.ops.field import field_ops
from torch_parity import jax_ints, one_torch_thread  # noqa: F401

CURVES = ("bn254", "bls12_381")
JAX_FR = {"bn254": jparams.BN254.fr, "bls12_381": jparams.BLS12_381.fr}
PORT_FR = {"bn254": apt.BN254.fr, "bls12_381": apt.BLS12_381.fr}


def edge_ints(curve: str, seed: int, n: int) -> list[int]:
    """n values of the field: the edges above, then uniform ones."""
    fp = PORT_FR[curve]
    p, top = fp.modulus, 1 << (fp.modulus.bit_length() - 1)
    r_inv = pow(word_field(fp).R, -1, p)
    rng = random.Random(seed)
    vals = [0, 1, p - 1] + [w * r_inv % p for w in (p - 1, p - 2, top)]
    vals += [rng.randrange(top, p) for _ in range(6)]
    return vals + [rng.randrange(p) for _ in range(n - len(vals))]


@pytest.fixture(scope="module", params=CURVES)
def fields(request):
    curve = request.param
    return curve, jax_field_ops(JAX_FR[curve]), field_ops(PORT_FR[curve], "cpu")


def to_lm(jf, ints):
    """ints -> the reference's limbs-major [L, n] Montgomery array."""
    return jnp.asarray(np.asarray(jf.encode(ints)).T)


def from_lm(curve, lm) -> list[int]:
    return jax_ints(np.asarray(lm).T, JAX_FR[curve])


def columns(vals, C: int) -> list:
    """Logical order (sub-transform s, element i at s C + i) -> the column
    layout (i M + s, M = N / C)."""
    M = len(vals) // C
    return [vals[s * C + i] for i in range(C) for s in range(M)]


def from_columns(vals, C: int) -> list:
    M = len(vals) // C
    return [vals[i * M + s] for s in range(M) for i in range(C)]


@pytest.mark.parametrize("layout", ["column", "column_in"])
@pytest.mark.parametrize("fused", [False, True], ids=["bare", "entry_exit"])
@pytest.mark.parametrize("inverse", [False, True], ids=["dif", "dit"])
def test_strided_plain_pass_matches_reference_pass_kernel(fields, inverse, fused, layout):
    """plain_ntt_pass reading the sub-transforms as columns (and writing them
    as columns, or contiguous) equals the reference's _pass_kernel on the
    contiguous array, at N = 64, C = 8; entry is read in the input's layout
    and exit in the output's."""
    curve, jf, tf = fields
    N, C = 64, 8
    xs, en, ex = edge_ints(curve, 1, N), edge_ints(curve, 2, N), edge_ints(curve, 3, N)
    run = _pass_kernel(curve, C, N, inverse, fused, fused)
    kw = dict(entry=to_lm(jf, en), exit_=to_lm(jf, ex)) if fused else {}
    want = from_lm(curve, run(to_lm(jf, xs), **kw))

    col = (N // C, 1)
    out_col = layout == "column"
    tw = tf.encode(nk.stage_twiddles(curve, C, inverse))
    tkw = {}
    if fused:
        tkw = dict(entry=tf.encode(columns(en, C)),
                   exit_=tf.encode(columns(ex, C) if out_col else ex))
    launches = nk.LAUNCHES["ntt_pass"]
    got = nk.ntt_pass(tf, tf.encode(columns(xs, C)), tw, C, inverse, **tkw,
                      in_strides=col, out_strides=col if out_col else None)
    got = tf.decode(got)
    assert (from_columns(got, C) if out_col else got) == want
    assert nk.LAUNCHES["ntt_pass"] == launches   # CPU tensors: the plain version


@pytest.mark.parametrize("C", [2, 4, 16])
@pytest.mark.parametrize("inverse", [False, True], ids=["dif", "dit"])
def test_strided_plain_pass_equals_contiguous(fields, C, inverse):
    """At other pass sizes: the column pass equals the contiguous pass on
    the same sub-transforms, fused, element for element."""
    curve, _, tf = fields
    N = 8 * C
    xs, en, ex = edge_ints(curve, 4, N), edge_ints(curve, 5, N), edge_ints(curve, 6, N)
    tw = tf.encode(nk.stage_twiddles(curve, C, inverse))
    want = tf.decode(nk.plain_ntt_pass(tf, tf.encode(xs), tw, C, inverse,
                                       tf.encode(en), tf.encode(ex)))
    col = (N // C, 1)
    got = nk.plain_ntt_pass(tf, tf.encode(columns(xs, C)), tw, C, inverse,
                            tf.encode(columns(en, C)), tf.encode(columns(ex, C)),
                            in_strides=col, out_strides=col)
    assert from_columns(tf.decode(got), C) == want


@pytest.mark.parametrize("bad", [(9, 1), (0, 8), (1, 9), (8, 0)])
def test_pass_strides_refuses_positions_outside(bad):
    assert nk.pass_strides(64, 8, None) == (1, 8)
    assert nk.pass_strides(64, 8, (8, 1)) == (8, 1)
    with pytest.raises(ValueError):
        nk.pass_strides(64, 8, bad)


def test_lazy_headroom_by_field():
    """K9 keeps values below 2p only where 4p < R: BN254's Fr, not
    BLS12-381's."""
    assert nk.lazy_headroom(field_ops(apt.BN254.fr, "cpu"))
    assert not nk.lazy_headroom(field_ops(apt.BLS12_381.fr, "cpu"))


@pytest.mark.parametrize("log_n,coset", [(5, False), (6, True)], ids=["n32", "n64-coset"])
def test_transforms_match_reference_four_step(fields, log_n, coset):
    """ntt_scr / intt_scr (each two passes, the transposes folded into P1 and
    P1') against the reference's ntt_scr_lm / intt_scr_lm, row p of the port
    against column p of the reference, on both fields; the round trip is the
    identity."""
    curve, jf, tf = fields
    shift = apt.fields.params.CURVES[curve].coset_shift if coset else None
    coeffs = edge_ints(curve, 10 + log_n, 1 << log_n)
    jfs = jax_four_step_plan(curve, log_n)
    tfs = nk.four_step_plan(curve, log_n, "cpu")
    got = tfs.ntt_scr(tf.encode(coeffs), coset_shift=shift)
    want = from_lm(curve, jfs.ntt_scr_lm(to_lm(jf, coeffs), coset_shift=shift))
    assert tf.decode(got) == want
    back = tfs.intt_scr(got, coset_shift=shift)
    assert tf.decode(back) == coeffs


def test_four_step_transform_is_two_passes(monkeypatch):
    """ntt_scr and intt_scr each make two K9 passes, the first (forward) or
    the second (inverse) in the column layout, and nothing else reorders
    the data."""
    calls = []
    real = nk.ntt_pass

    def counted(f, x, tw, C, inverse, entry=None, exit_=None, **kw):
        calls.append((C, inverse, kw.get("in_strides"), kw.get("out_strides")))
        return real(f, x, tw, C, inverse, entry, exit_, **kw)

    monkeypatch.setattr(nk, "ntt_pass", counted)
    tfs = nk.four_step_plan("bn254", 6, "cpu")
    x = tfs.f.encode(edge_ints("bn254", 7, 64))
    ev = tfs.ntt_scr(x, coset_shift=apt.BN254.coset_shift)
    tfs.intt_scr(ev, coset_shift=apt.BN254.coset_shift)
    col = tfs.column
    assert calls == [(8, False, col, col), (8, False, None, None),
                     (8, True, None, None), (8, True, col, col)]

"""The field layer under K8 ``field_mul`` and ``field_add_sub`` on the CPU:
the operand descriptor of ops/field_kernels.py against
``torch.broadcast_tensors`` for every operand layout the prover gives the
field ops, the plain versions (ops/field.py ``plain_mul``, ``plain_add``,
``plain_sub``, ``plain_neg``) against the JAX reference's ops/field.py on
all four fields, and a CPU ``FieldOps`` and its plain twin, which must
build and launch nothing.  Every comparison is exact."""

import numpy as np
import pytest
import torch

from algoplonk_tpu.fields import params as jparams
from algoplonk_tpu.ops.field import field_ops as jax_field_ops
from algoplonk_tpu_torch.fields import params as tparams
from algoplonk_tpu_torch.fields.words import ints_to_words, word_field
from algoplonk_tpu_torch.ops import _build
from algoplonk_tpu_torch.ops import field_kernels as fk
from algoplonk_tpu_torch.ops.curve import curve_ops
from algoplonk_tpu_torch.ops.field import (
    FieldOps,
    field_ops,
    plain_add,
    plain_mul,
    plain_neg,
    plain_sub,
)
from torch_parity import one_torch_thread  # noqa: F401

FIELDS = ["bn254_fr", "bn254_fp", "bls12_381_fr", "bls12_381_fp"]
W = 8


def rows_as_kernel_reads(x, n0, n1, strides):
    """The [n0 n1, W] rows that the kernels read from operand x with row
    strides (s0, s1) from its first word."""
    s0, s1 = strides
    return x.as_strided((n0, n1, x.shape[-1]), (s0, s1, 1), x.storage_offset()).reshape(
        n0 * n1, x.shape[-1])


def words(n, seed=0):
    return torch.arange(n * W, dtype=torch.int32).reshape(n, W) + 1000 * seed


def prover_layouts(n):
    """The operand layouts of the prove path, with about n rows each: the
    ones that must fit the descriptor without a copy."""
    h = min(n & -n, 4)
    stage = words(2 * n).reshape(n // h, 2, h, W)
    tw = words(4 * h, 1)[:: 4][:h]           # tw[::n/(2h)][:half], broadcast over groups
    pts = words(3 * n).reshape(n, 3, W)
    rows = words(2 * n)
    return {
        "contiguous": (words(n), words(n, 1)),
        "element-batch": (words(1)[0], words(n, 1)),
        "batch-element": (words(n), words(1, 1)[0]),
        "ntt-halves": (stage[:, 0], stage[:, 1]),
        "ntt-twiddles": (stage[:, 1], tw),
        "every-other-row": (rows[0::2], rows[1::2]),
        "k-n-by-1-n": (words(3 * n).reshape(3, n, W), words(n, 1)[None]),
        "nb-1-by-1-b": (words(n)[:, None], words(3, 1)[None]),
        "point-coordinates": (pts[:, 0], pts[:, 2]),
        "blocked-carries": (words(n).reshape(n // h, h, W), words(n // h, 1)[:, None, :]),
        "single-elements": (words(1)[0], words(1, 1)[0]),
    }


@pytest.mark.parametrize("n", [1, 4, 12, 16])
@pytest.mark.parametrize("layout", sorted(prover_layouts(4)))
def test_descriptor_matches_broadcast(layout, n):
    """Every prover layout fits two batch dimensions with no copy, and the
    rows the kernels read are the rows of ``torch.broadcast_tensors``."""
    a, b = prover_layouts(n)[layout]
    xs, shape, n0, n1, strides, copies = fk.layout((a, b))
    assert copies == 0 and xs[0] is a and xs[1] is b
    assert all(s0 % 4 == 0 and s1 % 4 == 0 for s0, s1 in strides)
    ba, bb = torch.broadcast_tensors(a, b)
    assert tuple(shape) == tuple(ba.shape)
    assert n0 * n1 == ba.numel() // W
    assert torch.equal(rows_as_kernel_reads(a, n0, n1, strides[0]), ba.reshape(-1, W))
    assert torch.equal(rows_as_kernel_reads(b, n0, n1, strides[1]), bb.reshape(-1, W))


def offset_view(x, words_in, shape=None, row_stride=None):
    """x's values in a view of a larger buffer that starts ``words_in``
    words into it, with rows ``row_stride`` words apart."""
    shape = x.shape if shape is None else shape
    row_stride = x.shape[-1] if row_stride is None else row_stride
    rows = x.numel() // x.shape[-1]
    buf = torch.zeros(words_in + rows * row_stride, dtype=x.dtype)
    view = buf.as_strided((rows, x.shape[-1]), (row_stride, 1), words_in)
    view.copy_(x.reshape(rows, -1))
    return view.reshape(shape) if rows > 1 or len(shape) == 2 else view[0]


COPY_CASES = ["words-not-contiguous", "three-batch-dims", "one-operand", "unaligned-rows",
              "unaligned-element", "row-stride-not-16-bytes"]


@pytest.mark.parametrize("case", COPY_CASES)
def test_descriptor_copies_what_does_not_fit(case):
    """A view whose words are not contiguous is copied (that operand only),
    and so is one whose pointer or row stride is not a multiple of 16
    bytes (the kernels read rows as 16-byte vectors); a broadcast left with
    three batch dimensions copies both operands; one operand (neg) is
    described alone."""
    n = 6
    if case == "words-not-contiguous":
        a, b, want = words(n).T.contiguous().T, words(n, 1), 1
    elif case == "three-batch-dims":
        a = words(6 * n).reshape(2, 3, n, W).transpose(1, 2)
        b, want = words(3, 1)[None, None], 2
    elif case == "unaligned-rows":
        a, b, want = offset_view(words(n), 1), words(n, 1), 1
    elif case == "unaligned-element":
        a, b, want = words(n), offset_view(words(1, 1)[0], 2), 1
    elif case == "row-stride-not-16-bytes":
        a, b, want = words(n), offset_view(words(n, 1), 0, row_stride=W + 2), 1
    else:
        a, b, want = words(2 * n)[1::2], None, 0
    operands = (a,) if b is None else (a, b)
    xs, shape, n0, n1, strides, copies = fk.layout(operands)
    assert copies == want
    wants = torch.broadcast_tensors(*operands)
    for x, s, full in zip(xs, strides, wants):
        assert x.stride(-1) == 1 and x.data_ptr() % 16 == 0
        assert s[0] % 4 == 0 and s[1] % 4 == 0
        assert torch.equal(rows_as_kernel_reads(x, n0, n1, s), full.reshape(-1, W))


def test_describe_merges_and_drops():
    """Dimensions merge where every operand allows it; size-1 dimensions
    drop; broadcast strides are 0."""
    assert fk.describe((5, 7, W), [((5, 7, W), (7 * W, W, 1)), ((7, W), (W, 1))]) == (
        5, 7, [(7 * W, W), (0, W)])
    assert fk.describe((5, 7, W), [((5, 7, W), (7 * W, W, 1)), ((5, 7, W), (7 * W, W, 1))]) == (
        1, 35, [(0, W), (0, W)])
    assert fk.describe((1, 1, W), [((1, 1, W), (W, W, 1))]) == (1, 1, [(0, 0)])
    assert fk.describe((2, 3, 4, W), [((2, 3, 4, W), (W, 2 * W, 12 * W, 1))]) is None


@pytest.mark.parametrize("s,t", [((5, W), (W,)), ((W,), (3, 1, W)), ((3, 1, W), (1, 4, W)),
                                 ((2, 3, W), (2, 3, W)), ((1, W), (6, W))])
def test_broadcast_shape_matches_torch(s, t):
    assert fk.broadcast_shape(torch.Size(s), torch.Size(t)) == torch.broadcast_shapes(s, t)


def test_broadcast_shape_refuses_a_mismatch():
    with pytest.raises(ValueError, match="do not broadcast"):
        fk.broadcast_shape(torch.Size((3, W)), torch.Size((4, W)))


# ------------------------------------------------------------- plain vs JAX

def port_fp(name):
    return getattr(tparams, name.upper())


def jax_fp(name):
    return getattr(jparams, name.upper())


def seeded_ints(p, n, seed):
    """n values below p from numpy's seeded generator, with 0, 1 and p - 1."""
    g = np.random.default_rng(seed)
    limbs = g.integers(0, 1 << 62, size=(n, 7), dtype=np.int64)
    vals = [sum(int(v) << (62 * k) for k, v in enumerate(row)) % p for row in limbs]
    return [0, 1, p - 1] + vals[3:]


@pytest.mark.parametrize("op", ["mul", "add", "sub"])
@pytest.mark.parametrize("field", FIELDS)
def test_plain_ops_match_reference(field, op):
    """plain_mul / plain_add / plain_sub on a batch against a batch, one
    element against a batch and [k, n] against [1, n] equal the JAX
    reference's FieldOps on the same values, broadcast out."""
    tf, jf = field_ops(port_fp(field), "cpu"), jax_field_ops(jax_fp(field))
    p = tf.modulus
    plain = {"mul": plain_mul, "add": plain_add, "sub": plain_sub}[op]
    a, b = seeded_ints(p, 24, 1), seeded_ints(p, 24, 2)[::-1]
    ta, tb = tf.encode(a), tf.encode(b)

    def want(xs, ys):
        return jf.decode(getattr(jf, op)(jf.encode(xs), jf.encode(ys)))

    assert tf.decode(plain(tf, ta, tb)) == want(a, b)
    assert tf.decode(plain(tf, ta[5], tb)) == want([a[5]] * len(b), b)
    assert tf.decode(plain(tf, ta, tb[7])) == want(a, [b[7]] * len(a))
    k = ta.reshape(3, 8, -1)
    got = plain(tf, k, tb[:8][None]).reshape(-1, tf.W)
    assert tf.decode(got) == want(a, b[:8] * 3)


@pytest.mark.parametrize("field", FIELDS)
def test_plain_neg_matches_reference(field):
    tf, jf = field_ops(port_fp(field), "cpu"), jax_field_ops(jax_fp(field))
    a = seeded_ints(tf.modulus, 16, 3)
    assert tf.decode(plain_neg(tf, tf.encode(a))) == jf.decode(jf.neg(jf.encode(a)))


@pytest.mark.parametrize("field", FIELDS)
def test_plain_mul_one_operand_below_r(field):
    """K8's contract: one multiplicand anywhere below R, the other below p,
    gives the canonical a b R^-1 mod p; the plain version agrees."""
    tf = field_ops(port_fp(field), "cpu")
    wf = word_field(tf.fp)
    p = tf.modulus
    g = np.random.default_rng(4)
    raw = [int.from_bytes(g.bytes(4 * tf.W), "little") for _ in range(30)] + [wf.R - 1, p, 2 * p]
    canon = seeded_ints(p, len(raw), 5)
    a = torch.from_numpy(ints_to_words(raw, tf.W))
    b = tf.encode(canon)
    r_inv = pow(wf.R, -1, p)
    b_vals = [c * wf.r % p for c in canon]                  # b's Montgomery words as ints
    want = [x * y * r_inv % p for x, y in zip(raw, b_vals)]
    for got in (plain_mul(tf, a, b), plain_mul(tf, b, a)):
        assert [int.from_bytes(np.asarray(row, np.int32).tobytes(), "little") for row in
                got.numpy()] == want


# ------------------------------------------------ the CPU builds nothing

def test_cpu_field_ops_build_and_launch_nothing(monkeypatch):
    """A CPU FieldOps, its twin and the field wrappers on CPU tensors run
    the plain functions: with the kernel library made unloadable, every op
    still runs, and no launch or copy is counted."""
    def no_build(*a, **k):
        raise AssertionError("a CPU field op reached the kernel build")

    monkeypatch.setattr(_build, "library", no_build)
    monkeypatch.setattr(_build, "entry", no_build)
    monkeypatch.setattr(fk, "entry", no_build)
    fk.reset_launch_counts()
    for field in FIELDS:
        f = FieldOps(port_fp(field), "cpu")
        assert not f.plain and f._mul is plain_mul and f._add is plain_add
        x = f.encode([3, 4, 5])
        y = f.inv(f.sub(f.add(f.mul(x, x), f.neg(x)), f.one))
        assert f.decode(f.mul(y, f.sub(f.add(f.mul(x, x), f.neg(x)), f.one))) == [1, 1, 1]
        assert torch.equal(fk.field_mul(f, x, x), plain_mul(f, x, x))
        assert torch.equal(fk.field_neg(f, x), plain_neg(f, x))
    assert all(v == 0 for v in fk.LAUNCHES.values()) and fk.COPIES == 0


@pytest.mark.parametrize("field", FIELDS)
def test_plain_twin_gives_the_same_words(field):
    f = field_ops(port_fp(field), "cpu")
    twin = field_ops(port_fp(field), "cpu", plain=True)
    assert f.as_plain() is twin and twin.as_plain() is twin and twin.plain
    a = f.encode(seeded_ints(f.modulus, 12, 6))
    b = f.encode(seeded_ints(f.modulus, 12, 7))
    for op in ("mul", "add", "sub"):
        assert torch.equal(getattr(f, op)(a, b), getattr(twin, op)(a, b))
    assert torch.equal(f.neg(a), twin.neg(a))
    assert torch.equal(f.inv(a[3]), twin.inv(a[3]))


@pytest.mark.parametrize("curve", ["BN254", "BLS12_381"])
def test_plain_twin_of_the_curve(curve):
    c = getattr(tparams, curve)
    ops = curve_ops(c, "cpu")
    twin = ops.as_plain()
    assert twin.plain and twin.f.plain and twin.f is ops.f.as_plain()
    g = ops.affine_to_jac(ops.g1_gen_affine)
    assert torch.equal(ops.jac_double(g), twin.jac_double(g))
    assert torch.equal(ops.jac_add(g, ops.jac_double(g)), twin.jac_add(g, twin.jac_double(g)))

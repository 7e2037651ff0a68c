"""Wrappers of the field kernels (csrc/field_kernels.cu): K8 ``field_mul``
and ``field_add_sub``, which a CUDA ``FieldOps`` (ops/field.py) calls for
every ``mul``, ``add``, ``sub`` and ``neg``.

  =================  =================================================
  port (here)        reference
  =================  =================================================
  K8 ``field_mul``   ``pallas_field_mul`` (ops/curve_pallas.py:447)
  ``field_add_sub``  ``FieldOps.add`` / ``sub`` / ``neg`` in XLA
                     (ops/field.py:237-247); no TPU kernel
  =================  =================================================

Their plain versions are ``plain_mul``, ``plain_add``, ``plain_sub`` and
``plain_neg`` of ops/field.py.  A tensor on the CPU goes to the plain
version; a CUDA tensor launches the kernel or raises, with no fallback.

Operands broadcast as in ``FieldOps``.  ``layout`` and ``describe`` (pure
functions, which the CPU tests check) put the broadcast batch into the
kernels' form: at most two batch dimensions, each operand
given by its data pointer and its row strides in words (0 where it is
broadcast), rows of W contiguous words that start on 16-byte boundaries.
An operand whose words are not contiguous or whose rows are not so
aligned, or a broadcast that does not merge into two dimensions, is made
contiguous with one copy, counted in ``COPIES`` (the prove paths make
none).  The output is a new contiguous tensor of the broadcast shape.

Most calls are small (the blocked scans of ops/poly.py multiply 256 rows or
fewer per step), so the wrapper is kept lean: ctypes signatures set once,
the constants packed once per field, and no checks beyond device, dtype,
word layout and alignment.  Launches are counted in ``LAUNCHES`` (by
kernel), ``LAUNCHES_BY_WIDTH`` and ``LAUNCHES_BY_FIELD``, under
``utils/profiling.py``'s ``LAUNCH_LOCK`` (exact under threads), and
charged with the wrapper's host time to the recorder's innermost open span
while it records; plain calls are not counted.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..fields.words import WordField, ints_to_words
from ..utils import profiling as _prof
from ._build import WIDTHS, entry, raise_on, stream_of
from .field import FieldOps, plain_add, plain_mul, plain_neg, plain_sub

KERNELS = ("field_mul", "field_add_sub")
LAUNCHES = dict.fromkeys(KERNELS, 0)
LAUNCHES_BY_WIDTH = dict.fromkeys(((k, w) for k in KERNELS for w in WIDTHS), 0)
LAUNCHES_BY_FIELD: dict = {}    # (kernel, field name) -> launches
COPIES = 0                      # operands copied to fit the descriptor
MAX_ROWS = (1 << 31) - 1        # the kernels index rows in 32 bits

ADD, SUB, NEG = 0, 1, 2         # field_add_sub's op codes
ALIGN = 16                      # bytes: rows are read as 16-byte vectors


def reset_launch_counts() -> None:
    global COPIES
    with _prof.LAUNCH_LOCK:
        for k in KERNELS:
            LAUNCHES[k] = 0
        for key in LAUNCHES_BY_WIDTH:
            LAUNCHES_BY_WIDTH[key] = 0
        LAUNCHES_BY_FIELD.clear()
        COPIES = 0


def _count(name: str, W: int, field: str, t0: int = 0) -> None:
    """One launch of ``name`` at width W on ``field``, in the counters and,
    where the wrapper was entered at ``t0`` (0: nothing records), to the
    recorder's innermost open span."""
    with _prof.LAUNCH_LOCK:
        LAUNCHES[name] += 1
        LAUNCHES_BY_WIDTH[name, W] += 1
        key = (name, field)
        LAUNCHES_BY_FIELD[key] = LAUNCHES_BY_FIELD.get(key, 0) + 1
    if t0:
        _prof.charge(name, t0)


_CONSTS: dict = {}


def field_consts(wf: WordField):
    """The packed FieldConsts<W> words (p, n0, one) in host memory."""
    key = wf.modulus
    buf = _CONSTS.get(key)
    if buf is None:
        words = np.concatenate([
            ints_to_words([wf.modulus], wf.W)[0],
            np.asarray([wf.n0], np.uint32).view(np.int32),
            ints_to_words([wf.r], wf.W)[0],
        ])
        buf = _CONSTS[key] = (ctypes.c_int32 * words.size)(*words.tolist())
    return buf


def describe(shape, layouts):
    """The kernels' view of a broadcast: ``shape`` is the broadcast shape
    [..., W], ``layouts`` each operand's (shape, strides).  Batch dimensions
    of size 1 are dropped, and neighbours merge where every operand allows
    it (outer stride = inner stride x inner size; stride 0 where the
    operand is broadcast).  Returns (n0, n1, [(s0, s1) per operand]), with
    n0 = 1 and strides 0 filling a missing dimension, or None when more
    than two dimensions remain."""
    nd = len(shape) - 1
    per = []                                    # each operand's stride per batch dim
    for sh, st in layouts:
        lead = nd + 1 - len(sh)
        row = [0] * nd
        for i in range(lead, nd):
            if sh[i - lead] != 1:
                row[i] = st[i - lead]
        per.append(row)
    sizes, dims = [], []                        # merged sizes, strides per operand
    for i in range(nd):
        size = shape[i]
        if size == 1:
            continue
        strides = [row[i] for row in per]
        if sizes:
            last = dims[-1]
            for o, s in zip(last, strides):
                if o != s * size:
                    break
            else:
                sizes[-1] *= size
                dims[-1] = strides
                continue
        sizes.append(size)
        dims.append(strides)
    if len(sizes) > 2:
        return None
    while len(sizes) < 2:
        sizes.insert(0, 1)
        dims.insert(0, [0] * len(layouts))
    return sizes[0], sizes[1], list(zip(dims[0], dims[1]))


_ENTRIES: dict = {}


def _entry(name: str, W: int):
    """The width-W C entry point ``ap_<name>``, once the library is known to
    take the FieldConsts layout packed above."""
    fn = _ENTRIES.get((name, W))
    if fn is None:
        words = entry("ap_field_consts_words", W)()
        if words != 2 * W + 1:
            raise RuntimeError(f"kernel constant layout mismatch ({words} words at W = {W})")
        fn = _ENTRIES[name, W] = entry(f"ap_{name}", W)
    return fn


def broadcast_shape(s, t):
    """The broadcast of shapes s and t (torch's rule), without
    ``torch.broadcast_shapes``' cost, which is most of a small call's."""
    if s == t:
        return s
    if len(s) < len(t):
        s, t = t, s
    t = (1,) * (len(s) - len(t)) + tuple(t)
    out = []
    for x, y in zip(s, t):
        if x != y and y != 1 and x != 1:
            raise ValueError(f"shapes {tuple(s)} and {tuple(t)} do not broadcast")
        out.append(y if x == 1 else x)
    return torch.Size(out)


def layout(xs):
    """The operands ``xs`` (one or two [..., W] tensors) as the kernels take
    them -> (operands, broadcast shape, n0, n1, strides per operand,
    copies).  Contiguous operands of one shape, or a contiguous batch and
    one element [W], take a short path; anything else goes through
    ``describe``.  The kernels read rows as 16-byte vectors, so an operand
    whose words are not contiguous, or whose pointer or row strides are not
    16-byte multiples, is copied, and so is every operand of a broadcast
    that ``describe`` cannot fit; ``copies`` counts those copies."""
    a = xs[0]
    if a.is_contiguous() and (len(xs) == 1 or xs[1].is_contiguous()):
        W, lay = a.shape[-1], None
        if len(xs) == 1:
            lay = a.shape, 1, a.numel() // W, [(0, W)]
        elif a.shape == xs[1].shape:
            lay = a.shape, 1, a.numel() // W, [(0, W), (0, W)]
        elif xs[1].dim() == 1:
            lay = a.shape, 1, a.numel() // W, [(0, W), (0, 0)]
        elif a.dim() == 1:
            lay = xs[1].shape, 1, xs[1].numel() // W, [(0, 0), (0, W)]
        if lay is not None and not any(x.data_ptr() % ALIGN for x in xs):
            return (xs, *lay, 0)
    xs = list(xs)
    copies = 0

    def copy(i):
        nonlocal copies
        xs[i] = xs[i].clone(memory_format=torch.contiguous_format)
        copies += 1

    for i, x in enumerate(xs):
        if x.stride(-1) != 1 or x.data_ptr() % ALIGN:
            copy(i)
    shape = xs[0].shape if len(xs) == 1 else broadcast_shape(xs[0].shape, xs[1].shape)
    lay = describe(shape, [(x.shape, x.stride()) for x in xs])
    if lay is not None:
        odd = [i for i, st in enumerate(lay[2]) if st[0] % 4 or st[1] % 4]
        for i in odd:
            copy(i)
        if odd:
            lay = describe(shape, [(x.shape, x.stride()) for x in xs])
    if lay is None:
        copies += len(xs)
        xs = [x.expand(shape).contiguous() for x in xs]
        lay = describe(shape, [(x.shape, x.stride()) for x in xs])
    n0, n1, strides = lay
    return xs, shape, n0, n1, strides, copies


def _launch(name: str, f: FieldOps, xs, op=None):
    """Launch ``name`` on the operands ``xs`` (one or two [..., W] int32
    CUDA tensors) -> a new contiguous tensor of their broadcast shape."""
    global COPIES
    t0 = _prof.entry_ns()
    W = f.W
    for x in xs:
        if not x.is_cuda:
            raise ValueError(f"{name}: expected CUDA tensors, got one on {x.device}")
        if x.dtype != torch.int32:
            raise TypeError(f"{name}: expected int32, got {x.dtype}")
        if x.shape[-1] != W:
            raise ValueError(f"{name}: expected rows of {W} words, got shape {tuple(x.shape)}")
    if len(xs) == 2 and xs[0].device != xs[1].device:
        raise ValueError(f"{name}: operands on {xs[0].device} and {xs[1].device}")
    xs, shape, n0, n1, strides, copies = layout(xs)
    if copies:
        with _prof.LAUNCH_LOCK:
            COPIES += copies
    out = torch.empty(shape, dtype=torch.int32, device=xs[0].device)
    if n0 * n1 == 0:
        return out
    if n0 * n1 > MAX_ROWS:
        raise ValueError(f"{name}: {n0 * n1} rows, at most {MAX_ROWS}")
    if len(xs) == 1:
        xs, strides = xs * 2, strides * 2
    (sa0, sa1), (sb0, sb1) = strides
    args = (xs[0].data_ptr(), xs[1].data_ptr(), out.data_ptr(), n0, n1, sa0, sa1, sb0, sb1)
    if op is not None:
        args += (op,)
    rc = _entry(name, W)(*args, field_consts(f.wf), stream_of(out))
    raise_on(rc, name)
    _count(name, W, f.fp.name, t0)
    return out


def field_mul(f: FieldOps, a, b):
    """K8: the strict Montgomery product a b R^-1 mod p of broadcast
    operands [..., W] (a below R and b below p, or the reverse) ->
    canonical words of the broadcast shape."""
    if a.device.type == "cpu":
        return plain_mul(f, a, b)
    return _launch("field_mul", f, (a, b))


def field_add(f: FieldOps, a, b):
    """field_add_sub: a + b mod p of canonical broadcast operands."""
    if a.device.type == "cpu":
        return plain_add(f, a, b)
    return _launch("field_add_sub", f, (a, b), ADD)


def field_sub(f: FieldOps, a, b):
    """field_add_sub: a - b mod p of canonical broadcast operands."""
    if a.device.type == "cpu":
        return plain_sub(f, a, b)
    return _launch("field_add_sub", f, (a, b), SUB)


def field_neg(f: FieldOps, a):
    """field_add_sub: -a mod p of a canonical [..., W]."""
    if a.device.type == "cpu":
        return plain_neg(f, a)
    return _launch("field_add_sub", f, (a,), NEG)

"""The four-step NTT of the round-3 quotient, with its pass kernel K9
(csrc/ntt_kernels.cu) beside the kernel's plain PyTorch version.

Counterpart of the reference ``ops/ntt_pallas.py``:

  ==============================  =======================================
  port (here)                     reference (TPU, Pallas)
  ==============================  =======================================
  ``ntt_pass`` (K9, one launch    ``_stages_kernel`` :129, ``_pass_kernel`` :245
  up to ``MAX_C``; above it
  ``ntt_stage`` launches first)
  ``FourStepPlan``                ``FourStepPlan`` :284
  ``ntt_scr`` / ``intt_scr``      ``ntt_scr_lm`` / ``intt_scr_lm`` :454-463
  ``four_step_plan``              ``four_step_plan`` :524
  ==============================  =======================================

Layout: the port's batch-major ``[n, W]`` words.  The reference keeps
``[L, n]`` limbs-major only because the TPU pads a minor dimension of 22 to
128; Hopper has no such padding.  What must match is the *scrambled storage
order*: for n = n1 n2 (log_n1 = log_n // 2), row p = r1 n2 + r2 of a forward
transform holds the evaluation at domain index k = brev(r1) + brev(r2) n1,
exactly as column p of the reference's array.  The transforms are

  forward (DIF passes):                   inverse (DIT passes):
    T1 [(j1, j2)] -> [(j2, j1)]             P2' iDIT over r2  -> [(r1, j2)]
    P1 DIF over j1, entry coset C_f,        T2' -> [(j2, r1)]
       exit cross W_f   -> [(j2, r1)]       P1' iDIT over r1, entry cross
    T2 -> [(r1, j2)]                           W_i (with 1/n), exit coset C_i
    P2 DIF over j2      -> [(r1, r2)]       T1' -> natural coefficients

where each P is ONE launch of K9 over all log2(C) stages, and no T is a
copy: P1 and P1' read and write the columns of the [n1, n2] array
(``FourStepPlan.column`` strides: element i of sub-transform j2 at row
i n2 + j2), which folds T1 and T2 into P1 and T2' and T1' into P1'; P2 and
P2' are contiguous.  A transform is two launches up to a coset of 2^22,
and the entry and exit tables of P1 and P1' are kept in the column layout
too.  The reference splits a pass into several launches at ``_T_SMALL``
to bound Mosaic compile time; the port splits only where K9 cannot hold a
sub-transform in shared memory (C > ``MAX_C``): the pass's stages of
halves C/2 .. MAX_C run over HBM, one ``ntt_stage`` launch each, before
K9 (DIF) or after it (DIT), so P2 and P2' of a 2^23 coset (C = 4096) are
two launches each.  On a field with 4p < R (BN254's Fr) K9 keeps values
below 2p between stages (``lazy_headroom``); ``ntt_stage`` is strict.

Its ``LmOps`` (jitted limbs-major elementwise ops) have no counterpart:
``FieldOps`` (ops/field.py) already works on any ``[..., W]``, and on the
card its ops are the field kernels.

A CPU tensor takes ``plain_ntt_pass`` (and ``plain_ntt_stage``, in the
same composition above ``MAX_C``); a CUDA tensor launches K9 and
``ntt_stage`` or raises, with no fallback.  ``LAUNCHES`` counts kernel
launches only, under ``utils/profiling.py``'s ``LAUNCH_LOCK``, and each
launch is charged with its wrapper's host time to the recorder's innermost
open span while it records.  Plans are cached per (curve, size, device, gnark-compat
mode), and a mode toggle clears the cache
(``fields/params.py:_clear_derived_caches``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields.params import CURVES, domain_generator, gnark_compat_enabled
from ..utils import profiling as _prof
from ._build import check_tensor, raise_on, settle, stream_of
from .field_kernels import field_consts
from .field import FieldOps, field_ops
from .ntt import power_table

KERNELS = ("ntt_pass", "ntt_stage")
LAUNCHES = dict.fromkeys(KERNELS, 0)
# K9's largest sub-transform, which it holds whole in shared memory (192 KB
# of Hopper's 227 KB a block at 2048).  ntt_pass runs a longer pass's stages
# of halves C/2 .. MAX_C over HBM (ntt_stage) and K9 at MAX_C on the rest.
MAX_C = 2048


def reset_launch_counts() -> None:
    with _prof.LAUNCH_LOCK:
        for k in KERNELS:
            LAUNCHES[k] = 0


def _count(name: str, t0: int = 0) -> None:
    """One launch of ``name``, in ``LAUNCHES`` and, where the wrapper was
    entered at ``t0`` (0: nothing records), to the recorder's innermost
    open span."""
    with _prof.LAUNCH_LOCK:
        LAUNCHES[name] += 1
    if t0:
        _prof.charge(name, t0)


def _brev(x: int, bits: int) -> int:
    return int(bin(x + (1 << bits))[3:][::-1], 2) if bits else 0


def stage_twiddles(curve_name: str, C: int, inverse: bool) -> list[int]:
    """K9's twiddle table in heap order: entry h + j is w_2h^j (j < h) for
    each stage half h, with w_2h = domain_generator(curve, log2(2h)) (its
    inverse when ``inverse``); entry 0 is unused (1)."""
    r = CURVES[curve_name].fr.modulus
    tw = [1] * C
    h = 1
    while h < C:
        w = domain_generator(curve_name, (2 * h).bit_length() - 1)
        if inverse:
            w = pow(w, -1, r)
        tw[h : 2 * h] = power_table(w, h, r)
        h *= 2
    return tw


# ------------------------------------------------------------ plain version

def pass_strides(N: int, C: int, strides) -> tuple[int, int]:
    """(element stride, sub-transform stride) of a pass operand, in
    elements: None is the contiguous layout (1, C).  Every position
    i es + s ss (i < C, s < N / C) must lie in [0, N)."""
    es, ss = (1, C) if strides is None else (int(strides[0]), int(strides[1]))
    if es < 1 or ss < 1 or (C - 1) * es + (N // C - 1) * ss >= N:
        raise ValueError(f"ntt_pass: strides {(es, ss)} leave [{N}] for C = {C}")
    return es, ss


def _pieces(t, C: int, strides, pieces: int):
    """The [N / (C pieces), pieces, C, W] view of storage t in which
    [s, q, i] is element q C + i of the length-(C pieces) sub-transform s
    that ``strides`` places."""
    N, W = t.shape
    es, ss = strides
    return t.as_strided((N // (C * pieces), pieces, C, W), (ss * W, C * es * W, es * W, 1))


def _logical(t, C: int, strides, pieces: int = 1):
    """Storage t -> [N / C, C, W] in logical order: row s pieces + q holds
    piece q of sub-transform s (a copy where the layout is not already
    that order)."""
    return _pieces(t, C, strides, pieces).reshape(-1, C, t.shape[1])


def _stored(x, C: int, strides, pieces: int = 1):
    """x [N, W] in logical order (``_logical``) -> its storage."""
    if pieces == 1 and strides == (1, C):
        return x
    out = torch.empty_like(x)
    view = _pieces(out, C, strides, pieces)
    view.copy_(x.reshape(view.shape))
    return out


def _stage(f: FieldOps, x, tw, h: int, inverse: bool):
    """One radix-2 stage of half h over x [N, W] in logical order: the
    butterflies of every block of 2h rows."""
    N, W = x.shape
    y = x.reshape(N // (2 * h), 2, h, W)
    u, v = y[:, 0], y[:, 1]
    w = tw[h : 2 * h]
    if inverse:
        t = f.mul(v, w)
        pair = (f.add(u, t), f.sub(u, t))
    else:
        pair = (f.add(u, v), f.mul(f.sub(u, v), w))
    return torch.stack(pair, dim=1).reshape(N, W)


def plain_ntt_pass(f: FieldOps, x, tw, C: int, inverse: bool, entry=None, exit_=None, *,
                   in_strides=None, out_strides=None, pieces: int = 1):
    """K9's stages in PyTorch: every length-C sub-transform of x [N, W],
    forward DIF (halves C/2 .. 1) or inverse DIT (halves 1 .. C/2), output
    bit-reversed within each sub-transform; ``in_strides`` (x and entry) and
    ``out_strides`` (the output and exit) place the sub-transforms, as
    ``ntt_pass`` takes them.  With ``pieces`` > 1 the strides place
    sub-transforms of length C pieces, and the pass runs on each one's
    pieces of length C (elements q C .. (q + 1) C - 1), as K9 does for a
    split pass.  It computes on the field's plain twin, so it launches no
    kernel on any device."""
    f = f.as_plain()
    N, W = x.shape
    ins = pass_strides(N, C * pieces, in_strides)
    outs = pass_strides(N, C * pieces, out_strides)
    x = _logical(x, C, ins, pieces).reshape(N, W)
    if entry is not None:
        x = f.mul(x, _logical(entry, C, ins, pieces).reshape(N, W))
    halves = [1 << s for s in range(C.bit_length() - 1)]
    for h in halves if inverse else halves[::-1]:
        x = _stage(f, x, tw, h, inverse)            # blocks of 2h never cross C
    if exit_ is not None:
        x = f.mul(x, _logical(exit_, C, outs, pieces).reshape(N, W))
    return _stored(x, C, outs, pieces)


def plain_ntt_stage(f: FieldOps, x, tw, C: int, h: int, inverse: bool, entry=None, exit_=None,
                    *, strides=None):
    """``ntt_stage`` in PyTorch: the one stage of half h of every length-C
    sub-transform of x [N, W] placed by ``strides``, DIF or DIT, with the
    entry multiply before it and the exit multiply after it, read at the
    elements' positions; the output in the same layout.  On the field's
    plain twin, so it launches no kernel."""
    f = f.as_plain()
    N, W = x.shape
    st = pass_strides(N, C, strides)
    x = _logical(x, C, st).reshape(N, W)
    if entry is not None:
        x = f.mul(x, _logical(entry, C, st).reshape(N, W))
    x = _stage(f, x, tw, h, inverse)
    if exit_ is not None:
        x = f.mul(x, _logical(exit_, C, st).reshape(N, W))
    return _stored(x, C, st)


# ------------------------------------------------------------------ kernel

def _lib(f: FieldOps):
    from ._build import library

    if f.W != 8:
        raise NotImplementedError("the NTT kernel is built for W = 8")
    lib = library()
    n = lib.ap_ntt_consts_words()
    if n != 2 * f.W + 1:
        raise RuntimeError(f"kernel constant layout mismatch ({n} words)")
    return lib


def lazy_headroom(f: FieldOps) -> bool:
    """Can K9 keep values below 2p between stages (csrc/field.cuh's lazy
    ops)?  Only where 4p < R: BN254's Fr, not BLS12-381's."""
    return 4 * f.wf.modulus < f.wf.R


def _check_length(name: str, N: int, C: int) -> None:
    if C < 2 or C & (C - 1) or N % C:
        raise ValueError(f"{name}: bad sub-transform length {C} for N = {N}")


def _operands(name: str, x, tw, C: int, entry, exit_) -> None:
    """A kernel's [N, W] operands and its [C, W] twiddle table: contiguous
    int32 CUDA tensors, 16-byte aligned."""
    N, W = x.shape
    check_tensor("x", x, (N, W))
    check_tensor("tw", tw, (C, W))
    ops = [x, tw]
    for arg, t in (("entry", entry), ("exit", exit_)):
        if t is not None:
            check_tensor(arg, t, (N, W))
            ops.append(t)
    if any(t.data_ptr() % 16 for t in ops):
        raise ValueError(f"{name}: operands must be 16-byte aligned")


def _ptr(t):
    return t.data_ptr() if t is not None else None


def ntt_pass(f: FieldOps, x, tw, C: int, inverse: bool, entry=None, exit_=None, *,
             in_strides=None, out_strides=None):
    """All log2(C) stages of the N / C length-C sub-transforms of x [N, W],
    with an optional entry multiply (on load) and exit multiply (on store),
    both [N, W].  tw: [C, W] twiddles from ``stage_twiddles``.
    ``in_strides`` = (es, ss) puts element i of sub-transform s at row
    i es + s ss of x and entry, ``out_strides`` likewise for the output
    and exit (default (1, C), contiguous; ``FourStepPlan`` passes columns).
    Returns a new [N, W] tensor of canonical words.

    Up to ``MAX_C`` this is one launch of K9.  Above it, a DIF pass first
    runs its stages of halves C/2 .. MAX_C over HBM, one ``ntt_stage`` each
    in the input's layout (the first takes the entry multiply), then K9 at
    MAX_C on the pieces they leave, which writes the output (with the exit
    multiply); a DIT pass runs K9 first, into the output's layout (with the
    entry multiply), then the HBM stages in rising halves (the last takes
    the exit multiply).  tw's first MAX_C rows are the MAX_C table.  On the
    CPU the same composition runs the plain versions."""
    N = x.shape[0]
    _check_length("ntt_pass", N, C)
    if C <= MAX_C:
        return _k9(f, x, tw, C, 1, inverse, entry, exit_, in_strides, out_strides)
    pieces = C // MAX_C
    halves = [C >> k for k in range(1, pieces.bit_length())]   # C/2 .. MAX_C
    if not inverse:
        for k, h in enumerate(halves):
            x = ntt_stage(f, x, tw, C, h, False, entry if k == 0 else None,
                          strides=in_strides)
        return _k9(f, x, tw[:MAX_C], MAX_C, pieces, False, None, exit_, in_strides, out_strides)
    x = _k9(f, x, tw[:MAX_C], MAX_C, pieces, True, entry, None, in_strides, out_strides)
    for k, h in enumerate(halves[::-1]):
        x = ntt_stage(f, x, tw, C, h, True, None, exit_ if k == len(halves) - 1 else None,
                      strides=out_strides)
    return x


def _k9(f: FieldOps, x, tw, C: int, pieces: int, inverse: bool, entry, exit_,
        in_strides, out_strides):
    """K9 over the length-C pieces of the pass of length C pieces that the
    strides place (``plain_ntt_pass``'s ``pieces``): one launch."""
    if x.device.type == "cpu":
        return plain_ntt_pass(f, x, tw, C, inverse, entry, exit_, in_strides=in_strides,
                              out_strides=out_strides, pieces=pieces)
    t0 = _prof.entry_ns()
    N, W = x.shape
    _check_length("ntt_pass", N, C * pieces)
    ins = pass_strides(N, C * pieces, in_strides)
    outs = pass_strides(N, C * pieces, out_strides)
    _operands("ntt_pass", x, tw, C, entry, exit_)
    lib = _lib(f)
    out = torch.empty_like(x)
    rc = lib.ap_ntt_pass(
        x.data_ptr(), tw.data_ptr(), _ptr(entry), _ptr(exit_), out.data_ptr(), N, C, pieces,
        int(inverse), int(lazy_headroom(f)), *ins, *outs, field_consts(f.wf), stream_of(x),
    )
    raise_on(rc, "ntt_pass")
    _count("ntt_pass", t0)
    return out


def ntt_stage(f: FieldOps, x, tw, C: int, h: int, inverse: bool, entry=None, exit_=None, *,
              strides=None):
    """One radix-2 stage of half h (DIF (u + v, (u - v) w) or DIT (u + v w,
    u - v w), w = w_2h^j = tw[h + j]) over the N / C length-C
    sub-transforms of x [N, W] that ``strides`` places, as the top stages
    of a pass above ``MAX_C`` run: one launch over HBM, with an optional
    entry multiply before the butterflies and exit multiply after them,
    read at the elements' positions.  tw: the pass's [C, W] table.
    Returns a new [N, W] tensor of canonical words in the same layout."""
    if x.device.type == "cpu":
        return plain_ntt_stage(f, x, tw, C, h, inverse, entry, exit_, strides=strides)
    t0 = _prof.entry_ns()
    N, W = x.shape
    _check_length("ntt_stage", N, C)
    if h < 1 or h & (h - 1) or 2 * h > C:
        raise ValueError(f"ntt_stage: bad stage half {h} for C = {C}")
    es, ss = pass_strides(N, C, strides)
    _operands("ntt_stage", x, tw, C, entry, exit_)
    lib = _lib(f)
    out = torch.empty_like(x)
    rc = lib.ap_ntt_stage(
        x.data_ptr(), tw.data_ptr(), _ptr(entry), _ptr(exit_), out.data_ptr(), N, C, h,
        int(inverse), es, ss, field_consts(f.wf), stream_of(x),
    )
    raise_on(rc, "ntt_stage")
    _count("ntt_stage", t0)
    return out


# -------------------------------------------------------------------- plan

class FourStepPlan:
    """Scrambled-order four-step NTT over Fr for one (curve, 2^log_n,
    device).  Evaluation at domain index k = brev(r1) + brev(r2) n1 is
    stored at row p = r1 n2 + r2; coefficient order is natural on both
    ends.  Tables are built on the plan's device at first use and kept
    until ``drop_tables``."""

    def __init__(self, curve_name: str, log_n: int, device):
        if log_n < 4:
            raise ValueError("the four-step path needs log_n >= 4 (4 | n1)")
        self.curve = CURVES[curve_name]
        self.curve_name = curve_name
        self.log_n = log_n
        self.n = 1 << log_n
        self.f = field_ops(self.curve.fr, device)
        self.log_n1 = log_n // 2
        self.log_n2 = log_n - self.log_n1
        self.n1, self.n2 = 1 << self.log_n1, 1 << self.log_n2
        self.r = self.curve.fr.modulus
        self.omega = domain_generator(curve_name, log_n)
        self.column = (self.n2, 1)   # K9 strides of a column of [n1, n2]
        self._tables: dict = {}
        self._readers: dict = {}   # key -> the CUDA streams recorded on its table

    def _table(self, key, build):
        t = self._tables.get(key)
        if t is None:
            t = build()
            settle(self.f.device)
            self._tables[key] = t
        if t.is_cuda:
            # Each stream that reads a table (parallel/batch_prove.py) is
            # recorded on it once, so that the block drop_tables frees waits
            # for the work queued on every one of them.
            s = torch.cuda.current_stream(t.device)
            readers = self._readers.setdefault(key, set())
            if s not in readers:
                t.record_stream(s)
                readers.add(s)
        return t

    def drop_tables(self, inverse: bool | None = None) -> None:
        """Free the cached tables of one direction (or of both with None):
        its cross and coset tables and its passes' twiddles (the
        reference's ``drop_tables``, ntt_pallas.py:316-326).  The next use
        rebuilds each, word for word.  At 2^22 a cross or coset table is
        [2^22, 8] int32, 128 MiB; the round-3 quotient of a 2^20 circuit
        evicts the direction it is not about to run.  It waits for nothing:
        ``_table`` records each stream that reads a table, so the caching
        allocator reuses a freed block only after the work queued on them
        is done."""
        for key in [k for k in self._tables if k[0] in ("tw", "cross", "coset")]:
            if inverse is None or key[-1] == inverse:
                del self._tables[key]
                self._readers.pop(key, None)

    def _outer(self, rowv, colv):
        """Host power vectors [a], [b] -> their product grid [a * b, W]."""
        f = self.f
        return f.mul(f.encode(rowv)[:, None], f.encode(colv)[None, :]).reshape(-1, f.W)

    # ------------------------------------------------------------- tables

    def twiddles(self, C: int, inverse: bool):
        return self._table(
            ("tw", C, inverse),
            lambda: self.f.encode(stage_twiddles(self.curve_name, C, inverse)),
        )

    def _cross_table(self, inverse: bool):
        """W[a, b] = w^(+-a brev_{n1}(b)) at row b n2 + a of [n, W] (the
        column layout of P1's output and of the inverse's P1 input; times
        1/n when inverse): log2(n1) masked multiplies by host-built P_t[a]
        = w^(+-a 2^t), as the reference builds it."""

        def build():
            f, r, n1, n2 = self.f, self.r, self.n1, self.n2
            w = pow(self.omega, -1, r) if inverse else self.omega
            scale = pow(self.n, -1, r) if inverse else 1
            tbl = f.encode([scale]).expand(n1, n2, f.W)
            rows = torch.arange(n1, device=f.device)
            for t in range(self.log_n1):
                pt = f.encode(power_table(w, n2, r))          # [n2, W]
                mask = ((rows >> (self.log_n1 - 1 - t)) & 1) != 0
                tbl = torch.where(mask[:, None, None], f.mul(tbl, pt[None, :]), tbl)
                w = w * w % r
            return tbl.reshape(self.n, f.W)

        return self._table(("cross", inverse), build)

    def _coset_table(self, shift: int, inverse: bool):
        """C[a (j2), b (j1)] = g^(+-(b n2 + a)) at row b n2 + a of [n, W]
        (the column layout of P1's input and of the inverse's P1 output)."""

        def build():
            r = self.r
            g = pow(shift, -1, r) if inverse else shift
            col = [pow(g, a, r) for a in range(self.n2)]
            row = [pow(g, b * self.n2, r) for b in range(self.n1)]
            return self._outer(row, col)

        return self._table(("coset", shift, inverse), build)

    # ---------------------------------------------------------- transforms

    def _check(self, x):
        if tuple(x.shape) != (self.n, self.f.W):
            raise ValueError(f"expected [{self.n}, {self.f.W}], got {tuple(x.shape)}")

    def ntt_scr(self, coeffs, coset_shift: int | None = None):
        """[n, W] natural coefficients -> [n, W] scrambled evaluations (on
        the coset shift H when coset_shift is given): two K9 launches, and
        ``ntt_stage`` launches in a pass above ``MAX_C``."""
        self._check(coeffs)
        f, n1, n2, col = self.f, self.n1, self.n2, self.column
        entry = self._coset_table(coset_shift, False) if coset_shift is not None else None
        x = ntt_pass(f, coeffs, self.twiddles(n1, False), n1, False, entry,   # T1, P1, T2
                     self._cross_table(False), in_strides=col, out_strides=col)
        return ntt_pass(f, x, self.twiddles(n2, False), n2, False)            # P2

    def intt_scr(self, evals_scr, coset_shift: int | None = None):
        """[n, W] scrambled evaluations -> [n, W] natural coefficients: two
        K9 launches, and ``ntt_stage`` launches in a pass above
        ``MAX_C``."""
        self._check(evals_scr)
        f, n1, n2, col = self.f, self.n1, self.n2, self.column
        exit_ = self._coset_table(coset_shift, True) if coset_shift is not None else None
        x = ntt_pass(f, evals_scr.contiguous(), self.twiddles(n2, True), n2, True)   # P2'
        return ntt_pass(f, x, self.twiddles(n1, True), n1, True,                  # T2', P1', T1'
                        self._cross_table(True), exit_, in_strides=col, out_strides=col)

    # ------------------------------------------------- scrambled-order data

    def scramble_perm(self) -> np.ndarray:
        """perm with evals_scr[p] = evals_natural[perm[p]]."""
        b1 = np.asarray([_brev(r1, self.log_n1) for r1 in range(self.n1)], np.int64)
        b2 = np.asarray([_brev(r2, self.log_n2) for r2 in range(self.n2)], np.int64)
        return (b1[:, None] + b2[None, :] * self.n1).reshape(-1)

    def coset_x_scr(self, shift: int):
        """[n, W] of x-values shift w^k(p) in scrambled storage order: the
        outer product of two host power vectors (no gather)."""

        def build():
            r, w = self.r, self.omega
            rowv = [shift * pow(w, _brev(r1, self.log_n1), r) % r for r1 in range(self.n1)]
            colv = [pow(w, self.n1 * _brev(r2, self.log_n2), r) for r2 in range(self.n2)]
            return self._outer(rowv, colv)

        return self._table(("x", shift), build)

    def tile_by_k_mod4(self, pattern4):
        """[n, W] holding pattern4[k(p) mod 4] at scrambled row p; k(p) mod 4
        = brev(r1) mod 4 (since 4 | n1), constant along each row r1."""
        pattern4 = tuple(pattern4)

        def build():
            f = self.f
            rowv = [pattern4[_brev(r1, self.log_n1) % 4] for r1 in range(self.n1)]
            return f.encode(rowv)[:, None].expand(self.n1, self.n2, f.W).reshape(self.n, f.W)

        return self._table(("tile", pattern4), build)


@functools.lru_cache(maxsize=None)
def _four_step_plan(curve_name: str, log_n: int, device: str, compat: bool) -> FourStepPlan:
    plan = FourStepPlan(curve_name, log_n, device)
    settle(device)
    return plan


def four_step_plan(curve_name: str, log_n: int, device="cuda") -> FourStepPlan:
    return _four_step_plan(curve_name, log_n, str(torch.device(device)), gnark_compat_enabled())

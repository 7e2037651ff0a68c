"""Wrappers of the curve kernels (csrc/msm_kernels.cu: K1-K3;
csrc/curve_kernels.cu: K4-K7), each beside its plain PyTorch version.

Counterparts of the reference ``ops/curve_pallas.py`` factories:

  ====  ==========================  =======================================
        port (here)                 reference (TPU, Pallas)
  ====  ==========================  =======================================
  K1    ``mixed_add_signed_multi``  ``pallas_mixed_add_signed_multi`` :250
  K2    ``jac_add_multi_scan``      ``pallas_jac_add_multi_scan``     :357
  K3    ``jac_add``                 ``pallas_jac_add``                :292
        ``jac_add_window_scan``     (its rounds in a window's scan)
        ``window_combine``          (its rounds in the MSM's phase 4)
  K4    ``canon``                   ``pallas_canon``                  :404
  K5    ``mixed_add``               ``pallas_mixed_add``              :156
  K6    ``mixed_add_signed``        ``pallas_mixed_add_signed``       :201
  K7    ``jac_add_multi``           ``pallas_jac_add_multi``          :324
  ====  ==========================  =======================================

K8 ``field_mul`` (``pallas_field_mul`` :447) is on the prove path, under
every ``FieldOps.mul`` of a CUDA device: ops/field_kernels.py.

K1-K3 are the MSM's (ops/msm.py).  Besides one complete add per lane, K3
has an entry for each chain of adds the MSM builds from it, each one launch
with one block per window: ``jac_add_window_scan`` (the Kogge-Stone scan of
each window's block or super-block sums) and ``window_combine`` (phase 4:
P[e_d], the tree sum over d, D P[e_D] by doublings, minus the sum).  Their
plain versions run the chain a round at a time, each round one add over all
lanes rolled into place, which the kernels follow word for word.  Every
curve kernel stores canonical words, so the MSM needs no K4; K4 serves,
with K5-K7, only the kernel-test path, as in the reference, whose MSM does
not call K5-K7 either.  Every curve kernel takes limbs-major
``[coord, W, B]`` int32 (lane axis last), as the TPU kernels take it, and
is built for W = 8 (BN254) and W = 12 (BLS12-381's Fp).

The curve kernels K1-K3 and K5-K7 run a lazy field core (values below 2p,
made canonical at the store), valid only for a field with 4p < R;
``check_lazy_headroom`` refuses any other when the constants are packed.
K4 does no field arithmetic: any W-word x is below 2^S p (S =
``canon_steps``: 3 for BN254's Fp, 4 for BLS12-381's), so x mod p is a
ladder of S conditional subtractions of 2^(S-1) p, ..., 2p, p, which its
plain version runs on the words as the kernel does.  K2 and K7 run ``T``
threads per lane (``scan_threads``, ``multi_threads``: functions of the lane
and step counts alone) and re-associate the scan or the sum; each plain
version takes the same T and follows the same association, so the two stay
equal word for word.  K5 and K6 are one kernel (K6 negates the point on
flagged lanes) that spreads each mixed add over ``mixed_threads(W)``
threads (one warp per role of ``ap::mixed_add_roles``), every product the
same operation on the same operands, so its words are the plain version's
at every count.

A tensor on the CPU goes to the plain version; a CUDA tensor launches the
kernel or raises, with no fallback.  The plain versions compute on the
curve's plain twin (``CurveOps.as_plain``), whose field ops are plain torch,
so a plain version launches no kernel on any device (K4's computes on the words
alone).  Each wrapper counts
its kernel launches in ``LAUNCHES`` (by kernel) and ``LAUNCHES_BY_WIDTH``
(by kernel and W); plain calls are not counted.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..fields.words import WordField, ints_to_words
from ._build import WIDTHS, check_tensor, entry, raise_on, stream_of
from .curve import CurveOps
from .field_kernels import field_consts

SIGN_SHIFT = 26  # bit of a packed member index carrying the digit sign
ROW_MASK = (1 << SIGN_SHIFT) - 1

MSM_KERNELS = ("mixed_add_signed_multi", "jac_add_multi_scan", "jac_add",
               "jac_add_window_scan", "window_combine")
OFF_PATH_KERNELS = ("canon", "mixed_add", "mixed_add_signed", "jac_add_multi")
KERNELS = MSM_KERNELS + OFF_PATH_KERNELS
LAUNCHES = dict.fromkeys(KERNELS, 0)
LAUNCHES_BY_WIDTH = dict.fromkeys(((k, w) for k in KERNELS for w in WIDTHS), 0)


def reset_launch_counts() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0
    for key in LAUNCHES_BY_WIDTH:
        LAUNCHES_BY_WIDTH[key] = 0


def _count(name: str, W: int) -> None:
    LAUNCHES[name] += 1
    LAUNCHES_BY_WIDTH[name, W] += 1


# ------------------------------------------------------------ plain versions

def _bm(x_lm):
    """[C, W, B] limbs-major -> [B, C, W] batch-major."""
    return x_lm.permute(2, 0, 1)


def _lm(x_bm):
    return x_bm.permute(1, 2, 0).contiguous()


def plain_mixed_add_signed_multi(ops: CurveOps, acc, pts_flat, packed):
    ops = ops.as_plain()
    W = ops.W
    rows = (packed & ROW_MASK).clamp(max=pts_flat.shape[0] - 1).long()
    neg = (packed >> SIGN_SHIFT) == 1
    a = _bm(acc)
    for k in range(packed.shape[0]):
        pts = pts_flat[rows[k]].reshape(-1, 2, W)
        # a lane that gathers the identity, affine (0, 0), keeps its sum
        # (jac_add_affine's select), so only the others are computed
        live = (pts != 0).flatten(1).any(dim=1).nonzero().squeeze(1)
        pts = pts[live]
        y = ops.f.select(neg[k][live], ops.f.neg(pts[:, 1]), pts[:, 1])
        a = a.index_copy(0, live, ops.jac_add_affine(a[live], torch.stack([pts[:, 0], y], dim=1)))
    return _lm(a)


def threads_per_lane(B: int, g: int, choices, min_threads: int) -> int:
    """Threads per lane for B lanes of g steps: the smallest T of
    ``choices`` (ascending, starting at 1) that divides g and gives
    B T >= min_threads threads, or the largest that divides g (1 for
    g = 0).  It reads no device property, so the CPU's plain version takes
    the same association as the card's kernel."""
    fits = [T for T in choices if g % T == 0 and T <= max(g, 1)]
    for T in fits:
        if B * T >= min_threads:
            return T
    return fits[-1]


SCAN_THREADS = (1, 4, 16)   # K2's threads per lane
K2_MIN_THREADS = 12288      # K2 takes the least T that gives this many


def scan_threads(B: int, g: int) -> int:
    """K2's threads per lane (``threads_per_lane`` over SCAN_THREADS and
    K2_MIN_THREADS).  A lane's T threads are each g/T - 1 + log2 T + g/T
    adds deep (g at T = 1), so T = 2 would not shorten the scan, and T = 8
    lost to 4 or 16 at every commit shape measured (PERF.md)."""
    return threads_per_lane(B, g, SCAN_THREADS, K2_MIN_THREADS)


def plain_jac_add_multi_scan(ops: CurveOps, acc, qs, T: int | None = None):
    """K2's plain version, in the kernel's association for T threads per
    lane: thread s of a lane sums steps [s L, (s + 1) L) (L = g / T), the
    partial sums are shifted up by one with acc in front and scanned
    Kogge-Stone (y[s] <- y[s - d] + y[s]), and each thread rescans its steps
    from its carry-in.  T = 1 is the sequential scan."""
    ops = ops.as_plain()
    g = qs.shape[0] // 3
    T = scan_threads(acc.shape[-1], g) if T is None else T
    if g % T:
        raise ValueError(f"T = {T} does not divide g = {g}")
    L = g // T
    q = _bm(qs).reshape(-1, g, 3, ops.W).transpose(0, 1)      # [g, B, 3, W]
    q = q.reshape(T, L, *q.shape[1:])                         # [T, L, B, 3, W]
    y = _bm(acc)[None]
    if T > 1:
        part = q[: T - 1, 0]
        for j in range(1, L):
            part = ops.jac_add(part, q[: T - 1, j])
        y = torch.cat([y, part])                              # [T, B, 3, W]
        d = 1
        while d < T:
            y = torch.cat([y[:d], ops.jac_add(y[: T - d], y[d:])])
            d *= 2
    outs = []
    for j in range(L):
        y = ops.jac_add(y, q[:, j])
        outs.append(y)
    out = torch.stack(outs, dim=1).reshape(g, -1, 3, ops.W)  # step k = s L + j
    return _lm(out.transpose(0, 1).reshape(-1, 3 * g, ops.W))


def plain_jac_add(ops: CurveOps, p, q):
    return _lm(ops.as_plain().jac_add(_bm(p), _bm(q)))


def canon_steps(wf: WordField) -> int:
    """K4's ladder length for a field of W words: the bit length of the
    largest quotient floor((2^(32 W) - 1) / p) of a W-word value, so that
    every such value is below 2^steps p."""
    return ((wf.R - 1) // wf.modulus).bit_length()


def canon_ladder(wf: WordField) -> list[int]:
    """The multiples K4 subtracts, largest first: 2^j p, j = steps - 1 .. 0."""
    return [wf.modulus << j for j in reversed(range(canon_steps(wf)))]


_WORD = (1 << 32) - 1


def plain_canon(ops: CurveOps, x):
    """K4's plain version: x [R, W, B] (any W-word values) -> x mod p by the
    kernel's ladder, on the words: for each multiple m of ``canon_ladder``
    a borrow chain computes x - m, which is kept where it did not borrow
    (x >= m)."""
    W = ops.W
    v = x.to(torch.int64) & _WORD                             # [R, W, B]
    for m in canon_ladder(ops.wf):
        borrow, d = 0, []
        for w in range(W):
            t = v[:, w] - ((m >> (32 * w)) & _WORD) - borrow
            borrow = (t < 0).to(torch.int64)
            d.append(t & _WORD)
        v = torch.where(borrow[:, None].bool(), v, torch.stack(d, dim=1))
    return (v - ((v >> 31) << 32)).to(torch.int32)


def inf_lm(ops: CurveOps, w: int):
    """Limbs-major identity (0 : 1 : 0) at lane width w."""
    z = torch.zeros((ops.W, w), dtype=torch.int32, device=ops.device)
    one = ops.f.one[:, None].expand(ops.W, w)
    return torch.stack([z, one, z]).contiguous()


def plain_jac_add_window_scan(ops: CurveOps, x, nwin: int, E: int, add=None):
    """The MSM's rolled Kogge-Stone scan of nwin windows of E lanes (lane
    w * E + i of x [3, W, B]) -> [3, W, nwin * E].  Round sh adds the lane
    sh below, or the identity where that lane is outside the window (which
    scales the point: the kernel does the same).  Each round is one call of
    ``add`` (default ``plain_jac_add``; ``jac_add`` makes it a K3 launch
    per round, as the MSM ran it before the scan had its own kernel)."""
    add = add or plain_jac_add
    i32 = dict(dtype=torch.int32, device=x.device)
    B = x.shape[-1]
    b_idx = torch.cat([
        torch.arange(E, **i32).repeat(nwin), torch.full((B - nwin * E,), -1, **i32)
    ])
    inf = inf_lm(ops, B)
    scan = x
    for i in range(max(0, (E - 1).bit_length())):
        sh = 1 << i
        shifted = torch.where((b_idx < sh)[None, None, :], inf, torch.roll(scan, sh, dims=2))
        scan = add(ops, scan, shifted.contiguous())
    return scan[:, :, : nwin * E].contiguous()


def plain_window_combine(ops: CurveOps, base, in_block, nw: int, c: int):
    """The MSM's phase 4 a round at a time: P[e_d] = base + in_block (lane
    w * (D + 1) + d, D = 2^(c-1)), the rolled tree sum over d < D (only
    lane d = 0 of each window is read), both made canonical, D P[e_D] by
    c - 1 doublings, minus the sum -> [nw, 3, W]."""
    ops = ops.as_plain()
    D = 1 << (c - 1)
    p_e = plain_jac_add(ops, base, in_block)
    tree = p_e
    for i in range((D - 1).bit_length()):
        tree = plain_jac_add(ops, tree, torch.roll(tree, -(D >> (i + 1)), dims=2))
    tree = plain_canon(ops, tree)
    p_e = plain_canon(ops, p_e)
    stride = D + 1
    prefix_sum = tree[:, :, 0 : nw * stride : stride].permute(2, 0, 1)  # [nw, 3, W]
    d_top = p_e[:, :, D : nw * stride : stride].permute(2, 0, 1)
    for _ in range(c - 1):                          # D * P[e_D], D = 2^(c-1)
        d_top = ops.jac_double(d_top)
    neg_sum = torch.stack(
        [prefix_sum[:, 0], ops.f.neg(prefix_sum[:, 1]), prefix_sum[:, 2]], dim=1
    )
    return ops.jac_add(d_top, neg_sum)              # [nw, 3, W]


def plain_mixed_add(ops: CurveOps, acc, pts):
    return _lm(ops.as_plain().jac_add_affine(_bm(acc), _bm(pts)))


def plain_mixed_add_signed(ops: CurveOps, acc, pts, neg):
    ops = ops.as_plain()
    p = _bm(pts)
    y = ops.f.select(neg[0] != 0, ops.f.neg(p[:, 1]), p[:, 1])
    return _lm(ops.jac_add_affine(_bm(acc), torch.stack([p[:, 0], y], dim=1)))


MULTI_THREADS = (1, 2, 4, 8, 16)   # K7's threads per lane
K7_MIN_THREADS = 16384              # K7 takes the least T that gives this many


def multi_threads(B: int, g: int) -> int:
    """K7's threads per lane (``threads_per_lane`` over MULTI_THREADS and
    K7_MIN_THREADS).  A lane's T threads are g/T + log2 T adds deep (g at
    T = 1), so T = 2 already shortens the chain, but every warp runs the
    log2 T adds of the tree, so a larger T costs issue slots: at 16 steps,
    6,272 lanes (W = 8) ran fastest at T = 4 (B T = 25,088) and 1,664 lanes
    (W = 12) at T = 8 or 16 on an H100 (PERF.md)."""
    return threads_per_lane(B, g, MULTI_THREADS, K7_MIN_THREADS)


def plain_jac_add_multi(ops: CurveOps, acc, qs, T: int | None = None):
    """K7's plain version, in the kernel's association for T threads per
    lane (default ``multi_threads``): thread s of a lane sums steps [s L,
    (s + 1) L) (L = g / T), thread 0 from acc, and the T partial sums are
    added by a tree, y[s] <- y[s] + y[s + d] for d = 1, 2, 4, ...  T = 1 is
    the sequential sum."""
    ops = ops.as_plain()
    g = qs.shape[0] // 3
    T = multi_threads(acc.shape[-1], g) if T is None else T
    if g % T or T > max(g, 1):
        raise ValueError(f"T = {T} does not divide g = {g}")
    a = _bm(acc)
    if g == 0:
        return _lm(a)
    L = g // T
    q = _bm(qs).reshape(-1, g, 3, ops.W).transpose(0, 1)      # [g, B, 3, W]
    q = q.reshape(T, L, *q.shape[1:])                         # [T, L, B, 3, W]
    y = torch.cat([ops.jac_add(a, q[0, 0])[None], q[1:, 0]])  # [T, B, 3, W]
    for j in range(1, L):
        y = ops.jac_add(y, q[:, j])
    while y.shape[0] > 1:                  # the partial sums left: s = 0, d, 2d, ...
        y = ops.jac_add(y[0::2], y[1::2])
    return _lm(y[0])


# ------------------------------------------------------------------ kernels

_CONSTS: dict = {}


def check_lazy_headroom(wf: WordField) -> None:
    """The curve kernels keep values below 2p with no final subtraction in
    the multiply (csrc/field.cuh), which needs 4p < R = 2^(32 W)."""
    if not 4 * wf.modulus < wf.R:
        raise ValueError(
            f"{wf.fp.name}: the lazy curve kernels need 4p < 2^{32 * wf.W}, and "
            f"p has {wf.modulus.bit_length()} bits"
        )


def _consts(ops: CurveOps):
    """The packed CurveConsts<W> words (p, n0, one, 2p, k3b) in host memory,
    for a field with the lazy core's headroom; 3b must be a small integer."""
    key = ("curve", ops.curve.name)
    buf = _CONSTS.get(key)
    if buf is None:
        wf = ops.wf
        check_lazy_headroom(wf)
        k3b = 3 * ops.curve.b
        if not 1 <= k3b < 16:
            raise ValueError(f"3b = {k3b}: the kernels take 3b below 16")
        words = np.concatenate([
            np.frombuffer(field_consts(wf), np.int32),
            ints_to_words([2 * wf.modulus], wf.W)[0],
            np.asarray([k3b], np.int32),
        ])
        buf = _CONSTS[key] = (ctypes.c_int32 * words.size)(*words.tolist())
    return buf


_LAYOUT_CHECKED: set = set()


def _kernel(name: str, W: int):
    """The width-W C entry point of kernel ``name``, once the library is
    known to take the constant layouts packed above."""
    if W not in _LAYOUT_CHECKED:
        words = (entry("ap_consts_words", W)(), entry("ap_field_consts_words", W)())
        if words != (3 * W + 2, 2 * W + 1):
            raise RuntimeError(f"kernel constant layout mismatch ({words} words at W = {W})")
        _LAYOUT_CHECKED.add(W)
    return entry(f"ap_{name}", W)


def mixed_add_signed_multi(ops: CurveOps, acc, pts_flat, packed):
    """K1: acc [3, W, B] plus g signed affine points, gathered from the flat
    table ``pts_flat`` [N+1, 2W] at ``packed`` [g, B] member indices (row in
    the low bits, sign in bit SIGN_SHIFT) -> [3, W, B]."""
    if acc.device.type == "cpu":
        return plain_mixed_add_signed_multi(ops, acc, pts_flat, packed)
    W = ops.W
    B = acc.shape[-1]
    g = packed.shape[0]
    check_tensor("acc", acc, (3, W, B))
    check_tensor("pts_flat", pts_flat, (pts_flat.shape[0], 2 * W))
    check_tensor("packed", packed, (g, B))
    if pts_flat.data_ptr() % 16:
        raise ValueError("pts_flat: the kernel reads rows as 16-byte vectors; "
                         "expected a 16-byte aligned table")
    out = torch.empty_like(acc)
    rc = _kernel("mixed_add_signed_multi", W)(
        acc.data_ptr(), pts_flat.data_ptr(), packed.data_ptr(), out.data_ptr(),
        B, g, pts_flat.shape[0], _consts(ops), stream_of(acc),
    )
    raise_on(rc, "mixed_add_signed_multi")
    _count("mixed_add_signed_multi", W)
    return out


def jac_add_multi_scan(ops: CurveOps, acc, qs):
    """K2: acc [3, W, B] and g projective points qs [3g, W, B] -> the
    inclusive scan [3g, W, B], out[3k:3k+3] = acc + qs[0] + ... + qs[k] (as
    points), with ``scan_threads(B, g)`` threads per lane."""
    if acc.device.type == "cpu":
        return plain_jac_add_multi_scan(ops, acc, qs)
    W = ops.W
    B = acc.shape[-1]
    g = qs.shape[0] // 3
    T = scan_threads(B, g)
    check_tensor("acc", acc, (3, W, B))
    check_tensor("qs", qs, (3 * g, W, B))
    if T not in SCAN_THREADS or g % T:
        raise ValueError(f"T = {T}: expected one of {SCAN_THREADS} dividing g = {g}")
    out = torch.empty_like(qs)
    rc = _kernel("jac_add_multi_scan", W)(
        acc.data_ptr(), qs.data_ptr(), out.data_ptr(), B, g, T, _consts(ops),
        stream_of(acc),
    )
    raise_on(rc, "jac_add_multi_scan")
    _count("jac_add_multi_scan", W)
    return out


def jac_add(ops: CurveOps, p, q):
    """K3: complete projective add, p, q [3, W, B] -> [3, W, B]."""
    if p.device.type == "cpu":
        return plain_jac_add(ops, p, q)
    W = ops.W
    B = p.shape[-1]
    check_tensor("p", p, (3, W, B))
    check_tensor("q", q, (3, W, B))
    out = torch.empty_like(p)
    rc = _kernel("jac_add", W)(
        p.data_ptr(), q.data_ptr(), out.data_ptr(), B, _consts(ops), stream_of(p)
    )
    raise_on(rc, "jac_add")
    _count("jac_add", W)
    return out


def jac_add_window_scan(ops: CurveOps, x, nwin: int, E: int):
    """K3's scan: the inclusive scan of each of nwin windows of E lanes
    (lane w * E + i of x [3, W, B], 1 <= E <= 1024; lanes past nwin * E are
    not read) -> [3, W, nwin * E], in one launch, one block per window."""
    if x.device.type == "cpu":
        return plain_jac_add_window_scan(ops, x, nwin, E)
    W = ops.W
    B = x.shape[-1]
    check_tensor("x", x, (3, W, B))
    if not (1 <= E <= 1024 and nwin * E <= B):
        raise ValueError(f"{nwin} windows of {E} lanes in {B}: expected 1 <= E <= 1024")
    out = torch.empty((3, W, nwin * E), dtype=x.dtype, device=x.device)
    rc = _kernel("jac_add_window_scan", W)(
        x.data_ptr(), out.data_ptr(), B, nwin, E, _consts(ops), stream_of(x)
    )
    raise_on(rc, "jac_add_window_scan")
    _count("jac_add_window_scan", W)
    return out


def window_combine(ops: CurveOps, base, in_block, nw: int, c: int):
    """K3's phase 4: S_w = D P[e_D] - sum_{d<D} P[e_d] for each of nw windows,
    P[e_d] = base + in_block at lane w * (D + 1) + d of [3, W, B], D =
    2^(c-1) -> [nw, 3, W] canonical, in one launch, one block per window."""
    if base.device.type == "cpu":
        return plain_window_combine(ops, base, in_block, nw, c)
    W = ops.W
    B = base.shape[-1]
    check_tensor("base", base, (3, W, B))
    check_tensor("in_block", in_block, (3, W, B))
    if not (1 <= c <= 12 and nw * ((1 << (c - 1)) + 1) <= B):
        raise ValueError(f"{nw} windows at c = {c} in {B} lanes")
    out = torch.empty((nw, 3, W), dtype=base.dtype, device=base.device)
    rc = _kernel("window_combine", W)(
        base.data_ptr(), in_block.data_ptr(), out.data_ptr(), B, nw, c,
        _consts(ops), stream_of(base),
    )
    raise_on(rc, "window_combine")
    _count("window_combine", W)
    return out


def _canon_ladder(ops: CurveOps):
    """(steps, the ladder's words in host memory) for K4 on the curve's base
    field."""
    key = ("canon", ops.curve.name)
    got = _CONSTS.get(key)
    if got is None:
        words = ints_to_words(canon_ladder(ops.wf), ops.W).reshape(-1)
        got = _CONSTS[key] = (canon_steps(ops.wf),
                              (ctypes.c_int32 * words.size)(*words.tolist()))
    return got


def canon(ops: CurveOps, x):
    """K4: [R, W, B] words (any W-word values) -> canonical residues, by a
    ladder of ``canon_steps`` conditional subtractions; the kernel refuses
    a ladder length other than the one it was compiled with."""
    if x.device.type == "cpu":
        return plain_canon(ops, x)
    W = ops.W
    R, B = x.shape[0], x.shape[-1]
    check_tensor("x", x, (R, W, B))
    out = torch.empty_like(x)
    steps, ladder = _canon_ladder(ops)
    rc = _kernel("canon", W)(x.data_ptr(), out.data_ptr(), R, B, steps, ladder, stream_of(x))
    raise_on(rc, "canon")
    _count("canon", W)
    return out


MIXED_THREADS = (1, 2)                 # K5's and K6's threads per lane
MIXED_THREADS_BY_WIDTH = {8: 1, 12: 2}


def mixed_threads(W: int) -> int:
    """K5's and K6's threads per lane at W words, the fastest at the
    kernel-test widths (98,688 lanes at W = 8, 24,960 at W = 12; H100,
    PERF.md).  At W = 12 two warps a lane group (6 multiplies deep, one
    wave) beat one thread a lane (11 deep); at W = 8 the lanes fill the
    card, and one thread a lane, with no exchange, wins.  It reads no
    device property."""
    if W not in MIXED_THREADS_BY_WIDTH:
        raise ValueError(f"K5 and K6 have no thread count for W = {W}")
    return MIXED_THREADS_BY_WIDTH[W]


def mixed_add(ops: CurveOps, acc, pts):
    """K5: acc [3, W, B] plus affine pts [2, W, B] ((0, 0) is the identity)
    -> [3, W, B], with ``mixed_threads(W)`` threads per lane (K6's kernel
    without the sign)."""
    if acc.device.type == "cpu":
        return plain_mixed_add(ops, acc, pts)
    W = ops.W
    B = acc.shape[-1]
    Tm = mixed_threads(W)
    check_tensor("acc", acc, (3, W, B))
    check_tensor("pts", pts, (2, W, B))
    out = torch.empty_like(acc)
    rc = _kernel("mixed_add", W)(
        acc.data_ptr(), pts.data_ptr(), out.data_ptr(), B, Tm, _consts(ops), stream_of(acc)
    )
    raise_on(rc, "mixed_add")
    _count("mixed_add", W)
    return out


def mixed_add_signed(ops: CurveOps, acc, pts, neg):
    """K6: as K5, with pts negated on lanes where neg [1, B] is non-zero (the
    identity is detected before the negation), with ``mixed_threads(W)``
    threads per lane."""
    if acc.device.type == "cpu":
        return plain_mixed_add_signed(ops, acc, pts, neg)
    W = ops.W
    B = acc.shape[-1]
    Tm = mixed_threads(W)
    check_tensor("acc", acc, (3, W, B))
    check_tensor("pts", pts, (2, W, B))
    check_tensor("neg", neg, (1, B))
    out = torch.empty_like(acc)
    rc = _kernel("mixed_add_signed", W)(
        acc.data_ptr(), pts.data_ptr(), neg.data_ptr(), out.data_ptr(), B, Tm,
        _consts(ops), stream_of(acc),
    )
    raise_on(rc, "mixed_add_signed")
    _count("mixed_add_signed", W)
    return out


def jac_add_multi(ops: CurveOps, acc, qs):
    """K7: acc [3, W, B] plus g projective points qs [3g, W, B] -> the sum
    [3, W, B] (as a point; in the words of ``plain_jac_add_multi`` at the
    same T), with ``multi_threads(B, g)`` threads per lane."""
    if acc.device.type == "cpu":
        return plain_jac_add_multi(ops, acc, qs)
    W = ops.W
    B = acc.shape[-1]
    g = qs.shape[0] // 3
    T = multi_threads(B, g)
    check_tensor("acc", acc, (3, W, B))
    check_tensor("qs", qs, (3 * g, W, B))
    if T not in MULTI_THREADS or g % T or T > max(g, 1):
        raise ValueError(f"T = {T}: expected one of {MULTI_THREADS} dividing g = {g}")
    out = torch.empty_like(acc)
    rc = _kernel("jac_add_multi", W)(
        acc.data_ptr(), qs.data_ptr(), out.data_ptr(), B, g, T, _consts(ops),
        stream_of(acc),
    )
    raise_on(rc, "jac_add_multi")
    _count("jac_add_multi", W)
    return out

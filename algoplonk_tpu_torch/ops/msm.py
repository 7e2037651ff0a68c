"""Multi-scalar multiplication: the prefix-scan bucket method in PyTorch.

Counterpart of the reference ``ops/msm.py`` (its module docstring has the
algorithm): signed balanced c-bit windows, one sort of each window by
|digit|, bucket sums telescoped into unsegmented prefix sums P[e_d], and the
prefix sums computed block-decomposed with static shapes.

    phase 1   K-step in-block reduction          -> K1 mixed_add_signed_multi
    phase 2   scan of the block sums per window: one level (Kogge-Stone,
              K3 jac_add_window_scan), or two levels (2a K2
              jac_add_multi_scan, 2b Kogge-Stone over the super sums, K3
              jac_add_window_scan, 2c one row gather of the 2a scan, then
              K3 jac_add)
    phase 3   in-block rescan up to e_d          -> K1
    phase 4   P[e_d], tree sum over d, D * P[e_D] - sum P[e_d]
                                                 -> K3 window_combine

This is the reference's Pallas branch; the wrappers in ``curve_kernels``
launch the CUDA kernels for CUDA tensors and run their plain versions for
CPU tensors, so one pipeline serves both.  On a plain twin of the curve
(``msm_ctx(curve, device, plain=True)``) the pipeline calls the plain
versions themselves, and its field ops are plain too: the MSM's plain path,
which launches no kernel on any device.  The sort and searchsorted are
``torch.sort`` and ``torch.searchsorted``; every index the reference clips
is clipped here too (a gather out of range raises in torch, and is a device
assert on CUDA).  The cross-window fold runs on host ints.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields.params import CurveParams
from ..fields.words import mont_words_to_ints
from . import curve_kernels as ck
from .curve import CurveOps, curve_ops
from .curve_kernels import (
    SIGN_SHIFT,
    inf_lm,
    jac_add,
    jac_add_multi_scan,
    jac_add_window_scan,
    mixed_add_signed_multi,
    window_combine,
)
from .field import FieldOps, field_ops

WINDOW_BITS = 11
_TILE = 128          # lane counts pad up to a multiple (one CUDA block)
K_BLOCK = 16         # entries per block (phase 1/3 steps)
FUSE_STEPS = 16      # gather-add steps per K1 launch
SUPER = 16           # blocks per super-block (two-level phase 2)
HOST_MSM_MAX = 1024  # at or below this many points the MSM runs on host ints
CHUNK = 1 << 18      # points per device piece


def num_windows(c: int = WINDOW_BITS) -> int:
    """Windows for a 256-bit scalar, with one bit of headroom for the final
    carry of the balanced signed recode."""
    return -(-257 // c)


def pick_window_bits(n: int) -> int:
    return max(2, min(WINDOW_BITS, n.bit_length() - 2))


def scalar_digits(scalars, nbytes: int = 32, c: int = WINDOW_BITS) -> np.ndarray:
    """Python ints -> [nw, N] signed balanced window digits (int32, LSB
    window first): sum_w d_w 2^(c w) = s with d_w in [-2^(c-1), 2^(c-1)]."""
    n = len(scalars)
    half = 1 << (c - 1)
    nb = nbytes + 3  # slack for 3-byte reads from the headroom window
    buf = b"".join(int(s).to_bytes(nb, "little") for s in scalars)
    arr = np.frombuffer(buf, dtype=np.uint8).reshape(n, nb).astype(np.int64)
    nw = num_windows(c)
    mask = (1 << c) - 1
    digs = np.zeros((nw, n), np.int64)
    for w in range(nw):
        k, off = divmod(c * w, 8)
        v = (arr[:, k] | (arr[:, k + 1] << 8) | (arr[:, k + 2] << 16)) >> off
        digs[w] = v & mask
    carry = np.zeros(n, np.int64)
    for w in range(nw):
        v = digs[w] + carry
        carry = (v >= half).astype(np.int64)
        digs[w] = v - (carry << c)
    if carry.any():
        raise ValueError("scalar overflows the window decomposition")
    return digs.astype(np.int32)


def digits_from_mont_limbs(f: FieldOps, mont_words, c: int = WINDOW_BITS):
    """Montgomery [N, W] words -> [nw, N] signed window digits, on the
    device.  A window of c <= 12 bits spans at most two 32-bit words, so it
    is re-packed with static shifts; the balanced recode is a short carry
    chain over the nw windows."""
    if c > 12:
        raise ValueError("windows wider than 12 bits are not supported")
    half = 1 << (c - 1)
    u = f.from_mont(mont_words).to(torch.int64) & 0xFFFFFFFF
    nw = num_windows(c)
    mask = (1 << c) - 1
    cols = []
    for w in range(nw):
        k, off = divmod(c * w, 32)
        if k >= f.W:
            cols.append(torch.zeros_like(u[:, 0]))
            continue
        b = u[:, k] >> off
        if k + 1 < f.W and off + c > 32:
            b = b | (u[:, k + 1] << (32 - off))
        cols.append(b & mask)
    carry = torch.zeros_like(u[:, 0])
    out = []
    for w in range(nw):
        v = cols[w] + carry
        carry = (v >= half).to(v.dtype)
        out.append(v - (carry << c))
    return torch.stack(out, dim=0).to(torch.int32)


def _pad_lanes(n: int) -> int:
    return -(-n // _TILE) * _TILE


def _no_mark(name: str) -> None:
    pass


def _curve_fns(ops: CurveOps):
    """K1, K2, K3, K3's scan and K3's phase 4 for ``ops``: the kernel
    wrappers (looked up at call time, so that tests can wrap them), or on a
    plain twin their plain versions."""
    if ops.plain:
        return (ck.plain_mixed_add_signed_multi, ck.plain_jac_add_multi_scan,
                ck.plain_jac_add, ck.plain_jac_add_window_scan, ck.plain_window_combine)
    return (mixed_add_signed_multi, jac_add_multi_scan, jac_add, jac_add_window_scan,
            window_combine)


def window_sums_scan(ops: CurveOps, points_pad, digits, c: int = WINDOW_BITS,
                     k_block: int = K_BLOCK, mark=None):
    """[N+1, 2, W] infinity-padded affine points + [nw, N] signed digits
    -> [nw, 3, W] batch-major window sums S_w = sum_d d B_d.  K1 adds
    ``FUSE_STEPS`` points per launch, read at call time so that tests can
    set it (the reference caps it at 8 for BLS12-381; the port keeps 16).

    ``mark(name)``, if given, is called at the end of each part of the
    pipeline with the part's name ('sort', 'K1', 'K2', 'K3 scan', 'K3 add',
    'gathers', 'phase 4'); a caller that synchronises there can time the
    parts."""
    mark = mark or _no_mark
    k1, k2, k3, k3_scan, k3_phase4 = _curve_fns(ops)
    dev = points_pad.device
    W = ops.W
    i32 = dict(dtype=torch.int32, device=dev)
    n = points_pad.shape[0] - 1
    pts_flat = points_pad.reshape(n + 1, 2 * W).contiguous()
    nw = digits.shape[0]
    D = 1 << (c - 1)
    K = max(1, min(k_block, n))
    S = SUPER
    two_level = (-(-n // K)) >= 16 * S
    blk_quant = K * S if two_level else K
    n_pad = -(-n // blk_quant) * blk_quant
    nblk = n_pad // K
    nsb = nblk // S if two_level else 0

    # ---- sort each window by |digit|.  (|d|, sign, row) pack into one int32
    # key; CHUNK keeps bits(D) + 1 + bits(n - 1) <= 31.
    idx_bits = max(1, (n - 1).bit_length())
    if D.bit_length() + 1 + idx_bits > 31 or idx_bits > SIGN_SHIFT:
        raise ValueError(f"{n} points at c = {c} do not fit the packed sort key")
    mag = digits.abs()
    rows = torch.arange(n, **i32)[None].expand(nw, n)
    combo = (mag << (idx_bits + 1)) | ((digits < 0).to(torch.int32) << idx_bits) | rows
    scombo = torch.sort(combo, dim=1).values
    smag = scombo >> (idx_bits + 1)
    packed = (scombo & ((1 << idx_bits) - 1)) | (((scombo >> idx_bits) & 1) << SIGN_SHIFT)
    if n_pad > n:
        smag = torch.cat([smag, torch.full((nw, n_pad - n), D + 1, **i32)], dim=1)
        packed = torch.cat([packed, torch.full((nw, n_pad - n), n, **i32)], dim=1)
    packed_blk = packed.reshape(nw, nblk, K).permute(2, 0, 1)   # [K, nw, nblk]
    mark("sort")

    def fused_gather_steps(acc, packed_steps, nsteps, lanes, lanes_pad):
        """packed_steps [nsteps, ...lanes]: K1 in groups of <= FUSE_STEPS."""
        flat = torch.cat(
            [packed_steps.reshape(nsteps, lanes),
             torch.full((nsteps, lanes_pad - lanes), n, **i32)],
            dim=1,
        )
        for j in range(0, nsteps, FUSE_STEPS):
            acc = k1(ops, acc, pts_flat, flat[j : j + FUSE_STEPS].contiguous())
        return acc

    # ---- phase 1: in-block reduction -> block sums [3, W, w1p]
    w1 = nw * nblk
    w1p = _pad_lanes(w1)
    block_sums = fused_gather_steps(inf_lm(ops, w1p), packed_blk, K, w1, w1p)
    mark("K1")

    # ---- phase 3 targets e_d = last sorted index with |digit| <= d
    dvals = torch.arange(0, D + 1, **i32)[None].expand(nw, D + 1).contiguous()
    e = torch.searchsorted(smag.contiguous(), dvals, right=True).to(torch.int32) - 1
    eb = torch.where(e >= 0, torch.div(e, K, rounding_mode="floor"), -1)
    r = torch.where(e >= 0, e - eb * K, -1)
    prev = eb - 1                                  # last block fully before e_d
    w_ids = torch.arange(nw, **i32)[:, None].expand(nw, D + 1)
    w2 = nw * (D + 1)
    w2p = _pad_lanes(w2)
    mark("sort")

    def gather_rows_lm(bm_with_inf, lane, invalid):
        """Rows of a batch-major [R+1, 3, W] table (last row = identity) at
        [nw, D+1] lane ids -> limbs-major [3, W, w2p]."""
        R1 = bm_with_inf.shape[0]
        idx = torch.where(invalid, R1 - 1, lane).reshape(w2)
        idx = torch.cat([idx, torch.full((w2p - w2,), R1 - 1, **i32)])
        flat = bm_with_inf.reshape(R1, 3 * W)
        return flat[idx.long()].T.reshape(3, W, w2p).contiguous()

    inf_row_bm = ops.jac_infinity((1,))

    if not two_level:
        # ---- phase 2, one level: inclusive scan over the block sums of
        # each window (lane w*nblk + b)
        scan = k3_scan(ops, block_sums, nw, nblk)
        mark("K3 scan")
        scan_bm = torch.cat([scan.permute(2, 0, 1), inf_row_bm])
        lane = w_ids * nblk + prev.clamp(0, nblk - 1)
        base_lm = gather_rows_lm(scan_bm, lane, prev < 0)
        mark("gathers")
    else:
        # ---- phase 2, two levels.  2a: scan each super-block of S block
        # sums, emitting every step (K2)
        bs5 = block_sums[:, :, :w1].reshape(3, W, nw, nsb, S)
        wsb = nw * nsb
        wsbp = _pad_lanes(wsb)
        # zero padding lanes are junk points no consulted lane ever reads
        qs = torch.nn.functional.pad(
            bs5.movedim(4, 0).reshape(S, 3, W, wsb), (0, wsbp - wsb)
        ).reshape(S * 3, W, wsbp).contiguous()
        mark("gathers")
        is_scan = k2(ops, inf_lm(ops, wsbp), qs)
        super_sums = is_scan[-3:]
        mark("K2")

        # 2b: inclusive scan over the super sums of each window
        super_scan = k3_scan(ops, super_sums.contiguous(), nw, nsb)
        mark("K3 scan")

        # base = super_scan[esb_prev - 1] + is_scan[esb_prev][r2]
        esb_prev = torch.where(prev >= 0, torch.div(prev, S, rounding_mode="floor"), -1)
        r2 = torch.where(prev >= 0, prev - esb_prev * S, -1)
        ss_bm = torch.cat([super_scan.permute(2, 0, 1), inf_row_bm])
        lane_ss = w_ids * nsb + (esb_prev - 1).clamp(0, nsb - 1)
        base_lm = gather_rows_lm(ss_bm, lane_ss, esb_prev - 1 < 0)

        # 2c as one gather from the row table [(lane, s), 3W] of the 2a scan,
        # identity row appended for prev < 0 targets
        flat_is = is_scan.reshape(S * 3 * W, wsbp).T.reshape(wsbp * S, 3 * W)
        tbl = torch.cat([flat_is, inf_row_bm.reshape(1, 3 * W)])
        lane_sb = w_ids * nsb + esb_prev.clamp(0, nsb - 1)
        idx = torch.where(prev < 0, wsbp * S, lane_sb * S + r2).reshape(w2)
        idx = torch.cat([idx, torch.full((w2p - w2,), wsbp * S, **i32)])
        rescan = tbl[idx.long()].T.reshape(3, W, w2p).contiguous()
        mark("gathers")
        base_lm = k3(ops, base_lm, rescan)
        mark("K3 add")

    # ---- phase 3: in-block point rescan up to e_d
    blk_members = torch.gather(
        packed_blk.permute(1, 2, 0),                          # [nw, nblk, K]
        1,
        eb.clamp(0, nblk - 1).long()[:, :, None].expand(nw, D + 1, K),
    ).permute(2, 0, 1)                                        # [K, nw, D+1]
    j_all = torch.arange(K, **i32)[:, None, None]
    live_all = (j_all <= r[None]) & (e[None] >= 0)
    idx_all = torch.where(live_all, blk_members, n)
    mark("gathers")
    in_block = fused_gather_steps(inf_lm(ops, w2p), idx_all, K, w2, w2p)
    mark("K1")

    # ---- phase 4: P[e_d] = base + in_block, S_w = D * P[e_D] - sum_{d<D}
    # P[e_d]
    out = k3_phase4(ops, base_lm, in_block, nw, c)           # [nw, 3, W]
    mark("phase 4")
    return out


def add_window_sums(ops: CurveOps, a, b):
    """Two [nw, 3, W] window-sum sets -> their sum window by window, in
    one K3 launch over nw lanes (its plain version on a plain twin): how
    the pieces of one MSM, and the shards of a sharded one, combine."""
    k3 = _curve_fns(ops)[2]
    return k3(ops, a.permute(1, 2, 0).contiguous(),
              b.permute(1, 2, 0).contiguous()).permute(2, 0, 1)


# --------------------------------------------------------------- host MSM

def _host_digits(s: int, c: int) -> list:
    """Signed balanced base-2^c digits of a non-negative int."""
    out = []
    half, full = 1 << (c - 1), 1 << c
    while s:
        d = s & (full - 1)
        s >>= c
        if d > half:
            d -= full
            s += 1
        out.append(d)
    return out


def _jac_double(p: int, P):
    """2P of a Jacobian (X, Y, Z) on y^2 = x^3 + b (a = 0); None is the
    identity."""
    if P is None:
        return None
    X, Y, Z = P
    if Y == 0:
        return None
    A, B = X * X % p, Y * Y % p
    C = B * B % p
    D = 2 * ((X + B) * (X + B) - A - C) % p
    E = 3 * A % p
    X3 = (E * E - 2 * D) % p
    return X3, (E * (D - X3) - 8 * C) % p, 2 * Y * Z % p


def _jac_add(p: int, P, Q):
    """P + Q of two Jacobian points; None is the identity."""
    if P is None:
        return Q
    if Q is None:
        return P
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    Z1Z1, Z2Z2 = Z1 * Z1 % p, Z2 * Z2 % p
    U1, U2 = X1 * Z2Z2 % p, X2 * Z1Z1 % p
    S1, S2 = Y1 * Z2 * Z2Z2 % p, Y2 * Z1 * Z1Z1 % p
    H, r = (U2 - U1) % p, (S2 - S1) % p
    if H == 0:
        return _jac_double(p, P) if r == 0 else None
    HH = H * H % p
    HHH, V = H * HH % p, U1 * HH % p
    X3 = (r * r - HHH - 2 * V) % p
    return X3, (r * (V - X3) - S1 * HHH) % p, Z1 * Z2 * H % p


def _jac_add_affine(p: int, P, x2: int, y2: int):
    """P + (x2, y2) of a Jacobian P and an affine point (mixed add)."""
    if P is None:
        return x2, y2, 1
    X1, Y1, Z1 = P
    Z1Z1 = Z1 * Z1 % p
    H, r = (x2 * Z1Z1 - X1) % p, (y2 * Z1 * Z1Z1 - Y1) % p
    if H == 0:
        return _jac_double(p, P) if r == 0 else None
    HH = H * H % p
    HHH, V = H * HH % p, X1 * HH % p
    X3 = (r * r - HHH - 2 * V) % p
    return X3, (r * (V - X3) - Y1 * HHH) % p, Z1 * H % p


def host_msm(curve: CurveParams, points: list, scalars: list):
    """Pippenger over host ints (after the reference ops/msm.py:665, whose
    module imports jax): points = [(x, y) | None], scalars = ints.  Returns
    an affine int tuple or None.

    The reference sums in affine coordinates, and each of its additions
    pays a modular inverse (about 30 of its 35 us on BN254's Fp); here the
    buckets and sums are Jacobian, with one inverse for the result, and the
    window is the c that balances a window's n point additions against its
    2^c bucket-sum additions.  The result is the same point."""
    p = curve.fp.modulus
    n = len(points)
    c = max(2, min(16, n.bit_length() - 3))
    nw = -(-curve.fr.modulus.bit_length() // c) + 1
    half = 1 << (c - 1)
    buckets = [[None] * (half + 1) for _ in range(nw)]
    for pt, s in zip(points, scalars):
        if pt is None or s == 0:
            continue
        x, y = pt
        for w, d in enumerate(_host_digits(int(s), c)):
            if d:
                b, k = buckets[w], abs(d)
                b[k] = _jac_add_affine(p, b[k], x, y if d > 0 else (-y) % p)
    acc = None
    for w in range(nw - 1, -1, -1):
        for _ in range(c if acc is not None else 0):
            acc = _jac_double(p, acc)
        run = tot = None
        for k in range(half, 0, -1):
            run = _jac_add(p, run, buckets[w][k])
            tot = _jac_add(p, tot, run)
        acc = _jac_add(p, acc, tot)
    if acc is None:
        return None
    X, Y, Z = acc
    zi = pow(Z, -1, p)
    zi2 = zi * zi % p
    return X * zi2 % p, Y * zi2 * zi % p


class MsmCtx:
    """The MSM of one curve on one device; ``plain=True`` runs it on the
    plain twins of the curve and scalar field (the plain path)."""

    def __init__(self, curve: CurveParams, device, plain: bool = False):
        self.curve = curve
        self.ops: CurveOps = curve_ops(curve, device, plain)
        self.fr: FieldOps = field_ops(curve.fr, device, plain)

    def _host_fold(self, window_sums, c: int = WINDOW_BITS) -> tuple | None:
        """[nw, 3, W] Montgomery projective window sums -> host affine int
        tuple (or None), Horner over the windows on host ints."""
        from ..host import fp as hfp

        p = self.curve.fp.modulus
        nw = window_sums.shape[0]
        coords = mont_words_to_ints(
            window_sums.reshape(nw * 3, self.ops.W).cpu().numpy(), self.ops.wf
        )
        F = hfp.GF(p)
        acc = None
        for w in range(nw - 1, -1, -1):
            X, Y, Z = coords[3 * w], coords[3 * w + 1], coords[3 * w + 2]
            if acc is not None:
                for _ in range(c):
                    acc = hfp.ec_double(F, acc)
            if Z != 0:
                zi = pow(Z, -1, p)
                acc = hfp.ec_add(F, acc, (X * zi % p, Y * zi % p))
        return acc

    def msm_to_affine_int(self, points_affine, scalars, kind: str = "auto",
                          window_bits: int | None = None, mark=None):
        """MSM over G1 -> host affine int tuple (or None).

        points_affine: [N, 2, W] Montgomery affine words on the device.
        scalars, by ``kind``: 'ints' (canonical Python ints), 'mont'
        ([N, W] Montgomery words, the prover's path), 'digits' ([nw, N]
        signed window digits) or 'auto'.  ``mark`` is window_sums_scan's,
        with 'digits' and 'host fold' besides."""
        mark = mark or _no_mark
        n = points_affine.shape[0]
        if kind == "auto":
            if isinstance(scalars, (list, tuple)):
                kind = "ints"
            elif scalars.ndim == 2 and tuple(scalars.shape) == (
                num_windows(window_bits or WINDOW_BITS), n
            ):
                kind = "digits"
            else:
                kind = "mont"

        if n <= HOST_MSM_MAX and kind != "digits":
            ints = (
                [int(s) for s in scalars] if kind == "ints"
                else self.fr.decode(scalars)
            )
            return host_msm(
                self.curve, self.ops.decode_affine(points_affine), ints
            )

        c = window_bits or (WINDOW_BITS if kind == "digits" else pick_window_bits(n))
        if kind == "ints":
            scal = torch.from_numpy(scalar_digits(scalars, c=c)).to(points_affine.device)
            kind = "digits"
        else:
            scal = scalars
        if kind == "digits" and tuple(scal.shape) != (num_windows(c), n):
            raise ValueError(f"digits shape {tuple(scal.shape)} for c = {c}, n = {n}")

        total = None
        for off in range(0, n, CHUNK):
            hi = min(off + CHUNK, n)
            pts = points_affine[off:hi]
            digs = (
                digits_from_mont_limbs(self.fr, scal[off:hi], c=c)
                if kind == "mont" else scal[:, off:hi]
            )
            pts_pad = torch.cat(
                [pts, torch.zeros((1, 2, self.ops.W), dtype=torch.int32, device=pts.device)]
            )
            mark("digits")
            ws = window_sums_scan(self.ops, pts_pad, digs.contiguous(), c, mark=mark)
            total = ws if total is None else add_window_sums(self.ops, total, ws)
        folded = self._host_fold(total, c)
        mark("host fold")
        return folded


@functools.lru_cache(maxsize=None)
def _msm_ctx(curve: CurveParams, device: str, plain: bool) -> MsmCtx:
    return MsmCtx(curve, device, plain)


def msm_ctx(curve: CurveParams, device="cuda", plain: bool = False) -> MsmCtx:
    return _msm_ctx(curve, str(torch.device(device)), plain)

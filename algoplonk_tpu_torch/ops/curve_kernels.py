"""Wrappers of the four MSM kernels (csrc/msm_kernels.cu), each beside its
plain PyTorch version.

Counterparts of the reference ``ops/curve_pallas.py`` factories:

  ==============================  =======================================
  port (here)                     reference (TPU, Pallas)
  ==============================  =======================================
  ``mixed_add_signed_multi``      ``pallas_mixed_add_signed_multi`` :250
  ``jac_add_multi_scan``          ``pallas_jac_add_multi_scan``     :357
  ``jac_add``                     ``pallas_jac_add``                :292
  ``canon``                       ``pallas_canon``                  :404
  ==============================  =======================================

Every array is limbs-major ``[coord, W, B]`` int32 (lane axis last), as the
TPU kernels take it.  A tensor on the CPU goes to the plain version; a CUDA
tensor launches the kernel or raises, with no fallback.  Each wrapper counts
its kernel launches in ``LAUNCHES``; plain calls are not counted.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..fields.words import ints_to_mont_words, ints_to_words
from ._build import check_tensor, raise_on, stream_of
from .curve import CurveOps

SIGN_SHIFT = 26  # bit of a packed member index carrying the digit sign
ROW_MASK = (1 << SIGN_SHIFT) - 1

KERNELS = ("mixed_add_signed_multi", "jac_add_multi_scan", "jac_add", "canon")
LAUNCHES = dict.fromkeys(KERNELS, 0)


def reset_launch_counts() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0


# ------------------------------------------------------------ plain versions

def _bm(x_lm):
    """[C, W, B] limbs-major -> [B, C, W] batch-major."""
    return x_lm.permute(2, 0, 1)


def _lm(x_bm):
    return x_bm.permute(1, 2, 0).contiguous()


def plain_mixed_add_signed_multi(ops: CurveOps, acc, pts_flat, packed):
    W = ops.W
    rows = (packed & ROW_MASK).clamp(max=pts_flat.shape[0] - 1).long()
    neg = (packed >> SIGN_SHIFT) == 1
    a = _bm(acc)
    for k in range(packed.shape[0]):
        pts = pts_flat[rows[k]].reshape(-1, 2, W)
        y = ops.f.select(neg[k], ops.f.neg(pts[:, 1]), pts[:, 1])
        a = ops.jac_add_affine(a, torch.stack([pts[:, 0], y], dim=1))
    return _lm(a)


def plain_jac_add_multi_scan(ops: CurveOps, acc, qs):
    g = qs.shape[0] // 3
    a = _bm(acc)
    outs = []
    for k in range(g):
        a = ops.jac_add(a, _bm(qs[3 * k : 3 * k + 3]))
        outs.append(a)
    return _lm(torch.cat(outs, dim=1))


def plain_jac_add(ops: CurveOps, p, q):
    return _lm(ops.jac_add(_bm(p), _bm(q)))


def plain_canon(ops: CurveOps, x):
    f = ops.f
    return f.reduce(f.mul(x.transpose(1, 2), f.one)).transpose(1, 2).contiguous()


# ------------------------------------------------------------------ kernels

_CONSTS: dict = {}


def _consts(ops: CurveOps):
    """The packed CurveConsts words (p, n0, one, b3) in host memory."""
    key = ops.curve.name
    buf = _CONSTS.get(key)
    if buf is None:
        wf = ops.wf
        words = np.concatenate([
            ints_to_words([wf.modulus], wf.W)[0],
            np.asarray([wf.n0], np.uint32).view(np.int32),
            ints_to_words([wf.r], wf.W)[0],
            ints_to_mont_words([3 * ops.curve.b], wf)[0],
        ])
        buf = (ctypes.c_int32 * words.size)(*words.tolist())
        _CONSTS[key] = buf
    return buf


def _lib(ops: CurveOps):
    from ._build import library

    if ops.W != 8:
        raise NotImplementedError("the kernels are built for W = 8 (BN254)")
    lib = library()
    n = lib.ap_consts_words()
    if n != 3 * ops.W + 1:
        raise RuntimeError(f"kernel constant layout mismatch ({n} words)")
    return lib


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
    lib = _lib(ops)
    out = torch.empty_like(acc)
    rc = lib.ap_mixed_add_signed_multi(
        acc.data_ptr(), pts_flat.data_ptr(), packed.data_ptr(), out.data_ptr(),
        B, g, pts_flat.shape[0], _consts(ops), stream_of(acc),
    )
    raise_on(rc, "mixed_add_signed_multi")
    LAUNCHES["mixed_add_signed_multi"] += 1
    return out


def jac_add_multi_scan(ops: CurveOps, acc, qs):
    """K2: acc [3, W, B] and g projective points qs [3g, W, B] -> the
    inclusive scan [3g, W, B], out[3k:3k+3] = acc + qs[0] + ... + qs[k]."""
    if acc.device.type == "cpu":
        return plain_jac_add_multi_scan(ops, acc, qs)
    W = ops.W
    B = acc.shape[-1]
    g = qs.shape[0] // 3
    check_tensor("acc", acc, (3, W, B))
    check_tensor("qs", qs, (3 * g, W, B))
    lib = _lib(ops)
    out = torch.empty_like(qs)
    rc = lib.ap_jac_add_multi_scan(
        acc.data_ptr(), qs.data_ptr(), out.data_ptr(), B, g, _consts(ops),
        stream_of(acc),
    )
    raise_on(rc, "jac_add_multi_scan")
    LAUNCHES["jac_add_multi_scan"] += 1
    return out


def jac_add(ops: CurveOps, p, q):
    """K3: complete projective add, p, q [3, W, B] -> [3, W, B]."""
    if p.device.type == "cpu":
        return plain_jac_add(ops, p, q)
    W = ops.W
    B = p.shape[-1]
    check_tensor("p", p, (3, W, B))
    check_tensor("q", q, (3, W, B))
    lib = _lib(ops)
    out = torch.empty_like(p)
    rc = lib.ap_jac_add(
        p.data_ptr(), q.data_ptr(), out.data_ptr(), B, _consts(ops), stream_of(p)
    )
    raise_on(rc, "jac_add")
    LAUNCHES["jac_add"] += 1
    return out


def canon(ops: CurveOps, x):
    """K4: [R, W, B] words (any W-word values) -> canonical residues."""
    if x.device.type == "cpu":
        return plain_canon(ops, x)
    W = ops.W
    R, B = x.shape[0], x.shape[-1]
    check_tensor("x", x, (R, W, B))
    lib = _lib(ops)
    out = torch.empty_like(x)
    rc = lib.ap_canon(x.data_ptr(), out.data_ptr(), R, B, _consts(ops), stream_of(x))
    raise_on(rc, "canon")
    LAUNCHES["canon"] += 1
    return out

"""Sharded MSM: the points split over a mesh, the bucket pipeline per
shard, and the shards' window sums combined on the mesh's first device.

Counterpart of the reference ``parallel/msm_sharded.py``.  The bucket
decomposition sum_d d B_d distributes over point shards, so each shard runs
the single-device pipeline (``ops/msm.py``'s ``window_sums_scan``: K1, K2,
K3's scan, add and phase 4) on its n/D points.  The reference folds each
shard's windows on the device and all-gathers D projective points; here
the D sets of window sums go to the first device, are added window by
window with K3 (``add_window_sums``, as the pieces of one MSM are), and are
folded once on the host (``MsmCtx._host_fold``), as the single-device MSM
folds.  Communication is D [nw, 3, W] sets, independent of n.
"""

from __future__ import annotations

import torch

from ..fields.params import CurveParams
from ..ops.field import field_ops
from ..ops.msm import (CHUNK, WINDOW_BITS, add_window_sums, digits_from_mont_limbs, msm_ctx,
                       pick_window_bits, window_sums_scan)
from ..ops.poly import pad_rows
from .mesh import Mesh, all_gather, on_device


def bucket_points(d: int, ndev: int) -> int:
    """Points a d-point commit is padded to on ndev shards (the reference
    prover's rule, ``plonk/prove.py:196-198``): a multiple of a step that
    grows with d and divides over the shards, so nearby commit sizes share
    one function."""
    step = max(256, 1 << max(8, d.bit_length() - 5))
    step = -(-step // ndev) * ndev
    return -(-d // step) * step


def _shard_window_sums(ctx, points, digits, c: int):
    """One shard: [nl, 2, W] points, [nw, nl] digits -> [nw, 3, W] window
    sums, in pieces of CHUNK points as ``MsmCtx.msm_to_affine_int`` runs
    them, each with the infinity row padded on (the reference's
    ``_local_msm``)."""
    ops = ctx.ops
    total = None
    for off in range(0, points.shape[0], CHUNK):
        pts = points[off : off + CHUNK]
        inf = torch.zeros((1, 2, ops.W), dtype=torch.int32, device=pts.device)
        ws = window_sums_scan(ops, torch.cat([pts, inf]),
                              digits[:, off : off + CHUNK].contiguous(), c)
        total = ws if total is None else add_window_sums(ops, total, ws)
    return total


def sharded_msm_fn(curve: CurveParams, mesh: Mesh, axis: str, n: int, nw: int,
                   c: int = WINDOW_BITS):
    """A sharded MSM of n points with [nw, n] window digits of c bits.

    ``fn(points, digits)`` takes the shards of the [n, 2, W] affine
    Montgomery points (``mesh.shard(points, 0)``) and of the [nw, n] signed
    digits (``mesh.shard(digits, 1)``) and returns the host affine int
    tuple of the sum, or None for the identity: the point to which the
    reference's replicated projective result is decoded at once
    (``plonk/prove.py:221``)."""
    ndev = mesh.shape[axis]
    if n % ndev:
        raise ValueError(f"{n} points do not split over {ndev} shards")
    nl = n // ndev
    ctxs = [msm_ctx(curve, dev) for dev in mesh.devices]
    first = mesh.devices[0]

    def fn(points, digits):
        if len(points) != ndev or len(digits) != ndev:
            raise ValueError(f"expected {ndev} shards of points and of digits")
        sums = []
        for ctx, pts, dig in zip(ctxs, points, digits):
            if tuple(pts.shape[:1]) != (nl,) or tuple(dig.shape) != (nw, nl):
                raise ValueError(f"shard shapes {tuple(pts.shape)}, {tuple(dig.shape)} for "
                                 f"{nl} points and {nw} windows")
            with on_device(pts.device):
                sums.append(_shard_window_sums(ctx, pts, dig, c))
        gathered = all_gather([s[None] for s in sums], first)   # [D, nw, 3, W]
        with on_device(first):
            total = gathered[0]
            for i in range(1, ndev):
                total = add_window_sums(ctxs[0].ops, total, gathered[i])
            return ctxs[0]._host_fold(total, c)

    return fn


def sharded_commit(curve: CurveParams, mesh: Mesh, axis: str, points, mont, cache=None):
    """The prover's sharded commit (the reference's ``_commit_sharded``,
    ``plonk/prove.py:184-221``): the MSM of [d, W] Montgomery scalars over
    [d, 2, W] points, both padded with zeros (the identity, digit 0) to
    ``bucket_points(d, D)``, whose window bits pick the digits.  ``cache``
    (a dict) keeps the function of each bucket.  Returns the host affine
    int tuple, or None."""
    d = points.shape[0]
    n_b = bucket_points(d, mesh.shape[axis])
    c = pick_window_bits(n_b)
    digits = digits_from_mont_limbs(field_ops(curve.fr, points.device), mont, c=c)
    digits = torch.nn.functional.pad(digits, (0, n_b - d))
    fn = None if cache is None else cache.get(n_b)
    if fn is None:
        fn = sharded_msm_fn(curve, mesh, axis, n_b, digits.shape[0], c)
        if cache is not None:
            cache[n_b] = fn
    return fn(mesh.shard(pad_rows(points, n_b), 0), mesh.shard(digits, 1))

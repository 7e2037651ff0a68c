"""Sharded NTT: the four-step decomposition over a mesh, with two
all-to-all exchanges.

Counterpart of the reference ``parallel/ntt_sharded.py``.  A transform of
size n = n1 n2 is a [n2, n1] matrix problem; shard i owns n2/D of its rows:

  1. coset pre-scale, and the NTT of size n1 along each local row (K9),
  2. the cross twiddles w^(j2 k1) (fused into that K9 launch's store),
  3. all-to-all: [n2, n1] sharded on rows -> [n1, n2] sharded on rows,
  4. the NTT of size n2 along each local row (K9),
  5. all-to-all back, and for the inverse coset the post-scale (fused into
     step 4's store).

Each local row transform is one launch of ``ntt_pass`` over the shard's
contiguous rows (C = n1 or n2).  K9's forward DIF leaves each row in
bit-reversed order and its inverse DIT reads that order, so each pass has
one row-local ``index_select``: after a forward pass, before an inverse one.
The entry and exit tables of a pass are laid out in the order the pass
reads and writes them.  K9 does not scale by 1/C; the inverse's 1/n is
folded into its cross table (the reference's local plans scale by 1/n1 and
1/n2).  Tables are built once per ``fn``, each shard's on its own device.
On CPU shards ``ntt_pass`` runs its plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields.params import CURVES, domain_generator
from ..ops.field import FieldOps, field_ops
from ..ops.ntt import _bit_reverse_perm, power_table
from ..ops.ntt_kernels import ntt_pass, stage_twiddles
from ..ops.poly import pad_rows
from .mesh import Mesh, all_gather, all_to_all, on_device
from .msm_sharded import sharded_commit


def four_step_factors(log_n: int) -> tuple[int, int]:
    """(n1, n2) of a size-2^log_n transform."""
    return 1 << (log_n // 2), 1 << (log_n - log_n // 2)


def power_grid(f: FieldOps, base: int, rows, ncols: int, scale: int = 1):
    """[len(rows), ncols, W]: scale * base^(a b) at [i, b] for a = rows[i],
    as masked multiplies by the host power vectors base^(2^t b), one per
    bit of the largest row (as ``FourStepPlan._cross_table`` builds its)."""
    r = f.modulus
    a = torch.as_tensor(list(rows), dtype=torch.int64, device=f.device)
    grid = f.encode([scale]).expand(len(a), ncols, f.W)
    t, b = 0, base
    while (1 << t) <= max(rows):
        pt = f.encode(power_table(b, ncols, r))
        grid = torch.where((((a >> t) & 1) != 0)[:, None, None], f.mul(grid, pt[None]), grid)
        t, b = t + 1, b * b % r
    return grid.contiguous()


def coset_grid(f: FieldOps, g: int, rows, ncols: int, row_step: int, col_step: int):
    """[len(rows), ncols, W]: g^(a row_step + b col_step) at [i, b], a =
    rows[i]: the outer product of two host power vectors."""
    r = f.modulus
    rv = f.encode([pow(g, a * row_step, r) for a in rows])
    cv = f.encode(power_table(pow(g, col_step, r), ncols, r))
    return f.mul(rv[:, None], cv[None, :]).contiguous()


def sharded_ntt_fn(curve_name: str, mesh: Mesh, axis: str, log_n: int,
                   inverse: bool = False, coset_shift: int | None = None):
    """A sharded (i)NTT of size 2^log_n over ``mesh``'s axis, and (n1, n2).

    ``fn(parts)`` takes the D shards of a [n2, n1, W] tensor of Montgomery
    words (``mesh.shard(x, 0)``) and returns the D shards of the result.
    The input holds the vector x as x[j1 n2 + j2] = in[j2, j1], the output
    X[k2 n1 + k1] = out[k2, k1] (so the flat output is in natural order).
    ``inverse`` interpolates (with the full 1/n); ``coset_shift`` g makes
    the forward evaluate on gH (coefficients pre-scaled by g^j) and the
    inverse interpolate from gH (outputs post-scaled by g^-k)."""
    curve = CURVES[curve_name]
    r = curve.fr.modulus
    n = 1 << log_n
    n1, n2 = four_step_factors(log_n)
    d = mesh.shape[axis]
    if n1 % d or n2 % d:
        raise ValueError(f"the four-step factors {n1} x {n2} do not split over {d} shards")
    rows1, rows2 = n2 // d, n1 // d      # local rows in the first and second pass
    w = domain_generator(curve_name, log_n)
    w_eff = pow(w, -1, r) if inverse else w
    g = None
    if coset_shift is not None:
        g = pow(coset_shift, -1, r) if inverse else coset_shift
    brev1 = torch.from_numpy(_bit_reverse_perm(n1))
    brev2 = torch.from_numpy(_bit_reverse_perm(n2))

    shards = []
    for i, dev in enumerate(mesh.devices):
        f = field_ops(curve.fr, dev)
        with on_device(dev):
            b1, b2 = brev1.to(dev), brev2.to(dev)
            # pass 1 rows j2, pass 2 rows k1 of this shard
            j2 = range(i * rows1, (i + 1) * rows1)
            k1 = range(i * rows2, (i + 1) * rows2)
            entry1 = exit2 = None
            if inverse:
                # cross W^-1[j2, k1] / n at the natural k1 the DIT writes
                exit1 = power_grid(f, w_eff, j2, n1, scale=pow(n, -1, r))
                if g is not None:   # g^-(k2 n1 + k1) at [k1, k2]
                    exit2 = coset_grid(f, g, k1, n2, row_step=1, col_step=n1)
            else:
                # cross W[j2, k1] at position brev(k1), where the DIF writes k1
                exit1 = power_grid(f, w_eff, j2, n1).index_select(1, b1)
                if g is not None:   # g^(j1 n2 + j2) at [j2, j1]
                    entry1 = coset_grid(f, g, j2, n1, row_step=1, col_step=n2)
            tw1 = f.encode(stage_twiddles(curve_name, n1, inverse))
            tw2 = f.encode(stage_twiddles(curve_name, n2, inverse))
            shards.append(dict(dev=dev, f=f, b1=b1, b2=b2, tw1=tw1, tw2=tw2,
                               entry1=entry1, exit1=exit1, exit2=exit2))

    def flat(t):
        return None if t is None else t.reshape(-1, t.shape[-1])

    def row_pass(s, x, C, tw, entry, exit_, perm):
        """K9 over the rows [rows, C, W] of shard s, in natural order on
        both sides."""
        W = x.shape[-1]
        if inverse:
            x = x.index_select(1, perm)
        y = ntt_pass(s["f"], x.reshape(-1, W), tw, C, inverse, flat(entry), flat(exit_))
        y = y.view(-1, C, W)
        return y if inverse else y.index_select(1, perm)

    def fn(parts):
        if len(parts) != d:
            raise ValueError(f"expected {d} shards, got {len(parts)}")
        ys = []
        for s, x in zip(shards, parts):
            with on_device(s["dev"]):
                y = row_pass(s, x.contiguous(), n1, s["tw1"], s["entry1"], s["exit1"], s["b1"])
            ys.append(y.reshape(rows1, d, rows2, y.shape[-1]))
        # [n2/D, D, n1/D] -> [D (source), n2/D, n1/D] -> rows k1, columns j2
        ys = all_to_all(ys, split_dim=1, concat_dim=0)
        zs = []
        for s, y in zip(shards, ys):
            with on_device(s["dev"]):
                y = y.permute(2, 0, 1, 3).reshape(rows2, n2, y.shape[-1])
                z = row_pass(s, y, n2, s["tw2"], None, s["exit2"], s["b2"])
            zs.append(z.reshape(rows2, d, rows1, z.shape[-1]))
        # and back: rows k2, columns k1
        zs = all_to_all(zs, split_dim=1, concat_dim=0)
        return [z.permute(2, 0, 1, 3).reshape(rows1, n1, z.shape[-1]) for z in zs]

    return fn, (n1, n2)


class Sharding:
    """A Prover's commits and transforms over ``mesh``'s axis, results on
    ``device`` (the key's).  ``ntt_hits`` counts the transforms sharded."""

    def __init__(self, curve, mesh: Mesh, axis: str, device):
        self.curve, self.mesh, self.axis, self.device = curve, mesh, axis, device
        self._msm_fns, self._ntt_fns, self.ntt_hits = {}, {}, 0

    def commit(self, points, mont) -> tuple:
        """``sharded_commit`` with this mesh's functions kept."""
        return sharded_commit(self.curve, self.mesh, self.axis, points, mont, self._msm_fns)

    def transform(self, vec, log_sz: int, inverse: bool, coset_shift: int | None = None):
        """The (i)NTT of size 2^log_sz of ``vec`` [m, W] (coefficients, or
        for the inverse natural-order evaluations), zero-padded to the size,
        in natural order on ``device``; None where the four-step factors
        do not divide over the shards."""
        n1, n2 = four_step_factors(log_sz)
        d = self.mesh.shape[self.axis]
        if n1 % d or n2 % d:
            return None
        key = (log_sz, inverse, coset_shift)
        if key not in self._ntt_fns:
            self._ntt_fns[key] = sharded_ntt_fn(self.curve.name, self.mesh, self.axis, log_sz,
                                                inverse, coset_shift)[0]
        W = vec.shape[-1]
        x = pad_rows(vec, n1 * n2).reshape(n1, n2, W).transpose(0, 1)   # [j2, j1]
        out = all_gather(self._ntt_fns[key](self.mesh.shard(x, 0)), self.device)
        self.ntt_hits += 1
        return out.reshape(n1 * n2, W)


def reference_layout(coeffs_ints, n1: int, n2: int):
    """Host helper: x[j] -> the [j2, j1] matrix that sharded_ntt_fn takes."""
    arr = np.asarray(coeffs_ints, dtype=object).reshape(n1, n2)  # [j1, j2]
    return arr.T  # [j2, j1]


def output_to_natural(out_mat):
    """[k2, k1, W] output -> flat evaluations X[k2 n1 + k1]: already row-major."""
    return out_mat.reshape(-1, out_mat.shape[-1])

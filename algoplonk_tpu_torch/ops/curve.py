"""Batched G1 arithmetic in PyTorch over ``FieldOps`` (homogeneous
projective).

Counterpart of the reference ``ops/curve.py``: the Renes-Costello-Batina
(2015) complete formulas for a = 0 short Weierstrass curves, one branch-free
sequence for generic adds, doublings, inverses and the point at infinity.

Representation: projective ``[..., 3, W]`` int32 words (X, Y, Z, Montgomery);
Z == 0 marks infinity, canonically (0 : 1 : 0).  Affine points are
``[..., 2, W]``; (0, 0) marks affine infinity.  The method names keep the
reference's jac_* prefix so call sites read the same.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields.params import CurveParams
from ..fields.words import ints_to_mont_words, mont_words_to_ints, word_field
from ._build import settle
from .field import FieldOps, field_ops


class CurveOps:
    """G1 arithmetic of one curve on one device, over its base field's
    ``FieldOps``: on a CUDA device its multiplies and adds are field kernel
    launches; ``plain=True`` gives the twin over the plain field ops, which
    the curve kernels' plain versions use."""

    def __init__(self, curve: CurveParams, device, plain: bool = False):
        self.curve = curve
        self.device = torch.device(device)
        self.plain = plain
        self.f: FieldOps = field_ops(curve.fp, device, plain)
        self.wf = word_field(curve.fp)
        self.W = self.wf.W
        self.b3_mont = self._enc([3 * curve.b % curve.fp.modulus])[0]
        self.g1_gen_affine = self._enc(list(curve.g1))      # [2, W]

    def _enc(self, ints) -> torch.Tensor:
        return torch.from_numpy(ints_to_mont_words(ints, self.wf)).to(self.device)

    def as_plain(self) -> "CurveOps":
        """This curve's twin with the kernels off (itself if it is one)."""
        return self if self.plain else curve_ops(self.curve, self.device, plain=True)

    # ------------------------------------------------------------ converts

    def affine_to_jac(self, pts):
        """[..., 2, W] affine -> [..., 3, W] projective ((0,0) -> (0,1,0))."""
        f = self.f
        x, y = pts[..., 0, :], pts[..., 1, :]
        is_inf = f.is_zero(x) & f.is_zero(y)
        one = torch.broadcast_to(f.one, x.shape)
        z = f.select(is_inf, torch.zeros_like(x), one)
        y = f.select(is_inf, one, y)
        return torch.stack([x, y, z], dim=-2)

    def jac_infinity(self, shape=()):
        """The identity (0 : 1 : 0), broadcast over leading ``shape``."""
        x = torch.zeros(tuple(shape) + (self.W,), dtype=torch.int32, device=self.device)
        y = torch.broadcast_to(self.f.one, x.shape)
        return torch.stack([x, y, x], dim=-2)

    # ----------------------------------------------------------------- ops

    def jac_double(self, p):
        """Complete projective doubling, a = 0 (EFD dbl-2015-rcb: 6M+2S)."""
        f = self.f
        X, Y, Z = p[..., 0, :], p[..., 1, :], p[..., 2, :]
        b3 = self.b3_mont
        t0 = f.square(Y)
        z3 = f.add(t0, t0)
        z3 = f.add(z3, z3)
        z3 = f.add(z3, z3)
        t1 = f.mul(Y, Z)
        t2 = f.square(Z)
        t2 = f.mul(b3, t2)
        x3 = f.mul(t2, z3)
        y3 = f.add(t0, t2)
        z3 = f.mul(t1, z3)
        t1 = f.add(t2, t2)
        t2 = f.add(t1, t2)
        t0 = f.sub(t0, t2)
        y3 = f.mul(t0, y3)
        y3 = f.add(x3, y3)
        t1 = f.mul(X, Y)
        x3 = f.mul(t0, t1)
        x3 = f.add(x3, x3)
        return torch.stack([x3, y3, z3], dim=-2)

    def jac_add(self, p, q):
        """Complete projective + projective addition, a = 0
        (EFD add-2015-rcb: 12M, branch-free)."""
        f = self.f
        X1, Y1, Z1 = p[..., 0, :], p[..., 1, :], p[..., 2, :]
        X2, Y2, Z2 = q[..., 0, :], q[..., 1, :], q[..., 2, :]
        b3 = self.b3_mont
        t0 = f.mul(X1, X2)
        t1 = f.mul(Y1, Y2)
        t2 = f.mul(Z1, Z2)
        t3 = f.mul(f.add(X1, Y1), f.add(X2, Y2))
        t3 = f.sub(t3, f.add(t0, t1))            # X1Y2 + X2Y1
        t4 = f.mul(f.add(Y1, Z1), f.add(Y2, Z2))
        t4 = f.sub(t4, f.add(t1, t2))            # Y1Z2 + Y2Z1
        t5 = f.mul(f.add(X1, Z1), f.add(X2, Z2))
        t5 = f.sub(t5, f.add(t0, t2))            # X1Z2 + X2Z1
        t0 = f.add(f.add(t0, t0), t0)            # 3 X1X2
        t2 = f.mul(b3, t2)                       # b3 Z1Z2
        z3 = f.add(t1, t2)                       # Y1Y2 + b3 Z1Z2
        t1 = f.sub(t1, t2)                       # Y1Y2 - b3 Z1Z2
        y3 = f.mul(b3, t5)                       # b3 (X1Z2 + X2Z1)
        x3 = f.sub(f.mul(t3, t1), f.mul(t4, y3))
        y3 = f.add(f.mul(t1, z3), f.mul(y3, t0))
        z3 = f.add(f.mul(z3, t4), f.mul(t0, t3))
        return torch.stack([x3, y3, z3], dim=-2)

    def jac_add_affine(self, p, q_affine):
        """Projective + affine mixed addition (affine (0,0) = infinity): the
        RCB mixed formula (11M) plus one select for affine-infinity lanes."""
        f = self.f
        X1, Y1, Z1 = p[..., 0, :], p[..., 1, :], p[..., 2, :]
        X2, Y2 = q_affine[..., 0, :], q_affine[..., 1, :]
        b3 = self.b3_mont
        t0 = f.mul(X1, X2)
        t1 = f.mul(Y1, Y2)
        t3 = f.mul(f.add(X1, Y1), f.add(X2, Y2))
        t3 = f.sub(t3, f.add(t0, t1))            # X1Y2 + X2Y1
        t4 = f.add(f.mul(Y2, Z1), Y1)            # Y1 + Y2Z1
        t5 = f.add(f.mul(X2, Z1), X1)            # X1 + X2Z1
        t0 = f.add(f.add(t0, t0), t0)            # 3 X1X2
        t2 = f.mul(b3, Z1)                       # b3 Z1
        z3 = f.add(t1, t2)
        t1 = f.sub(t1, t2)
        y3 = f.mul(b3, t5)
        x3 = f.sub(f.mul(t3, t1), f.mul(t4, y3))
        y3 = f.add(f.mul(t1, z3), f.mul(y3, t0))
        z3 = f.add(f.mul(z3, t4), f.mul(t0, t3))
        out = torch.stack([x3, y3, z3], dim=-2)
        q_inf = f.is_zero(X2) & f.is_zero(Y2)
        return torch.where(q_inf[..., None, None], p, out)

    def to_affine(self, p):
        """Projective -> affine; infinity maps to (0, 0)."""
        f = self.f
        X, Y, Z = p[..., 0, :], p[..., 1, :], p[..., 2, :]
        is_inf = f.is_zero(Z)
        zi = f.inv(f.select(is_inf, torch.broadcast_to(f.one, Z.shape), Z))
        x = f.select(is_inf, torch.zeros_like(X), f.mul(X, zi))
        y = f.select(is_inf, torch.zeros_like(Y), f.mul(Y, zi))
        return torch.stack([x, y], dim=-2)

    def scalar_mul(self, pts_affine, scalar_bits):
        """Batched variable-base scalar mul, MSB-first double-and-add.

        pts_affine: [..., 2, W]; scalar_bits: [..., nbits] (MSB first).
        Returns projective [..., 3, W]."""
        acc = self.jac_infinity(pts_affine.shape[:-2])
        set_bit = (scalar_bits == 1)[..., None, None]
        for i in range(scalar_bits.shape[-1]):
            acc = self.jac_double(acc)
            acc = torch.where(set_bit[..., i, :, :], self.jac_add_affine(acc, pts_affine), acc)
        return acc

    # -------------------------------------------------------- host helpers

    def encode_affine(self, points) -> torch.Tensor:
        """List of affine int tuples (or None) -> [N, 2, W] Montgomery."""
        flat = []
        for P in points:
            flat.extend((0, 0) if P is None else (P[0], P[1]))
        return self._enc(flat).reshape(len(points), 2, self.W)

    def decode_affine(self, arr) -> list:
        """[N, 2, W] affine Montgomery words -> int tuples / None."""
        a = np.asarray(arr.cpu() if torch.is_tensor(arr) else arr)
        coords = mont_words_to_ints(a.reshape(-1, self.W), self.wf)
        out = []
        for i in range(0, len(coords), 2):
            x, y = coords[i], coords[i + 1]
            out.append(None if (x == 0 and y == 0) else (x, y))
        return out

    def scalar_bits_array(self, scalars, nbits=None) -> torch.Tensor:
        """Python ints -> [N, nbits] int32 MSB-first bits on the device."""
        r = self.curve.fr.modulus
        nbits = nbits or r.bit_length()
        nbytes = (nbits + 7) // 8
        buf = b"".join((int(s) % r).to_bytes(nbytes, "big") for s in scalars)
        by = np.frombuffer(buf, np.uint8).reshape(len(scalars), nbytes)
        bits = np.unpackbits(by, axis=1)[:, 8 * nbytes - nbits :]
        return torch.from_numpy(bits.astype(np.int32)).to(self.device)


@functools.lru_cache(maxsize=None)
def _curve_ops(curve: CurveParams, device: str, plain: bool) -> CurveOps:
    ops = CurveOps(curve, device, plain)
    settle(device)
    return ops


def curve_ops(curve: CurveParams, device="cuda", plain: bool = False) -> CurveOps:
    return _curve_ops(curve, str(torch.device(device)), plain)

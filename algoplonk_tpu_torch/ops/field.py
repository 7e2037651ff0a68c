"""Batched modular field arithmetic: CUDA kernels on the card, plain PyTorch
elsewhere.

Counterpart of the reference ``ops/field.py``.  There these ops are XLA,
which fuses them on the TPU; here each torch op would be a launch of its own
(about 380 for one plain multiply), so on a CUDA device ``FieldOps`` sends
``mul`` to K8 ``field_mul`` and ``add``, ``sub`` and ``neg`` to
``field_add_sub`` (``ops/field_kernels.py``, ``csrc/field_kernels.cu``), one
launch each, with no fallback.  The module-level ``plain_mul``,
``plain_add``, ``plain_sub`` and ``plain_neg`` are their plain versions, on
every device: a CPU ``FieldOps`` runs them, and so does the twin that
``field_ops(fp, device, plain=True)`` gives, which every kernel's plain
version computes with, so that no plain reference launches a kernel.

Elements are ``[..., W]`` int32 words of canonical Montgomery residues
(``fields/words.py``).  Inside each plain op a word splits into two 16-bit digits
held in int64, so every column sum of a digit product is exact: the product
of two digits is below 2^32 and a column adds at most 2W of them.  The
structure follows the reference: column products from one broadcast outer
product, carry *relaxation* passes (each moves every digit's excess one digit
up), one Kogge-Stone carry or borrow lookahead for the exact form, and a
coarse Montgomery REDC.  Because the Montgomery radix is the port's
R = 2^(32 W), outputs are word-for-word comparable with the kernels.

Operands are broadcast against each other, so a single element ``[W]``
combines with a batch ``[N, W]``; the kernels take the same operands.
"""

from __future__ import annotations

import functools

import torch

from ..fields.params import FieldParams
from ..fields.words import WordField, ints_to_words, word_field, words_to_ints
from ._build import settle

_DB = 16                    # digit bits
_DM = (1 << _DB) - 1


def _to_digits(x: torch.Tensor) -> torch.Tensor:
    """int32 words [..., W] -> int64 16-bit digits [..., 2W]."""
    u = x.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([u & _DM, u >> _DB], dim=-1).flatten(-2)


def _from_digits(d: torch.Tensor) -> torch.Tensor:
    """Exact digits [..., 2W] (each < 2^16) -> int32 words [..., W]."""
    d = d.unflatten(-1, (d.shape[-1] // 2, 2))
    u = d[..., 0] | (d[..., 1] << _DB)
    return (u - ((u >> 31) << 32)).to(torch.int32)


def _shift_up(x: torch.Tensor, s: int) -> torch.Tensor:
    """Move digit k to digit k+s; the top s digits fall off."""
    z = torch.zeros(x.shape[:-1] + (s,), dtype=x.dtype, device=x.device)
    return torch.cat([z, x[..., :-s]], dim=-1)


_OUTER_MAX_ROWS = 256  # above this, the shift-and-add form is faster


def _cols(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Column sums of the digit product: out[k] = sum_{i+j=k} a_i b_j for
    k < 2K.  Small batches take one outer product (few launches): row i of
    it, padded to 2K+1 and laid flat, starts at 2K i + i, so cut into rows of
    2K it lands at columns i..i+K-1 of row i, and summing the rows gives the
    columns.  Large batches take K shift-and-add rounds, whose traffic is
    ~5x smaller than the padded outer product's."""
    K = a.shape[-1]
    a, b = torch.broadcast_tensors(a, b)
    if a.numel() > _OUTER_MAX_ROWS * K:
        out = torch.zeros(a.shape[:-1] + (2 * K,), dtype=a.dtype, device=a.device)
        for i in range(K):
            out[..., i : i + K] += a[..., i : i + 1] * b
        return out
    o = a.unsqueeze(-1) * b.unsqueeze(-2)                    # [..., K, K]
    o = torch.cat(
        [o, torch.zeros(o.shape[:-1] + (K + 1,), dtype=o.dtype, device=o.device)],
        dim=-1,
    )                                                        # [..., K, 2K+1]
    o = o.flatten(-2)[..., : 2 * K * K].unflatten(-1, (K, 2 * K))
    return o.sum(dim=-2)


def _relax(x: torch.Tensor, passes: int) -> torch.Tensor:
    """Carry relaxation.  From column sums below 2^38, three passes bound
    every digit by 2^16 (inclusive).  The carry out of the top digit is
    dropped: callers either want the value mod 2^(16 K) or know it fits."""
    for _ in range(passes):
        x = (x & _DM) + _shift_up(x >> _DB, 1)
    return x


def _ks_chain(g: torch.Tensor, pr: torch.Tensor) -> torch.Tensor:
    """Kogge-Stone lookahead: c_k = g_k | (pr_k & c_{k-1}) in log2(K)
    rounds.  g, pr: bool [..., K]."""
    c = g
    s = 1
    while s < g.shape[-1]:
        c = c | (pr & _shift_up(c, s))
        pr = pr & _shift_up(pr, s)
        s *= 2
    return c


def _ks_carry(x: torch.Tensor) -> torch.Tensor:
    """Digits bounded by 2^17 - 2 -> exact digits (top carry dropped)."""
    low = x & _DM
    c = _ks_chain((x >> _DB) != 0, low == _DM)
    return (low + _shift_up(c.to(x.dtype), 1)) & _DM


def _sub_borrow(a: torch.Tensor, b: torch.Tensor):
    """Exact digits a - b -> (digits of a - b mod 2^(16 K), borrow bool)."""
    d = a - b
    c = _ks_chain(d < 0, d == 0)
    return (d - _shift_up(c.to(d.dtype), 1)) & _DM, c[..., -1]


def plain_add(f: "FieldOps", a, b):
    """a + b mod p, canonical (the plain version of ``field_add_sub``'s add).
    Canonical sums stay below 2p < R, so the dropped carry is zero."""
    return _from_digits(f._cond_sub_p(_ks_carry(_to_digits(a) + _to_digits(b))))


def plain_sub(f: "FieldOps", a, b):
    """a - b mod p, canonical (the plain version of ``field_add_sub``'s sub)."""
    diff, borrow = _sub_borrow(*torch.broadcast_tensors(_to_digits(a), _to_digits(b)))
    plus_p = _ks_carry(diff + f._p)
    return _from_digits(torch.where(borrow.unsqueeze(-1), plus_p, diff))


def plain_neg(f: "FieldOps", a):
    """-a mod p (the plain version of ``field_add_sub``'s neg)."""
    return plain_sub(f, torch.zeros_like(a), a)


def plain_mul(f: "FieldOps", a, b):
    """Montgomery product a b R^-1 mod p, canonical (the plain version of K8
    ``field_mul``; coarse REDC, as the reference).

    T = a b as 2K column sums; m = (T mod R)(-p^-1) mod R with relaxed
    digits, so its value may exceed R by a hair; s = T + m p is then a
    multiple of R below R * 1.5p, its relaxed low half is worth exactly
    0 or R, and its high half plus that carry is s / R < 2p.  With one
    operand anywhere below R and the other below p, s / R < 2p still holds
    unless m takes its hair (m mod R < R / 2^16) while T > R p (1 - 2^-16)."""
    K = 2 * f.W
    ad, bd = torch.broadcast_tensors(_to_digits(a), _to_digits(b))
    cols = _cols(ad, bd)
    t_low = _relax(cols[..., :K], 3)
    m = _relax(_cols(t_low, f._np.expand_as(t_low))[..., :K], 3)
    s = _relax(_cols(m, f._p.expand_as(m)) + cols, 3)
    c_out = (s[..., :K] != 0).any(dim=-1).to(s.dtype)
    hi = s[..., K:].clone()
    hi[..., 0] += c_out
    return _from_digits(f._cond_sub_p(_ks_carry(hi)))


class FieldOps:
    """Batched arithmetic in one prime field, on one device.

    On a CUDA device ``mul``, ``add``, ``sub`` and ``neg`` (and everything
    built on them) launch K8 ``field_mul`` and ``field_add_sub``
    (``ops/field_kernels.py``), or raise; elsewhere, and on the twin made
    with ``plain=True``, they run ``plain_mul``, ``plain_add``,
    ``plain_sub`` and ``plain_neg``.  The choice is made once, here."""

    def __init__(self, fp: FieldParams, device, plain: bool = False):
        self.fp = fp
        self.wf: WordField = word_field(fp)
        self.W = self.wf.W
        self.device = torch.device(device)
        self.modulus = fp.modulus
        self.plain = plain

        def digits(v: int) -> torch.Tensor:
            return _to_digits(self._words([v]))[0]

        self._p = digits(fp.modulus)
        self._np = digits(self.wf.n_prime)
        self.one = self._words([self.wf.r])[0]          # 1 in Montgomery form
        self.zero = torch.zeros(self.W, dtype=torch.int32, device=self.device)
        self._r2 = self._words([self.wf.r2])[0]
        self._unit = self._words([1])[0]                # the integer 1 (R^-1)
        if plain or self.device.type != "cuda":
            self._mul, self._add, self._sub, self._neg = plain_mul, plain_add, plain_sub, plain_neg
        else:
            from . import field_kernels as fk   # imports this module: not at the top

            self._mul, self._add, self._sub, self._neg = (
                fk.field_mul, fk.field_add, fk.field_sub, fk.field_neg)

    def _words(self, ints) -> torch.Tensor:
        return torch.from_numpy(ints_to_words(ints, self.W)).to(self.device)

    def as_plain(self) -> "FieldOps":
        """This field's twin with the kernels off (itself if it is one)."""
        return self if self.plain else field_ops(self.fp, self.device, plain=True)

    # ------------------------------------------------------------ helpers

    def _cond_sub_p(self, d):
        diff, borrow = _sub_borrow(d, self._p)
        return torch.where(borrow.unsqueeze(-1), d, diff)

    # ---------------------------------------------------------------- ops

    def add(self, a, b):
        return self._add(self, a, b)

    def sub(self, a, b):
        return self._sub(self, a, b)

    def neg(self, a):
        return self._neg(self, a)

    def mul(self, a, b):
        """Montgomery product a b R^-1 mod p."""
        return self._mul(self, a, b)

    def square(self, a):
        return self.mul(a, a)

    def pow(self, a, exponent: int):
        """a^exponent for a Python int exponent (MSB-first square and
        multiply; the exponent is public, so the branches are Python)."""
        acc = torch.broadcast_to(self.one, a.shape).clone()
        for bit in bin(exponent)[2:]:
            acc = self.square(acc)
            if bit == "1":
                acc = self.mul(acc, a)
        return acc

    def inv(self, a):
        """Fermat inverse a^(p-2); inv(0) = 0."""
        return self.pow(a, self.modulus - 2)

    def is_zero(self, a):
        return (a == 0).all(dim=-1)

    def select(self, cond, a, b):
        """cond: bool [...]; a, b: [..., W]."""
        return torch.where(cond.unsqueeze(-1), a, b)

    def to_mont(self, a_canonical):
        return self.mul(a_canonical, self._r2)

    def from_mont(self, a):
        return self.mul(a, self._unit)

    def bits_from_mont(self, a, nbits: int):
        """Montgomery [..., W] -> [..., nbits] int32 MSB-first 0/1 bits of
        the canonical values, on the device (the reference's
        ``bits_from_mont``): shifts of the 32-bit words, least significant
        word first."""
        canon = self.from_mont(a)
        shifts = torch.arange(32, dtype=torch.int32, device=canon.device)
        bits = (canon[..., :, None] >> shifts) & 1
        bits = bits.reshape(canon.shape[:-1] + (32 * self.W,))
        return bits[..., :nbits].flip(-1)

    # ------------------------------------------------------- host helpers

    def encode(self, values) -> torch.Tensor:
        """Python ints -> Montgomery words [N, W] on the device.

        The host reduces mod p and packs little-endian bytes; the device
        applies one Montgomery multiply by R^2.  Unlike the reference's
        ``encode_bytes`` (ops/field.py:328) any int is accepted, negative
        ones included."""
        p = self.modulus
        words = self._words([int(v) % p for v in values])
        return self.to_mont(words)

    encode_bytes = encode  # the reference's name for the byte-packing path

    def decode(self, arr) -> list[int]:
        """Montgomery words -> canonical Python ints."""
        canon = self.from_mont(arr)
        return words_to_ints(canon.cpu().numpy())


@functools.lru_cache(maxsize=None)
def _field_ops(fp: FieldParams, device: str, plain: bool) -> FieldOps:
    ops = FieldOps(fp, device, plain)
    settle(device)
    return ops


def field_ops(fp: FieldParams, device="cuda", plain: bool = False) -> FieldOps:
    """The cached ``FieldOps`` of ``fp`` on ``device``; ``plain=True`` gives
    its twin with the kernels off, which the kernels' plain versions use."""
    return _field_ops(fp, str(torch.device(device)), plain)

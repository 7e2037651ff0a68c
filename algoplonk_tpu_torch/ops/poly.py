"""Polynomial scans in PyTorch: prefix products, batch inversion, powers,
Horner evaluation and the KZG division (p(X) - p(z)) / (X - z).

Counterpart of the reference ``ops/poly.py`` (:31-283).  The sequential
recurrences keep the reference's two-level blocked form: a loop of b steps,
each a field op over all n/b blocks at once, then a thin carry chain of n/b
steps; about 2 sqrt(n) sequential ops instead of n.
"""

from __future__ import annotations

import torch

from .field import FieldOps


def _block_size(n: int) -> int:
    """Largest power-of-two divisor of n, capped near sqrt(n)."""
    pow2 = n & -n
    cap = 1 << (max(n.bit_length() - 1, 2) // 2)
    return max(1, min(pow2, cap, n))


def _pow2_at_least(n: int) -> int:
    return 1 << (n - 1).bit_length() if n > 1 else 1


def pad_rows(x, n: int):
    """x [m, ...] cut or zero-padded to n rows."""
    if x.shape[0] >= n:
        return x[:n]
    z = torch.zeros((n - x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    return torch.cat([x, z])


def prefix_products(f: FieldOps, v):
    """Inclusive prefix products: out[i] = v[0] * ... * v[i].  [n, W]"""
    n, W = v.shape
    b = _block_size(n)
    nb = n // b
    vb = v.reshape(nb, b, W)
    run = torch.broadcast_to(f.one, (nb, W))
    parts = []
    for t in range(b):                          # in-block, batched over nb
        run = f.mul(run, vb[:, t])
        parts.append(run)
    part = torch.stack(parts, dim=1)            # [nb, b, W]
    carries = []
    c = f.one
    for j in range(nb):                         # thin scan over block totals
        carries.append(c)
        c = f.mul(c, part[j, b - 1])
    out = f.mul(part, torch.stack(carries)[:, None, :])
    return out.reshape(n, W)


def batch_inverse_tree(f: FieldOps, v, stop: int = 256):
    """Elementwise inverse through a product tree (Montgomery trick,
    2 log2(n/stop) wide levels and one Fermat inversion at width <= stop).
    inv(0) lanes return 0."""
    n, W = v.shape
    n_pad = _pow2_at_least(n)
    is_zero = f.is_zero(v)
    x = f.select(is_zero, torch.broadcast_to(f.one, v.shape), v)
    if n_pad != n:
        x = torch.cat([x, torch.broadcast_to(f.one, (n_pad - n, W))])
    levels = []
    while x.shape[0] > stop:
        levels.append(x)
        x = f.mul(x[0::2], x[1::2])
    inv = f.inv(x)
    for lev in reversed(levels):
        il = f.mul(inv, lev[1::2])
        ir = f.mul(inv, lev[0::2])
        inv = torch.stack([il, ir], dim=1).reshape(lev.shape[0], W)
    return f.select(is_zero, torch.zeros_like(v), inv[:n])


def powers(f: FieldOps, x, n: int):
    """[n, W] table 1, x, ..., x^(n-1) for a single element x [W]."""
    n_pad = _pow2_at_least(n)
    v = torch.broadcast_to(x, (n_pad, f.W)).clone()
    v[0] = f.one
    return prefix_products(f, v)[:n]


def horner_scan(f: FieldOps, coeffs_desc, z):
    """All Horner intermediates y_k = y_{k-1} z + c_k over coefficients in
    DESCENDING degree order: [n, W] (y_0 .. y_{n-1}); y_{n-1} = p(z)."""
    n, W = coeffs_desc.shape
    b = _block_size(n)
    nb = n // b
    cb = coeffs_desc.reshape(nb, b, W)
    run = torch.zeros((nb, W), dtype=torch.int32, device=coeffs_desc.device)
    parts = []
    for t in range(b):
        run = f.add(f.mul(run, z), cb[:, t])
        parts.append(run)
    part = torch.stack(parts, dim=1)            # [nb, b, W]
    ends = part[:, b - 1]
    # carry_j = true y entering block j: carry_{j+1} = carry_j z^b + end_j
    zb = f.pow(z, b)
    carries = []
    c = torch.zeros_like(z)
    for j in range(nb):
        carries.append(c)
        c = f.add(f.mul(c, zb), ends[j])
    # y[j, t] = part[j, t] + carry_j z^(t+1)
    zp = powers(f, z, b + 1)[1:]                # z^1 .. z^b
    out = f.add(part, f.mul(torch.stack(carries)[:, None, :], zp[None]))
    return out.reshape(n, W)


_EVAL_BLOCK = 1 << 16


def poly_eval_many(f: FieldOps, coeffs_seq, z):
    """Evaluate several ascending-coefficient polynomials at one point z
    [W]: one powers scan, one batched multiply and a log-depth add tree.
    Returns [k, W].  Above 2^16 coefficients the multiply runs over blocks
    of 2^16 (bounded transient), with the same exact field sums."""
    n_pad = _pow2_at_least(max(c.shape[0] for c in coeffs_seq))
    stack = torch.stack([pad_rows(c, n_pad) for c in coeffs_seq])  # [k, n_pad, W]
    k = stack.shape[0]

    def reduce_block(x):
        while x.shape[1] > 1:
            h = x.shape[1] // 2
            x = f.add(x[:, :h], x[:, h:])
        return x[:, 0]

    if n_pad <= _EVAL_BLOCK:
        return reduce_block(f.mul(stack, powers(f, z, n_pad)[None]))
    B = _EVAL_BLOCK
    nb = n_pad // B
    pows_b1 = powers(f, z, B + 1)               # z^0 .. z^B
    pows_b = pows_b1[:B]
    zb_pows = powers(f, pows_b1[B], nb)         # [nb, W]
    acc = torch.zeros((k, f.W), dtype=torch.int32, device=stack.device)
    for j in range(nb):
        val = reduce_block(f.mul(stack[:, j * B : (j + 1) * B], pows_b[None]))
        acc = f.add(acc, f.mul(val, zb_pows[j]))
    return acc


def kzg_quotient(f: FieldOps, coeffs, z):
    """(p(X) - p(z)) / (X - z) for ascending coefficients [n, W].

    Returns (q_coeffs [n_padded, W] with top coefficients zero, p(z) [W]).
    The input is zero-padded to a power of two so the blocked scan keeps its
    sqrt(n) structure for any length."""
    n, W = coeffs.shape
    coeffs = pad_rows(coeffs, _pow2_at_least(n))
    ys = horner_scan(f, coeffs.flip(0), z)
    q = ys[:-1].flip(0)                         # y_{n-2} .. y_0 -> q_0 .. q_{n-2}
    q = torch.cat([q, torch.zeros((1, W), dtype=q.dtype, device=q.device)])
    return q, ys[-1]

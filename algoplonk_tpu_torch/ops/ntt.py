"""Radix-2 NTT / iNTT over the scalar field, with coset support, in PyTorch.

Counterpart of the reference ``ops/ntt.py`` (NttPlan :43-155): the domain is
an ``[n, W]`` word tensor and each butterfly stage is one batched field
multiply plus an add and a sub over n/2 elements, which on the card are
three field kernel launches (``FieldOps``, ops/field_kernels.py).  In the
reference these stages are XLA too (the fused Pallas stage kernel serves only
the limbs-major quotient, ops/ntt_kernels.py here).

Twiddles derive from ``domain_generator``, which depends on the gnark-compat
mode, so plans are cached per mode as well as per curve, size and device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields.params import CURVES, CurveParams, domain_generator, gnark_compat_enabled
from ._build import settle
from .field import field_ops


def _bit_reverse_perm(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def power_table(base: int, count: int, modulus: int) -> list[int]:
    out = [1] * count
    for i in range(1, count):
        out[i] = out[i - 1] * base % modulus
    return out


class NttPlan:
    """Precomputed twiddles and permutation for one (curve, n, device)."""

    def __init__(self, curve: CurveParams, log_n: int, device):
        self.curve = curve
        self.log_n = log_n
        self.n = 1 << log_n
        self.f = field_ops(curve.fr, device)
        r = curve.fr.modulus
        self.omega = domain_generator(curve.name, log_n)
        self.omega_inv = pow(self.omega, -1, r)
        self.n_inv = pow(self.n, -1, r)
        half = max(self.n // 2, 1)
        self.tw_fwd = self.f.encode(power_table(self.omega, half, r))
        self.tw_inv = self.f.encode(power_table(self.omega_inv, half, r))
        self.n_inv_mont = self.f.encode([self.n_inv])[0]
        self.bitrev = torch.from_numpy(_bit_reverse_perm(self.n)).to(self.f.device)
        self._shift_tables: dict = {}

    def _transform(self, a, inverse: bool):
        f = self.f
        n, W = self.n, f.W
        tw = self.tw_inv if inverse else self.tw_fwd
        a = a[self.bitrev]
        for s in range(self.log_n):
            half = 1 << s
            w = tw[:: n // (2 * half)][:half]               # [half, W]
            a = a.reshape(n // (2 * half), 2, half, W)
            u = a[:, 0]
            v = f.mul(a[:, 1], w)
            a = torch.stack([f.add(u, v), f.sub(u, v)], dim=1).reshape(n, W)
        if inverse:
            a = f.mul(a, self.n_inv_mont)
        return a

    def ntt(self, coeffs):
        """Coefficients -> evaluations p(omega^i), natural order. [n, W]"""
        return self._transform(coeffs, False)

    def intt(self, evals):
        """Evaluations -> coefficients. [n, W]"""
        return self._transform(evals, True)

    # --------------------------------------------------------------- coset

    def _shift_powers(self, shift: int, inverse: bool):
        key = (shift, inverse)
        tbl = self._shift_tables.get(key)
        if tbl is None:
            r = self.curve.fr.modulus
            s = pow(shift, -1, r) if inverse else shift
            tbl = self.f.encode(power_table(s, self.n, r))
            settle(self.f.device)
            self._shift_tables[key] = tbl
        return tbl

    def coset_ntt(self, coeffs, shift: int):
        """Evaluate on the coset shift * H (shift a Python int)."""
        return self.ntt(self.f.mul(coeffs, self._shift_powers(shift, False)))

    def coset_intt(self, evals, shift: int):
        return self.f.mul(self.intt(evals), self._shift_powers(shift, True))


@functools.lru_cache(maxsize=None)
def _ntt_plan(curve_name: str, log_n: int, device: str, compat: bool) -> NttPlan:
    plan = NttPlan(CURVES[curve_name], log_n, device)
    settle(device)
    return plan


def ntt_plan(curve_name: str, log_n: int, device="cuda") -> NttPlan:
    return _ntt_plan(curve_name, log_n, str(torch.device(device)), gnark_compat_enabled())

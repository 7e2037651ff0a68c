"""NTT over G1 points — the ToLagrangeG1 equivalent, in PyTorch.

Counterpart of the reference ``ops/gntt.py``.  The reference converts the
monomial SRS to Lagrange basis with a G1 inverse FFT (kzg.ToLagrangeG1,
reference setup/setup.go:124-142).  The prover commits in the monomial
basis, so this is off the prove path: it exists for component parity and
for eval-basis commitments (``ops/kzg.py``).

Butterflies over the group: A' = A + w^k B, B' = A - w^k B, where the twiddle
multiply is a batched scalar mul (``CurveOps.scalar_mul``, one double and
one mixed add per scalar bit).  All stages are batched over n/2 points; the
cost is O(n log n) scalar muls, dominated by the twiddle ladders.  The
device is the input tensor's: on the card every field operation of the
ladders is a field kernel launch (``ops/field_kernels.py``).
"""

from __future__ import annotations

import torch

from ..fields.params import CURVES, domain_generator
from .curve import curve_ops
from .ntt import _bit_reverse_perm


def g1_intt(curve_name: str, points_affine, log_n: int):
    """Inverse NTT of [n, 2, W] affine G1 points -> [n, 3, W] projective.

    out[j] = (1/n) * sum_i points[i] * w^(-ij): monomial SRS -> Lagrange SRS
    when applied to [tau^i] G1."""
    curve = CURVES[curve_name]
    ops = curve_ops(curve, points_affine.device)
    r = curve.fr.modulus
    n = 1 << log_n
    if points_affine.shape[0] != n:
        raise ValueError(f"{points_affine.shape[0]} points for an NTT of 2^{log_n}")
    w_inv = pow(domain_generator(curve_name, log_n), -1, r)
    n_inv = pow(n, -1, r)

    jac = ops.affine_to_jac(points_affine)
    jac = jac[torch.from_numpy(_bit_reverse_perm(n)).to(jac.device)]

    for s in range(log_n):
        half = 1 << s
        # twiddles w_inv^(j * n/(2*half)) for j < half
        step = n // (2 * half)
        tw = [pow(w_inv, j * step, r) for j in range(half)]
        a = jac.reshape(n // (2 * half), 2, half, 3, ops.W)
        u = a[:, 0]
        b = a[:, 1].reshape(-1, 3, ops.W)
        bits = ops.scalar_bits_array(tw * (n // (2 * half)))
        # scalar-mul needs affine inputs; normalize b each stage
        b_aff = ops.to_affine(b)
        tb = ops.scalar_mul(b_aff, bits).reshape(u.shape)
        jac = torch.stack(
            [ops.jac_add(u, tb), ops.jac_add(u, _neg(ops, tb))], dim=1
        ).reshape(n, 3, ops.W)

    n_bits = ops.scalar_bits_array([n_inv] * n)
    return ops.scalar_mul(ops.to_affine(jac), n_bits)


def _neg(ops, jac):
    y = ops.f.neg(jac[..., 1, :])
    return torch.stack([jac[..., 0, :], y, jac[..., 2, :]], dim=-2)


def to_lagrange_g1(curve_name: str, srs_points_affine, log_n: int):
    """Monomial-basis SRS [n, 2, W] -> Lagrange-basis SRS [n, 2, W]
    (gnark ToLagrangeG1 semantics: L_i(tau) * G1), on the input's device."""
    ops = curve_ops(CURVES[curve_name], srs_points_affine.device)
    return ops.to_affine(g1_intt(curve_name, srs_points_affine, log_n))

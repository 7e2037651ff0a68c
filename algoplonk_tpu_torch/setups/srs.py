"""Structured reference strings for the port.

The registry (``SetupName``, ``get``, ``srs_size_for``, ``SRS``, the trusted
loader) is the port's copy of the reference's ``setups/registry.py``
(``registry.py`` here).  The reference's test-only generator reaches jax, so
the port has its own: ``test_only_srs`` returns the same points as the
reference's (registry.py:162-277), [tau^i] G1 with the same ``_test_tau``,
computed on the device with the port's batched double-and-add
``scalar_mul``.  A trusted ceremony (``run_setup``) is decompressed on the
host by ``load_trusted``, which caches the points under ``.cache/``, and
encoded on the device.

The result is an ``SRS`` whose ``g1_limbs`` field holds the port's
``[N, 2, W]`` Montgomery word tensor on the device.  It is cached under
``.cache/`` as canonical big-endian coordinates, in files named
``torch_testsrs_*`` (the reference's cache files hold 12-bit limbs).
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from ..fields.params import CurveParams
from ..host import fp as hfp
from .registry import (  # noqa: F401 (re-exported)
    CACHE_DIR,
    SRS,
    SetupName,
    _test_tau,
    get,
    load_trusted,
    srs_size_for,
)
from ..ops.curve import curve_ops

_CHUNK = 1 << 16  # points per scalar_mul batch


def _g1_table(curve: CurveParams, g1_count: int, device) -> torch.Tensor:
    """[g1_count, 2, W] words of [tau^i] G1 computed on ``device``."""
    ops = curve_ops(curve, device)
    r = curve.fr.modulus
    tau = _test_tau(curve)
    scalars, t = [], 1
    for _ in range(g1_count):
        scalars.append(t)
        t = t * tau % r
    pieces = []
    for lo in range(0, g1_count, _CHUNK):
        part = scalars[lo : lo + _CHUNK]
        base = ops.g1_gen_affine.expand(len(part), 2, ops.W)
        jac = ops.scalar_mul(base, ops.scalar_bits_array(part))
        pieces.append(ops.to_affine(jac))
    return torch.cat(pieces)


def _load_cached(path: str, curve: CurveParams, device):
    z = np.load(path)
    nb = curve.fp.nbytes
    pts = [
        (int.from_bytes(bytes(x), "big"), int.from_bytes(bytes(y), "big"))
        for x, y in zip(z["xs"].reshape(-1, nb), z["ys"].reshape(-1, nb))
    ]
    return curve_ops(curve, device).encode_affine(pts)


def _save_cached(path: str, curve: CurveParams, table: torch.Tensor) -> None:
    nb = curve.fp.nbytes
    pts = curve_ops(curve, table.device).decode_affine(table)
    xs = np.frombuffer(b"".join(P[0].to_bytes(nb, "big") for P in pts), np.uint8)
    ys = np.frombuffer(b"".join(P[1].to_bytes(nb, "big") for P in pts), np.uint8)
    os.makedirs(CACHE_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".npz", dir=CACHE_DIR)
    os.close(fd)
    np.savez(tmp, xs=xs.reshape(-1, nb), ys=ys.reshape(-1, nb))
    os.replace(tmp, path)


def test_only_srs(curve: CurveParams, g1_count: int, device="cuda",
                  use_cache: bool = True) -> SRS:
    """Deterministic test SRS (NOT for production): [tau^i] G1 for
    i < g1_count on ``device``, and ([1] G2, [tau] G2)."""
    path = os.path.join(CACHE_DIR, f"torch_testsrs_{curve.name}_{g1_count}.npz")
    if use_cache and os.path.exists(path):
        table = _load_cached(path, curve, device)
    else:
        table = _g1_table(curve, g1_count, device)
        if use_cache:
            _save_cached(path, curve, table)
    F2 = hfp.GF2(curve.fp.modulus, curve.fp2_nonresidue)
    g2_gen = (curve.g2_x, curve.g2_y)
    return SRS(
        curve=curve,
        g1=[],
        vk_g1=curve.g1,
        vk_g2=(g2_gen, hfp.ec_mul(F2, g2_gen, _test_tau(curve))),
        g1_limbs=table,
    )


def run_setup(curve: CurveParams, setup_name: SetupName, nb_constraints: int,
              nb_public: int, device="cuda") -> SRS:
    """Size and load the SRS for a circuit (reference registry.run_setup)."""
    info = get(setup_name)
    if info is None:
        raise ValueError(f"unknown setup: {setup_name}")
    if info.curve.name != curve.name:
        raise ValueError(
            f"setup curve {info.curve.name} does not match circuit curve {curve.name}"
        )
    size = srs_size_for(nb_constraints, nb_public)
    if not info.trusted:
        return test_only_srs(curve, size, device)
    srs = load_trusted(info, size)
    srs.g1_limbs = curve_ops(curve, device).encode_affine(srs.g1)
    return srs

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
``[N, 2, W]`` Montgomery word tensor on the device.  At every count the
test SRS is made as the reference makes it above 2^16 points
(``_test_only_srs_large``): the tau powers, their bits and the
double-and-add stay on the device, and the cache under ``.cache/``
(``torch_testsrs_words_*``) holds the canonical 32-bit words, so no point
passes through a Python int on either side.  The reference's cache files
hold 12-bit limbs.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from ..fields.params import CurveParams
from ..host import fp as hfp
from ..ops import poly as polyops
from ..ops.field import field_ops
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

_CHUNK = 1 << 16  # points per scalar_mul batch, as in the reference


def _g1_table(curve: CurveParams, g1_count: int, device, chunk: int = _CHUNK) -> torch.Tensor:
    """[g1_count, 2, W] words of [tau^i] G1, made on ``device`` as the
    reference's large path makes them (registry.py:243-266): the powers of
    tau's Montgomery form (``poly.powers``), their bits (``bits_from_mont``)
    and one double-and-add per chunk of ``chunk`` points, the last chunk
    cut to what is left.  A chunk's bits are [chunk, 254] int32; 2^20
    points' would be 1 GB."""
    ops = curve_ops(curve, device)
    fr = field_ops(curve.fr, device)
    nbits = curve.fr.modulus.bit_length()
    pows = polyops.powers(fr, fr.encode([_test_tau(curve)])[0], g1_count)
    pieces = []
    for lo in range(0, g1_count, chunk):
        part = pows[lo : lo + chunk]
        base = ops.g1_gen_affine.expand(len(part), 2, ops.W)
        pieces.append(ops.to_affine(ops.scalar_mul(base, fr.bits_from_mont(part, nbits))))
    return torch.cat(pieces)


def test_only_srs(curve: CurveParams, g1_count: int, device="cuda",
                  use_cache: bool = True, chunk: int = _CHUNK) -> SRS:
    """Deterministic test SRS (NOT for production): [tau^i] G1 for
    i < g1_count on ``device`` (``_g1_table`` in chunks of ``chunk``), and
    ([1] G2, [tau] G2).  Cached as canonical 32-bit words (uint32
    [N, 2, W]), which move to and from the device whole and enter or leave
    Montgomery form there."""
    path = os.path.join(CACHE_DIR, f"torch_testsrs_words_{curve.name}_{g1_count}.npz")
    fq = field_ops(curve.fp, device)
    if use_cache and os.path.exists(path):
        words = np.load(path)["g1"].view(np.int32)
        table = fq.to_mont(torch.from_numpy(words).to(fq.device))
    else:
        table = _g1_table(curve, g1_count, device, chunk)
        if use_cache:
            os.makedirs(CACHE_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".npz", dir=CACHE_DIR)
            os.close(fd)
            np.savez(tmp, g1=fq.from_mont(table).cpu().numpy().view(np.uint32))
            os.replace(tmp, path)   # a reader never sees it half written
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

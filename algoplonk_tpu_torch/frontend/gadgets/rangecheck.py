"""Range-check gadget (gnark std/rangecheck equivalent).

Constrains 0 <= v < 2^nbits via binary decomposition; used by BSB22-style
configurations (reference BASELINE.json config #3 exercises the rangecheck
gadget through frontend.Committer circuits).

Copied from ``algoplonk_tpu/frontend/gadgets/rangecheck.py`` so that the port imports nothing of the
JAX package.
"""

from __future__ import annotations


def assert_bit_length(api, v, nbits: int):
    """Constrain v to fit in nbits bits."""
    api.to_binary(v, nbits)


def assert_less_than_constant(api, v, bound: int):
    """Constrain v < bound for a constant bound (bound <= 2^k form only:
    rounds the bound up to the next power of two via bit-length check, then
    subtracts the remainder check when bound is not a power of two)."""
    nbits = (bound - 1).bit_length() if bound > 1 else 1
    if bound == 1 << nbits or bound == (1 << (nbits - 1)):
        assert_bit_length(api, v, nbits)
        return
    # v < bound  <=>  v + (2^nbits - bound) fits in nbits bits and v fits too
    assert_bit_length(api, v, nbits)
    shifted = api.add(v, (1 << nbits) - bound)
    api.to_binary(shifted, nbits)

"""Host-side conversions between integers and the reference's limb arrays.

Device representation of the reference: ``[..., L]`` int32 arrays,
little-endian 12-bit limbs (see fields/params.py).  The port keeps only the
reading direction, which ``fields/words.jax_limbs_to_mont_words`` needs to
carry a reference proving key across.

Copied from ``algoplonk_tpu/fields/limbs.py`` (``limbs_to_ints`` without its
native fast path, and ``mont_limbs_to_ints``) so that the port imports nothing
of the JAX package.
"""

from __future__ import annotations

import numpy as np

from .params import LIMB_BITS, FieldParams


def limbs_to_ints(limbs: np.ndarray) -> list[int]:
    """[..., L] 12-bit limbs -> flat list of python ints (row-major)."""
    arr = np.asarray(limbs)
    flat = arr.reshape(-1, arr.shape[-1])
    nl = arr.shape[-1]
    shifts = [LIMB_BITS * k for k in range(nl)]
    out = []
    for row in flat:
        v = 0
        for k, s in enumerate(shifts):
            v |= int(row[k]) << s
        out.append(v)
    return out


def mont_limbs_to_ints(limbs: np.ndarray, fp: FieldParams) -> list[int]:
    """Montgomery-form limb array -> canonical python ints."""
    return [fp.from_mont(v) for v in limbs_to_ints(limbs)]

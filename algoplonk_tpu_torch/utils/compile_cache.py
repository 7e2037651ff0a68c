"""The kernel build cache for the prover path.

Counterpart of the reference ``utils/compile_cache.py``, which turns on
JAX's persistent compilation cache so that repeat runs skip the jit.  Here
the expensive artifact is the CUDA kernel library, which ``ops/_build.py``
builds with nvcc once per source hash into ``algoplonk_tpu_torch/_kernels/``
and loads from there afterwards; this builds or loads it ahead of the first
launch.  A ``Prover`` on a CUDA device calls it, as the reference's
``Prover`` turns on its cache, so that a prove's phase times hold no build.
"""

from __future__ import annotations

import torch


def enable_persistent_cache() -> bool:
    """Build, or load from ``ops/_build.py``'s cache, the kernel library.

    Returns True when it is loaded: on a machine with a CUDA device.
    Without a device there is nothing to build, and it returns False."""
    if not torch.cuda.is_available():
        return False
    from ..ops import _build

    _build.library()
    return True

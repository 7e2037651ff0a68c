"""The reference package's jax-free modules, loaded under the port's name.

Several modules of ``algoplonk_tpu`` import no jax themselves (fields/params,
fields/limbs, frontend/*, host/*, plonk/transcript and the module level of
setups/registry), but importing them as ``algoplonk_tpu.*`` runs
``algoplonk_tpu/__init__.py`` first, which loads the whole JAX stack.  This
package points its ``__path__`` at the reference directory instead, so
``algoplonk_tpu_torch._ref.frontend.api`` executes the reference file as a
submodule of this package and the reference ``__init__`` never runs.

Two consequences for callers:

* the modules are separate instances from ``algoplonk_tpu.*`` in a process
  that imports both (classes such as ``frontend.api._Input`` differ, and the
  gnark-compat flag in ``fields.params`` is kept per instance);
* only jax-free modules may be imported from here.  ``plonk.keys``,
  ``plonk.prove``, ``plonk.marshal``, ``plonk.verify``, ``verifier.*`` and
  ``setups.registry.test_only_srs`` reach jax; the port has its own.

The reference's ``fields.params._clear_derived_caches`` clears the caches
that ``set_gnark_compat`` invalidates by the reference's module names
(``algoplonk_tpu.host.mimc``, ...), which never name this instance's
modules.  ``_extend_compat_clear`` wraps it, on this instance only, so a
toggle also clears the port's caches that depend on the mode.
"""

import os
import sys

__path__ = [
    os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "algoplonk_tpu",
    )
]

_PORT = __name__.rsplit(".", 1)[0]

# (module, lru_cache'd function) pairs whose values depend on the compat mode
_MODE_CACHES = (
    (f"{__name__}.host.mimc", "round_constants"),
    (f"{_PORT}.ops.ntt_kernels", "_four_step_plan"),
)


def _extend_compat_clear() -> None:
    from .fields import params

    ref_clear = params._clear_derived_caches

    def _clear_derived_caches() -> None:
        ref_clear()
        for modname, attr in _MODE_CACHES:
            m = sys.modules.get(modname)
            if m is not None:
                getattr(m, attr).cache_clear()

    params._clear_derived_caches = _clear_derived_caches


_extend_compat_clear()

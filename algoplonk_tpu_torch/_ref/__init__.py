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
"""

import os

__path__ = [
    os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "algoplonk_tpu",
    )
]

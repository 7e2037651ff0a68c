"""In-circuit MiMC gadget, matching host/mimc.py exactly.

Equivalent of gnark's std/hash/mimc used by the reference's merkle example
(examples/merkle/logicsigVerifier/main.go:34-61).  Each absorbed block costs
3 constraints per round (t^2, t^4, t^5) plus the key/feedback additions.

Copied from ``algoplonk_tpu/frontend/gadgets/mimc.py`` so that the port imports nothing of the
JAX package.
"""

from __future__ import annotations

from ...host.mimc import EXPONENT, round_constants


class MiMC:
    """Usage: h = MiMC(api, curve); h.write(x, y); digest = h.sum()."""

    def __init__(self, api, curve):
        assert EXPONENT == 5
        self.api = api
        self.curve = curve
        self.constants = round_constants(curve.name, curve.fr.modulus)
        self.state = 0  # field constant zero

    def _encrypt(self, key, msg):
        api = self.api
        x = msg
        for c in self.constants:
            t = api.add(api.add(x, key), c)
            t2 = api.mul(t, t)
            t4 = api.mul(t2, t2)
            x = api.mul(t4, t)
        return api.add(x, key)

    def write(self, *values):
        api = self.api
        for v in values:
            enc = self._encrypt(self.state, v)
            self.state = api.add(api.add(enc, self.state), v)

    def sum(self):
        return self.state

    def reset(self):
        self.state = 0


def mimc_hash_gadget(api, curve, values):
    h = MiMC(api, curve)
    h.write(*values)
    return h.sum()

"""A BSB22 range proof (BASELINE.json config 3): ``amounts`` secret uint64
values, each held to ``bits`` bits by bit decomposition, their sum public,
and one BSB22 commitment to them whose value is used, as gnark's
std/rangecheck commits once through frontend.Committer.

Copied from ``range_commit`` and ``range_values`` in chip_smoke.py
(:420, :442), with the program's ``assert_bit_length`` gadget written out
as the decomposition it is (``api.to_binary``).  ``circuit`` takes the
frontend as ``fe``; ``assignment`` draws the amounts from the run's
generator, with the range's edges 0 and 2^bits - 1 among them; ``publics``
is the reference's own account of the public input.  Nothing here imports
the program.
"""

from __future__ import annotations


def circuit(fe, cfg: dict):
    n, bits = cfg["amounts"], cfg["bits"]

    class RangeCommit(fe.Circuit):
        total = fe.PublicInput()
        amounts = fe.SecretInput(shape=n)

        def define(self, api):
            for a in self.amounts:
                api.to_binary(a, bits)
            api.assert_is_equal(api.add(*self.amounts), self.total)
            v = api.commit(*self.amounts)
            api.assert_is_different(v, 0)

    return RangeCommit


def assignment(cfg: dict, r: int, rng) -> dict:
    n, top = cfg["amounts"], (1 << cfg["bits"]) - 1
    amounts = [0, top] + [rng.randrange(top + 1) for _ in range(n - 2)]
    rng.shuffle(amounts)
    return {"total": sum(amounts), "amounts": amounts}


def publics(cfg: dict, r: int, values: dict) -> list:
    return [sum(values["amounts"]) % r]

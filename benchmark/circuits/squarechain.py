"""gnark's PLONK prover benchmark circuit: a chain of squarings of a secret
x whose last square is the public y.

``chain`` = 2^log_n - 3 squarings, one equality row and the two inputs'
rows fill the domain of 2^log_n exactly.  Copied from ``square_chain`` in
chip_smoke.py (:390), which follows the JAX package's bench_prove.py:60-69.

Both sides build the circuit from this file: ``circuit`` takes the frontend
(the program's, or the reference's copy) as ``fe``; ``assignment`` draws a
uniform nonzero x from the run's generator; ``publics`` is the reference's
own account of the public inputs.  Nothing here imports the program.
"""

from __future__ import annotations


def chain_length(cfg: dict) -> int:
    return (1 << cfg["log_n"]) - 3


def circuit(fe, cfg: dict):
    chain = chain_length(cfg)

    class SquareChain(fe.Circuit):
        y = fe.PublicInput()
        x = fe.SecretInput()

        def define(self, api):
            t = self.x
            for _ in range(chain):
                t = api.mul(t, t)
            api.assert_is_equal(t, self.y)

    return SquareChain


def assignment(cfg: dict, r: int, rng) -> dict:
    x = rng.randrange(1, r)
    return {"x": x, "y": pow(x, pow(2, chain_length(cfg), r - 1), r)}


def publics(cfg: dict, r: int, values: dict) -> list:
    """y = x^(2^chain) mod r, by Fermat (x is nonzero)."""
    x = values["x"] % r
    return [pow(x, pow(2, chain_length(cfg), r - 1), r)]

"""A MiMC Merkle inclusion proof (BASELINE.json config 2, AlgoPlonk's
examples/merkle): a secret leaf, ``depth`` secret siblings and direction
bits, and the public root they hash up to.

The circuit is written out over the frontend ``fe`` as the program's
frontend/gadgets/mimc.py and merkle.py build it (the example
examples_torch/merkle at ``depth`` 16): for each level a boolean check of
the direction, two selects, and one MiMC hash of (left, right) in
Miyaguchi-Preneel mode, 110 rounds of x^5 a block.  MiMC's round
constants follow the program's rule (host/mimc.py: a sha256 chain seeded
with "algoplonk-tpu.mimc.<curve>", c_0 = 0), derived here again.

``assignment`` draws a fresh path from the run's generator: the leaf and
the siblings uniform in Fr, the leaf's index uniform in [0, 2^depth),
whose bits (least significant first, 1 = the node is the right child) are
the directions.  ``publics``, the reference's own account of the public
input, hashes the path up to the root with this file's host MiMC.
Nothing here imports the program.
"""

from __future__ import annotations

import functools
import hashlib
import math

EXPONENT = 5


@functools.lru_cache(maxsize=None)
def round_constants(curve: str, r: int) -> tuple:
    rounds = math.ceil(r.bit_length() / math.log2(EXPONENT))
    cs = [0]
    seed = hashlib.sha256(f"algoplonk-tpu.mimc.{curve}".encode()).digest()
    for _ in range(rounds - 1):
        seed = hashlib.sha256(seed).digest()
        cs.append(int.from_bytes(seed, "big") % r)
    return tuple(cs)


def mimc(curve: str, r: int, values) -> int:
    """MiMC over Fr of field-element blocks, h <- E_h(m) + h + m."""
    cs = round_constants(curve, r)
    h = 0
    for m in values:
        x = m % r
        for c in cs:
            x = pow((x + h + c) % r, EXPONENT, r)
        h = (x + h + h + m) % r
    return h


def root_of(curve: str, r: int, leaf: int, siblings, directions) -> int:
    cur = leaf % r
    for sib, d in zip(siblings, directions):
        cur = mimc(curve, r, [sib, cur] if d else [cur, sib])
    return cur


def circuit(fe, cfg: dict):
    depth, curve = cfg["depth"], cfg["curve"]

    class Merkle(fe.Circuit):
        root = fe.PublicInput()
        leaf = fe.SecretInput()
        siblings = fe.SecretInput(shape=depth)
        directions = fe.SecretInput(shape=depth)

        def define(self, api):
            cs = round_constants(curve, api.r)

            def hash2(left, right):
                h = 0
                for m in (left, right):
                    x = m
                    for c in cs:
                        t = api.add(api.add(x, h), c)
                        t2 = api.mul(t, t)
                        t4 = api.mul(t2, t2)
                        x = api.mul(t4, t)
                    h = api.add(api.add(api.add(x, h), h), m)
                return h

            cur = self.leaf
            for sib, d in zip(self.siblings, self.directions):
                api.assert_is_boolean(d)
                cur = hash2(api.select(d, sib, cur), api.select(d, cur, sib))
            api.assert_is_equal(cur, self.root)

    return Merkle


def assignment(cfg: dict, r: int, rng) -> dict:
    depth = cfg["depth"]
    leaf = rng.randrange(r)
    index = rng.randrange(1 << depth)
    directions = [(index >> i) & 1 for i in range(depth)]
    siblings = [rng.randrange(r) for _ in range(depth)]
    return {"root": root_of(cfg["curve"], r, leaf, siblings, directions), "leaf": leaf,
            "siblings": siblings, "directions": directions}


def publics(cfg: dict, r: int, values: dict) -> list:
    return [root_of(cfg["curve"], r, values["leaf"], values["siblings"], values["directions"])]

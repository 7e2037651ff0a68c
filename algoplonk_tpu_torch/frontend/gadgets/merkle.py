"""Merkle-proof verification gadget (gnark std/accumulator/merkle equivalent,
used by the reference's merkle example, examples/merkle/*/main.go:34-61).

Verifies a MiMC Merkle inclusion path: directions are boolean wires
(1 = current node is the right child), siblings are field elements.

Copied from ``algoplonk_tpu/frontend/gadgets/merkle.py`` so that the port imports nothing of the
JAX package.
"""

from __future__ import annotations

from .mimc import mimc_hash_gadget


def verify_merkle_proof(api, curve, root, leaf, siblings, directions):
    """Constrain mimc-merkle path(leaf, siblings, directions) == root."""
    cur = leaf
    for sib, d in zip(siblings, directions):
        api.assert_is_boolean(d)
        left = api.select(d, sib, cur)
        right = api.select(d, cur, sib)
        cur = mimc_hash_gadget(api, curve, [left, right])
    api.assert_is_equal(cur, root)

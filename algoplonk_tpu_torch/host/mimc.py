"""MiMC hash over the scalar field (host reference implementation).

The reference's merkle example uses gnark's std MiMC both in-circuit and on
host (examples/merkle/*/main.go:34-61 + gnark-crypto mimc).  What matters for
proofs is that the in-circuit gadget (frontend/gadgets/mimc.py) and this host
hash agree — both are generated from the same spec below.

Spec (deterministic, self-contained):
* permutation: 110 rounds of x <- (x + k + c_i)^5 over Fr, with exponent 5
  checked invertible (gcd(5, r-1) = 1 on both supported curves);
* round constants: sha256 chain seeded with "algoplonk-tpu.mimc.<curve>",
  each digest reduced mod r; c_0 = 0;
* multi-block hashing in Miyaguchi-Preneel mode like gnark's fr.MiMC:
  h <- E_h(m) + h + m.

Default-mode round constants intentionally differ from gnark's (we do not
copy its generated tables); circuits and host hashes are consistent with
each other, which is what on-chain verification requires.

gnark-compat mode (fields.params.set_gnark_compat): constants re-derived by
gnark-crypto's documented rule — an iterated legacy-Keccak-256 chain over the
public seed string "seed", each digest taken big-endian mod r (gnark-crypto
ecc/*/fr/mimc initConstants; same 110-round x^5 permutation and
Miyaguchi-Preneel chaining as the default mode).

Copied from ``algoplonk_tpu/host/mimc.py`` so that the port imports nothing of the
JAX package.
"""

from __future__ import annotations

import functools
import hashlib

from ..fields.params import CurveParams, gnark_compat_enabled

EXPONENT = 5
GNARK_SEED = b"seed"


def nb_rounds(r: int) -> int:
    """MiMC round count, derived per field instead of hard-coded (ADVICE r4):
    the MiMC paper's rule rounds = ceil(log_d(r)) for the x^d permutation —
    ceil(254 / log2(5)) = 110 for BN254 and ceil(255 / log2(5)) = 110 for
    BLS12-381, matching gnark-crypto's mimcNbRounds = 110 on both."""
    import math

    return math.ceil(r.bit_length() / math.log2(EXPONENT))


ROUNDS = 110  # both supported curves derive to 110; kept for callers


@functools.lru_cache(maxsize=None)
def round_constants(curve_name: str, r: int) -> tuple:
    assert r % EXPONENT != 1, "x^5 must be a permutation of Fr"
    if gnark_compat_enabled():
        return _gnark_round_constants(r)
    rounds = nb_rounds(r)
    cs = [0]
    seed = hashlib.sha256(f"algoplonk-tpu.mimc.{curve_name}".encode()).digest()
    for _ in range(rounds - 1):
        seed = hashlib.sha256(seed).digest()
        cs.append(int.from_bytes(seed, "big") % r)
    return tuple(cs)


@functools.lru_cache(maxsize=None)
def _gnark_round_constants(r: int) -> tuple:
    """c_i = Keccak256^(i+2)("seed") mod r, i = 0..rounds-1.

    Mirrors gnark-crypto's initConstants: one pre-hash of the seed, then each
    round constant is the Keccak of the previous digest."""
    from .keccak import keccak256

    rnd = keccak256(GNARK_SEED)  # pre-hash before use
    cs = []
    for _ in range(nb_rounds(r)):
        rnd = keccak256(rnd)
        cs.append(int.from_bytes(rnd, "big") % r)
    return tuple(cs)


def mimc_encrypt(curve: CurveParams, key: int, msg: int) -> int:
    r = curve.fr.modulus
    x = msg % r
    k = key % r
    for c in round_constants(curve.name, r):
        t = (x + k + c) % r
        x = pow(t, EXPONENT, r)
    return (x + k) % r


def mimc_hash(curve: CurveParams, values) -> int:
    """Miyaguchi-Preneel over field-element blocks."""
    r = curve.fr.modulus
    h = 0
    for v in values:
        v = int(v) % r
        h = (mimc_encrypt(curve, h, v) + h + v) % r
    return h


def merkle_root(curve: CurveParams, leaves) -> int:
    """Binary Merkle tree, parent = mimc_hash(left, right)."""
    level = [int(v) % curve.fr.modulus for v in leaves]
    assert level and (len(level) & (len(level) - 1)) == 0, "need power-of-two leaves"
    while len(level) > 1:
        level = [
            mimc_hash(curve, [level[i], level[i + 1]])
            for i in range(0, len(level), 2)
        ]
    return level[0]


def merkle_path(curve: CurveParams, leaves, index: int):
    """(siblings, directions) for leaf `index`; direction bit 1 means the
    current node is the right child."""
    level = [int(v) % curve.fr.modulus for v in leaves]
    sibs, dirs = [], []
    idx = index
    while len(level) > 1:
        sib = level[idx ^ 1]
        sibs.append(sib)
        dirs.append(idx & 1)
        level = [
            mimc_hash(curve, [level[i], level[i + 1]])
            for i in range(0, len(level), 2)
        ]
        idx //= 2
    return sibs, dirs

"""Field elements as 32-bit words, and converters to and from the reference.

Representation: ``[..., W]`` int32 tensors holding the little-endian 32-bit
words of a canonical Montgomery residue (the int32 is the bit pattern of the
uint32 word).  Both BN254 fields and BLS12-381's scalar field use W = 8 and
R = 2^256; BLS12-381's 381-bit base field uses W = 12 and R = 2^384.  Every
Montgomery constant is derived here from Python ints in this R; none is copied
from the reference's 12-bit limb arrays (whose R is 2^264 for BN254,
fields/params.py).

Parity with the reference is checked on values: its limb arrays go through
canonical Python ints before they become words (``jax_limbs_to_mont_words``,
which carries a proving key across).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from .params import FieldParams
from . import limbs as ref_limbs

WORD_BITS = 32


def words_for(fp: FieldParams) -> int:
    """Words per element: the modulus plus at least one bit of headroom
    (the CUDA CIOS multiply and the plain REDC both need p < R/2, so that
    a sum of two residues and every REDC output below 2p fit in W words)."""
    return -(-(fp.nbits + 1) // WORD_BITS)


@dataclasses.dataclass(frozen=True)
class WordField:
    """One prime field in the port's word layout and Montgomery radix."""

    fp: FieldParams
    W: int
    R: int        # 2^(32 W)
    r: int        # R mod p (Montgomery one)
    r2: int       # R^2 mod p
    n_prime: int  # -p^-1 mod R
    n0: int       # -p^-1 mod 2^32

    @property
    def modulus(self) -> int:
        return self.fp.modulus

    def to_mont(self, x: int) -> int:
        return x % self.fp.modulus * self.r % self.fp.modulus

    def from_mont(self, x: int) -> int:
        return x * pow(self.r, -1, self.fp.modulus) % self.fp.modulus


@functools.lru_cache(maxsize=None)
def word_field(fp: FieldParams) -> WordField:
    p = fp.modulus
    W = words_for(fp)
    R = 1 << (WORD_BITS * W)
    if not 2 * p < R:
        raise ValueError(f"{fp.name}: the kernels and the plain REDC need p < R/2")
    n_prime = (-pow(p, -1, R)) % R
    return WordField(
        fp=fp, W=W, R=R, r=R % p, r2=R * R % p, n_prime=n_prime,
        n0=n_prime & 0xFFFFFFFF,
    )


def ints_to_words(values, W: int) -> np.ndarray:
    """Non-negative ints < 2^(32 W) -> [N, W] int32 words (no reduction)."""
    values = list(values)
    buf = b"".join(int(v).to_bytes(4 * W, "little") for v in values)
    return np.frombuffer(buf, dtype="<i4").reshape(len(values), W).copy()


def words_to_ints(arr) -> list[int]:
    """[..., W] int32 words -> flat list of ints (row-major)."""
    a = np.ascontiguousarray(np.asarray(arr, dtype=np.int32))
    W = a.shape[-1]
    raw = a.reshape(-1, W).astype("<i4").tobytes()
    step = 4 * W
    return [
        int.from_bytes(raw[i : i + step], "little")
        for i in range(0, len(raw), step)
    ]


def ints_to_mont_words(values, wf: WordField) -> np.ndarray:
    """Canonical (or any) ints -> Montgomery words [N, W], reduced mod p."""
    return ints_to_words([wf.to_mont(int(v)) for v in values], wf.W)


def mont_words_to_ints(arr, wf: WordField) -> list[int]:
    """Montgomery words -> canonical ints (values reduced mod p)."""
    return [wf.from_mont(v) for v in words_to_ints(arr)]


# ----------------------------------------------------- reference converters

def jax_limbs_to_mont_words(limbs, wf: WordField) -> np.ndarray:
    """Reference Montgomery limbs [..., L] -> the port's Montgomery words
    [..., W] holding the same field values."""
    a = np.asarray(limbs)
    ints = ref_limbs.mont_limbs_to_ints(a.reshape(-1, a.shape[-1]), wf.fp)
    return ints_to_mont_words(ints, wf).reshape(a.shape[:-1] + (wf.W,))

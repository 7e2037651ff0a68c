"""Legacy Keccak-256 (pre-NIST padding), pure Python.

gnark-crypto derives its MiMC round constants with golang.org/x/crypto/sha3
``NewLegacyKeccak256`` (the Ethereum-style Keccak with 0x01 domain padding,
NOT NIST SHA3's 0x06).  Python's hashlib only ships the NIST variant, so the
gnark-compat MiMC mode (host/mimc.py) needs this self-contained permutation.

Validated against the two canonical public test vectors (tests/test_gadgets.py):
  keccak256(b"")    = c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470
  keccak256(b"abc") = 4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45

Copied from ``algoplonk_tpu/host/keccak.py`` so that the port imports nothing of the
JAX package.
"""

from __future__ import annotations

_MASK = (1 << 64) - 1

def _rotl(v: int, n: int) -> int:
    n %= 64
    return ((v << n) | (v >> (64 - n))) & _MASK


def _keccak_f(a):
    """Keccak-f[1600] on a 5x5 list-of-lists of 64-bit lanes a[x][y],
    modified in place.  The round structure follows the Keccak team's
    compact iterative formulation (theta / rho+pi walk / chi / LFSR iota)."""
    lfsr = 1
    for _ in range(24):
        # theta
        c = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x][y] ^= d[x]
        # rho + pi: walk the 24 non-origin lanes, rotating by triangular nums
        x, y = 1, 0
        cur = a[x][y]
        for t in range(24):
            x, y = y, (2 * x + 3 * y) % 5
            cur, a[x][y] = a[x][y], _rotl(cur, (t + 1) * (t + 2) // 2)
        # chi
        for y in range(5):
            row = [a[x][y] for x in range(5)]
            for x in range(5):
                a[x][y] = row[x] ^ ((~row[(x + 1) % 5]) & row[(x + 2) % 5] & _MASK)
        # iota: round constant bits from the degree-8 LFSR
        for j in range(7):
            lfsr = ((lfsr << 1) ^ ((lfsr >> 7) * 0x71)) % 256
            if lfsr & 2:
                a[0][0] ^= 1 << ((1 << j) - 1)
    return a


def keccak256(data: bytes) -> bytes:
    """Legacy (Ethereum-style) Keccak-256 digest of ``data``."""
    rate = 136  # (1600 - 2*256) / 8
    # multi-rate padding with 0x01 domain byte (legacy), final bit 0x80
    padded = bytearray(data)
    pad_len = rate - (len(padded) % rate)
    padded += b"\x00" * pad_len
    padded[len(data)] ^= 0x01
    padded[-1] ^= 0x80

    a = [[0] * 5 for _ in range(5)]
    for off in range(0, len(padded), rate):
        block = padded[off : off + rate]
        for i in range(rate // 8):
            lane = int.from_bytes(block[8 * i : 8 * i + 8], "little")
            a[i % 5][i // 5] ^= lane
        _keccak_f(a)

    out = bytearray()
    for i in range(4):  # 32 bytes = 4 lanes
        out += a[i % 5][i // 5].to_bytes(8, "little")
    return bytes(out)

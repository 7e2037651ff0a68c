"""Trusted-setup registry and SRS loading.

Mirrors the reference registry design (setup/setup.go:30-161):
an enum of named setups mapping to {curve, data path, trusted}, loaders that
parse the exact pk.bin / vk.bin byte formats, and a deterministic test-only
SRS for arbitrary sizes (the unsafekzg equivalent, setup/setup.go:102-108).

pk.bin: 4-byte big-endian G1 count + that many compressed G1 points
        (32 B BN254, 48 B BLS12-381)  — setup/setup.go:216-226.
vk.bin: 2 compressed G2 points + 1 compressed G1 point (160 B / 240 B).

Unlike gnark we commit polynomials in the monomial basis (coefficients come
out of the prover's iNTT anyway), so no Lagrange-SRS conversion is required;
the G1 i-NTT (ToLagrangeG1, setup/setup.go:124-142) is still available on
device via ops/gntt.py for parity and for eval-basis commitment experiments.

Copied from ``algoplonk_tpu/setups/registry.py`` (its jax-free part: the
test-only generator and ``run_setup`` are the port's own, in
``setups/srs.py``) so that the port imports nothing of the JAX package.  The
ceremony files are read as data from the reference's ``setups/data``.
"""

from __future__ import annotations

import enum
import hashlib
import os
from dataclasses import dataclass

import numpy as np

from ..fields.params import BLS12_381, BN254, CurveParams
from ..host.serialize import PointCodec

DATA_DIR = os.path.join(
    os.path.dirname(__file__), "..", "..", "algoplonk_tpu", "setups", "data"
)
CACHE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", ".cache")


class SetupName(enum.Enum):
    PERPETUAL_POWERS_OF_TAU_BN254 = 0
    ETHEREUM_KZG_CEREMONY_BLS12_381 = 1
    DUSK_BLS12_381 = 2
    TEST_ONLY_BN254 = 3
    TEST_ONLY_BLS12_381 = 4


@dataclass(frozen=True)
class SetupInfo:
    curve: CurveParams
    name_path: str
    trusted: bool
    max_log2: int  # ceremony capacity ceiling (reference README.md:45-49)


SETUPS = {
    SetupName.PERPETUAL_POWERS_OF_TAU_BN254: SetupInfo(
        BN254, "PerpetualPowersOfTauBN254", True, 17
    ),
    SetupName.ETHEREUM_KZG_CEREMONY_BLS12_381: SetupInfo(
        BLS12_381, "EthereumKzgCeremonyBLS12_381", True, 14
    ),
    SetupName.DUSK_BLS12_381: SetupInfo(BLS12_381, "DuskBLS12_381", True, 21),
    SetupName.TEST_ONLY_BN254: SetupInfo(BN254, "test_only", False, 28),
    SetupName.TEST_ONLY_BLS12_381: SetupInfo(BLS12_381, "test_only", False, 32),
}


def get(name: SetupName) -> SetupInfo | None:
    return SETUPS.get(name)


def test_only_setup(curve: CurveParams) -> SetupName:
    if curve.name == "bn254":
        return SetupName.TEST_ONLY_BN254
    if curve.name == "bls12_381":
        return SetupName.TEST_ONLY_BLS12_381
    raise ValueError(f"unsupported curve: {curve.name}")


@dataclass
class SRS:
    """Structured reference string (monomial basis).

    g1: [n] affine int tuples [tau^i] G1 (may be empty when g1_limbs is set).
    g1_limbs: optional [n, 2, L] int32 Montgomery affine limb array — the
        device-ready form; large test SRSs are generated and kept in this
        form to skip the million-point host int round trip.
    vk_g1: G1 generator; vk_g2: ([1] G2, [tau] G2).
    """

    curve: CurveParams
    g1: list
    vk_g1: tuple
    vk_g2: tuple
    g1_limbs: np.ndarray | None = None

    @property
    def g1_count(self) -> int:
        if self.g1_limbs is not None:
            return self.g1_limbs.shape[0]
        return len(self.g1)


def next_power_of_two(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def srs_size_for(nb_constraints: int, nb_public: int) -> int:
    """gnark sizing rule: NextPow2(constraints + public) + 3
    (reference setup/setup.go:113-114)."""
    return next_power_of_two(nb_constraints + nb_public) + 3


def load_trusted(info: SetupInfo, g1_count: int) -> SRS:
    """Parse pk.bin / vk.bin, truncating to g1_count points."""
    if g1_count < 2:
        raise ValueError("need at least 2 G1 points")
    pk_path = os.path.join(DATA_DIR, info.name_path, "pk.bin")
    vk_path = os.path.join(DATA_DIR, info.name_path, "vk.bin")
    if not os.path.exists(pk_path):
        raise FileNotFoundError(
            f"{pk_path} missing: this mount ships without the large ceremony "
            f"blobs for {info.name_path} (see reference .MISSING_LARGE_BLOBS); "
            "rebuild it from the public ceremony artifacts per the audit "
            "programs documented in SURVEY.md section 2a row 7"
        )
    codec = PointCodec(info.curve)
    nb = info.curve.fp.nbytes
    raw = open(pk_path, "rb").read()
    declared = int.from_bytes(raw[:4], "big")
    needed = 4 + g1_count * nb
    if len(raw) < needed or declared < g1_count:
        raise ValueError(f"pk.bin too small for {g1_count} elements")

    cache_key = hashlib.sha256(
        f"{info.name_path}:{g1_count}".encode() + raw[4 : 4 + 64]
    ).hexdigest()[:16]
    cache_file = os.path.join(CACHE_DIR, f"srs_{cache_key}.npz")
    if os.path.exists(cache_file):
        z = np.load(cache_file, allow_pickle=False)
        xs, ys = z["xs"], z["ys"]
        g1 = [
            (int.from_bytes(bytes(x), "big"), int.from_bytes(bytes(y), "big"))
            for x, y in zip(xs, ys)
        ]
    else:
        g1 = [
            codec.g1_from_compressed(raw[4 + i * nb : 4 + (i + 1) * nb])
            for i in range(g1_count)
        ]
        os.makedirs(CACHE_DIR, exist_ok=True)
        xs = np.frombuffer(b"".join(P[0].to_bytes(nb, "big") for P in g1), np.uint8).reshape(-1, nb)
        ys = np.frombuffer(b"".join(P[1].to_bytes(nb, "big") for P in g1), np.uint8).reshape(-1, nb)
        # written whole, then renamed: other processes read this file too
        tmp = f"{cache_file}.{os.getpid()}.npz"
        np.savez_compressed(tmp, xs=xs, ys=ys)
        os.replace(tmp, cache_file)

    vk_raw = open(vk_path, "rb").read()
    g2_size = 2 * nb
    assert len(vk_raw) == 2 * g2_size + nb, f"bad vk.bin size {len(vk_raw)}"
    g2_0 = codec.g2_from_compressed(vk_raw[:g2_size])
    g2_1 = codec.g2_from_compressed(vk_raw[g2_size : 2 * g2_size])
    vk_g1 = codec.g1_from_compressed(vk_raw[2 * g2_size :])
    return SRS(info.curve, g1, vk_g1, (g2_0, g2_1))


def _test_tau(curve: CurveParams) -> int:
    seed = hashlib.sha256(b"algoplonk-tpu unsafe test srs tau v1").digest()
    return int.from_bytes(seed, "big") % curve.fr.modulus

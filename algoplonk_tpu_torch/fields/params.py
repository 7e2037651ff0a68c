"""Field and curve parameters for BN254 and BLS12-381.

These are the two curves with AVM elliptic-curve opcodes, mirroring the
reference's supported set (reference: algoplonk.go:34-40).

All constants here are public standard curve parameters.  Limb layout and
Montgomery constants are derived at import time with exact Python integers.

TPU-first design note: field elements on device are batched arrays of shape
``[..., L]`` with ``L`` limbs of ``LIMB_BITS`` bits each, stored little-endian
(limb 0 = least significant) in int32 lanes.  12-bit limbs are chosen so that a
schoolbook product term a_i*b_j <= (2^12-1)^2 and a full column accumulation of
up to 32 such terms stays well below 2^31, i.e. every intermediate of the
Montgomery multiplier fits an int32 vector register with no emulated wide
arithmetic (SURVEY.md section 7, hard part #1).

Copied from ``algoplonk_tpu/fields/params.py`` so that the port imports nothing of the
JAX package.
"""

from __future__ import annotations

import dataclasses
import functools

LIMB_BITS = 12
LIMB_MASK = (1 << LIMB_BITS) - 1


def _nlimbs(bits: int) -> int:
    """Number of 12-bit limbs, rounded so products have carry headroom."""
    return -(-bits // LIMB_BITS)


@dataclasses.dataclass(frozen=True)
class FieldParams:
    """Exact parameters of one prime field plus its limb/Montgomery layout."""

    name: str
    modulus: int
    nbits: int          # bit length of modulus
    nbytes: int         # canonical big-endian byte length (gnark layout)
    nlimbs: int         # number of LIMB_BITS limbs (covers modulus + headroom)

    # Montgomery constants, R = 2**(LIMB_BITS * nlimbs)
    r: int              # R mod modulus
    r2: int             # R^2 mod modulus
    n_prime: int        # -modulus^-1 mod R
    n_prime_limb0: int  # -modulus^-1 mod 2^LIMB_BITS (for CIOS-style steps)

    @property
    def R(self) -> int:
        return 1 << (LIMB_BITS * self.nlimbs)

    def to_mont(self, x: int) -> int:
        return (x * self.r) % self.modulus

    def from_mont(self, x: int) -> int:
        # x * R^-1 mod p
        return (x * pow(self.r, -1, self.modulus)) % self.modulus


def _mk_field(name: str, modulus: int, nbytes: int) -> FieldParams:
    nbits = modulus.bit_length()
    nlimbs = _nlimbs(nbits)
    # Guarantee at least ~6 bits of headroom above the modulus inside R so that
    # REDC output < 2p fits and lazy sums have room.
    if LIMB_BITS * nlimbs - nbits < 6:
        nlimbs += 1
    R = 1 << (LIMB_BITS * nlimbs)
    r = R % modulus
    r2 = (r * r) % modulus
    n_prime = (-pow(modulus, -1, R)) % R
    n_prime_limb0 = n_prime & LIMB_MASK
    return FieldParams(
        name=name,
        modulus=modulus,
        nbits=nbits,
        nbytes=nbytes,
        nlimbs=nlimbs,
        r=r,
        r2=r2,
        n_prime=n_prime,
        n_prime_limb0=n_prime_limb0,
    )


# --------------------------------------------------------------------------
# BN254 (alt_bn128).  Base field Fp, scalar field Fr.
# Values match the constants baked into the reference's generated verifiers
# (verifier/templateLogicSigBN254.go:14-18).
# --------------------------------------------------------------------------

BN254_P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
BN254_R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

# --------------------------------------------------------------------------
# BLS12-381.
# --------------------------------------------------------------------------

BLS12_381_P = int(
    "1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f624"
    "1eabfffeb153ffffb9feffffffffaaab",
    16,
)
BLS12_381_R = int(
    "73eda753299d7d483339d80809a1d80553bda402fffe5bfeffffffff00000001", 16
)

BN254_FP = _mk_field("bn254_fp", BN254_P, 32)
BN254_FR = _mk_field("bn254_fr", BN254_R, 32)
BLS12_381_FP = _mk_field("bls12_381_fp", BLS12_381_P, 48)
BLS12_381_FR = _mk_field("bls12_381_fr", BLS12_381_R, 32)


@dataclasses.dataclass(frozen=True)
class CurveParams:
    """G1/G2 curve parameters (short Weierstrass y^2 = x^3 + b)."""

    name: str
    fp: FieldParams
    fr: FieldParams
    b: int                       # G1 curve constant
    g1: tuple[int, int]          # G1 generator (affine)
    # G2 over Fp2 = Fp[u]/(u^2 - nonresidue); elements (c0, c1) = c0 + c1*u
    fp2_nonresidue: int          # u^2 = nonresidue (as int mod p; -1 for BLS)
    b2: tuple[int, int]          # G2 curve constant in Fp2
    g2_x: tuple[int, int]
    g2_y: tuple[int, int]
    cofactor_g1: int
    # Fr multiplicative domain data
    two_adicity: int
    # generator of the 2^two_adicity roots of unity subgroup of Fr — two
    # derivations (see set_gnark_compat): "native" picks the smallest
    # quadratic non-residue; "gnark" raises gnark-crypto's documented
    # multiplicative generator of Fr* (5 for BN254, 7 for BLS12-381) to
    # (r-1)/2^s.  For BN254 the two coincide (the smallest QNR IS 5).
    native_root_of_unity: int
    gnark_root_of_unity: int
    # coset shift k1 used by the PLONK permutation argument (k2 = k1^2);
    # free protocol choice, baked into our vk and generated verifiers.
    # gnark uses its Fr multiplicative generator (5 / 7).
    native_coset_shift: int
    gnark_coset_shift: int
    # compressed-point flag convention: "msb2" (BN254 gnark style) or
    # "zcash" (BLS12-381 0x80/0x40/0x20 style) — see host/serialize.py
    flag_style: str

    @property
    def root_of_unity(self) -> int:
        return (
            self.gnark_root_of_unity if _GNARK_COMPAT[0]
            else self.native_root_of_unity
        )

    @property
    def coset_shift(self) -> int:
        return (
            self.gnark_coset_shift if _GNARK_COMPAT[0]
            else self.native_coset_shift
        )


# --------------------------------------------------------------------------
# gnark-constants compatibility mode.
#
# The protocol-free constants (domain root of unity, PLONK coset shift, MiMC
# round constants — host/mimc.py) default to self-consistent derivations that
# differ from gnark's for BLS12-381 and for MiMC.  set_gnark_compat(True)
# switches every derived constant to gnark's documented, offline-reproducible
# rules so circuits/proofs interoperate with gnark-built artifacts
# (reference: examples/merkle/logicsigVerifier/main.go:34-61
# hashes with gnark's MiMC; templates bake VK_OMEGA / VK_COSET_SHIFT from
# gnark's fft domain, verifier/templateLogicSigBN254.go:56-68).
#
# Call it BEFORE compiling circuits or constructing provers: it clears the
# derived-constant caches (NTT plans, MiMC tables), but objects built earlier
# (compiled circuits, pk/vk, Prover instances) keep the constants they were
# built with.
# --------------------------------------------------------------------------

_GNARK_COMPAT = [False]

# gnark-crypto's Fr multiplicative generators (fft domain FrMultiplicativeGen)
GNARK_FR_GENERATOR = {"bn254": 5, "bls12_381": 7}


def set_gnark_compat(enabled: bool = True) -> None:
    enabled = bool(enabled)
    if enabled == _GNARK_COMPAT[0]:
        return
    _GNARK_COMPAT[0] = enabled
    _clear_derived_caches()


def gnark_compat_enabled() -> bool:
    return _GNARK_COMPAT[0]


def _clear_derived_caches() -> None:
    import sys

    domain_generator.cache_clear()
    # the port's radix-2 plans are keyed on the mode and need no clearing
    for modname, attrs in (
        ("algoplonk_tpu_torch.ops.ntt_kernels", ("_four_step_plan",)),
        ("algoplonk_tpu_torch.host.mimc", ("round_constants",)),
    ):
        m = sys.modules.get(modname)
        if m is not None:
            for a in attrs:
                getattr(m, a).cache_clear()


def _find_two_adic_root(r_mod: int, two_adicity: int) -> int:
    """Deterministically derive a generator of the 2^s root-of-unity subgroup.

    Picks the smallest h >= 2 that is a quadratic non-residue (h^((r-1)/2) =
    -1), which guarantees h^((r-1)/2^s) has exact order 2^s.
    """
    e = (r_mod - 1) >> 1
    h = 2
    while pow(h, e, r_mod) != r_mod - 1:
        h += 1
    return pow(h, (r_mod - 1) >> two_adicity, r_mod)


def _two_adicity(r_mod: int) -> int:
    s, m = 0, r_mod - 1
    while m % 2 == 0:
        s += 1
        m >>= 1
    return s


_BN254_TWO_ADICITY = _two_adicity(BN254_R)      # 28
_BLS_TWO_ADICITY = _two_adicity(BLS12_381_R)    # 32

BN254 = CurveParams(
    name="bn254",
    fp=BN254_FP,
    fr=BN254_FR,
    b=3,
    g1=(1, 2),
    fp2_nonresidue=BN254_P - 1,  # u^2 = -1
    # b2 = 3 / (9 + u) in Fp2
    b2=(
        19485874751759354771024239261021720505790618469301721065564631296452457478373,
        266929791119991161246907387137283842545076965332900288569378510910307636690,
    ),
    g2_x=(
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ),
    g2_y=(
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ),
    cofactor_g1=1,
    two_adicity=_BN254_TWO_ADICITY,
    native_root_of_unity=_find_two_adic_root(BN254_R, _BN254_TWO_ADICITY),
    # == native (smallest QNR = gnark's generator = 5); value equals the
    # published BN254 2^28 root 191032190679217139442913928276920700361...
    gnark_root_of_unity=pow(
        GNARK_FR_GENERATOR["bn254"], (BN254_R - 1) >> _BN254_TWO_ADICITY, BN254_R
    ),
    native_coset_shift=5,
    gnark_coset_shift=GNARK_FR_GENERATOR["bn254"],
    flag_style="msb2",
)

BLS12_381 = CurveParams(
    name="bls12_381",
    fp=BLS12_381_FP,
    fr=BLS12_381_FR,
    b=4,
    g1=(
        int(
            "17f1d3a73197d7942695638c4fa9ac0fc3688c4f9774b905a14e3a3f171bac58"
            "6c55e83ff97a1aeffb3af00adb22c6bb",
            16,
        ),
        int(
            "08b3f481e3aaa0f1a09e30ed741d8ae4fcf5e095d5d00af600db18cb2c04b3ed"
            "d03cc744a2888ae40caa232946c5e7e1",
            16,
        ),
    ),
    fp2_nonresidue=BLS12_381_P - 1,  # u^2 = -1
    b2=(4, 4),  # 4 * (1 + u)
    g2_x=(
        int(
            "024aa2b2f08f0a91260805272dc51051c6e47ad4fa403b02b4510b647ae3d177"
            "0bac0326a805bbefd48056c8c121bdb8",
            16,
        ),
        int(
            "13e02b6052719f607dacd3a088274f65596bd0d09920b61ab5da61bbdc7f5049"
            "334cf11213945d57e5ac7d055d042b7e",
            16,
        ),
    ),
    g2_y=(
        int(
            "0ce5d527727d6e118cc9cdc6da2e351aadfd9baa8cbdd3a76d429a695160d12c"
            "923ac9cc3baca289e193548608b82801",
            16,
        ),
        int(
            "0606c4a02ea734cc32acd2b02bc28b99cb3e287e85a763af267492ab572e99ab"
            "3f370d275cec1da1aaa9075ff05f79be",
            16,
        ),
    ),
    cofactor_g1=0xD201000000010001,
    two_adicity=_BLS_TWO_ADICITY,
    native_root_of_unity=_find_two_adic_root(BLS12_381_R, _BLS_TWO_ADICITY),
    # gnark/zkcrypto use generator 7; the resulting 2^32 root is the
    # published 0x16a2a19edfe81f20d09b681922c813b4b63683508c2280b93829971f439f0d2b
    gnark_root_of_unity=pow(
        GNARK_FR_GENERATOR["bls12_381"],
        (BLS12_381_R - 1) >> _BLS_TWO_ADICITY,
        BLS12_381_R,
    ),
    native_coset_shift=5,
    gnark_coset_shift=GNARK_FR_GENERATOR["bls12_381"],
    flag_style="zcash",
)

CURVES = {"bn254": BN254, "bls12_381": BLS12_381}


@functools.lru_cache(maxsize=None)
def domain_generator(curve_name: str, log_n: int) -> int:
    """Primitive 2^log_n-th root of unity of the curve's scalar field."""
    curve = CURVES[curve_name]
    if log_n > curve.two_adicity:
        raise ValueError(
            f"domain 2^{log_n} exceeds two-adicity {curve.two_adicity} of {curve_name}"
        )
    w = curve.root_of_unity
    for _ in range(curve.two_adicity - log_n):
        w = (w * w) % curve.fr.modulus
    return w

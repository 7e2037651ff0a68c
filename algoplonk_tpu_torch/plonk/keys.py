"""PLONK proving / verifying keys holding torch tensors.

Counterpart of the reference ``plonk/keys.py`` (:19-75), with the same
fields.  ``proving_key_from_jax`` carries a key built by the JAX package
across (limbs -> canonical ints -> words), the way weights are carried from
one framework to another.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..fields.params import CURVES, CurveParams
from ..fields.words import jax_limbs_to_mont_words, word_field


@dataclass
class VerifyingKey:
    curve: CurveParams
    size: int                 # domain size n (power of two)
    size_inv: int             # 1/n mod r
    generator: int            # omega
    coset_shift: int          # k1
    nb_public: int
    ql: tuple                 # G1 affine commitments (host int tuples)
    qr: tuple
    qm: tuple
    qo: tuple
    qk: tuple                 # commitment to the *incomplete* qk
    s1: tuple
    s2: tuple
    s3: tuple
    qcp: list                 # BSB22 selector commitments
    commitment_indexes: list  # rows of commitment constraints
    kzg_g1: tuple             # [1] G1
    kzg_g2: tuple             # ([1] G2, [tau] G2)


@dataclass
class ProvingKey:
    """Device-resident proving data: [n, W] int32 Montgomery words.

    qk and the sigma columns are kept in evaluation form (the grand product
    and the qk completion read them); every selector is kept in coefficient
    form (commitments, the quotient and the openings read those)."""

    curve: CurveParams
    n: int
    log_n: int
    omega: int
    coset_shift: int
    nb_public: int
    qk_ev: torch.Tensor
    s1_ev: torch.Tensor
    s2_ev: torch.Tensor
    s3_ev: torch.Tensor
    ql_c: torch.Tensor
    qr_c: torch.Tensor
    qm_c: torch.Tensor
    qo_c: torch.Tensor
    qk_c: torch.Tensor
    s1_c: torch.Tensor
    s2_c: torch.Tensor
    s3_c: torch.Tensor
    srs_g1: torch.Tensor                  # [n+3, 2, W] affine, Montgomery
    qcp_ev: list = field(default_factory=list)
    qcp_c: list = field(default_factory=list)
    vk: VerifyingKey | None = None

    @property
    def device(self) -> torch.device:
        return self.srs_g1.device


_FR_FIELDS = ("qk_ev", "s1_ev", "s2_ev", "s3_ev", "ql_c", "qr_c", "qm_c",
              "qo_c", "qk_c", "s1_c", "s2_c", "s3_c")


def verifying_key_from_jax(jvk) -> VerifyingKey:
    """The reference VerifyingKey (host ints) under the port's curve object."""
    fields = {name: getattr(jvk, name) for name in VerifyingKey.__dataclass_fields__}
    fields["curve"] = CURVES[jvk.curve.name]
    fields["qcp"] = list(jvk.qcp)
    fields["commitment_indexes"] = list(jvk.commitment_indexes)
    return VerifyingKey(**fields)


def proving_key_from_jax(jpk, device="cuda") -> ProvingKey:
    """Carry a reference ProvingKey (12-bit Montgomery limbs, R = 2^264)
    across to the port (32-bit Montgomery words, R = 2^256) on ``device``."""
    curve = CURVES[jpk.curve.name]
    fr, fp = word_field(curve.fr), word_field(curve.fp)

    def conv(arr, wf):
        return torch.from_numpy(jax_limbs_to_mont_words(np.asarray(arr), wf)).to(device)

    tensors = {name: conv(getattr(jpk, name), fr) for name in _FR_FIELDS}
    return ProvingKey(
        curve=curve,
        n=jpk.n,
        log_n=jpk.log_n,
        omega=jpk.omega,
        coset_shift=jpk.coset_shift,
        nb_public=jpk.nb_public,
        srs_g1=conv(jpk.srs_g1, fp),
        qcp_ev=[conv(x, fr) for x in jpk.qcp_ev],
        qcp_c=[conv(x, fr) for x in jpk.qcp_c],
        vk=verifying_key_from_jax(jpk.vk),
        **tensors,
    )

"""On-chain verifier code generation (PuyaPy) — reference L3 equivalent
(verifier/verifier.go).

Renders a complete PLONK+KZG verifier as PuyaPy source with the verifying key
baked in as constants, in four variants: {LogicSig, SmartContract} x
{BN254, BLS12-381}.  Templates live in tmpl_*.py.

Copied from ``algoplonk_tpu/verifier/codegen.py`` so that the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import enum

from ..plonk.keys import VerifyingKey

DEFAULT_FILE_NAME = "Verifier"


class ContractType(enum.Enum):
    LOGIC_SIG = "logicsig"
    SMART_CONTRACT = "smart_contract"


def write_python_code(vk: VerifyingKey, contract_type: ContractType, writer):
    from . import tmpl_bn254, tmpl_bls12_381

    if vk.curve.name == "bn254":
        src = tmpl_bn254.render(vk, contract_type)
    elif vk.curve.name == "bls12_381":
        src = tmpl_bls12_381.render(vk, contract_type)
    else:  # pragma: no cover
        raise ValueError(f"unsupported curve {vk.curve.name}")
    writer.write(src)

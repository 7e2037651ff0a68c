"""algoplonk_tpu_torch — the PLONK prover of ``algoplonk_tpu`` in PyTorch,
with its TPU kernels rewritten in CUDA for NVIDIA Hopper (sm_90a).

Top-level API, mirroring ``algoplonk_tpu/__init__.py`` with an explicit
device:

    cc = compile(MyCircuit, BN254, SetupName.TEST_ONLY_BN254)   # on the card
    vp = cc.verify(MyCircuit(a=3, b=4, c=5))       # prove + self-verify
    cc.write_puyapy_verifier("Verifier.py", ContractType.LOGIC_SIG)
    vp.export_proof_and_public_inputs("proof.bin", "public_inputs.bin")

Both of AlgoPlonk's curves are served, BN254 and BLS12-381.  Every entry
point runs on the CUDA device unless the caller passes ``device="cpu"``;
``compile`` refuses to start without a card rather than fall back to the
host.

The package imports torch and never jax, nor anything of ``algoplonk_tpu``:
the reference modules that need no jax (fields, frontend, host, the
transcript, the setup registry) are copied here.  Circuits for this package
subclass *its* ``Circuit`` and use *its* inputs.

On a CPU tensor every op, kernels included, runs plain PyTorch; on a CUDA
tensor the kernels (``ops/curve_kernels.py``, ``ops/ntt_kernels.py``) are
built with nvcc at first use and launched.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from .fields.params import (
    BLS12_381,
    BN254,
    CurveParams,
    gnark_compat_enabled,
    set_gnark_compat,
)
from .frontend.api import (
    Circuit,
    CompiledConstraintSystem,
    PublicInput,
    SecretInput,
    compile_circuit,
)
from .frontend import witness as witness_mod
from .plonk import marshal as marshal_mod
from .plonk import verify as verify_mod
from .plonk.keys import ProvingKey, VerifyingKey
from .plonk.prove import Proof, Prover
from .setups.registry import test_only_setup
from .setups.srs import SetupName, get as get_setup, run_setup
from .utils import profiling
from .verifier.codegen import ContractType, write_python_code

__all__ = [
    "BN254",
    "BLS12_381",
    "Circuit",
    "PublicInput",
    "SecretInput",
    "SetupName",
    "ContractType",
    "CompiledCircuit",
    "VerifiedProof",
    "compile",
    "test_only_setup",
    "set_gnark_compat",
    "gnark_compat_enabled",
]


@dataclass
class CompiledCircuit:
    """Compiled circuit with its proving and verifying keys."""

    ccs: CompiledConstraintSystem
    pk: ProvingKey
    vk: VerifyingKey
    curve: CurveParams

    def verify(self, assignment) -> "VerifiedProof":
        """Prove + self-verify (every proof is checked with the native
        verifier before export).  One request of ``utils/profiling.py``'s
        recorder: spans ``verify`` (the root), ``solve``, ``prove`` and
        ``self_verify``."""
        with profiling.request("verify"):
            prover = Prover(self.pk, self.ccs)
            wit = witness_mod.solve(self.ccs, assignment, commitment_solver=prover.bsb_solver)
            proof = prover.prove(wit)
            with profiling.span("self_verify"):
                ok = verify_mod.verify(self.vk, proof, wit.public_values)
            if not ok:
                raise RuntimeError("proof failed native verification")
            return VerifiedProof(proof, wit, self.curve, dict(prover.phase_seconds))

    def write_puyapy_verifier(self, filepath: str, output_type: "ContractType"):
        """Emit PuyaPy verifier source (reference algoplonk.go:63-76)."""
        with open(filepath, "w") as fh:
            write_python_code(self.vk, output_type, fh)


@dataclass
class VerifiedProof:
    """A proof plus its witness; ``phase_seconds`` times the prove rounds
    (empty where the proof was not made by ``CompiledCircuit.verify``)."""

    proof: Proof
    witness: witness_mod.Witness
    curve: CurveParams
    phase_seconds: dict = field(default_factory=dict)

    def marshal_proof(self) -> bytes:
        return marshal_mod.marshal_proof(self.curve, self.proof)

    def marshal_public_inputs(self) -> bytes:
        return self.witness.public_inputs_blob()

    def export_proof_and_public_inputs(self, proof_path: str, public_inputs_path: str):
        """Write the AVM binary blobs."""
        if proof_path:
            with open(proof_path, "wb") as fh:
                fh.write(self.marshal_proof())
        if public_inputs_path:
            with open(public_inputs_path, "wb") as fh:
                fh.write(self.marshal_public_inputs())


def compile(circuit_cls, curve: CurveParams, setup_name: SetupName,
            device="cuda") -> CompiledCircuit:
    """Compile a circuit and run the (trusted or test-only) setup, with the
    keys on ``device`` (the CUDA device unless the caller asks for the
    CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device=\"cpu\" to compile and prove on the host"
        )
    info = get_setup(setup_name)
    if info is None:
        raise ValueError(f"unknown setup: {setup_name}")
    if info.curve.name != curve.name:
        raise ValueError(
            f"setup curve {info.curve.name} does not match circuit curve {curve.name}"
        )
    ccs = compile_circuit(circuit_cls, curve)
    srs = run_setup(curve, setup_name, ccs.nb_constraints, ccs.nb_public, device)
    from .plonk.setup import setup as plonk_setup

    pk, vk = plonk_setup(ccs, srs)
    return CompiledCircuit(ccs=ccs, pk=pk, vk=vk, curve=curve)

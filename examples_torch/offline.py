"""What every example does after proving: run the emitted PuyaPy verifier
offline under the port's AVM mock (``chain/algopy_mock.py``) on the
exported blobs, the no-localnet counterpart of the reference's simulate."""

from __future__ import annotations

import time

from algoplonk_tpu_torch import ContractType
from algoplonk_tpu_torch.chain import algopy_mock as mock


def run_emitted(verifier_py: str, ctype: ContractType, proof_path: str,
                public_inputs_path: str) -> dict:
    """Execute the verifier source at ``verifier_py`` under the mock on the
    proof and public-input blobs.  Returns ``accepted``, the three paths
    and the mock's approximate ``opcode_budget`` of the run."""
    with open(verifier_py) as fh:
        ns = mock.exec_verifier_source(fh.read())
    with open(proof_path, "rb") as fh:
        proof = fh.read()
    with open(public_inputs_path, "rb") as fh:
        publics = fh.read()
    run = mock.run_logicsig if ctype is ContractType.LOGIC_SIG else mock.run_contract_verify
    mock.budget.reset()
    t0 = time.perf_counter()
    accepted = run(ns, proof, publics)
    return {
        "accepted": accepted,
        "verifier": verifier_py,
        "proof": proof_path,
        "public_inputs": public_inputs_path,
        "opcode_budget": mock.budget.consumed(),
        "mock_seconds": time.perf_counter() - t0,
    }

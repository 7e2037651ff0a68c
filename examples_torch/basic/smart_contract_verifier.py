"""Basic example, smart-contract verifier variant, on the PyTorch/CUDA port
(the counterpart of examples/basic/smart_contract_verifier.py, after the
reference's examples/basic/smartContractVerifier/main.go): BLS12-381 on
the real Ethereum KZG ceremony setup, ARC4 contract output.

    python3 examples_torch/basic/smart_contract_verifier.py

proves on the CUDA device; ``main(device="cpu")`` proves on the host.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import algoplonk_tpu_torch as apt
from examples_torch.basic.logicsig_verifier import BasicCircuit  # same circuit
from examples_torch.offline import run_emitted


def main(device=None, outdir=None) -> dict:
    outdir = outdir or os.path.join(os.path.dirname(__file__), "generated")
    os.makedirs(outdir, exist_ok=True)
    print("compiling circuit (BLS12-381, Ethereum KZG ceremony)...")
    t0 = time.perf_counter()
    cc = apt.compile(BasicCircuit, apt.BLS12_381, apt.SetupName.ETHEREUM_KZG_CEREMONY_BLS12_381,
                     device="cuda" if device is None else device)
    t_compile = time.perf_counter() - t0
    path = os.path.join(outdir, "BasicSmartContractVerifier.py")
    cc.write_puyapy_verifier(path, apt.ContractType.SMART_CONTRACT)
    print(f"wrote {path}")
    t0 = time.perf_counter()
    vp = cc.verify(BasicCircuit(a=3, b=4, c=5))
    t_prove = time.perf_counter() - t0
    proof_path = os.path.join(outdir, "sc_proof.bin")
    pi_path = os.path.join(outdir, "sc_public_inputs.bin")
    vp.export_proof_and_public_inputs(proof_path, pi_path)

    result = run_emitted(path, apt.ContractType.SMART_CONTRACT, proof_path, pi_path)
    result.update(compile_seconds=t_compile, prove_seconds=t_prove)
    print(f"offline mock execution of the emitted verifier: accepted={result['accepted']}, "
          f"opcode budget {result['opcode_budget']}")
    print("done")
    return result


if __name__ == "__main__":
    sys.exit(0 if main()["accepted"] else 1)

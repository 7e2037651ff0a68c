"""Merkle example, smart-contract verifier variant, on the PyTorch/CUDA
port (the counterpart of examples/merkle/smart_contract_verifier.py, after
the reference's examples/merkle/smartContractVerifier/main.go): BN254,
test-only setup, ARC4 contract output.  MERKLE_DEPTH as in its sibling.

    python3 examples_torch/merkle/smart_contract_verifier.py

proves on the CUDA device; ``main(device="cpu")`` proves on the host.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import algoplonk_tpu_torch as apt
from examples_torch.merkle.logicsig_verifier import MerkleCircuit, inclusion
from examples_torch.offline import run_emitted


def main(device=None, outdir=None) -> dict:
    outdir = outdir or os.path.join(os.path.dirname(__file__), "generated")
    os.makedirs(outdir, exist_ok=True)
    values, t_tree = inclusion(3)
    print("compiling circuit (BN254, test-only setup)...")
    t0 = time.perf_counter()
    cc = apt.compile(MerkleCircuit, apt.BN254, apt.SetupName.TEST_ONLY_BN254,
                     device="cuda" if device is None else device)
    t_compile = time.perf_counter() - t0
    path = os.path.join(outdir, "MerkleSmartContractVerifier.py")
    cc.write_puyapy_verifier(path, apt.ContractType.SMART_CONTRACT)
    print(f"wrote {path}")
    t0 = time.perf_counter()
    vp = cc.verify(MerkleCircuit(**values))
    t_prove = time.perf_counter() - t0
    proof_path = os.path.join(outdir, "merkle_sc_proof.bin")
    pi_path = os.path.join(outdir, "merkle_sc_public_inputs.bin")
    vp.export_proof_and_public_inputs(proof_path, pi_path)

    result = run_emitted(path, apt.ContractType.SMART_CONTRACT, proof_path, pi_path)
    result.update(tree_seconds=t_tree, compile_seconds=t_compile, prove_seconds=t_prove,
                  domain=cc.vk.size)
    print(f"offline mock execution of the emitted verifier: accepted={result['accepted']}, "
          f"opcode budget {result['opcode_budget']}")
    print("done")
    return result


if __name__ == "__main__":
    sys.exit(0 if main()["accepted"] else 1)

"""Merkle example: prove inclusion of a secret leaf in a public Merkle root
(MiMC hashing), BN254, on the PyTorch/CUDA port (the counterpart of
examples/merkle/logicsig_verifier.py, after the reference's
examples/merkle/logicsigVerifier/main.go) with a 16-level tree.

Set MERKLE_DEPTH (read at import) to a smaller value for quick runs; the
leaf index is taken modulo the tree's width, so that depths 1 and 2 run
too (5 from depth 3 on).

    python3 examples_torch/merkle/logicsig_verifier.py

proves on the CUDA device; ``main(device="cpu")`` proves on the host.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import algoplonk_tpu_torch as apt
from algoplonk_tpu_torch.frontend.gadgets.merkle import verify_merkle_proof
from algoplonk_tpu_torch.host import mimc as hm
from examples_torch.offline import run_emitted

DEPTH = int(os.environ.get("MERKLE_DEPTH", "16"))


class MerkleCircuit(apt.Circuit):
    root = apt.PublicInput()
    leaf = apt.SecretInput()
    siblings = apt.SecretInput(shape=DEPTH)
    directions = apt.SecretInput(shape=DEPTH)

    def define(self, api):
        verify_merkle_proof(
            api, apt.BN254, self.root, self.leaf, self.siblings, self.directions
        )


def inclusion(index: int):
    """The tree of leaves 1 .. 2^DEPTH and the assignment that proves leaf
    ``index`` (modulo the width) is under its root.  Returns (the
    assignment's values by input name, seconds spent hashing on the host)."""
    n_leaves = 1 << DEPTH
    print(f"building a depth-{DEPTH} MiMC Merkle tree ({n_leaves} leaves)...")
    t0 = time.perf_counter()
    leaves = list(range(1, n_leaves + 1))
    index %= n_leaves
    root = hm.merkle_root(apt.BN254, leaves)
    sibs, dirs = hm.merkle_path(apt.BN254, leaves, index)
    values = dict(root=root, leaf=leaves[index], siblings=sibs, directions=dirs)
    return values, time.perf_counter() - t0


def main(device=None, outdir=None) -> dict:
    outdir = outdir or os.path.join(os.path.dirname(__file__), "generated")
    os.makedirs(outdir, exist_ok=True)
    values, t_tree = inclusion(5)

    print("compiling circuit (BN254, test-only setup)...")
    t0 = time.perf_counter()
    cc = apt.compile(MerkleCircuit, apt.BN254, apt.SetupName.TEST_ONLY_BN254,
                     device="cuda" if device is None else device)
    t_compile = time.perf_counter() - t0
    print(f"constraints: {cc.ccs.nb_constraints}, domain: {cc.vk.size}")

    verifier_py = os.path.join(outdir, "MerkleVerifier.py")
    cc.write_puyapy_verifier(verifier_py, apt.ContractType.LOGIC_SIG)
    print(f"wrote {verifier_py}")

    print(f"proving inclusion of leaf {values['leaf']} ...")
    t0 = time.perf_counter()
    vp = cc.verify(MerkleCircuit(**values))
    t_prove = time.perf_counter() - t0
    proof_path = os.path.join(outdir, "merkle_proof.bin")
    pi_path = os.path.join(outdir, "merkle_public_inputs.bin")
    vp.export_proof_and_public_inputs(proof_path, pi_path)

    result = run_emitted(verifier_py, apt.ContractType.LOGIC_SIG, proof_path, pi_path)
    result.update(tree_seconds=t_tree, compile_seconds=t_compile, prove_seconds=t_prove,
                  domain=cc.vk.size)
    print(f"offline mock execution of the emitted verifier: accepted={result['accepted']}, "
          f"opcode budget {result['opcode_budget']}")
    print("done")
    return result


if __name__ == "__main__":
    sys.exit(0 if main()["accepted"] else 1)

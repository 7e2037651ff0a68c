"""Basic example: Pythagorean circuit with a logicsig verifier, on the
PyTorch/CUDA port (the counterpart of examples/basic/logicsig_verifier.py,
after the reference's examples/basic/logicsigVerifier/main.go).

compile -> write verifier -> (optionally) puyapy-compile -> prove -> export
blobs -> run the emitted verifier offline under the AVM mock.  The puyapy
compile runs only where algokit is installed.

    python3 examples_torch/basic/logicsig_verifier.py

proves on the CUDA device; ``main(device="cpu")`` proves on the host.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import algoplonk_tpu_torch as apt
from algoplonk_tpu_torch.utils import toolchain
from examples_torch.offline import run_emitted


class BasicCircuit(apt.Circuit):
    """Prove we know c such that a^2 + b^2 = c^2 (a, b public; c secret)."""

    a = apt.PublicInput()
    b = apt.PublicInput()
    c = apt.SecretInput()

    def define(self, api):
        api.assert_is_equal(
            api.add(api.mul(self.a, self.a), api.mul(self.b, self.b)),
            api.mul(self.c, self.c),
        )


def main(device=None, outdir=None) -> dict:
    outdir = outdir or os.path.join(os.path.dirname(__file__), "generated")
    os.makedirs(outdir, exist_ok=True)

    print("compiling circuit (BLS12-381, test-only setup)...")
    t0 = time.perf_counter()
    cc = apt.compile(BasicCircuit, apt.BLS12_381, apt.SetupName.TEST_ONLY_BLS12_381,
                     device="cuda" if device is None else device)
    t_compile = time.perf_counter() - t0

    verifier_py = os.path.join(outdir, "BasicVerifier.py")
    cc.write_puyapy_verifier(verifier_py, apt.ContractType.LOGIC_SIG)
    print(f"wrote {verifier_py}")

    print("proving a=3, b=4, c=5 ...")
    t0 = time.perf_counter()
    vp = cc.verify(BasicCircuit(a=3, b=4, c=5))
    t_prove = time.perf_counter() - t0
    proof_path = os.path.join(outdir, "proof.bin")
    pi_path = os.path.join(outdir, "public_inputs.bin")
    vp.export_proof_and_public_inputs(proof_path, pi_path)
    print(f"wrote {proof_path} ({os.path.getsize(proof_path)} B), "
          f"{pi_path} ({os.path.getsize(pi_path)} B)")

    result = run_emitted(verifier_py, apt.ContractType.LOGIC_SIG, proof_path, pi_path)
    result.update(compile_seconds=t_compile, prove_seconds=t_prove)
    print(f"offline mock execution of the emitted verifier: accepted={result['accepted']}, "
          f"opcode budget {result['opcode_budget']}")

    if toolchain.have_algokit():
        print("compiling verifier with puyapy...")
        toolchain.compile_with_puyapy(verifier_py)
        toolchain.rename_puyapy_output("Verifier", "BasicVerifier", outdir)
        print("TEAL written; run the localnet flow via chain/testutils.py")
    else:
        print("algokit not installed - skipping on-chain steps")
    print("done")
    return result


if __name__ == "__main__":
    sys.exit(0 if main()["accepted"] else 1)

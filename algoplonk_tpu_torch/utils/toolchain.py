"""PuyaPy toolchain integration + ABI argument encoding
(reference utils/utils.go:22-86,162-224).

`algokit compile py` is an external tool; every shell-out is gated on its
presence with a clear error so the rest of the framework works without it.

Copied from ``algoplonk_tpu/utils/toolchain.py`` so that the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import os
import shutil
import subprocess


class ToolchainError(RuntimeError):
    pass


def have_algokit() -> bool:
    return shutil.which("algokit") is not None


def compile_with_puyapy(path: str, options: str = "") -> None:
    """Compile PuyaPy source to TEAL via `algokit compile py`
    (reference utils/utils.go:22-34)."""
    if not have_algokit():
        raise ToolchainError(
            "algokit not found on PATH; install algokit + puyapy to compile "
            "generated verifiers (https://github.com/algorandfoundation/algokit-cli)"
        )
    cmd = ["algokit", "compile", "py", path] + (options.split() if options else [])
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise ToolchainError(
            f"puyapy compilation failed:\n{res.stdout}\n{res.stderr}"
        )


def rename_puyapy_output(old_name: str, new_name: str, directory: str) -> None:
    """Rename PuyaPy outputs <old>.teal / <old>.approval.teal / ... to the
    user's name (reference utils/utils.go:40-64)."""
    suffixes = [
        ".teal", ".approval.teal", ".clear.teal", ".arc56.json",
        ".approval.puya.map", ".clear.puya.map", ".puya.map",
    ]
    for sfx in suffixes:
        old = os.path.join(directory, old_name + sfx)
        if os.path.exists(old):
            os.replace(old, os.path.join(directory, new_name + sfx))


def should_recompile(source: str, *artifacts: str) -> bool:
    """mtime-based staleness check (reference utils/utils.go:68-86):
    recompile if any artifact is missing or older than the source."""
    if not os.path.exists(source):
        return True
    src_m = os.path.getmtime(source)
    for art in artifacts:
        if not os.path.exists(art) or os.path.getmtime(art) < src_m:
            return True
    return False


# ---------------------------------------------------------------- ABI args


def chunks32(data: bytes) -> list[bytes]:
    if len(data) % 32 != 0:
        raise ValueError("data must be 32-byte aligned")
    return [data[i : i + 32] for i in range(0, len(data), 32)]


def proof_and_public_inputs_for_atomic_composer(proof: bytes, public_inputs: bytes):
    """[proof_chunks, public_input_chunks] for an AtomicTransactionComposer
    method call (reference utils/utils.go:162-172)."""
    return [chunks32(proof), chunks32(public_inputs)]


def abi_encode_byte32_array(data: bytes) -> bytes:
    """ARC4 encoding of byte[32][]: u16 big-endian count + elements
    (reference utils/utils.go:196-211)."""
    cs = chunks32(data)
    return len(cs).to_bytes(2, "big") + b"".join(cs)


def abi_encode_proof_and_public_inputs(proof: bytes, public_inputs: bytes):
    return [
        abi_encode_byte32_array(proof),
        abi_encode_byte32_array(public_inputs),
    ]

"""Batch proving: many witnesses of one circuit, proved at once.

Counterpart of the reference ``parallel/batch_prove.py``, which pins proof i
to ``devices[i % D]`` and drives each device from a host thread.  Here each
of ``min(len(devices), len(assignments))`` workers is a host thread with its
own CUDA stream on its device, and proves its share of the assignments in
turn; devices may repeat, so ``devices=["cuda:0"] * 4`` is four provers
sharing one card, each launching on its own stream.  A prove is host work
(witness solving, Fiat-Shamir, the kernels' launches) between device
kernels, so what the streams can overlap is one prover's host work with the
others' device work, as far as the interpreter lock lets the threads run.

Each distinct device gets one copy of the proving key, made before the
workers start, and the devices are synchronised then, so that the keys,
written on the default stream, are complete before any worker's stream
reads them.  Each proof is one request of ``utils/profiling.py``'s
recorder, its tree built by its worker's thread, as
``CompiledCircuit.verify`` builds one; the launch counters of ``ops/`` are
exact under the workers' threads.
"""

from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor

import torch

from .mesh import on_device, resolve_device


def prove_batch(cc, assignments, devices=None, self_verify: bool = True, rng=None):
    """Prove every assignment against one CompiledCircuit, proof i on
    ``devices[i % len(devices)]`` (default: every CUDA device; without a
    card this raises unless the caller passes ``["cpu"]``).

    Returns the VerifiedProofs in assignment order; a proof that fails the
    native verifier raises RuntimeError.  ``rng`` follows the Prover's
    semantics (None: blinding from ``secrets``; False: none, so every proof
    is byte-equal to the sequential prover's)."""
    from .. import VerifiedProof
    from ..frontend import witness as witness_mod
    from ..plonk import verify as verify_mod
    from ..plonk.prove import Prover
    from ..utils import profiling

    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass devices=[\"cpu\"] to prove on the host")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if not devices:
        raise ValueError("prove_batch needs at least one device")
    assignments = list(assignments)
    keys = {}
    for dev in devices:
        if dev not in keys:
            keys[dev] = cc.pk.to(dev)
    for dev in keys:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def one(i, dev):
        with profiling.request("verify"):
            prover = Prover(keys[dev], cc.ccs, rng=rng)
            wit = witness_mod.solve(cc.ccs, assignments[i], commitment_solver=prover.bsb_solver)
            proof = prover.prove(wit)
            if self_verify:
                with profiling.span("self_verify"):
                    ok = verify_mod.verify(cc.vk, proof, wit.public_values)
                if not ok:
                    raise RuntimeError(f"proof {i} failed native verification")
            return VerifiedProof(proof, wit, cc.curve, dict(prover.phase_seconds))

    n_workers = min(len(devices), len(assignments))

    def worker(w):
        dev = devices[w]
        stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        ctx = torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()
        with on_device(dev), ctx:
            out = [(i, one(i, dev)) for i in range(w, len(assignments), n_workers)]
        if stream is not None:
            stream.synchronize()
        return out

    results = [None] * len(assignments)
    with ThreadPoolExecutor(max_workers=max(n_workers, 1)) as ex:
        futures = [ex.submit(worker, w) for w in range(n_workers)]
        for fut in futures:
            for i, vp in fut.result():
                results[i] = vp
    return results

"""What decides ``correct``: every proof of the window, judged by the plain
reference (benchmark/reference/) against keys it worked out itself.

For each proof attempted in the window, by the assignment it was made for:
  - the public-input blob must be the reference's encoding of the public
    inputs it expects from the assignment (circuits/<name>.py ``publics``);
  - the proof must parse as the AVM layout and verify, with those public
    inputs, under the reference's keys (reference/plonk.py);
  - a proof that never came, or whose call raised, is bad too.
For a sample of the verified proofs, drawn from the seed, the left wire
commitment must differ from the unblinded wire polynomial's (the
configuration's zero-knowledge guarantee; the program blinds from
``secrets``, so a blinded proof equals it with probability 1/r).

The one number compared is ``bad_proofs``, the count of proofs that fail
any of these, with the limit 0.
"""

from __future__ import annotations

import random
import time

from ..reference import curves as RC
from ..reference import frontend as RF
from ..reference import plonk as RP

BLINDING_SAMPLE = 2     # proofs per run whose blinding is checked
LIMITS = {"bad_proofs": 0}


def tau_for(cfg: dict, curve) -> int:
    if not cfg["setup"].startswith("TEST_ONLY"):
        raise ValueError(f"the reference checks proofs on the test setups only, not {cfg['setup']}")
    return curve.test_tau()


def check(cfg: dict, circuit, items, seed: int) -> dict:
    """``items``: (assignment, proof bytes or None, public blob or None).
    Returns the counts by fault, ``bad_proofs``, and the seconds taken."""
    t0 = time.perf_counter()
    curve = RC.CURVES[cfg["curve"]]
    ccs = RF.compile_circuit(circuit.circuit(RF, cfg), curve)
    keys = RP.keys(ccs, curve, tau_for(cfg, curve))
    ncom = len(ccs.commitments)
    counts = {"missing": 0, "public_inputs": 0, "malformed": 0, "rejected": 0, "unblinded": 0}
    verified = []
    for assignment, proof, pub in items:
        if proof is None:
            counts["missing"] += 1
            continue
        want = circuit.publics(cfg, curve.r, assignment)
        if pub != b"".join(x.to_bytes(32, "big") for x in want):
            counts["public_inputs"] += 1
            continue
        try:
            pf = RP.parse_proof(curve, proof, ncom)
        except ValueError:
            counts["malformed"] += 1
            continue
        if not RP.verify(keys, pf, want):
            counts["rejected"] += 1
            continue
        verified.append((assignment, pf))
    rng = random.Random(seed)
    for assignment, pf in rng.sample(verified, min(BLINDING_SAMPLE, len(verified))):
        bsb = iter(pf.bsb)
        values = RF.solve(ccs, assignment, commitment_solver=lambda info, committed:
                          RP.hash_to_fr(curve, RC.encode_g1(curve, next(bsb))))
        if RC.mul(curve, curve.g1, RP.wire_l_at_tau(keys, ccs, values)) == pf.L:
            counts["unblinded"] += 1
    counts["bad_proofs"] = sum(counts.values())
    counts["blinding_checked"] = min(BLINDING_SAMPLE, len(verified))
    counts["seconds"] = time.perf_counter() - t0
    return counts

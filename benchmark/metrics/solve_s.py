"""solve_s (API layer): the program's ``solve`` span (frontend/witness.py,
the witness solve on host ints, with ``bsb_commit``, the BSB22 device
commit that the prover's solver hook makes inside it), seconds per proof
of the traced window (core/program_spans.py)."""

from benchmark.core.program_spans import spans_per_proof


def read(run):
    return spans_per_proof(run, "solve")

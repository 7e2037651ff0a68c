"""self_verify_s (API layer): the program's ``self_verify`` span, the
native verifier's check of each proof inside ``CompiledCircuit.verify``,
seconds per proof of the traced window (core/program_spans.py)."""

from benchmark.core.program_spans import spans_per_proof


def read(run):
    return spans_per_proof(run, "self_verify")

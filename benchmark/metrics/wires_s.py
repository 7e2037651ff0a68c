"""wires_s (prover rounds): the program's ``wires`` span inside round 1
(``wire_values``, three columns of n host ints, and their three
``FieldOps.encode``), seconds per proof of the traced window
(core/program_spans.py)."""

from benchmark.core.program_spans import spans_per_proof


def read(run):
    return spans_per_proof(run, "wires", parent="r1")

"""radix2_ntt_s (ntt): the program's ``ntt.radix2`` spans, one around each
radix-2 transform of ``NttPlan`` (ops/ntt.py: the size-n iNTTs of rounds
1 to 3, and below the four-step threshold round 3's 4n coset lifts and
its final coset iNTT), seconds per proof of the traced window
(core/program_spans.py).  None where the program records no such span."""

from benchmark.core.program_spans import spans_per_proof


def read(run):
    return spans_per_proof(run, "ntt.radix2")

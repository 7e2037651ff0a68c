"""r1_s (prover rounds): round 1's host seconds (wire vectors, three
iNTTs, three commits), from the prover's ``phase_seconds``; the mean over
the window's proofs."""

from benchmark.core.readers import phase_mean


def read(run):
    return phase_mean(run, "r1")

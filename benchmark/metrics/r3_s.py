"""r3_s (prover rounds, quotient): round 3's host seconds, from the
prover's ``phase_seconds``; the mean over the window's proofs."""

from benchmark.core.readers import phase_mean


def read(run):
    return phase_mean(run, "r3")

"""The end-to-end metrics, which the benchmark takes by the host's clock
itself.  A rate divides the proofs completed in the window by the
window's whole time, to the end of the last request started in it."""

from __future__ import annotations


def proofs_per_s(run) -> float:
    return len(run.done) / run.window_s


def setup_s(run) -> float:
    return run.setup_s


READERS = {
    "proofs_per_s": proofs_per_s,
    "batch_proofs_per_s": proofs_per_s,
    "setup_s": setup_s,
}

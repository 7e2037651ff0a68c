"""dispatch_s (field ops and dispatch): the host seconds spent inside the
port's kernel wrappers (ops/field_kernels.py, ops/curve_kernels.py,
ops/ntt_kernels.py; from each wrapper's entry to its return), as the
program's recorder charges them to its spans, summed over each request of
the traced window, per proof (core/program_spans.py).  Logs the launches
and the wrapper seconds by round per proof on stderr."""

import sys

from benchmark.core.program_spans import by_round, window_requests


def read(run):
    reqs = window_requests(run)
    if reqs is None:
        return None
    rounds = by_round(reqs)
    print("launches and wrapper seconds by round, per proof: " + "; ".join(
        f"{k} {n / len(reqs):.1f} {ns * 1e-9 / len(reqs):.6f} s"
        for k, (n, ns) in sorted(rounds.items())), file=sys.stderr)
    if not rounds:
        return None
    return sum(ns for _, ns in rounds.values()) * 1e-9 / len(reqs)

"""host_ints_per_proof (prover rounds): the Python ints the program packs
for the device (``FieldOps.encode``), as its recorder charges them to its
spans (``host_ints``), summed over each request of the traced window, per
proof (core/program_spans.py).  Logs the ints by span per proof on stderr.
None from a program whose spans have no such count."""

import sys

from benchmark.core.program_spans import top_round, window_requests


def read(run):
    reqs = window_requests(run)
    if reqs is None:
        return None
    spans = [sp for q in reqs for sp in q.spans]
    if not spans or not all(hasattr(sp, "host_ints") for sp in spans):
        return None
    by_span: dict = {}
    for sp in spans:
        if sp.host_ints:
            top = top_round(sp)
            key = top if top == sp.name else f"{top}/{sp.name}"
            by_span[key] = by_span.get(key, 0) + sp.host_ints
    print("host ints by span, per proof: " + "; ".join(
        f"{k} {v / len(reqs):.1f}" for k, v in sorted(by_span.items())), file=sys.stderr)
    return sum(by_span.values()) / len(reqs)

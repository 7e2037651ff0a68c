"""r3_idle_share (prover rounds): 100 (1 - busy / duration) of the device
inside the program's ``r3`` spans of the traced window: the union of the
window's device records clipped to each span (on the device's clock, by
the window's marker offset), over the spans' total time.  High: round 3
waits on its launches' host cost; low: on its kernels (K9, K8).  Read
only where idle_share.seq's record check holds.  Logs the window's idle
seconds by innermost program span on stderr (core/program_spans.py)."""

import sys

from benchmark.core import trace
from benchmark.core.program_spans import idle_by_span, records_hold, window_requests


def read(run):
    if run.trace_data is None or not records_hold(run):
        return None
    reqs = window_requests(run)
    if reqs is None:
        return None
    off = run.trace_data["offset_ns"]
    merged = trace.union(run.trace_data["records"])
    busy = total = 0
    for q in reqs:
        for sp in q.spans:
            if sp.name == "r3":
                busy += trace.busy_ns(trace.clip(merged, sp.start + off, sp.end + off))
                total += sp.end - sp.start
    print("idle seconds by innermost program span: " + "; ".join(
        f"{label} {s:.6f}" for label, s in idle_by_span(run, reqs)), file=sys.stderr)
    return 100.0 * (1.0 - busy / total) if total else None

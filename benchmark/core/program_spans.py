"""What the per-layer readers take from the program's own recorder
(``algoplonk_tpu_torch/utils/profiling.py``): its spans, each with its
parent, request and thread, the kernel launches made while it was the
innermost open span and the host time spent in the kernel wrappers for
them.

The recorder is on while a torch profiler records, so it records the
traced window's requests (core/trace.py's ``Capture``) and not those of
the untraced runs.  A request belongs to the window where its root span
overlaps the benchmark's own spans around the program's calls
(``run.spans`` less ``marshal``: those wrappers come off before the probe
request traced after the window, while ``Run.marshal`` adds a span for
the probe's proof too, so the probe is left out).  A reader
reads nothing unless the recorder holds exactly one request per proof
done in the window, and nothing from a program without the recorder: it
returns None there and never raises.
"""

from __future__ import annotations

import sys

from . import trace as trace_mod
from .readers import LOST_RECORDS, records_check

ROUNDS = ("r1", "r2", "r3", "r4", "r5")


def window_requests(run):
    """The recorder's requests in the window, or None unless there is one
    for each proof done there."""
    try:
        from algoplonk_tpu_torch.utils.profiling import RECORDER
    except ImportError:
        return None
    calls = [s for s in run.spans.items if s[0] != "marshal"]
    if not calls or not run.done:
        return None
    lo = min(s[1] for s in calls)
    hi = max(s[2] for s in calls)
    reqs = [q for q in RECORDER.requests() if q.start <= hi and q.end >= lo]
    if len(reqs) != len(run.done):
        print(f"program spans: {len(reqs)} requests in the window, {len(run.done)} proofs done",
              file=sys.stderr)
        return None
    return reqs


def spans_per_proof(run, name: str, parent: str | None = None):
    """The seconds of the window's spans named ``name`` (inside a span
    named ``parent``, where given) per proof done, or None where there
    are none."""
    reqs = window_requests(run)
    if reqs is None:
        return None
    durs = [sp.end - sp.start for q in reqs for sp in q.spans
            if sp.name == name and (parent is None or (sp.parent is not None
                                                       and sp.parent.name == parent))]
    return sum(durs) * 1e-9 / len(reqs) if durs else None


def records_hold(run) -> bool:
    """idle_share.seq's record check: the trace holds the port's launches
    as its counters (exact in one thread) saw them, less at most
    LOST_RECORDS."""
    got = records_check(run)
    if got is None:
        return False
    recs, launches = got
    return launches > 0 and (1 - LOST_RECORDS) * launches <= recs <= launches


def top_round(sp) -> str:
    """The round (r1..r5) a span lies in, else the name of its outermost
    span below the request's root."""
    while sp.parent is not None and sp.name not in ROUNDS:
        if sp.parent.parent is None:
            return sp.name
        sp = sp.parent
    return sp.name


def by_round(reqs) -> dict:
    """{round: [launches, dispatch ns]} of the requests' spans, summed."""
    out: dict = {}
    for q in reqs:
        for sp in q.spans:
            if sp.launches:
                acc = out.setdefault(top_round(sp), [0, 0])
                acc[0] += sum(sp.launches.values())
                acc[1] += sp.dispatch_ns
    return out


def innermost_segments(reqs) -> list:
    """[(start, end, label)] of host time, sorted and disjoint, labelled by
    the innermost span open there: its path of names from the request's
    root down."""
    segs = []
    for q in reqs:
        kids: dict = {}
        for sp in q.spans[1:]:
            kids.setdefault(id(sp.parent), []).append(sp)
        todo = [(q.root, q.root.name)]
        while todo:
            sp, path = todo.pop()
            t = sp.start
            for c in sorted(kids.get(id(sp), ()), key=lambda c: c.start):
                if c.start > t:
                    segs.append((t, c.start, path))
                todo.append((c, f"{path}/{c.name}"))
                t = max(t, c.end)
            if sp.end > t:
                segs.append((t, sp.end, path))
    segs.sort()
    return segs


def idle_by_span(run, reqs, top: int = 40) -> list:
    """[[label, seconds]] of the device's idle time from the first
    request's start to the last one's end, by the innermost program span
    open on the host (core/trace.py's split; outside every span
    'harness')."""
    td = run.trace_data
    off = td["offset_ns"]
    lo, hi = min(q.start for q in reqs), max(q.end for q in reqs)
    merged = trace_mod.union(td["records"])
    idle = [[a - off, b - off] for a, b in trace_mod.gaps(merged, lo + off, hi + off)]
    return trace_mod.idle_by_label(idle, innermost_segments(reqs), top=top)

"""Shared arithmetic of the per-layer readers in benchmark/metrics/: means
over the window's proofs, the trace's record check, and a kernel's share
of its roofline."""

from __future__ import annotations

import sys

from .roofline import Bound, peaks_for
from .trace import kernel_ident

LOST_RECORDS = 0.01     # the share of the port's launches a trace may lack


def mean(values):
    values = list(values)
    return sum(values) / len(values) if values else None


def phase_mean(run, name: str):
    return mean(p.phase_seconds[name] for p in run.done if name in p.phase_seconds)


def port_idents() -> set:
    from .probes import launch_kernels

    return {k + "_kernel" for k in launch_kernels()}


def records_check(run):
    """(records of the port's kernels in the traced window, launches its
    counters saw there), or None without a trace."""
    if run.trace_data is None:
        return None
    idents = port_idents()
    recs = sum(1 for r in run.trace_data["records"] if kernel_ident(r[0]) in idents)
    return recs, sum(run.launches.values())


def idle_share(run, exact_counters: bool):
    """100 (1 - busy / window) of the traced window, where the trace holds
    the port's launches: with exact counters (one thread), all but
    LOST_RECORDS of them; with counters that may lose counts under
    threads, at least (1 - LOST_RECORDS) of what they saw."""
    got = records_check(run)
    if got is None:
        return None
    recs, launches = got
    print(f"the port's kernels: {recs} records in the trace, {launches} launches counted",
          file=sys.stderr)
    if launches == 0 or recs < (1 - LOST_RECORDS) * launches:
        return None
    if exact_counters and recs > launches:
        return None
    td = run.trace_data
    return 100.0 * (1.0 - td["busy_s"] / td["window_s"])


def roofline_share(run, record_key: str, ident: str):
    """100 (sum of the recorded launches' bounds) / (sum of their device
    time) over the probe request after the window, where its trace holds
    exactly as many records of the kernel as launches were recorded; None
    otherwise, or where the table of peaks does not hold the card."""
    peaks = peaks_for(run.kind)
    launches = run.records.get(record_key)
    if run.probe_records is None or peaks is None or not launches:
        return None
    times = [r[2] - r[1] for r in run.probe_records if kernel_ident(r[0]) == ident]
    if len(times) != len(launches):
        print(f"{ident}: {len(times)} records in the trace, {len(launches)} launches recorded",
              file=sys.stderr)
        return None
    bound = Bound(peaks)
    least = sum(bound.seconds(W, montmuls, nbytes) for W, montmuls, nbytes in launches)
    return 100.0 * least / (sum(times) * 1e-9)

"""The device trace of a window, and what the benchmark reads from it.

``Capture`` runs torch.profiler (CUDA activity only) around the window, as
``profile_device`` in chip_smoke.py (:1415) does around a call; the
reduction below is that function's (device events named Memcpy or Memset
are copies and sets, every other one a kernel; the busy time is the union
of the device events' intervals), split into pure functions over
(name, start ns, end ns) records so that they can be checked on fixed
numbers.

The host's spans are on perf_counter's clock and the device's records on
the profiler's.  A marker kernel (torch.cuda._sleep, "spin_kernel")
launched right after a synchronise at each end of the window ties the two:
its device start less the host time of its launch is the offset, true to
the launch latency (microseconds), which is far below the idle gaps that
it serves to label.
"""

from __future__ import annotations

import re
import time

MARKER = "spin_kernel"
LEAD_S = 0.05          # idle time traced before and after the window


def kernel_ident(name: str) -> str:
    """A device record's short name: its function's identifier, without
    'void', namespaces (anonymous ones too), template arguments or
    parameters."""
    name = name.replace("(anonymous namespace)", "anonymous")
    head = re.split(r"[<(]", name, maxsplit=1)[0].strip()
    if head.startswith("void "):
        head = head[5:]
    return head.rsplit("::", 1)[-1].strip() or name


def union(records) -> list:
    """The merged [start, end] intervals of (name, start, end) records."""
    out = []
    for _, lo, hi in sorted(records, key=lambda x: x[1]):
        if out and lo <= out[-1][1]:
            if hi > out[-1][1]:
                out[-1][1] = hi
        else:
            out.append([lo, hi])
    return out


def clip(intervals, lo: int, hi: int) -> list:
    return [[max(a, lo), min(b, hi)] for a, b in intervals if b > lo and a < hi]


def busy_ns(intervals) -> int:
    return sum(b - a for a, b in intervals)


def gaps(intervals, lo: int, hi: int) -> list:
    """The idle [start, end] intervals of [lo, hi] between merged busy
    intervals."""
    out, t = [], lo
    for a, b in clip(intervals, lo, hi):
        if a > t:
            out.append([t, a])
        t = max(t, b)
    if hi > t:
        out.append([t, hi])
    return out


def device_ops(records, top: int = 10) -> list:
    """[[short name, seconds]] of the records' total device time by short
    name, longest first."""
    tot: dict = {}
    for name, lo, hi in records:
        k = kernel_ident(name)
        tot[k] = tot.get(k, 0) + hi - lo
    ranked = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
    return [[k, v * 1e-9] for k, v in ranked]


PRIORITY = ("msm", "self_verify", "solve", "prove", "marshal")
OUTSIDE = "harness"


def label_timeline(spans) -> list:
    """[(start, end, label)] segments of host time labelled by the spans
    active there: the first label of PRIORITY that any thread is inside,
    else OUTSIDE.  ``spans`` are (label, start ns, end ns, thread)."""
    ev = []
    for label, lo, hi, _ in spans:
        ev.append((lo, 1, label))
        ev.append((hi, -1, label))
    ev.sort(key=lambda e: (e[0], e[1]))
    active = {k: 0 for k in PRIORITY}
    segs, t = [], None
    for when, step, label in ev:
        if t is not None and when > t:
            cur = next((k for k in PRIORITY if active.get(k)), OUTSIDE)
            segs.append((t, when, cur))
        if label in active:
            active[label] += step
        t = when
    return segs


def idle_by_label(idle, segs, top: int = 10) -> list:
    """[[label, seconds]]: the idle intervals (on the host's clock) split
    over the labelled segments, totals by label, longest first.  Idle time
    outside every segment is OUTSIDE's."""
    tot: dict = {}
    j = 0
    for a, b in idle:
        covered = 0
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            lo, hi = max(a, segs[k][0]), min(b, segs[k][1])
            if hi > lo:
                tot[segs[k][2]] = tot.get(segs[k][2], 0) + hi - lo
                covered += hi - lo
            k += 1
        if b - a > covered:
            tot[OUTSIDE] = tot.get(OUTSIDE, 0) + (b - a - covered)
    ranked = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
    return [[k, v * 1e-9] for k, v in ranked]


def within(records, offset_ns: int, lo_ns: int, hi_ns: int) -> list:
    """The records, markers left out, that overlap [lo_ns, hi_ns] on the
    host's clock, given the offset of the device's clock from it."""
    lo, hi = lo_ns + offset_ns, hi_ns + offset_ns
    return [r for r in records if kernel_ident(r[0]) != MARKER and r[2] > lo and r[1] < hi]


class Capture:
    """torch.profiler around a window, with a marker at each end (and one
    more after a probe traced after it)."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.marks: list = []        # host ns of each marker's launch

    def mark(self):
        """A marker, after the device has drained: at the window's start,
        its end, and the end of any probe traced after it."""
        import torch

        torch.cuda.synchronize()
        self.marks.append(time.perf_counter_ns())
        torch.cuda._sleep(100)
        torch.cuda.synchronize()

    def start(self):
        self.prof.__enter__()
        time.sleep(LEAD_S)
        self.mark()

    def stop(self):
        time.sleep(LEAD_S)
        self.prof.__exit__(None, None, None)

    def records(self) -> list:
        """Every device record of the trace: (name, start ns, end ns)."""
        import torch

        out = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            s = e.start_ns()
            out.append((e.name(), s, s + e.duration_ns()))
        return out


def reduce(records, marks, spans, t0_ns: int, t1_ns: int) -> dict:
    """What a window's trace says: the offset from the host's clock to the
    device's, busy and window seconds, the device ops and the idle time by
    label.  ``t0_ns``/``t1_ns`` bound the window on the host's clock.
    Returns None where the markers are missing from the trace."""
    mk = sorted(r[1] for r in records if kernel_ident(r[0]) == MARKER)
    if len(mk) != len(marks) or len(marks) < 2:
        return None
    off = mk[0] - marks[0]
    drift = (mk[-1] - marks[-1]) - off
    lo, hi = t0_ns + off, t1_ns + off
    inside = within(records, off, t0_ns, t1_ns)
    merged = union(inside)
    idle = [[a - off, b - off] for a, b in gaps(merged, lo, hi)]
    return {
        "offset_ns": off,
        "drift_ns": drift,
        "busy_s": busy_ns(clip(merged, lo, hi)) * 1e-9,
        "window_s": (t1_ns - t0_ns) * 1e-9,
        "records": inside,
        "device_ops": device_ops(inside),
        "idle_gaps": idle_by_label(idle, label_timeline(spans)),
    }

"""Lightweight profiling / observability for the prover pipeline.

Counterpart of the reference ``utils/profiling.py``.  The reference's only
profiler is the printed AVM opcode budget after simulated runs; for the
device build, per-phase wall-clock and optional profiler traces are the
equivalents.

Usage:
    with phase_timer() as t:
        with t.phase("ntt"):
            ...
    t.report()          # -> stderr table

    with torch_trace("/tmp/trace"):   # Chrome trace (chrome://tracing, Perfetto)
        prover.prove(...)
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from collections import OrderedDict

import torch


class PhaseTimer:
    def __init__(self):
        self.times = OrderedDict()

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            # charge the device work queued in the phase to the phase
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
            self.times[name] = self.times.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def report(self, file=sys.stderr):
        total = sum(self.times.values()) or 1e-12
        print("---- phase timings ----", file=file)
        for name, t in self.times.items():
            print(f"{name:24s} {t*1e3:10.1f} ms  {100*t/total:5.1f}%", file=file)
        print(f"{'total':24s} {total*1e3:10.1f} ms", file=file)


@contextlib.contextmanager
def phase_timer():
    yield PhaseTimer()


@contextlib.contextmanager
def torch_trace(outdir: str):
    """Capture a torch.profiler trace (host, and the card where there is
    one) around a block, exported as ``outdir/trace.json`` in Chrome's
    format."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(outdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(outdir, "trace.json"))

"""What the benchmark reads from the program: launch counters, and spans
that its own wrappers put around the program's calls.

``launches_by_width`` is copied from chip_smoke.py (:1524).  The counters
are exact in one thread; under ``prove_batch``'s threads they can lose a
count, so they are read as a lower bound there.
"""

from __future__ import annotations

import threading
import time


def launches_by_width() -> dict:
    """Every launch counter of the port by (kernel, width).  K9 counts at
    width 8, that of both scalar fields."""
    from algoplonk_tpu_torch.ops import curve_kernels as ck
    from algoplonk_tpu_torch.ops import field_kernels as fk
    from algoplonk_tpu_torch.ops import ntt_kernels as nk

    return {**ck.LAUNCHES_BY_WIDTH, **fk.LAUNCHES_BY_WIDTH,
            **{(k, 8): v for k, v in nk.LAUNCHES.items()}}


def launch_kernels() -> tuple:
    """The names of the port's kernels as its counters key them."""
    from algoplonk_tpu_torch.ops import curve_kernels as ck
    from algoplonk_tpu_torch.ops import field_kernels as fk
    from algoplonk_tpu_torch.ops import ntt_kernels as nk

    return tuple(ck.KERNELS) + tuple(fk.KERNELS) + tuple(nk.KERNELS)


def counts_since(before: dict) -> dict:
    now = launches_by_width()
    return {k: v - before.get(k, 0) for k, v in now.items() if v != before.get(k, 0)}


class Spans:
    """Host spans (label, start ns, end ns, thread) in memory, on
    perf_counter's clock."""

    def __init__(self):
        self.items: list = []

    def add(self, label: str, t0: int, t1: int) -> None:
        self.items.append((label, t0, t1, threading.get_ident()))


class Patches:
    """Wrappers put on the program's functions and methods for a window,
    each taken off again by ``restore``."""

    def __init__(self):
        self._saved: list = []

    def wrap(self, owner, name: str, make):
        """owner.name = make(original); for a method, ``make`` gets the
        plain function and returns one that takes ``self`` first."""
        orig = getattr(owner, name)
        self._saved.append((owner, name, orig))
        setattr(owner, name, make(orig))

    def span(self, owner, name: str, spans: Spans, label: str):
        def make(orig):
            def spanned(*args, **kwargs):
                t0 = time.perf_counter_ns()
                try:
                    return orig(*args, **kwargs)
                finally:
                    spans.add(label, t0, time.perf_counter_ns())
            return spanned
        self.wrap(owner, name, make)

    def restore(self) -> None:
        while self._saved:
            owner, name, orig = self._saved.pop()
            setattr(owner, name, orig)

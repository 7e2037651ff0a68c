"""The port's recorder: spans and launch counts inside the program, on the
host's clock.

Counterpart of the reference ``utils/profiling.py``, whose profiler is the
printed AVM opcode budget and the prover's ``AP_PROVE_PROFILE`` marks.
Here one recorder serves every reader of time inside the program: the
prover's ``phase_seconds`` and its ``AP_PROVE_PROFILE`` profile, the
benchmark's per-layer readers and an operator's ``torch_trace``.

A span is a named interval on ``time.perf_counter_ns()`` with its parent,
the request it belongs to and its thread, and its self counts: the kernel
launches made while it was the innermost open span (by kernel) and the
host nanoseconds spent inside the kernel wrappers of ``ops/`` for them.  A
request is the tree under one root span: ``CompiledCircuit.verify``,
one item of ``prove_batch``, or a bare ``Prover.prove``.  Each thread keeps
its own stack, so ``prove_batch``'s workers each build their own tree.

Recording is decided once, at each request's root: on while the program
enables it (``RECORDER.enable()`` / ``recording()``), while a torch
profiler is recording, or under ``AP_PROVE_PROFILE=1``.  Off, a span site
costs one check of a thread-local attribute.  A span never synchronises,
launches or copies anything on the card, resets no memory statistic and
opens no profiler range: it reads the host's clock, and on the spans the
profile prints, ``torch.cuda.memory_allocated`` at their end.

Finished requests stay in memory, the last ``STORE`` of them:

    with RECORDER.recording():
        cc.verify(MyCircuit(...))
    (req,) = RECORDER.requests(last=1)
    for sp in req.spans:
        print(sp.name, sp.parent and sp.parent.name, sp.seconds, sp.launches)

    with torch_trace("/tmp/trace"):   # Chrome trace (chrome://tracing, Perfetto)
        cc.verify(MyCircuit(...))     # with the spans as rows of their own
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import sys
import threading
import time
from collections import deque

import torch

STORE = 256                     # finished requests kept in memory
MARKER = "ap_span_clock"        # the host marker of torch_trace on the CPU
clock = time.perf_counter_ns

# The launch counters of ops/ (``LAUNCHES``, ``LAUNCHES_BY_WIDTH``,
# ``LAUNCHES_BY_FIELD``) are updated under this one lock.
LAUNCH_LOCK = threading.Lock()
# Threads with a recording request open: the kernel wrappers read the
# clock at their entry only while it is above 0.
LIVE = 0


class Span:
    """One named interval of a request; ``end`` is None while it is open."""

    __slots__ = ("name", "start", "end", "parent", "request", "thread", "launches",
                 "dispatch_ns", "mem", "_mem_device")

    def __init__(self, name: str, start: int, parent, request: int, thread: int, mem_device):
        self.name = name
        self.start = start
        self.end = None
        self.parent = parent            # the enclosing Span, None for the root
        self.request = request
        self.thread = thread
        self.launches: dict = {}        # kernel -> launches while innermost
        self.dispatch_ns = 0            # host ns inside the kernel wrappers for them
        self.mem = None                 # device bytes allocated at the end, where asked
        self._mem_device = mem_device

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-9


class Request:
    """The spans of one request, in the order they opened (the root first)."""

    __slots__ = ("id", "thread", "spans")

    def __init__(self, rid: int, thread: int):
        self.id = rid
        self.thread = thread
        self.spans: list = []

    @property
    def root(self) -> Span:
        return self.spans[0]

    @property
    def start(self) -> int:
        return self.root.start

    @property
    def end(self) -> int:
        return self.root.end


class _Thread(threading.local):
    req = None          # the open Request of this thread, or None
    stack = None        # its open spans, innermost last
    off = False         # inside a root that decided not to record


_tls = _Thread()


class Recorder:
    """The finished requests, the last ``keep`` of them, and the switch
    that the program's API turns."""

    def __init__(self, keep: int = STORE):
        self._lock = threading.Lock()
        self._done: deque = deque(maxlen=keep)
        self._enabled = 0
        self._ids = itertools.count(1)

    def enable(self) -> None:
        with self._lock:
            self._enabled += 1

    def disable(self) -> None:
        with self._lock:
            self._enabled = max(self._enabled - 1, 0)

    @contextlib.contextmanager
    def recording(self):
        """Record the requests that start inside the block."""
        self.enable()
        try:
            yield self
        finally:
            self.disable()

    def wanted(self) -> bool:
        """Whether a request starting now records."""
        return bool(self._enabled or torch.autograd.profiler._is_profiler_enabled
                    or os.environ.get("AP_PROVE_PROFILE", "") == "1")

    def requests(self, last: int | None = None, since_ns: int | None = None) -> list:
        """Finished requests, oldest first: those whose root started at or
        after ``since_ns``, the last ``last`` of them."""
        with self._lock:
            done = list(self._done)
        if since_ns is not None:
            done = [q for q in done if q.start >= since_ns]
        if last is not None:
            done = done[len(done) - last:] if last > 0 else []
        return done

    def _finish(self, req: Request) -> None:
        global LIVE
        with self._lock:
            self._done.append(req)
        with LAUNCH_LOCK:
            LIVE -= 1


RECORDER = Recorder()


def open_span(name: str, t_ns: int | None = None, mem=None):
    """Open ``name`` inside the innermost open span of this thread's
    request, at ``t_ns`` (default now) -> the Span, or None where the
    thread is not recording.  ``mem``: a device whose allocated bytes the
    span reads at its end (on a CUDA device only)."""
    st = _tls
    req = st.req
    if req is None:
        return None
    stack = st.stack
    sp = Span(name, clock() if t_ns is None else t_ns, stack[-1] if stack else None,
              req.id, req.thread, mem)
    req.spans.append(sp)
    stack.append(sp)
    return sp


def close_span(sp, t_ns: int | None = None) -> None:
    """Close ``sp`` at ``t_ns`` (default now), and every span opened inside
    it that is still open; closing a root finishes its request."""
    if sp is None or sp.end is not None:
        return
    st = _tls
    now = clock() if t_ns is None else t_ns
    stack = st.stack
    while stack:
        top = stack.pop()
        top.end = now
        dev = top._mem_device
        if dev is not None and dev.type == "cuda":
            top.mem = torch.cuda.memory_allocated(dev)
        if top is sp:
            break
    if not stack:
        req, st.req, st.stack = st.req, None, None
        RECORDER._finish(req)


def charge(kernel: str, t0: int) -> None:
    """One launch of ``kernel``, whose wrapper was entered at ``t0``, to
    the innermost open span of this thread's request."""
    st = _tls
    if st.req is None:
        return
    sp = st.stack[-1]
    sp.launches[kernel] = sp.launches.get(kernel, 0) + 1
    sp.dispatch_ns += clock() - t0


def entry_ns() -> int:
    """A kernel wrapper's entry time, or 0 while no thread records."""
    return clock() if LIVE else 0


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


class _Off:
    """A root that does not record: the roots opened inside it stay off."""

    __slots__ = ()

    def __enter__(self):
        _tls.off = True

    def __exit__(self, *exc):
        _tls.off = False
        return False


class _Opened:
    __slots__ = ("name", "span")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.span = open_span(self.name)
        return self.span

    def __exit__(self, *exc):
        close_span(self.span)
        return False


class _Root(_Opened):
    def __enter__(self):
        global LIVE
        st = _tls
        st.req = Request(next(RECORDER._ids), threading.get_ident())
        st.stack = []
        with LAUNCH_LOCK:
            LIVE += 1
        return super().__enter__()


_NOOP, _OFF = _Noop(), _Off()


def span(name: str):
    """A span around a block, inside the thread's open request; nothing
    where the thread is not recording."""
    return _NOOP if _tls.req is None else _Opened(name)


def request(name: str):
    """A root span around a block: where this thread has a span open, a
    span inside it; otherwise a new request, recorded if the recorder
    wants it now."""
    st = _tls
    if st.req is not None:
        return _Opened(name)
    if st.off:
        return _NOOP
    return _Root(name) if RECORDER.wanted() else _OFF


def _clock_tie(on_card: bool) -> int:
    """A marker in the profiler's trace, at the returned host ns: on the
    card the spin kernel, launched then after the device has drained (the
    tie of the benchmark's trace reader); on the CPU the middle of an
    empty host range."""
    if on_card:
        torch.cuda.synchronize()
        t = clock()
        torch.cuda._sleep(100)
        torch.cuda.synchronize()
        return t
    t = clock()
    with torch.profiler.record_function(MARKER):
        pass
    return (t + clock()) // 2


def _marker_ts(events: list, on_card: bool):
    """The marker's time in the trace (us): the spin kernel's start, or
    the middle of the host range."""
    for e in events:
        name = e.get("name", "")
        if on_card and e.get("cat") == "kernel" and "spin_kernel" in name:
            return e["ts"]
        if not on_card and name == MARKER:
            return e["ts"] + e.get("dur", 0) / 2
    return None


SPAN_PID = 1 << 30              # the trace's process row that holds the spans


def span_rows(requests: list, shift_us: float) -> list:
    """Chrome trace events of the requests' spans, their host ns shifted
    by ``shift_us`` onto the trace's clock, one row a thread."""
    pid = SPAN_PID
    rows = [{"ph": "M", "name": "process_name", "pid": pid,
             "args": {"name": "algoplonk_tpu_torch spans"}}]
    for q in requests:
        for sp in q.spans:
            args = {"request": q.id, "parent": sp.parent.name if sp.parent else None}
            if sp.launches:
                args["launches"] = dict(sp.launches)
                args["dispatch_us"] = sp.dispatch_ns / 1e3
            if sp.mem is not None:
                args["mem_bytes"] = sp.mem
            rows.append({"ph": "X", "cat": "ap_span", "name": sp.name, "pid": pid,
                         "tid": sp.thread, "ts": sp.start / 1e3 + shift_us,
                         "dur": (sp.end - sp.start) / 1e3, "args": args})
    return rows


@contextlib.contextmanager
def torch_trace(outdir: str):
    """Capture a torch.profiler trace (host, and the card where there is
    one) around a block, exported as ``outdir/trace.json`` in Chrome's
    format, with the block's spans (the recorder is on for it) as rows of
    their own on the trace's clock, tied by one marker."""
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    os.makedirs(outdir, exist_ok=True)
    since = clock()
    with RECORDER.recording(), profile(activities=activities) as prof:
        tie = _clock_tie(on_card)
        yield
    path = os.path.join(outdir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        trace = json.load(fh)
    ts = _marker_ts(trace.get("traceEvents", []), on_card)
    if ts is None:
        print("torch_trace: the clock marker is missing from the trace; no span rows",
              file=sys.stderr)
        return
    trace["traceEvents"] += span_rows(RECORDER.requests(since_ns=since), ts - tie / 1e3)
    with open(path, "w") as fh:
        json.dump(trace, fh)

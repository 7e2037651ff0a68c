"""One run of one cell: set-up, the measured window, the check, the line.

Set-up (``setup_s``, from the process's start): the program's import and
kernel library (built with nvcc into the checkout on a first run, which
the log says), the configuration's circuit compiled with ``apt.compile``
(``compile_s``; the test SRS comes from the checkout's ``.cache/`` after a
first run), one ``CompiledCircuit.verify`` (``first_prove_s``: it builds
round 3's tables), then the traffic's warm-up requests, at the window's
own shapes.

The window: a closed loop of one client.  Each request draws fresh
assignments from the seed and drives the traffic's entry
(entries/<entry>.py); the window ends when the last request started
within ``seconds`` is done, and rates divide by that time.  Without
``trace`` the line carries the end-to-end metrics.  With it, the window
runs under the profiler with nothing but the benchmark's host spans
around the program's calls (no synchronise, no per-launch wrapper), and
the line carries the per-layer metrics; readers that record each launch's
shape (the rooflines) do so over one more request after the window, a
probe traced apart, so that they perturb neither the window's idle share
nor its breakdown.

After the window: the peak device memory is read, the loaded modules are
searched for JAX, the program's state is freed, and the reference checks
every proof made (core/check.py).
"""

from __future__ import annotations

import gc
import random
import sys
import time
from dataclasses import dataclass, field

from . import check as check_mod
from . import probes
from . import trace as trace_mod
from .spec import Cell, metric_reader

FORBIDDEN = ("jax", "jaxlib", "flax", "algoplonk_tpu")


class Refused(RuntimeError):
    """A run that must exit without a result."""


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".", 1)[0] in FORBIDDEN})


@dataclass
class Proofed:
    """One proof attempted in the window."""

    assignment: dict
    proof: bytes | None = None
    publics: bytes | None = None
    call_s: float = 0.0          # the verify call (or the batch call)
    phase_seconds: dict = field(default_factory=dict)
    error: str | None = None


@dataclass
class Run:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    devices: list
    kind: str = ""
    build_s: float = 0.0
    compile_s: float = 0.0
    first_prove_s: float = 0.0
    setup_s: float = 0.0
    window_s: float = 0.0
    proofs: list = field(default_factory=list)
    probe: list = field(default_factory=list)      # the probe request's proofs
    launches: dict = field(default_factory=dict)
    trace_data: dict | None = None
    probe_records: list | None = None              # the probe's device records
    patches: probes.Patches = field(default_factory=probes.Patches)
    spans: probes.Spans = field(default_factory=probes.Spans)
    records: dict = field(default_factory=dict)

    @property
    def done(self) -> list:
        return [p for p in self.proofs if p.error is None and p.proof is not None]

    def marshal(self, vp, item: Proofed) -> None:
        """The AVM bytes of ``vp`` into ``item``, with the prover's rounds."""
        t0 = time.perf_counter_ns()
        item.proof = vp.marshal_proof()
        item.publics = vp.marshal_public_inputs()
        if self.trace:
            self.spans.add("marshal", t0, time.perf_counter_ns())
        item.phase_seconds = dict(vp.phase_seconds)


def request(run: Run, cc, P, group: list) -> list:
    """Drive the traffic's entry (entries/<entry>.py) on ``group``
    (assignments) -> one Proofed each, in order."""
    items = [Proofed(a) for a in group]
    run.cell.entry.request(run, cc, P, items)
    return items


def _draw(run: Run, rng, r: int) -> list:
    c = run.cell
    return [c.circuit.assignment(c.cfg, r, rng) for _ in range(c.traffic["batch"])]


def _spans(run: Run) -> None:
    """Host spans around the program's layers, for the idle time's labels
    and the span readers: no synchronise is added, and MsmCtx's method
    ends in its own read back to the host."""
    from algoplonk_tpu_torch import plonk
    from algoplonk_tpu_torch.frontend import witness
    from algoplonk_tpu_torch.ops import msm
    from algoplonk_tpu_torch.plonk import prove as prove_mod

    run.patches.span(witness, "solve", run.spans, "solve")
    run.patches.span(prove_mod.Prover, "prove", run.spans, "prove")
    run.patches.span(plonk.verify, "verify", run.spans, "self_verify")
    run.patches.span(msm.MsmCtx, "msm_to_affine_int", run.spans, "msm")


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, devices=("cuda:0",),
             t_start: float | None = None, log=print, before_window=None) -> dict:
    """One run on ``devices`` (the cell's cards); returns the result line's
    object.  Raises Refused where the run must end without a result.
    ``before_window(run)``, which the benchmark's own runs never pass, may
    put wrappers on the program for the window through ``run.patches``
    (benchmark/control.py: the control and the faults that show the check
    can fail)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    devices = [torch.device(d) for d in devices]
    device = devices[0]
    on_card = device.type == "cuda"
    run = Run(cell=cell, seed=seed, seconds=seconds, trace=trace, devices=devices)
    run.kind = torch.cuda.get_device_name(device) if on_card else "cpu"

    def sync():
        if on_card:
            for d in devices:
                torch.cuda.synchronize(d)

    import algoplonk_tpu_torch as apt

    if on_card:
        from algoplonk_tpu_torch.ops import _build

        t0 = time.perf_counter()
        _build.library()
        run.build_s = time.perf_counter() - t0
        if _build.build_seconds:
            log(f"this run built the kernel library with nvcc ({_build.build_seconds:.3f} s, "
                "inside setup_s): a checkout's first run, whose set-up is not comparable")
    cfg = cell.cfg
    curve = {"bn254": apt.BN254, "bls12_381": apt.BLS12_381}[cfg["curve"]]
    r = curve.fr.modulus
    P = cell.circuit.circuit(apt, cfg)
    rng = random.Random(seed)

    t0 = time.perf_counter()
    cc = apt.compile(P, curve, apt.SetupName[cfg["setup"]], device=device)
    sync()
    run.compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cc.verify(P(**cell.circuit.assignment(cfg, r, rng))).marshal_proof()
    sync()
    run.first_prove_s = time.perf_counter() - t0
    for _ in range(cell.traffic["warmup_requests"]):
        bad = [p.error for p in request(run, cc, P, _draw(run, rng, r)) if p.error]
        if bad:
            raise Refused(f"warm-up request failed: {bad[0]}")
    sync()
    run.setup_s = time.perf_counter() - t_start
    log(f"set-up {run.setup_s:.3f} s (build {run.build_s:.3f}, compile {run.compile_s:.3f}, "
        f"first verify {run.first_prove_s:.3f}); {cc.pk.n} rows, {cc.ccs.nb_constraints} constraints")

    readers = {m["name"]: metric_reader(m["name"], cell.bench) for m in cell.per_layer} if trace else {}
    recorders = [rd for rd in readers.values() if hasattr(rd, "install")]
    capture = None
    if trace:
        _spans(run)
        if on_card:
            capture = trace_mod.Capture()
            capture.start()

    if before_window is not None:
        before_window(run)
    before = probes.launches_by_width()
    cpu0 = time.process_time()
    t0_ns = time.perf_counter_ns()
    try:
        while time.perf_counter_ns() - t0_ns < seconds * 1e9:
            run.proofs += request(run, cc, P, _draw(run, rng, r))
        sync()
        t1_ns = time.perf_counter_ns()
        cpu_s = time.process_time() - cpu0
        run.launches = probes.counts_since(before)
        if capture is not None:
            capture.mark()
        run.patches.restore()
        if trace and recorders:
            # the probe: one more request, with each launch's shape recorded
            for rd in recorders:
                rd.install(run)
            tp0_ns = time.perf_counter_ns()
            run.probe = request(run, cc, P, _draw(run, rng, r))
            sync()
            tp1_ns = time.perf_counter_ns()
            if capture is not None:
                capture.mark()
    finally:
        if capture is not None:
            capture.stop()
        run.patches.restore()
    run.window_s = (t1_ns - t0_ns) * 1e-9

    peak = max(torch.cuda.max_memory_allocated(d) for d in devices) if on_card else 0
    found = forbidden_modules()
    if found:
        raise Refused(f"modules of JAX or the JAX package are loaded: {', '.join(found)}")
    if capture is not None:
        records = capture.records()
        run.trace_data = trace_mod.reduce(records, capture.marks, run.spans.items, t0_ns, t1_ns)
        capture = None
        td = run.trace_data
        log(f"trace: {len(records)} device records; " + (
            "markers missing: no trace read" if td is None else
            f"{len(td['records'])} in the window, offset {td['offset_ns']} ns, drift "
            f"{td['drift_ns']} ns, busy {td['busy_s']:.6f} of {td['window_s']:.6f} s; "
            f"launches counted {sum(run.launches.values())}"))
        if td is not None and recorders:
            run.probe_records = trace_mod.within(records, td["offset_ns"], tp0_ns, tp1_ns)
            log(f"probe: {len(run.probe_records)} device records in {(tp1_ns - tp0_ns) * 1e-9:.3f} s")
    del cc
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    items = [(p.assignment, p.proof, p.publics) for p in run.proofs + run.probe]
    verdict = check_mod.check(cfg, cell.circuit, items, seed)
    log(f"reference check {verdict['seconds']:.3f} s: " + ", ".join(
        f"{k} {v}" for k, v in verdict.items() if k != "seconds"))
    log(f"window {run.window_s:.3f} s, {len(run.done)} of {len(run.proofs)} proofs done, "
        f"process CPU {cpu_s:.3f} s; call seconds " + " ".join(f"{p.call_s:.3f}" for p in run.proofs))
    errors = [p.error for p in run.proofs + run.probe if p.error]
    if errors:
        log(f"{len(errors)} proofs raised; the first: {errors[0]}")

    metrics = {}
    if not trace:
        from .endtoend import READERS

        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": READERS[m["name"]](run), "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            value = readers[m["name"]].read(run)
            if value is None:
                log(f"per-layer metric {m['name']}: nothing to read")
                continue
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = {"platform": "gpu" if on_card else "cpu", "kind": run.kind,
           "count": len(devices) if on_card else 0, "memory_peak_bytes": peak}
    out = {"correct": verdict["bad_proofs"] <= check_mod.LIMITS["bad_proofs"],
           "attempted": len(run.proofs), "failed": verdict["bad_proofs"],
           "metrics": metrics, "device": dev}
    if trace and run.trace_data is not None:
        dev["busy_s"] = run.trace_data["busy_s"]
        dev["window_s"] = run.trace_data["window_s"]
        out["breakdown"] = {"device_ops": run.trace_data["device_ops"],
                            "idle_gaps": run.trace_data["idle_gaps"]}
    out["checks"] = {k: {"value": verdict[k], "limit": v} for k, v in check_mod.LIMITS.items()}
    return out

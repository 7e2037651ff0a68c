#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (algoplonk_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero and prints no
result line):

1. build the kernels from algoplonk_tpu_torch/csrc with nvcc (sm_90a, one
   process per source and width) and hold each against its plain PyTorch
   version, word for word (tolerance: exact): K1-K7 at W = 8 on random
   valid points at the lane widths a BN254 2^16 commit gives K1-K4 (c = 11,
   K = 16), and at W = 12 at the widths of a BLS12-381 2^14 commit, with
   identity, doubling and cancelling lanes; K4 on arbitrary words with the
   edges of its ladder (k p - 1, k p, k p + 1, 2^(32 W) - 1) at the phase-3
   width and at 2^20 lanes, where its bytes bound is far above a launch's
   floor; K3's window scan over the 24
   windows of the super sums (E = 257 and 513 at W = 8, the 2^16 and 2^17
   commits; E = 65 at W = 12; E = 1024, its limit, at both widths: a
   2^18-point MSM piece of the 2^20 path), beside the same scan run as one K3 launch
   per round (the MSM's scan before it had its own kernel), and K3's phase
   4 on 24 windows of D = 1024 at both widths, each printed with its bound
   and the depth of its chain of dependent point operations (the scan's
   bound counts the E - 1 adds a window's scan needs, and the adds its
   Kogge-Stone rounds do are printed beside it); K1 gathers from a table of the
   commit's own size (65,540 rows at W = 8, 16,388 at W = 12) and is timed
   at the phase-1 and phase-3 widths; K2 is held to its plain version at
   every thread count per lane T and timed at every T at the phase-2a
   widths of the three commits (6,272 and 12,416 lanes at W = 8, 1,664 at
   W = 12), and both held to their plain versions and timed at the widths
   of a 2^18-point MSM piece (K1 24 x 16,384 lanes on a table of 2^18 + 1
   rows, K2 24 x 1,024 lanes) at both widths;
   K5 and K6 at every thread count per lane T_m and K7 at every T
   (K5 and K6 at the phase-1 width, K7 over 16 steps at the phase-2a
   width), each held word for word to its plain version at that count and
   timed, the wrapper's count marked; K4, K5 and K6 timed on the device
   (torch.profiler; K4 with the L2 flushed before each launch, as its
   bytes bound assumes) beside CUDA events over back-to-back launches,
   which read the host's launch rate too; the field kernels K8 (field_mul) and field_add_sub (add, sub,
   neg) on each of the four fields at the prove's shapes (2^18 contiguous
   rows, K8 also with one multiplicand arbitrary below R, held to host
   integers; 256 rows against one element; an NTT stage's strided halves
   against its strided twiddle slice; on the two scalar fields also the
   2^22 contiguous rows of phase 10's round-3 coset), each timed on the
   device with its inputs read from HBM (the L2 flushed before each launch) beside its
   bound, and the host microseconds of one field_mul call; and the NTT
   pass kernel K9 on both scalar fields (BN254's lazy, BLS12-381's strict)
   at the four pass shapes of the 2^17 path's four-step transforms of 2^19
   (C = 512 and 1024, forward and inverse, with and without the fused entry
   and exit multiplies), in the column layout through which the transforms
   run the fused passes and contiguous, at the four of the 2^20 path's
   transforms of 2^22 (C = 2048) and at the four of the 2^21 path's
   transforms of 2^23 (P2 and P2' at C = 4096: one HBM stage, ntt_stage,
   and K9 at 2048 on the pieces it leaves), in the transforms' layouts
   (the plain versions there timed by one call), and at C = 4096 in the
   column layout with entry and exit at N = 2^14 (K9's second
   sub-transform stride), each timed beside its bound recounted without
   the multiplies by one and beside the count with them; and ntt_stage
   alone on both scalar fields at the 2^21 path's shapes (the half-2048
   stage of P2 and P2', N = 2^23) and in the column layout at N = 2^14
   with the entry (DIF) or exit (DIT) multiply, each timed beside its
   bytes bound.  Every random residue of this phase is drawn from all of
   [0, p), edge values among them.  Every plain version must launch no kernel (all
   launch counters are read around each plain call);
2. the 2^16 path, with the launch counts zeroed just before it: compile the
   2^16-constraint SquareChain circuit on BN254 with the test SRS on the
   GPU, prove and self-verify it (CompiledCircuit.verify, batch-major
   quotient), marshal; the proof must be 24 words, a flipped public input
   must be rejected, every MSM kernel (K1, K2, K3 and its scan and
   phase-4 entries) must have launched, and both field kernels in the prove
   itself; the prove's MSM share, the field kernels' launches per prove and
   the operands they copied are printed.  Then one warm prove + self-verify
   under torch.profiler: its CUDA kernel launches and the device's busy
   share; then round 3's seconds through both quotient paths
   (Prover(rng=False), warm, five each, alternating; equal bytes);
3. one commit-sized MSM (65,539 points of that SRS): the kernel path must
   equal the plain path (``msm_ctx(..., plain=True)``, which must launch
   nothing), and on a 4,096-point prefix the host Pippenger;
   then its split (sort, gathers, K1, K2, K3's scan, add and phase 4, host
   fold) from synchronised marks;
4. a small circuit proved on the GPU (device MSM forced) must give the same
   proof bytes as on the CPU through both quotient paths, and a BSB22
   circuit must prove and verify;
5. the 2^17 path: one four-step coset transform of 2^19 must equal the
   radix-2 plan's (positions through scramble_perm) and invert exactly, and
   each direction, warm, must run its two K9 launches and nothing else on
   the device (no transpose copy: K9's count, the PyTorch operators it
   dispatches, allocations only, and a torch.profiler trace with no record
   but K9's); then, with the counts zeroed, the 2^17
   SquareChain (the cap of the production BN254 setup) is compiled, proved
   through the four-step quotient and self-verified, with the same checks
   as phase 2 and every kernel, K9 and the field kernels included,
   launched, K9 28 times; one warm prove + self-verify under
   torch.profiler (launches, K9's among them, and the busy share); two
   more proves of the same witness with Prover(rng=False), forced through
   each quotient path, must give equal bytes;
6. the BLS12-381 path, with the counts zeroed just before it: the 2^14
   SquareChain (y in BLS12-381's Fr) compiled on the Ethereum KZG ceremony,
   proved and self-verified; the proof must be 33 words, a flipped public
   input rejected, the MSM kernels launched at W = 12 and the field kernels
   in the prove; round 3's seconds through both quotient paths as in phase
   2.  Then a small BLS12-381
   circuit with the device MSM forced gives the CPU's proof bytes through
   both quotient paths (the four-step one runs K9 on BLS12-381's Fr), and
   an MSM over all 32,768 ceremony points agrees between the kernel path
   at fuse depths 16 and 8 and the plain path, and on a 4,096-point prefix
   (c = 11) with the host Pippenger; then the split of one 16,387-point
   commit MSM;
7. the kernel-test path of K4-K8 (the counterpart of the reference's
   tests/test_pallas_kernels.py), with the counts zeroed just before it:
   on each curve, K4 on arbitrary words and the edges of its ladder against
   its plain version and host integers, K5, K6 and K7 on identity, doubling
   and cancelling lanes against host EC arithmetic, and K8 on both of its
   fields against host integers;
8. the modules off the prove path, on the circuits of phases 2 and 6
   (nothing new is compiled), with the counts zeroed just before: each
   circuit's emitted logicsig and contract (CompiledCircuit.
   write_puyapy_verifier) run under the offline AVM mock
   (chain/algopy_mock.py) on that phase's card proof must accept it and
   reject a flipped public input, and print their opcode budgets; KZG
   (ops/kzg.py) on the 2^16 + 3 SRS points: commit, open and
   verify_opening of 2^16 random residues (the value equals host Horner,
   value + 1 is rejected), and at 2^12 coefficients commit and the
   opening's proof equal to the plain MSM, which launches nothing; the G1
   NTT (ops/gntt.py): to_lagrange_g1 of 2^11 SRS points, its launches and
   seconds, then commit == commit_lagrange of random coefficients (both
   MSMs on the kernels) and its first point against host arithmetic; the
   cache (utils/cache.py): phase 2's circuit written and read back onto
   the card proves Prover(rng=False)'s bytes.  Every MSM kernel at W = 8
   and both field kernels must have launched;
9. sharded and batch proving (algoplonk_tpu_torch/parallel/) on a mesh of
   MESH_SHARDS shards, all on the one card (``Mesh([cuda:0] * 4)``), each
   sharded call with the counts zeroed just before it and read just after:
   (a) the sharded commit MSM (the prover's bucket padding) of phase 3's
   65,539 BN254 points and of 16,387 BLS12-381 ceremony points equals the
   single-device MSM, and a 4,096-point prefix the plain path; (b) the
   sharded coset NTT and iNTT of 2^19 equal the radix-2 plan's words, in
   two K9 launches per shard each; (c) Prover(rng=False, mesh) on phase
   5's BN254 2^17 keys and phase 6's BLS12-381 2^14 keys gives the
   single-device Prover(rng=False)'s proof bytes with every size-n iNTT,
   lift and coset iNTT sharded, and verifies (seconds, launches, peak
   memory; then a warm sharded prove under torch.profiler); (d) prove_batch
   of BATCH BN254 2^16 witnesses with BATCH workers (one CUDA stream each)
   and with one, beside BATCH sequential proves, alternating, each batch
   proof byte-equal to its sequential proof (then the BATCH-stream batch
   under torch.profiler).  K1, K2, K3 (its scan and phase 4 too) at both
   widths, K8 and field_add_sub on both scalar fields and K9 must have
   launched in (a)-(c);
10. the 2^20 path (the JAX package's headline size, BASELINE.json), on
   BN254 and then BLS12-381, both on the test SRS: the SRS of 2^20 + 3
   points built on the device (setups/srs.py's large path) and timed, the
   2^20-constraint SquareChain compiled (timed) and, with the counts
   zeroed just before, proved and self-verified through the four-step
   quotient (its 2^22 coset: K9 at C = 2048); the proof must have the
   curve's length and a flipped public input must be rejected; K1, K2,
   K3 (its scan at E = 1024, phase 4, and add_window_sums over the MSM's
   four 2^18-point pieces and its tail piece), K8, field_add_sub and K9
   (28 times) must have launched.  Then five warm Prover(rng=False)
   proves of one witness: under AP_PROVE_PROFILE=1 (round 3 split into
   its sub-phases, the memory in use and its peak, launches per prove),
   then unprofiled with table eviction, without it (plonk/prove.py's
   EVICT_MIN_LOG raised to 99) twice, and with it; all verify, their
   bytes must be equal, and each one's seconds and peak are printed.
   BLS12-381's warm proves stop after the profiled one: phase 11 runs
   its shapes and eviction pairs at twice the size;
11. the 2^21 path (Dusk's cap on BLS12-381, setups/registry.py) on
   BLS12-381 on the test SRS (the repo holds Dusk's vk.bin only), as
   phase 10 runs its curves: the SRS of 2^21 + 3 points, the circuit, a
   prove + self-verify through the four-step quotient on a 2^23 coset
   (K9 28 times, ntt_stage 14 times: P2 and P2' at C = 4096), the five
   warm proves with and without eviction, all equal bytes.

Output: timings on stdout; before the last line the card's name and power
limit, then a JSON line of per-kernel numbers: launches from the path that
runs the kernel (the MSM kernels at W = 8 and K9 from the 2^17 path, the
MSM kernels at W = 12 from the BLS12-381 path, K4-K7 from the kernel-test
path, the field kernels from the prove + self-verify of their curve's path,
or the kernel-test path's for a field that prove does not compute in;
"phase8_launches" the same kernel's in phase 8, "phase9_launches" in
phase 9's sharded calls, "phase10_launches" in phase 10's prove +
self-verify of the kernel's curve, K9's BN254's, "phase11_launches" in
phase 11's; ntt_stage's launches are phase 11's), the time of
kernel and plain version at phase 1's shapes (K9's ms and plain_ms are the
sums over BN254's four main-path passes of 2^19, every pass of both fields
and every size itemised under "passes"; ntt_stage's are the sums over
BLS12-381's two stages of 2^23; ntt_stage's shapes and K1's, K2's, K4's
and the field kernels' other shapes are itemised under "shapes"; the field kernels'
ms is at 2^18 contiguous rows, inputs from HBM; K4's, K5's and K6's ms is
device time, with CUDA events over back-to-back launches as "events_ms"),
and the bound at those shapes: the larger of the bytes over HBM bandwidth
and the 32-bit integer multiplies over the card's multiply rate (K4 does
none); "T" is the wrapper's thread count per lane (K2, K5, K6, K7), and
K5's, K6's and K7's "shapes" time every count.  No single PyTorch call
computes any of these functions (multi-word modular arithmetic), so
library_ms is null.  The last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import os
import random
import subprocess
import sys
import time

LOG_N = 16        # the BN254 2^16 path (batch-major quotient)
LM_LOG_N = 17     # the BN254 2^17 path (four-step quotient, K9)
LARGE_LOG_N = 20  # phase 10: the JAX package's headline size (BASELINE.json), both curves
DUSK_LOG_N = 21   # phase 11: Dusk's cap on BLS12-381 (setups/registry.py), a 2^23 coset
BLS_LOG_N = 14    # the BLS12-381 path: the Ethereum KZG ceremony's cap
BLS_MSM_POINTS = 1 << 15   # every G1 point of that ceremony
HOST_PREFIX = 4096         # points checked against the host Pippenger
KZG_LOG = 16               # phase 8: coefficients of the KZG polynomial, 2^KZG_LOG
KZG_CHECK = 1 << 12        # phase 8: coefficients held to the plain MSM (above HOST_MSM_MAX)
G1_NTT_LOG = 11            # phase 8: points of the G1 NTT, 2^G1_NTT_LOG
MESH_SHARDS = 4            # phase 9: shards of the mesh, all on the one card
BATCH = 4                  # phase 9: witnesses of a batch, and its workers
TRACE_PADS = (0.02, 0.25, 1.0, 3.0)   # idle seconds around a traced call, by try
TRACE_LEAD = 5                        # uncounted launches at the start of a timing trace
MSM_SRC = "algoplonk_tpu_torch/csrc/msm_kernels.cu"
CURVE_SRC = "algoplonk_tpu_torch/csrc/curve_kernels.cu"
FIELD_SRC = "algoplonk_tpu_torch/csrc/field_kernels.cu"
NTT_SRC = "algoplonk_tpu_torch/csrc/ntt_kernels.cu"
SOURCE = {
    "mixed_add_signed_multi": MSM_SRC, "jac_add_multi_scan": MSM_SRC,
    "jac_add": MSM_SRC, "jac_add_window_scan": MSM_SRC, "window_combine": MSM_SRC,
    "canon": CURVE_SRC, "mixed_add": CURVE_SRC,
    "mixed_add_signed": CURVE_SRC, "jac_add_multi": CURVE_SRC,
    "field_mul": FIELD_SRC, "field_add_sub": FIELD_SRC, "ntt_pass": NTT_SRC,
    "ntt_stage": NTT_SRC,
}
REPLACES = {
    "mixed_add_signed_multi": "algoplonk_tpu/ops/curve_pallas.py:250",
    "jac_add_multi_scan": "algoplonk_tpu/ops/curve_pallas.py:357",
    "jac_add": "algoplonk_tpu/ops/curve_pallas.py:292",
    "jac_add_window_scan": "algoplonk_tpu/ops/curve_pallas.py:292",
    "window_combine": "algoplonk_tpu/ops/curve_pallas.py:292",
    "canon": "algoplonk_tpu/ops/curve_pallas.py:404",
    "mixed_add": "algoplonk_tpu/ops/curve_pallas.py:156",
    "mixed_add_signed": "algoplonk_tpu/ops/curve_pallas.py:201",
    "jac_add_multi": "algoplonk_tpu/ops/curve_pallas.py:324",
    "field_mul": "algoplonk_tpu/ops/curve_pallas.py:447",
    # no TPU kernel: the reference's add/sub/neg are XLA, which fuses them
    "field_add_sub": "algoplonk_tpu/ops/field.py:237",
    "ntt_pass": "algoplonk_tpu/ops/ntt_pallas.py:129",
    # the same TPU kernel run on one stage, as _pass_kernel (:245) runs
    # each stage with 2h > _T_SMALL
    "ntt_stage": "algoplonk_tpu/ops/ntt_pallas.py:129",
}
# Montgomery multiplies per lane of one call of each formula, as the kernels
# do them (csrc/curve.cuh): the two products by 3b that the plain version
# (ops/curve.py) makes as multiplies are a few additions there, and are not
# counted
MIXED_ADD_MULS = 11
JAC_ADD_MULS = 12
JAC_DOUBLE_MULS = 8
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
IMUL_PER_CLK_PER_SM = 64    # 32-bit integer multiply-adds, compute capability 9.0


def log(*a):
    print(*a, flush=True)


L2_FLUSH_BYTES = 3 * 50 * 2**20   # three times the H100's 50 MB L2


def device_ms(torch, fn, reps: int, kernel: str, flush=None) -> float:
    """Mean device milliseconds per call of fn (one launch of ``kernel``, a
    part of its name) over reps calls after one warm-up, summed from that
    kernel's own intervals in a torch.profiler trace: the card's time
    without the host's gaps between launches, which CUDA events around
    back-to-back launches include.  With ``flush`` (an int32 buffer of
    L2_FLUSH_BYTES on the card), each call follows a read of the whole
    buffer, which evicts fn's inputs from the L2: they then come from HBM,
    as a bytes bound over HBM bandwidth assumes.

    On the card the profiler has lost the records of a trace's first
    launches (3 of 20 in a row, in a long process), and once every record
    of three short traces in a row, and once returned 20 records whose mean
    was half the kernel's time.  So each trace runs TRACE_LEAD uncounted
    launches first and the last reps records are read; the launches run
    between idle pads (TRACE_PADS, longer at each try), and a trace with
    fewer records, or with one below half their median, is taken again."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for pad in TRACE_PADS:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            for _ in range(TRACE_LEAD + reps):
                if flush is not None:
                    flush.sum()
                fn()
            torch.cuda.synchronize()
            time.sleep(pad)
        spans = sorted((e.start_ns(), e.duration_ns()) for e in prof.profiler.kineto_results.events()
                       if e.device_type() == torch.autograd.DeviceType.CUDA and kernel in e.name())
        last = [d for _, d in spans[-reps:]]
        if len(last) == reps and 2 * min(last) >= sorted(last)[reps // 2]:
            return sum(last) * 1e-6 / reps
        log(f"device_ms: {len(spans)} of {TRACE_LEAD + reps} {kernel} launches in the trace"
            + (f", spans {min(last)}-{max(last)} ns" if last else "") + "; again")
    raise AssertionError(f"expected {reps} consistent {kernel} launches in the trace, "
                         f"found {len(spans)}")


def host_seconds(torch, fn, calls: int) -> float:
    """Host seconds per call of fn over ``calls`` calls, synchronised before
    and after (the device keeps up with a launch rate of tens of us)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call of fn over reps calls (one warm-up)."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Bound:
    """The least time the card could take for a kernel's work: the larger
    of the bytes it must move (each input read once, each output written
    once) over HBM bandwidth and its 32-bit integer multiplies over the
    card's rate for them (SMs x 64 per clock x the maximum SM clock).  A
    W-word CIOS Montgomery multiply is 2 W^2 + W 32x32->64-bit products,
    each two 32-bit multiplies (low and high word)."""

    def __init__(self, torch, max_sm_mhz: float):
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        self.imul_per_s = sms * IMUL_PER_CLK_PER_SM * max_sm_mhz * 1e6
        log(f"bound rates: {HBM_BYTES_PER_S:.3e} B/s, {self.imul_per_s:.4e} 32-bit "
            f"multiplies/s ({sms} SMs at {max_sm_mhz:.0f} MHz)")

    @staticmethod
    def imuls(W: int, montmuls: float) -> float:
        return 2 * (2 * W * W + W) * montmuls

    def __call__(self, W: int, montmuls: float, nbytes: float):
        t_ops = self.imuls(W, montmuls) / self.imul_per_s
        t_bytes = nbytes / HBM_BYTES_PER_S
        return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def square_chain(apt, log_n: int):
    chain = (1 << log_n) - 3  # + final equality gate + 2 input rows = 2^log_n

    class SquareChain(apt.Circuit):
        y = apt.PublicInput()
        x = apt.SecretInput()

        def define(self, api):
            t = self.x
            for _ in range(chain):
                t = api.mul(t, t)
            api.assert_is_equal(t, self.y)

    return SquareChain, chain


def one_commit(apt):
    class OneCommit(apt.Circuit):
        x = apt.PublicInput()
        y = apt.SecretInput()

        def define(self, api):
            t = api.mul(self.y, self.y)
            v = api.commit(t)
            api.assert_is_different(v, 0)
            api.assert_is_equal(t, self.x)

    return OneCommit


def pythagorean(apt):
    class Pythagorean(apt.Circuit):
        a = apt.PublicInput()
        b = apt.PublicInput()
        c = apt.SecretInput()

        def define(self, api):
            a2 = api.mul(self.a, self.a)
            b2 = api.mul(self.b, self.b)
            c2 = api.mul(self.c, self.c)
            api.assert_is_equal(api.add(a2, b2), c2)

    return Pythagorean


def random_residues(torch, f, n: int, gen):
    """n canonical residues [n, W] on f's device over all of [0, p): random
    words under a top word below p's, so that values in [2^(bits(p) - 1),
    p) come up (where a lazy reduction would fail), and the edge values 0,
    1, 2, p - 1, p - 2, (p - 1) / 2, 2^(bits(p) - 1) and Montgomery one spread
    over the rows."""
    from algoplonk_tpu_torch.fields.words import ints_to_words

    p = f.fp.modulus
    x = torch.randint(-2**31, 2**31, (n, f.W), generator=gen, dtype=torch.int64)
    x[:, -1] = torch.randint(0, p >> (32 * (f.W - 1)), (n,), generator=gen)
    x = x.to(torch.int32)
    edges = [0, 1, 2, p - 1, p - 2, (p - 1) // 2, 1 << (p.bit_length() - 1), f.wf.r]
    rows = torch.linspace(0, n - 1, len(edges)).long().unique()
    x[rows] = torch.from_numpy(ints_to_words(edges[: len(rows)], f.W))
    return x.to(f.device).contiguous()


def commit_widths(n: int):
    """K1-K4's lane widths in one MSM of n points (c = 11, K = 16, S = 16)."""
    from algoplonk_tpu_torch.ops import msm as M

    c = M.pick_window_bits(n)
    nw = M.num_windows(c)
    nblk = -(-n // (M.K_BLOCK * M.SUPER)) * M.SUPER
    return (M._pad_lanes(nw * nblk), M._pad_lanes(nw * ((1 << (c - 1)) + 1)),
            M._pad_lanes(nw * (nblk // M.SUPER)))


def commit_windows(n: int):
    """(windows, super-blocks per window, D, c) of one MSM of n points: K3's
    scan runs over nw windows of nsb lanes, its phase 4 over nw windows of
    D + 1 lanes."""
    from algoplonk_tpu_torch.ops import msm as M

    c = M.pick_window_bits(n)
    nblk = -(-n // (M.K_BLOCK * M.SUPER)) * M.SUPER
    return M.num_windows(c), nblk // M.SUPER, 1 << (c - 1), c


class CommitInputs:
    """Random inputs of the MSM kernels at the lane widths of one commit of
    n_commit points on ``curve`` (commit_widths): a table of the commit's
    own size (n_commit + 1 rows drawn from 256 random points, the identity
    row last), projective points and K1's packed steps over it."""

    def __init__(self, torch, rng, curve, n_commit):
        from algoplonk_tpu_torch.host import fp as hfp
        from algoplonk_tpu_torch.ops.curve import curve_ops

        self.torch, self.dev = torch, torch.device("cuda")
        self.ops = ops = curve_ops(curve, self.dev)
        W = ops.W
        self.g = torch.Generator(device="cpu").manual_seed(1 + W)
        self.w1p, self.w2p, self.wsbp = commit_widths(n_commit)
        F = hfp.GF(curve.fp.modulus)
        base = [hfp.ec_mul(F, curve.g1, rng.randrange(1, curve.fr.modulus)) for _ in range(256)]
        self.nrows = n_commit + 1
        pick = torch.randint(0, 256, (self.nrows,), generator=self.g).to(self.dev)
        self.table = ops.encode_affine(base)[pick].reshape(self.nrows, 2 * W).contiguous()
        self.table[-1] = 0

    def rand_proj(self, lanes):
        """Random projective points: (doubled, so Z != 1; table rows;
        undoubled).  The first 8 lanes are the identity."""
        ops = self.ops
        idx = self.torch.randint(0, self.nrows, (lanes,), generator=self.g).to(self.dev)
        idx[:8] = self.nrows - 1
        p = ops.affine_to_jac(self.table[idx].reshape(lanes, 2, ops.W))
        return ops.jac_double(p).permute(1, 2, 0).contiguous(), idx, p.permute(1, 2, 0)

    def k1_inputs(self, lanes):
        """FUSE_STEPS signed gather-adds over random rows of the table; lanes
        0-63 add their own point (doubling), lanes 64-127 its negation
        (result: identity).  Returns (acc, rows, sign, packed)."""
        from algoplonk_tpu_torch.ops import curve_kernels as ck
        from algoplonk_tpu_torch.ops import msm as M

        torch, g = self.torch, self.g
        acc, acc_idx, acc_plain = self.rand_proj(lanes)
        acc[:, :, :128] = acc_plain[:, :, :128]
        rows = torch.randint(0, self.nrows, (M.FUSE_STEPS, lanes), generator=g).to(self.dev)
        sign = torch.randint(0, 2, (M.FUSE_STEPS, lanes), generator=g).to(self.dev)
        rows[0, :128] = acc_idx[:128]
        sign[0, :64] = 0
        sign[0, 64:128] = 1
        return acc, rows, sign, (rows | (sign << ck.SIGN_SHIFT)).to(torch.int32).contiguous()

    def k2_inputs(self, lanes):
        """K2's acc [3, W, lanes] and SUPER steps qs [3 SUPER, W, lanes]."""
        from algoplonk_tpu_torch.ops import msm as M

        qs = self.torch.cat([self.rand_proj(lanes)[0] for _ in range(M.SUPER)]).contiguous()
        return self.rand_proj(lanes)[0], qs


@contextlib.contextmanager
def forced_threads(T: int, chooser: str = "scan_threads"):
    """The wrapper whose thread count ``chooser`` of curve_kernels picks
    (K2 ``scan_threads``, K7 ``multi_threads``, K6 ``mixed_threads``) runs T
    threads per lane, whatever the shape."""
    from algoplonk_tpu_torch.ops import curve_kernels as ck

    saved = getattr(ck, chooser)
    setattr(ck, chooser, lambda *shape: T)
    try:
        yield
    finally:
        setattr(ck, chooser, saved)


def every_thread_count(torch, name, kern, plain, choices, chooser, picked, suffix,
                       device=None):
    """``kern`` (one launch of kernel ``name``) at every thread count per
    lane T of ``choices``, forced through ``chooser``: word for word equal
    to ``plain(T)``, which launches nothing, and timed (CUDA events, 20
    launches; with ``device``, a part of the kernel's name, also device_ms
    over 20).  Returns [{"T", "picked", "ms"[, "device_ms"]}]."""
    shapes = []
    for T in choices:
        with forced_threads(T, chooser):
            out_k = kern()
            torch.cuda.synchronize()
            want = plain_launches_nothing(lambda: plain(T), name + suffix)
            if not torch.equal(out_k, want):
                raise AssertionError(f"{name}{suffix} at T = {T} disagrees with its plain version")
            shapes.append({"T": T, "picked": T == picked, "ms": cuda_ms(kern, 20)})
            if device:
                shapes[-1]["device_ms"] = device_ms(torch, kern, 20, device)
    log(f"{name}{suffix}: exact at every T; by T (* the wrapper's): "
        + ", ".join(f"T={x['T']}{'*' if x['picked'] else ''} {x['ms']:.4f} ms"
                    + (f" (device {x['device_ms']:.4f} ms)" if device else "")
                    for x in shapes))
    return shapes


def kernel_phase(torch, rng, curve, n_commit, bound, suffix, k2_lanes=(), scan_E=()):
    """K1-K7 on ``curve`` against their plain versions at the lane widths of
    one commit of n_commit points; names carry ``suffix``.  K1 gathers from
    a table of the commit's own size (n_commit + 1 rows) and is timed at
    the phase-1 and phase-3 widths; K2 is checked at every T it takes and
    timed at every T at the commit's phase-2a width and at ``k2_lanes``;
    K3's scan at the commit's windows and at windows of ``scan_E`` lanes,
    its phase 4 at the commit's windows."""
    from algoplonk_tpu_torch.ops import curve_kernels as ck
    from algoplonk_tpu_torch.ops import msm as M

    s = CommitInputs(torch, rng, curve, n_commit)
    ops, W, pts_flat, nrows = s.ops, s.ops.W, s.table, s.nrows
    w1p, w2p, wsbp = s.w1p, s.w2p, s.wsbp
    log(f"[{curve.name}] kernel widths at W = {W}: w1p={w1p} w2p={w2p} wsbp={wsbp}")
    results = []

    def check(name, kern, plain, reps, montmuls, moved, device=None, flush=None, **extra):
        """kern against plain, word for word, and timed: by CUDA events over
        reps launches, or with ``device`` (a part of the kernel's name) by
        device_ms (the L2 flushed before each launch with ``flush``), the
        events' time then kept as "events_ms"."""
        out_k = kern()
        torch.cuda.synchronize()
        out_p = plain_launches_nothing(plain, name + suffix)
        diff = (out_k.to(torch.int64) - out_p.to(torch.int64)).abs().max().item()
        ms = events_ms = cuda_ms(kern, reps)
        if device:
            ms = device_ms(torch, kern, 20, device, flush)
            extra["events_ms"] = events_ms
        plain_ms = cuda_ms(plain, 1)
        bound_ms, bound_by = bound(W, montmuls, moved + nbytes(out_k))
        log(f"{name}{suffix}: exact={diff == 0} kernel {ms:.4f} ms"
            + (f" on the device ({events_ms:.4f} ms a launch back to back)" if device else "")
            + f", plain {plain_ms:.2f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
            f"{ms / bound_ms:.2f}x")
        if diff != 0:
            raise AssertionError(f"{name}{suffix}: kernel disagrees with its plain version")
        results.append({"name": name + suffix, "route": "cuda", "source": SOURCE[name],
                        "replaces": REPLACES[name], "kernel": name, "width": W,
                        "max_abs_err": diff, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                        **extra})

    # K1 at the phase-3 width first (timed only), then at the phase-1 width
    acc, _, _, packed = s.k1_inputs(w2p)
    k1_w2p = cuda_ms(lambda: ck.mixed_add_signed_multi(ops, acc, pts_flat, packed), 20)
    acc, rows, sign, packed = s.k1_inputs(w1p)
    check("mixed_add_signed_multi",
          lambda: ck.mixed_add_signed_multi(ops, acc, pts_flat, packed),
          lambda: ck.plain_mixed_add_signed_multi(ops, acc, pts_flat, packed), 20,
          M.FUSE_STEPS * w1p * MIXED_ADD_MULS, nbytes(acc, pts_flat, packed),
          shapes=[{"lanes": w1p, "table_rows": nrows}, {"lanes": w2p, "table_rows": nrows,
                                                        "ms": k1_w2p}])
    results[-1]["shapes"][0]["ms"] = results[-1]["ms"]
    log(f"mixed_add_signed_multi{suffix} on the {nrows}-row table: w1p={w1p} "
        f"{results[-1]['ms']:.4f} ms, w2p={w2p} {k1_w2p:.4f} ms")
    # K5 and K6 (one kernel) at the same width: one step, the gathered
    # point given; each at every T_m (exact against its plain version, which
    # has no T_m), then checked and timed at the wrapper's, on the device
    aff = pts_flat[rows[0]].reshape(w1p, 2, W).permute(1, 2, 0).contiguous()
    neg = sign[:1].to(torch.int32).contiguous()
    for name, kern, plain, moved in (
            ("mixed_add", lambda: ck.mixed_add(ops, acc, aff),
             lambda: ck.plain_mixed_add(ops, acc, aff), nbytes(acc, aff)),
            ("mixed_add_signed", lambda: ck.mixed_add_signed(ops, acc, aff, neg),
             lambda: ck.plain_mixed_add_signed(ops, acc, aff, neg), nbytes(acc, aff, neg))):
        shapes = every_thread_count(torch, name, kern, lambda T, plain=plain: plain(),
                                    ck.MIXED_THREADS, "mixed_threads", ck.mixed_threads(W),
                                    suffix, device="mixed_add")
        check(name, kern, plain, 20, w1p * MIXED_ADD_MULS, moved, device="mixed_add",
              T=ck.mixed_threads(W), shapes=shapes)
    # K2 at every T (exact against the plain scan in the same association),
    # then timed at every T at each phase-2a width, and checked at the
    # wrapper's T; K7 at the commit's width
    acc2, qs = s.k2_inputs(wsbp)
    for T in ck.SCAN_THREADS:
        with forced_threads(T):
            out_k = ck.jac_add_multi_scan(ops, acc2, qs)
        torch.cuda.synchronize()
        want = plain_launches_nothing(lambda: ck.plain_jac_add_multi_scan(ops, acc2, qs, T),
                                      "jac_add_multi_scan")
        if not torch.equal(out_k, want):
            raise AssertionError(f"jac_add_multi_scan{suffix} at T = {T} disagrees with its "
                                 "plain version")
    log(f"jac_add_multi_scan{suffix}: exact at every T in {ck.SCAN_THREADS}")
    shapes = []
    for lanes in (wsbp, *k2_lanes):
        a_x, q_x = (acc2, qs) if lanes == wsbp else s.k2_inputs(lanes)
        picked = ck.scan_threads(lanes, M.SUPER)
        for T in ck.SCAN_THREADS:
            with forced_threads(T):
                ms = cuda_ms(lambda: ck.jac_add_multi_scan(ops, a_x, q_x), 20)
            shapes.append({"lanes": lanes, "T": T, "picked": T == picked, "ms": ms})
        if lanes != wsbp:   # the plain scan at the wrapper's T (check() times wsbp's)
            shapes[-len(ck.SCAN_THREADS) + ck.SCAN_THREADS.index(picked)]["plain_ms"] = \
                cuda_ms(lambda: ck.plain_jac_add_multi_scan(ops, a_x, q_x), 1)
    check("jac_add_multi_scan",
          lambda: ck.jac_add_multi_scan(ops, acc2, qs),
          lambda: ck.plain_jac_add_multi_scan(ops, acc2, qs), 20,
          M.SUPER * wsbp * JAC_ADD_MULS, nbytes(acc2, qs), T=ck.scan_threads(wsbp, M.SUPER))
    results[-1]["shapes"] = shapes
    log(f"jac_add_multi_scan{suffix} by lanes and T (* the wrapper's): "
        + ", ".join(f"{x['lanes']} lanes T={x['T']}{'*' if x['picked'] else ''} "
                    f"{x['ms']:.4f} ms"
                    + (f" (plain {x['plain_ms']:.2f} ms)" if "plain_ms" in x else "")
                    for x in shapes))
    # K7 at every T (exact against its plain version at the same T), then
    # checked and timed at the wrapper's
    k7_shapes = every_thread_count(
        torch, "jac_add_multi", lambda: ck.jac_add_multi(ops, acc2, qs),
        lambda T: ck.plain_jac_add_multi(ops, acc2, qs, T), ck.MULTI_THREADS,
        "multi_threads", ck.multi_threads(wsbp, M.SUPER), suffix)
    check("jac_add_multi",
          lambda: ck.jac_add_multi(ops, acc2, qs),
          lambda: ck.plain_jac_add_multi(ops, acc2, qs), 20,
          M.SUPER * wsbp * JAC_ADD_MULS, nbytes(acc2, qs), T=ck.multi_threads(wsbp, M.SUPER),
          shapes=k7_shapes)
    # K3 at phase-3/4 width, with p + p and p + (-p) lanes
    p3 = s.rand_proj(w2p)[0]
    q3 = s.rand_proj(w2p)[0]
    q3[:, :, :128] = p3[:, :, :128]
    q3[1, :, 64:128] = ops.f.neg(p3[1, :, 64:128].T).T
    check("jac_add", lambda: ck.jac_add(ops, p3, q3),
          lambda: ck.plain_jac_add(ops, p3, q3), 50, w2p * JAC_ADD_MULS, nbytes(p3, q3))
    # K3's scan over nw windows of E lanes.  The bound counts the E - 1 adds
    # a window's inclusive scan needs; the Kogge-Stone rounds do nw E rounds
    # adds (every lane adds once per round, the identity below the shift),
    # printed as the work done, in a chain of rounds dependent adds.  Beside
    # it, the same rolled scan with one K3 launch per round, as the MSM ran
    # it before the scan had its own kernel; p + p and p + (-p) in round 1
    nw, nsb, D, c = commit_windows(n_commit)
    first = len(results)
    for E in (nsb, *scan_E):
        x = s.rand_proj(M._pad_lanes(nw * E))[0]
        x[:, :, 9] = x[:, :, 8]
        x[:, :, 11] = x[:, :, 10]
        x[1, :, 11] = ops.f.neg(x[1, :, 10].contiguous())
        rounds = (E - 1).bit_length()

        def per_round():
            return ck.plain_jac_add_window_scan(ops, x, nw, E, add=ck.jac_add)

        check("jac_add_window_scan", lambda: ck.jac_add_window_scan(ops, x, nw, E),
              lambda: ck.plain_jac_add_window_scan(ops, x, nw, E), 20,
              nw * (E - 1) * JAC_ADD_MULS, 3 * W * 4 * nw * E,
              windows=nw, E=E, depth=rounds, work_adds=nw * rounds * E)
        if not torch.equal(per_round(), ck.jac_add_window_scan(ops, x, nw, E)):
            raise AssertionError("jac_add_window_scan disagrees with a K3 launch per round")
        results[-1]["rounds_ms"] = cuda_ms(per_round, 20)
        log(f"  {nw} windows of E = {E}: chain of {rounds} dependent adds, "
            f"{nw * (E - 1)} adds needed, {nw * rounds * E} done; a K3 launch per round "
            f"{results[-1]['rounds_ms']:.4f} ms")
    main, *more = results[first:]
    del results[first + 1:]
    main["shapes"] = [{k: r[k] for k in ("windows", "E", "depth", "work_adds", "ms",
                                         "rounds_ms", "plain_ms", "bound_ms")}
                      for r in (main, *more)]
    # K3's phase 4 over nw windows of D + 1 lanes: 2 D adds, c - 1 doublings
    # and one add per window, in a chain of c + 2 dependent point operations
    # (two P[e_d] adds, c - 1 tree rounds, the final add); a doubling in the
    # P[e_d] add, and window 1's P[e_D] the identity
    base, in_block = s.rand_proj(w2p)[0], s.rand_proj(w2p)[0]
    in_block[:, :, 64:128] = base[:, :, 64:128]
    top = 2 * D + 1
    in_block[:, :, top] = base[:, :, top]
    in_block[1, :, top] = ops.f.neg(base[1, :, top].contiguous())
    check("window_combine", lambda: ck.window_combine(ops, base, in_block, nw, c),
          lambda: ck.plain_window_combine(ops, base, in_block, nw, c), 20,
          nw * (2 * D * JAC_ADD_MULS + (c - 1) * JAC_DOUBLE_MULS + JAC_ADD_MULS),
          nbytes(base, in_block), windows=nw, D=D, depth=c + 2)
    log(f"  {nw} windows of D = {D}: chain of {c + 2} dependent point operations "
        f"(2 adds, {c - 1} tree rounds, 1 add)")
    # K4 on arbitrary W-word values with its ladder's edges, at the phase-3
    # width (the reference's MSM ran it there) and at CANON_LANES, where its
    # bytes bound is far above a launch's floor; on the device, the L2
    # flushed before each launch: it does no multiply, so its bound is bytes
    flush = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=s.dev)
    shapes = []
    for lanes in (w2p, CANON_LANES):
        x4 = canon_words(torch, ops, lanes, s.g)
        check("canon", lambda: ck.canon(ops, x4), lambda: ck.plain_canon(ops, x4), 50,
              0, nbytes(x4), device="canon", flush=flush)
        shapes.append({"lanes": lanes, **{k: results[-1][k] for k in (
            "ms", "events_ms", "plain_ms", "bound_ms", "bound_by")}})
    del results[-1]
    results[-1]["shapes"] = shapes
    return results


def piece_shapes(torch, rng, curve, bound, results, suffix):
    """K1 and K2 at the widths of one full MSM piece (M.CHUNK points: a
    commit of the 2^20 path runs four of them), K1 gathering from a table
    of the piece's size, each held word for word to its plain version
    (timed once) and timed (CUDA events) beside its bound; added to the
    "shapes" of the kernel's entry in ``results``."""
    from algoplonk_tpu_torch.ops import curve_kernels as ck
    from algoplonk_tpu_torch.ops import msm as M

    s = CommitInputs(torch, rng, curve, M.CHUNK)
    ops, W = s.ops, s.ops.W
    entry = {k["name"]: k for k in results}
    acc, _, _, packed = s.k1_inputs(s.w1p)
    acc2, qs = s.k2_inputs(s.wsbp)
    T = ck.scan_threads(s.wsbp, M.SUPER)
    for name, lanes, kern, plain, montmuls, moved in (
            ("mixed_add_signed_multi", s.w1p,
             lambda: ck.mixed_add_signed_multi(ops, acc, s.table, packed),
             lambda: ck.plain_mixed_add_signed_multi(ops, acc, s.table, packed),
             M.FUSE_STEPS * s.w1p * MIXED_ADD_MULS, nbytes(acc, s.table, packed)),
            ("jac_add_multi_scan", s.wsbp,
             lambda: ck.jac_add_multi_scan(ops, acc2, qs),
             lambda: ck.plain_jac_add_multi_scan(ops, acc2, qs),
             M.SUPER * s.wsbp * JAC_ADD_MULS, nbytes(acc2, qs))):
        out_k = kern()
        torch.cuda.synchronize()
        out_p, plain_ms = plain_once(torch, plain, name + suffix)
        if not torch.equal(out_k, out_p):
            raise AssertionError(f"{name}{suffix} at {lanes} lanes (an MSM piece) disagrees "
                                 "with its plain version")
        ms = cuda_ms(kern, 20)
        bound_ms, bound_by = bound(W, montmuls, moved + nbytes(out_k))
        shape = {"lanes": lanes, "piece": M.CHUNK, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": 0}
        if name == "mixed_add_signed_multi":
            shape["table_rows"] = s.nrows
        else:
            shape.update(T=T, picked=True)
        entry[name + suffix]["shapes"].append(shape)
        log(f"{name}{suffix} at an MSM piece's width ({M.CHUNK} points, {lanes} lanes): exact "
            f"kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
            f"{ms / bound_ms:.2f}x")


CANON_LANES = 1 << 20   # K4's large shape: [3, W, 2^20], 201 MB (W = 8) to 302 MB moved


def canon_words(torch, ops, lanes: int, g):
    """[3, W, lanes] random W-word values on ops' device, the first lanes of
    row 0 the edges of K4's ladder: 0, 1, p - 1, p, k p - 1, k p and k p + 1
    for every k up to floor((2^(32 W) - 1) / p), 2^(32 W) - 1, 2^(32 W - 1)."""
    from algoplonk_tpu_torch.fields.words import ints_to_words

    W, p = ops.W, ops.wf.modulus
    top = (1 << (32 * W)) - 1
    edges = [0, 1, p - 1, p, top, 1 << (32 * W - 1)]
    edges += [v for k in range(1, top // p + 1) for v in (k * p - 1, k * p, k * p + 1)]
    x = torch.randint(-2**31, 2**31, (3, W, lanes), generator=g, dtype=torch.int64)
    x = x.to(torch.int32)
    x[0, :, :len(edges)] = torch.from_numpy(ints_to_words(edges, W)).T
    return x.to(ops.device).contiguous()


def launch_counts():
    """Every kernel launch counter of the port, by kernel."""
    from algoplonk_tpu_torch.ops import curve_kernels as ck
    from algoplonk_tpu_torch.ops import field_kernels as fk
    from algoplonk_tpu_torch.ops import ntt_kernels as nk

    return {**ck.LAUNCHES, **nk.LAUNCHES, **fk.LAUNCHES}


def plain_launches_nothing(fn, what):
    """Run ``fn`` (a plain version) and fail if any kernel counter moved."""
    import torch

    before = launch_counts()
    out = fn()
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}
    if moved:
        raise AssertionError(f"the plain version of {what} launched kernels: {moved}")
    return out


FIELD_ROWS = 1 << 18   # the largest field op of a prove: the 4n coset at 2^16


def field_shapes(torch, f, g, large: bool):
    """The operands of the field kernels at the prove's shapes: 2^18
    contiguous rows (with one multiplicand arbitrary below R), 256 rows
    against one element (a step of the blocked scans), and an NTT stage's
    strided halves of a 2^18 coset against its strided twiddle slice (stage
    half h = 512, ops/ntt.py); with ``large`` (a scalar field), also the
    2^22 rows of phase 10's round-3 coset."""
    n, h = FIELD_ROWS, 512
    a, b = random_residues(torch, f, n, g), random_residues(torch, f, n, g)
    a[:3] = f.encode([0, 1, f.fp.modulus - 1])
    arb = torch.randint(-2**31, 2**31, (n, f.W), generator=g, dtype=torch.int64)
    arb = arb.to(torch.int32).to(f.device)
    x = random_residues(torch, f, n, g).reshape(n // (2 * h), 2, h, f.W)
    tw = random_residues(torch, f, n // 2, g)[:: n // (2 * h)][:h]
    shapes = [(f"{n} rows", a, b), (f"{n} rows, a below R", arb, b),
              ("256 rows x 1", a[:256], b[7]), (f"ntt halves {n // (2 * h)}x{h}", x[:, 1], tw),
              (f"ntt u, v {n // (2 * h)}x{h}", x[:, 0], x[:, 1])]
    if large:
        big = 4 << LARGE_LOG_N
        shapes.append((f"{big} rows", random_residues(torch, f, big, g),
                       random_residues(torch, f, big, g)))
    return shapes


def field_phase(torch, apt, bound):
    """K8 and field_add_sub against their plain versions on each of the four
    fields at the prove's shapes (``field_shapes``, the 2^22 rows of phase
    10's coset on the scalar fields; K8 with one operand
    arbitrary below R against host integers), each timed on the device with
    its inputs read from HBM (the L2 flushed before each launch) and left in
    the L2, beside its bound; every plain call must launch nothing.  Then
    the host microseconds of one wrapper call (launch included) and of its
    operand layout alone."""
    from algoplonk_tpu_torch.ops import field_kernels as fk
    from algoplonk_tpu_torch.ops._build import stream_of
    from algoplonk_tpu_torch.ops.field import (field_ops, plain_add, plain_mul, plain_neg,
                                               plain_sub)

    g = torch.Generator(device="cpu").manual_seed(8)
    flush = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    results = []
    for curve in (apt.BN254, apt.BLS12_381):
        for fp in (curve.fr, curve.fp):
            f = field_ops(fp, "cuda")
            by_kernel = {"field_mul": [], "field_add_sub": []}
            worst = 0
            for shape, a, b in field_shapes(torch, f, g, fp is curve.fr):
                ops = [("field_mul", "mul", fk.field_mul, plain_mul, (a, b))]
                if "below R" not in shape:
                    ops += [("field_add_sub", "add", fk.field_add, plain_add, (a, b)),
                            ("field_add_sub", "sub", fk.field_sub, plain_sub, (a, b)),
                            ("field_add_sub", "neg", fk.field_neg, plain_neg, (a,))]
                for kname, op, kern, plain, xs in ops:
                    out_k = kern(f, *xs)
                    torch.cuda.synchronize()
                    out_p = plain_launches_nothing(lambda: plain(f, *xs), f"{kname} {op}")
                    if "below R" in shape:
                        # plain_mul's coarse REDC is exact for canonical
                        # operands only: K8's wider contract is held to
                        # host integers
                        out_p = host_mont_mul(torch, f, *xs)
                    diff = (out_k.to(torch.int64) - out_p.to(torch.int64)).abs().max().item()
                    if diff != 0 or out_k.shape != out_p.shape:
                        raise AssertionError(f"{kname} {op} [{fp.name}] {shape}: the kernel "
                                             "disagrees with its reference")
                    worst = max(worst, diff)
                    name = f"{kname}_kernel"
                    ms = device_ms(torch, lambda: kern(f, *xs), 20, name, flush)
                    warm_ms = device_ms(torch, lambda: kern(f, *xs), 20, name)
                    events_ms = cuda_ms(lambda: kern(f, *xs), 50)
                    plain_ms = cuda_ms(lambda: plain(f, *xs), 2)
                    rows = out_k.numel() // f.W
                    bound_ms, bound_by = bound(f.W, rows if kname == "field_mul" else 0,
                                               field_bytes(xs, out_k))
                    log(f"{kname} {op} [{fp.name}] {shape}: exact, kernel {ms:.4f} ms on the "
                        f"device from HBM ({warm_ms:.4f} ms with its inputs left in the L2, "
                        f"{events_ms:.4f} ms a launch back to back), plain {plain_ms:.2f} ms, "
                        f"bound {bound_ms:.4f} ms ({bound_by}), {ms / bound_ms:.2f}x")
                    by_kernel[kname].append({"op": op, "shape": shape, "rows": rows, "ms": ms,
                                             "warm_ms": warm_ms, "events_ms": events_ms,
                                             "plain_ms": plain_ms, "bound_ms": bound_ms,
                                             "bound_by": bound_by})
            # host cost of one call at the scans' size, which sets the launch
            # rate: the whole call, then three of its parts alone
            a, b = random_residues(torch, f, 256, g), random_residues(torch, f, 1, g)[0]
            host = {"call": lambda: fk.field_mul(f, a, b), "layout": lambda: fk.layout((a, b)),
                    "empty": lambda: torch.empty(a.shape, dtype=torch.int32, device=a.device),
                    "stream": lambda: stream_of(a)}
            host_us = {k: host_seconds(torch, fn, 2000) * 1e6 for k, fn in host.items()}
            t_call, t_layout = host_us["call"], host_us["layout"]
            log(f"field_mul [{fp.name}] host us per call (256 rows x 1): "
                + ", ".join(f"{k} {v:.1f}" for k, v in host_us.items()))
            for kname, shapes in by_kernel.items():
                main = shapes[0]
                results.append({"name": f"{kname}[{fp.name}]", "route": "cuda",
                                "source": SOURCE[kname], "replaces": REPLACES[kname],
                                "kernel": kname, "width": f.W, "field": fp.name,
                                "max_abs_err": worst, "ms": main["ms"],
                                "plain_ms": main["plain_ms"],
                                "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                                "library_ms": None, "shapes": shapes,
                                **({"host_us": host_us} if kname == "field_mul" else {})})
    return results


def host_mont_mul(torch, f, a, b):
    """a b R^-1 mod p of broadcast operands from host integers, as int32
    words of the broadcast shape on a's device."""
    from algoplonk_tpu_torch.fields.words import ints_to_words, words_to_ints

    a, b = torch.broadcast_tensors(a, b)
    xs = words_to_ints(a.reshape(-1, f.W).cpu().numpy())
    ys = words_to_ints(b.reshape(-1, f.W).cpu().numpy())
    p = f.modulus
    r_inv = pow(1 << (32 * f.W), -1, p)
    out = ints_to_words([x * y * r_inv % p for x, y in zip(xs, ys)], f.W)
    return torch.from_numpy(out).reshape(a.shape).to(a.device)


def field_bytes(xs, out) -> int:
    """Bytes a field op must move: the rows of each operand that are
    distinct in memory read once (a broadcast element once, not once per
    row), the output written once."""
    total = nbytes(out)
    for x in xs:
        rows = 1
        for size, stride in zip(x.shape[:-1], x.stride()[:-1]):
            rows *= size if stride else 1
        total += rows * x.shape[-1] * x.element_size()
    return total


def k9_shapes(fsp):
    """(C, inverse, fused) of the four K9 passes of a four-step transform,
    in the order the round-3 quotient runs them: P1, P2 (ntt_scr), P2', P1'
    (intt_scr); the fused ones run in the plan's column layout."""
    return ((fsp.n1, False, True), (fsp.n2, False, False),
            (fsp.n2, True, False), (fsp.n1, True, True))


def k9_montmuls(N: int, C: int, fused: bool, skip_ones: bool = True) -> int:
    """Montgomery multiplies a K9 pass must do: N/2 per stage, less the
    (N / C)(C - 1) butterflies whose twiddle is one, plus the entry and exit
    multiplies; with skip_ones False, the older count with the multiplies by one."""
    n = N // 2 * (C.bit_length() - 1) - (N // C * (C - 1) if skip_ones else 0)
    return n + (2 * N if fused else 0)


def stage_montmuls(N: int, h: int, entry: bool, exit_: bool) -> int:
    """Montgomery multiplies an ntt_stage launch must do: N/2 butterflies,
    less the N / 2h whose twiddle is one, plus the entry and exit
    multiplies."""
    return N // 2 - N // (2 * h) + N * (int(entry) + int(exit_))


def four_step_launches(log_n: int) -> tuple[int, int]:
    """(K9, ntt_stage) launches of one four-step transform of 2^log_n: two
    passes (n1 = 2^(log_n // 2), n2 = n / n1), each one K9 launch and one
    ntt_stage launch a stage of half MAX_C or more."""
    from algoplonk_tpu_torch.ops import ntt_kernels as nk

    log_max = nk.MAX_C.bit_length() - 1
    log_n1 = log_n // 2
    return 2, sum(max(0, lc - log_max) for lc in (log_n1, log_n - log_n1))


def plain_once(torch, fn, what):
    """One call of a plain version, which must launch nothing, and its
    milliseconds (CUDA events around that one call): at the 2^20 path's
    shapes a plain version takes seconds, so it runs once."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = plain_launches_nothing(fn, what)
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def ntt_kernel_phase(torch, bound):
    """K9 against its plain version, word for word, on both scalar fields
    (BN254's runs lazy, BLS12-381's strict) at the four pass shapes of the
    2^17 path's four-step transforms of 2^19 (n1 = 512, n2 = 1024), in the
    layouts the transforms run them (P1 and P1' in the column layout), the
    fused shapes also contiguous, at the four of the 2^20 path's
    transforms of 2^22 (n1 = n2 = 2048, K9's largest C) and at the four of
    the 2^21 path's transforms of 2^23 (n1 = 2048, n2 = 4096: P2 and P2'
    one HBM stage, ntt_stage, and K9 at 2048), in the transforms' layouts
    only, and at C = 4096 in the column layout with entry and exit at N =
    2^14 (P1 and P1' from a 2^24 coset on, K9 on pieces of 2048), on random
    residues with edge values.  Each is timed on the device
    (torch.profiler; a split pass as K9's time plus its stages') beside
    its bound, recounted without the multiplies by one, and the bound of
    the count with them.  ms, plain_ms and bound_ms are BN254's sums over
    its four main-path passes of 2^19.  Then ``ntt_stage_phase``.  Returns
    K9's and ntt_stage's entries of the kernels line."""
    import algoplonk_tpu_torch as apt
    from algoplonk_tpu_torch.ops import ntt_kernels as nk

    passes = []

    def check_pass(f, N, C, inverse, x, tw, kw, layout, st, main_path, time_plain):
        lk = dict(kw, in_strides=st, out_strides=st)
        kern = lambda: nk.ntt_pass(f, x, tw, C, inverse, **lk)          # noqa: E731
        plain = lambda: nk.plain_ntt_pass(f, x, tw, C, inverse, **lk)   # noqa: E731
        out_k = kern()
        torch.cuda.synchronize()
        out_p, plain_ms = plain_once(torch, plain, "ntt_pass")
        diff = (out_k.to(torch.int64) - out_p.to(torch.int64)).abs().max().item()
        del out_p
        shape = (f"{f.fp.name} {'dit' if inverse else 'dif'} N={N} C={C}"
                 + (" entry+exit" if kw else "") + f" {layout}")
        if diff != 0:
            raise AssertionError(f"ntt_pass {shape}: kernel disagrees with its plain version")
        # device time of K9 and of the HBM stages (a stage launch's mean
        # times the stages of a call), each read from a trace of its own
        k9_ms = device_ms(torch, kern, 20, "ntt_pass")
        stages = max(0, (C // nk.MAX_C).bit_length() - 1)
        stage_ms = device_ms(torch, kern, 20, "ntt_stage") * stages if stages else 0.0
        ms = k9_ms + stage_ms
        if time_plain:
            plain_ms = cuda_ms(plain, 1)
        moved = nbytes(x, tw, out_k, *kw.values())
        fused = bool(kw)
        bound_ms, bound_by = bound(f.W, k9_montmuls(N, C, fused), moved)
        old_ms, _ = bound(f.W, k9_montmuls(N, C, fused, skip_ones=False), moved)
        split = f" (K9 {k9_ms:.4f}, ntt_stage {stage_ms:.4f})" if stage_ms else ""
        log(f"ntt_pass {shape}: exact kernel {ms:.4f} ms{split}, plain {plain_ms:.2f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}; with the multiplies by one {old_ms:.4f}), "
            f"{ms / bound_ms:.2f}x")
        entry = {"shape": shape, "field": f.fp.name, "N": N, "main_path": main_path,
                 "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                 "bound_old_ms": old_ms, "lazy": nk.lazy_headroom(f)}
        if stage_ms:
            entry.update(k9_ms=k9_ms, stage_ms=stage_ms)
        passes.append(entry)

    for log_sz in (LM_LOG_N + 2, LARGE_LOG_N + 2, DUSK_LOG_N + 2):
        for curve in (apt.BN254, apt.BLS12_381):
            fsp = nk.four_step_plan(curve.name, log_sz, "cuda")
            f, N = fsp.f, fsp.n
            g = torch.Generator(device="cpu").manual_seed(9)
            for C, inverse, fused in k9_shapes(fsp):
                x = random_residues(torch, f, N, g)
                tw = fsp.twiddles(C, inverse)
                kw = {}
                if fused:
                    kw = dict(entry=random_residues(torch, f, N, g),
                              exit_=random_residues(torch, f, N, g))
                layouts = [("column", fsp.column)]
                if not fused:
                    layouts = [("contiguous", None)]
                elif log_sz == LM_LOG_N + 2:
                    layouts.append(("contiguous", None))
                for layout, st in layouts:
                    check_pass(f, N, C, inverse, x, tw, kw, layout, st,
                               layout != "contiguous" or not fused, log_sz == LM_LOG_N + 2)
            del x, kw
    # C = 4096 in the column layout with entry and exit: P1 and P1' of a
    # 2^24 coset, at a small N (no prove here runs it)
    C, N = 2 * nk.MAX_C, 1 << 14
    for curve in (apt.BN254, apt.BLS12_381):
        f = nk.four_step_plan(curve.name, 14, "cuda").f
        g = torch.Generator(device="cpu").manual_seed(10)
        for inverse in (False, True):
            x = random_residues(torch, f, N, g)
            tw = f.encode(nk.stage_twiddles(curve.name, C, inverse))
            kw = dict(entry=random_residues(torch, f, N, g), exit_=random_residues(torch, f, N, g))
            check_pass(f, N, C, inverse, x, tw, kw, "column", (N // C, 1), False, True)
    for name in sorted({p["field"] for p in passes}):
        for N in sorted({p["N"] for p in passes}):
            mine = [p for p in passes if p["main_path"] and p["field"] == name and p["N"] == N]
            if mine:
                log(f"ntt_pass {name} N={N}, the four main-path passes: "
                    f"{sum(p['ms'] for p in mine):.4f} ms, bound "
                    f"{sum(p['bound_ms'] for p in mine):.4f} ms (with the multiplies by one "
                    f"{sum(p['bound_old_ms'] for p in mine):.4f})")
    main = [p for p in passes if p["main_path"] and p["field"] == "bn254_fr"
            and p["N"] == 1 << (LM_LOG_N + 2)]
    k9 = {"name": "ntt_pass", "route": "cuda", "source": NTT_SRC,
          "replaces": REPLACES["ntt_pass"], "kernel": "ntt_pass", "width": 8,
          "max_abs_err": 0,
          "ms": sum(p["ms"] for p in main),
          "plain_ms": sum(p["plain_ms"] for p in main),
          "bound_ms": sum(p["bound_ms"] for p in main),
          "bound_by": "operations" if all(p["bound_by"] == "operations" for p in main) else "bytes",
          "library_ms": None, "passes": passes}
    return k9, ntt_stage_phase(torch, bound)


def ntt_stage_phase(torch, bound):
    """ntt_stage against its plain version, word for word, on both scalar
    fields: the one HBM stage (half 2048) of the 2^21 path's P2 and P2'
    (contiguous, N = 2^23, C = 4096), and of a C = 4096 column pass at N =
    2^14, the DIF stage with the entry multiply and the DIT stage with the
    exit multiply.  Each is timed on the device beside its bound (bytes:
    x and out, and the twiddle rows it reads; multiplies: the butterflies'
    less those by one, and the entry or exit).  ms, plain_ms and bound_ms
    are BLS12-381's sums over its two main-path stages."""
    import algoplonk_tpu_torch as apt
    from algoplonk_tpu_torch.ops import ntt_kernels as nk

    shapes = []
    for curve in (apt.BLS12_381, apt.BN254):
        fsp = nk.four_step_plan(curve.name, DUSK_LOG_N + 2, "cuda")   # no table but tw
        g = torch.Generator(device="cpu").manual_seed(13)
        f, C, h = fsp.f, fsp.n2, nk.MAX_C
        for N, layout, st in ((fsp.n, "contiguous", None),
                              (1 << 14, "column", ((1 << 14) // C, 1))):
            for inverse in (False, True):
                x = random_residues(torch, f, N, g)
                tw = fsp.twiddles(C, inverse)
                kw = {}
                if layout == "column":   # P1 takes the entry multiply, P1' the exit
                    kw = {"exit_" if inverse else "entry": random_residues(torch, f, N, g)}

                def kern():
                    return nk.ntt_stage(f, x, tw, C, h, inverse, **kw, strides=st)

                def plain():
                    return nk.plain_ntt_stage(f, x, tw, C, h, inverse, **kw, strides=st)

                out_k = kern()
                torch.cuda.synchronize()
                out_p, plain_ms = plain_once(torch, plain, "ntt_stage")
                diff = (out_k.to(torch.int64) - out_p.to(torch.int64)).abs().max().item()
                del out_p
                shape = (f"{f.fp.name} {'dit' if inverse else 'dif'} N={N} C={C} h={h}"
                         + "".join(f" {k.rstrip('_')}" for k in kw) + f" {layout}")
                if diff != 0:
                    raise AssertionError(f"ntt_stage {shape}: kernel disagrees with its plain "
                                         "version")
                ms = device_ms(torch, kern, 20, "ntt_stage")
                moved = nbytes(x, tw[h : 2 * h], out_k, *kw.values())
                muls = stage_montmuls(N, h, "entry" in kw, "exit_" in kw)
                bound_ms, bound_by = bound(f.W, muls, moved)
                log(f"ntt_stage {shape}: exact kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, "
                    f"bound {bound_ms:.4f} ms ({bound_by}), {ms / bound_ms:.2f}x")
                shapes.append({"shape": shape, "field": f.fp.name, "N": N,
                               "main_path": layout == "contiguous", "ms": ms,
                               "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by})
                del x, kw, out_k
    main = [p for p in shapes if p["main_path"] and p["field"] == "bls12_381_fr"]
    return {"name": "ntt_stage", "route": "cuda", "source": NTT_SRC,
            "replaces": REPLACES["ntt_stage"], "kernel": "ntt_stage", "width": 8,
            "max_abs_err": 0,
            "ms": sum(p["ms"] for p in main),
            "plain_ms": sum(p["plain_ms"] for p in main),
            "bound_ms": sum(p["bound_ms"] for p in main),
            "bound_by": "operations" if all(p["bound_by"] == "operations" for p in main) else "bytes",
            "library_ms": None, "shapes": shapes}


def kernel_test_path(torch, curve, lanes: int = 1024):
    """K4-K8 on one curve as the reference's kernel tests drive them, each
    result against host arithmetic: K4 on arbitrary words and its ladder's
    edges (and against its plain version), K5 and K6 on identity, doubling
    and cancelling lanes, K7 over four steps, K8 on both fields."""
    from algoplonk_tpu_torch.fields.words import words_to_ints
    from algoplonk_tpu_torch.host import fp as hfp
    from algoplonk_tpu_torch.ops import curve_kernels as ck
    from algoplonk_tpu_torch.ops import field_kernels as fk
    from algoplonk_tpu_torch.ops.curve import curve_ops
    from algoplonk_tpu_torch.ops.field import field_ops

    rng = random.Random(0x5EED + curve.fp.nbits)
    F = hfp.GF(curve.fp.modulus)
    ops = curve_ops(curve, "cuda")
    base = [hfp.ec_mul(F, curve.g1, rng.randrange(1, 1 << 64)) for _ in range(32)] + [None]
    P = [rng.choice(base) for _ in range(lanes)]
    Q = [rng.choice(base) for _ in range(lanes)]
    for i in range(0, lanes, 16):
        Q[i] = P[i]                                        # doubling
        Q[i + 1] = hfp.ec_neg(F, P[i + 1]) if P[i + 1] else None   # cancellation
        P[i + 2], Q[i + 3] = None, None                    # identities
    neg = [rng.randrange(2) for _ in range(lanes)]

    def lm(bm):
        return bm.permute(1, 2, 0).contiguous()

    def proj(points):
        return ops.jac_double(ops.affine_to_jac(ops.encode_affine(points)))

    def affine(out_lm):
        return ops.decode_affine(ops.to_affine(out_lm.permute(2, 0, 1)))

    def ints(words_lm):
        return words_to_ints(words_lm.transpose(1, 2).reshape(-1, ops.W).cpu().numpy())

    x = canon_words(torch, ops, lanes, torch.Generator(device="cpu").manual_seed(curve.fp.nbits))
    got = ck.canon(ops, x)
    ok = torch.equal(got, ck.plain_canon(ops, x))
    ok &= ints(got) == [v % curve.fp.modulus for v in ints(x)]

    dP = [hfp.ec_double(F, a) for a in P]
    acc = lm(proj(P))
    got = affine(ck.mixed_add(ops, acc, lm(ops.encode_affine(Q))))
    ok &= got == [hfp.ec_add(F, a, b) for a, b in zip(dP, Q)]
    signed = [hfp.ec_neg(F, q) if s and q else q for q, s in zip(Q, neg)]
    neg_t = torch.tensor([neg], dtype=torch.int32, device="cuda")
    got = affine(ck.mixed_add_signed(ops, acc, lm(ops.encode_affine(Q)), neg_t))
    ok &= got == [hfp.ec_add(F, a, b) for a, b in zip(dP, signed)]
    steps = [[rng.choice(base) for _ in range(lanes)] for _ in range(4)]
    qs = torch.cat([lm(proj(s)) for s in steps])
    want = dP
    for s in steps:
        want = [hfp.ec_add(F, a, hfp.ec_double(F, b)) for a, b in zip(want, s)]
    ok &= affine(ck.jac_add_multi(ops, acc, qs)) == want
    for fp in (curve.fr, curve.fp):
        f = field_ops(fp, "cuda")
        xs = [rng.randrange(fp.modulus) for _ in range(lanes - 2)] + [0, fp.modulus - 1]
        ys = [rng.randrange(fp.modulus) for _ in range(lanes - 2)] + [fp.modulus - 1, 0]
        ok &= f.decode(fk.field_mul(f, f.encode(xs), f.encode(ys))) == [
            x * y % fp.modulus for x, y in zip(xs, ys)]
    return ok


def device_kernel_names(torch, fn, expect: int):
    """Names of the CUDA kernels and copies that one synchronised call of fn
    runs on the device (torch.profiler), from the first trace that holds at
    least ``expect`` records, taken between idle pads as in device_ms; the
    last trace's names if none does (it may have lost records)."""
    from torch.profiler import ProfilerActivity, profile

    for pad in TRACE_PADS:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            fn()
            torch.cuda.synchronize()
            time.sleep(pad)
        names = [e.name() for e in prof.profiler.kineto_results.events()
                 if e.device_type() == torch.autograd.DeviceType.CUDA]
        if len(names) >= expect:
            break
        log(f"device_kernel_names: {len(names)} of {expect} records in the trace; again")
    return names


def dispatched_ops(torch, fn) -> list[str]:
    """The PyTorch operators that one call of fn dispatches, recorded on the
    host by a TorchDispatchMode: every PyTorch kernel and copy goes through
    one, so a call whose operators are all allocations (``aten.empty*``)
    runs no PyTorch kernel on the device."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    with Record() as rec:
        fn()
    return rec.ops


def four_step_check(torch):
    """One four-step coset transform of 2^19 against the radix-2 plan, and
    its round trip; then each direction, warm, must run two K9 launches and
    nothing else on the device (no transpose copy): its K9 count, its
    PyTorch operators (allocations only) and its device trace, which must
    hold no record but K9's."""
    import algoplonk_tpu_torch as apt
    from algoplonk_tpu_torch.ops import ntt_kernels as nk
    from algoplonk_tpu_torch.ops.ntt import ntt_plan

    log_n, shift = LM_LOG_N + 2, apt.BN254.coset_shift
    fsp = nk.four_step_plan("bn254", log_n, "cuda")
    coeffs = random_residues(torch, fsp.f, fsp.n, torch.Generator(device="cpu").manual_seed(10))
    t0 = time.perf_counter()
    ev = fsp.ntt_scr(coeffs, coset_shift=shift)
    torch.cuda.synchronize()
    t_fs = time.perf_counter() - t0
    t0 = time.perf_counter()
    nat = ntt_plan("bn254", log_n, "cuda").coset_ntt(coeffs, shift)
    torch.cuda.synchronize()
    t_r2 = time.perf_counter() - t0
    perm = torch.from_numpy(fsp.scramble_perm()).to(coeffs.device)
    same = torch.equal(ev, nat[perm])
    back = torch.equal(fsp.intt_scr(ev, coset_shift=shift), coeffs)
    log(f"coset transform of 2^{log_n}: four-step {t_fs:.3f} s (tables included), "
        f"radix-2 plan {t_r2:.3f} s (plan included); equal: {same}; round trip: {back}")
    if not (same and back):
        raise AssertionError("four-step coset transform disagrees with the radix-2 plan")
    for name, fn in (("ntt_scr", lambda: fsp.ntt_scr(coeffs, coset_shift=shift)),
                     ("intt_scr", lambda: fsp.intt_scr(ev, coset_shift=shift))):
        before = nk.LAUNCHES["ntt_pass"]
        ops = dispatched_ops(torch, fn)
        k9 = nk.LAUNCHES["ntt_pass"] - before
        names = device_kernel_names(torch, fn, 2)
        log(f"{name} of 2^{log_n}, warm: {k9} K9 launches; PyTorch operators: {ops}; "
            f"device events: {names}")
        if k9 != 2 or not all(op.startswith("aten.empty") for op in ops):
            raise AssertionError(f"{name} ran more than its two K9 passes: {k9} K9, {ops}")
        if len(names) > 2 or not all("ntt_pass" in n for n in names):
            raise AssertionError(f"{name} ran more than its two K9 passes on the device: {names}")
        if len(names) < 2:
            log(f"{name}: the profiler lost records in every trace ({len(names)} of 2); "
                "the operator record and the K9 count above decide")


def quotient_paths(torch, apt, cc, circuit, tag, reps: int = 5):
    """Round 3's seconds through both quotient paths at one size:
    Prover(rng=False) on one witness, warm (one prove each first), reps
    proves per path in alternating order; both must give the same bytes."""
    from algoplonk_tpu_torch.frontend import witness as witness_mod
    from algoplonk_tpu_torch.plonk.marshal import marshal_proof
    from algoplonk_tpu_torch.plonk.prove import Prover

    if cc.ccs.commitments:
        raise ValueError("one witness serves every prover only without BSB22 commitments")
    wit = witness_mod.solve(cc.ccs, circuit)
    r3, blobs = {"0": [], "1": []}, {}
    try:
        for i in range(reps + 1):
            for lm in ("0", "1") if i % 2 == 0 else ("1", "0"):
                os.environ["AP_QUOTIENT_LM"] = lm
                prover = Prover(cc.pk, cc.ccs, rng=False)
                blobs[lm] = marshal_proof(cc.curve, prover.prove(wit))
                if i:
                    r3[lm].append(prover.phase_seconds["r3"])
    finally:
        os.environ.pop("AP_QUOTIENT_LM", None)
    med = {k: sorted(v)[len(v) // 2] for k, v in r3.items()}
    log(f"{tag} round 3 by quotient path, Prover(rng=False), warm, {reps} each alternating (s): "
        f"four-step {json.dumps([round(t, 4) for t in r3['1']])} (median {med['1']:.4f}), "
        f"batch-major {json.dumps([round(t, 4) for t in r3['0']])} (median {med['0']:.4f}); "
        f"proof bytes equal: {blobs['0'] == blobs['1']}")
    if blobs["0"] != blobs["1"]:
        raise AssertionError(f"{tag} the two quotient paths give different proofs")
    return r3


def profile_device(torch, fn):
    """Run fn once under torch.profiler (CUDA activity only) and read the
    trace: (CUDA kernel launches, device events by type, device busy share,
    wall seconds).  Device events named Memcpy or Memset are copies and
    sets, every other one a kernel.  The busy share is the union of the
    device events' intervals over the wall time of the call."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_type, spans = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name()
        kind = ("memcpy" if name.startswith("Memcpy") else
                "memset" if name.startswith("Memset") else "kernel")
        by_type[kind] = by_type.get(kind, 0) + 1
        spans.append((e.start_ns(), e.start_ns() + e.duration_ns()))
    spans.sort()
    busy, end = 0, None
    for lo, hi in spans:
        if end is None or lo > end:
            busy += hi - lo
            end = hi
        elif hi > end:
            busy += hi - end
            end = hi
    return by_type.get("kernel", 0), by_type, busy * 1e-9 / wall, wall


class Split:
    """Synchronised marks for MsmCtx.msm_to_affine_int's ``mark``: the host
    seconds of each part of one MSM, by the part's name."""

    def __init__(self, torch):
        self.torch, self.parts = torch, {}
        torch.cuda.synchronize()
        self.t0 = self.last = time.perf_counter()

    def __call__(self, name):
        self.torch.cuda.synchronize()
        now = time.perf_counter()
        self.parts[name] = self.parts.get(name, 0.0) + now - self.last
        self.last = now

    def report(self, tag):
        total = self.last - self.t0
        log(f"{tag} MSM split (s, synchronised marks): total {total:.4f}; "
            + json.dumps({k: round(v, 5) for k, v in self.parts.items()})
            + f"; phase 4 {self.parts['phase 4'] / total:.1%} of the MSM")


def msm_split(torch, ctx, pts, mont, want, tag):
    """One marked MSM (warm): its split, and its result against ``want``."""
    split = Split(torch)
    got = ctx.msm_to_affine_int(pts, mont, kind="mont", mark=split)
    split.report(tag)
    if got != want:
        raise AssertionError(f"{tag} marked MSM disagrees")


class msm_timer:
    """Host seconds spent in MsmCtx.msm_to_affine_int.  Each call starts
    after a synchronise and ends in a host fold that waits for the device,
    so the sum is the MSMs' share of a prove."""

    def __enter__(self):
        import torch
        from algoplonk_tpu_torch.ops import msm as M

        self.seconds, self.calls = 0.0, 0
        self.orig = orig = M.MsmCtx.msm_to_affine_int

        def timed(ctx, *args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return orig(ctx, *args, **kwargs)
            finally:
                self.seconds += time.perf_counter() - t0
                self.calls += 1

        M.MsmCtx.msm_to_affine_int = timed
        return self

    def __exit__(self, *exc):
        from algoplonk_tpu_torch.ops import msm as M

        M.MsmCtx.msm_to_affine_int = self.orig


def counts_since(before: dict) -> dict:
    """Launches by kernel and width since ``before`` (a launches_by_width() reading)."""
    now = launches_by_width()
    return {k: v - before.get(k, 0) for k, v in now.items() if v != before.get(k, 0)}


def launches_by_width() -> dict:
    """Every launch counter by (kernel, width): the one reader the phases
    compare readings of.  K9 counts at width 8, that of both scalar fields."""
    from algoplonk_tpu_torch.ops import curve_kernels as ck
    from algoplonk_tpu_torch.ops import field_kernels as fk
    from algoplonk_tpu_torch.ops import ntt_kernels as nk

    return {**ck.LAUNCHES_BY_WIDTH, **fk.LAUNCHES_BY_WIDTH,
            **{(k, 8): v for k, v in nk.LAUNCHES.items()}}


def emit_and_run(apt, cc, vp, tag):
    """cc's emitted logicsig and contract, each run under the AVM mock on
    vp's card proof (True) and on a flipped public-input byte (False).
    Returns the opcode budget of each accepted run, by contract type."""
    import tempfile

    from algoplonk_tpu_torch.chain import algopy_mock as mock

    proof, publics = vp.marshal_proof(), vp.marshal_public_inputs()
    flipped = publics[:31] + bytes([publics[31] ^ 1]) + publics[32:]
    budgets = {}
    with tempfile.TemporaryDirectory() as tmp:
        for ctype in apt.ContractType:
            path = os.path.join(tmp, f"Verifier_{ctype.value}.py")
            cc.write_puyapy_verifier(path, ctype)
            with open(path) as fh:
                ns = mock.exec_verifier_source(fh.read())
            run = mock.run_logicsig if ctype is apt.ContractType.LOGIC_SIG else \
                mock.run_contract_verify
            mock.budget.reset()
            t0 = time.perf_counter()
            ok = run(ns, proof, publics)
            secs = time.perf_counter() - t0
            budgets[ctype.value] = mock.budget.consumed()
            rejected = run(ns, proof, flipped) is False
            log(f"{tag} emitted {ctype.value} ({os.path.getsize(path)} bytes) under the AVM "
                f"mock: accepts the card proof {ok} in {secs:.2f} s, opcode budget "
                f"{budgets[ctype.value]}; flipped public input rejected {rejected}")
            if ok is not True or not rejected:
                raise AssertionError(f"{tag} emitted {ctype.value} verifier failed its checks")
    return budgets


def kzg_check(torch, cc, rng, gen):
    """KZG on cc's SRS (2^16 + 3 points on the card): commit, open at a
    random z and verify a polynomial of 2^KZG_LOG random residues (its value
    equals host Horner, value + 1 is rejected); at KZG_CHECK coefficients,
    commit and the opening's proof point equal the plain MSM, which
    launches nothing."""
    from algoplonk_tpu_torch.ops import msm as M
    from algoplonk_tpu_torch.ops import poly as polyops
    from algoplonk_tpu_torch.ops.kzg import KZG

    curve, dev = cc.curve, cc.pk.device
    r = curve.fr.modulus
    kzg = KZG(curve, cc.pk.srs_g1, cc.vk.kzg_g1, cc.vk.kzg_g2)
    coeffs = random_residues(torch, kzg.f, 1 << KZG_LOG, gen)
    z = rng.randrange(r)
    out = {}
    torch.cuda.synchronize()
    for name, fn in (("commit", lambda: kzg.commit(coeffs)), ("open", lambda: kzg.open(coeffs, z))):
        before = launches_by_width()
        t0 = time.perf_counter()
        out[name] = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        log(f"[kzg 2^{KZG_LOG}] {name}: {secs:.3f} s, launches {counts_since(before)}")
    C, opening = out["commit"], out["open"]
    want = 0
    for c in reversed(kzg.f.decode(coeffs)):
        want = (want * z + c) % r
    bad = type(opening)(value=(opening.value + 1) % r, proof=opening.proof)
    checks = {"value == host Horner": opening.value == want,
              "verify_opening": kzg.verify_opening(C, opening, z),
              "value + 1 rejected": not kzg.verify_opening(C, bad, z)}
    small = coeffs[:KZG_CHECK]
    plain = M.msm_ctx(curve, dev, plain=True)
    q, _ = polyops.kzg_quotient(kzg.f, small, kzg.f.encode([z])[0])
    checks["commit == plain MSM"] = kzg.commit(small) == plain_launches_nothing(
        lambda: plain.msm_to_affine_int(kzg.srs[:KZG_CHECK], small, kind="mont"), "the MSM")
    checks["open's proof == plain MSM"] = kzg.open(small, z).proof == plain_launches_nothing(
        lambda: plain.msm_to_affine_int(kzg.srs[:q.shape[0]], q, kind="mont"), "the MSM")
    log(f"[kzg] checks (2^{KZG_LOG}; plain MSM at {KZG_CHECK}): {checks}")
    if not all(checks.values()):
        raise AssertionError(f"KZG failed: {checks}")
    return kzg


def g1_ntt_check(torch, kzg, gen):
    """to_lagrange_g1 of the first 2^G1_NTT_LOG SRS points on the card,
    with its launches and seconds; then commit(coeffs) == commit_lagrange(
    ntt(coeffs), lag), both MSMs on the kernels, and lag[0] against host
    arithmetic ((1/n) sum_i P_i)."""
    from algoplonk_tpu_torch.host import fp as hfp
    from algoplonk_tpu_torch.ops.gntt import to_lagrange_g1
    from algoplonk_tpu_torch.ops.ntt import ntt_plan

    n = 1 << G1_NTT_LOG
    curve = kzg.curve
    before = launches_by_width()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lag = to_lagrange_g1(curve.name, kzg.srs[:n], G1_NTT_LOG)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = counts_since(before)
    log(f"[g1 ntt 2^{G1_NTT_LOG}] to_lagrange_g1: {secs:.2f} s, launches {launches} "
        f"({sum(launches.values())} in all)")
    coeffs = random_residues(torch, kzg.f, n, gen)
    evals = ntt_plan(curve.name, G1_NTT_LOG, kzg.srs.device).ntt(coeffs)
    F = hfp.GF(curve.fp.modulus)
    total = None
    for P in kzg.ops.decode_affine(kzg.srs[:n]):
        total = hfp.ec_add(F, total, P)
    checks = {"commit == commit_lagrange": kzg.commit(coeffs) == kzg.commit_lagrange(evals, lag),
              "lag[0] == host": kzg.ops.decode_affine(lag[:1])[0] == hfp.ec_mul(
                  F, total, pow(n, -1, curve.fr.modulus))}
    log(f"[g1 ntt 2^{G1_NTT_LOG}] checks: {checks}")
    if not all(checks.values()):
        raise AssertionError(f"G1 NTT failed: {checks}")


def cache_check(torch, cc, circuit, t_compile, tag):
    """cc written with utils.cache and read back onto its device (the
    card): the read-back keys prove Prover(rng=False)'s bytes."""
    import tempfile

    from algoplonk_tpu_torch.frontend import witness as witness_mod
    from algoplonk_tpu_torch.plonk.marshal import marshal_proof
    from algoplonk_tpu_torch.plonk.prove import Prover
    from algoplonk_tpu_torch.utils import cache

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "circuit.ccc")
        t0 = time.perf_counter()
        cache.write_compiled_circuit(cc, path)
        t_write = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        back = cache.read_compiled_circuit(path, device=cc.pk.device)
        torch.cuda.synchronize()
        t_read = time.perf_counter() - t0
    blobs = []
    for keys in (cc, back):
        prover = Prover(keys.pk, keys.ccs, rng=False)
        wit = witness_mod.solve(keys.ccs, circuit, commitment_solver=prover.bsb_solver)
        blobs.append(marshal_proof(keys.curve, prover.prove(wit)))
    log(f"{tag} cache: {size} bytes, write {t_write:.2f} s, read onto the card {t_read:.2f} s "
        f"(compile {t_compile:.2f} s); Prover(rng=False) bytes equal: {blobs[0] == blobs[1]}")
    if blobs[0] != blobs[1] or back.pk.device != cc.pk.device:
        raise AssertionError(f"{tag} the cached keys prove other bytes")


class Phase9Counts:
    """Launches of phase 9's sharded calls: each is run with every count
    zeroed just before it and read just after, and the readings add up,
    by (kernel, width) and by (field kernel, field).  The comparisons'
    single-device runs and the batches (whose threads race on the
    counters) are not counted."""

    def __init__(self, torch):
        self.torch, self.by_width, self.by_field = torch, {}, {}

    def __call__(self, fn):
        from algoplonk_tpu_torch.ops import curve_kernels as ck
        from algoplonk_tpu_torch.ops import field_kernels as fk
        from algoplonk_tpu_torch.ops import ntt_kernels as nk

        for mod in (ck, nk, fk):
            mod.reset_launch_counts()
        out = fn()
        self.torch.cuda.synchronize()
        for key, v in launches_by_width().items():
            self.by_width[key] = self.by_width.get(key, 0) + v
        for key, v in fk.LAUNCHES_BY_FIELD.items():
            self.by_field[key] = self.by_field.get(key, 0) + v
        return out


def sharded_msm_check(torch, mesh, counts, curve, pts, mont, want, tag):
    """Phase 9 (a): the sharded commit MSM (the prover's bucket padding,
    ``sharded_commit``) equals the single-device one (``want``), and on a
    HOST_PREFIX prefix the plain path, which launches nothing."""
    from algoplonk_tpu_torch.ops import msm as M
    from algoplonk_tpu_torch.parallel.msm_sharded import sharded_commit

    ctx = M.msm_ctx(curve, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = counts(lambda: sharded_commit(curve, mesh, "x", pts, mont))
    t_sh = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ctx.msm_to_affine_int(pts, mont, kind="mont")
    t_one = time.perf_counter() - t0
    pre = counts(lambda: sharded_commit(curve, mesh, "x", pts[:HOST_PREFIX], mont[:HOST_PREFIX]))
    plain = plain_launches_nothing(
        lambda: M.msm_ctx(curve, "cuda", plain=True).msm_to_affine_int(
            pts[:HOST_PREFIX], mont[:HOST_PREFIX], kind="mont"), "the MSM")
    log(f"{tag} sharded MSM of {pts.shape[0]} points on {len(mesh.devices)} shards: "
        f"{t_sh:.3f} s (function built in the call), single device {t_one:.3f} s; equal: "
        f"{got == want}; {HOST_PREFIX}-point prefix sharded == plain: {pre == plain}")
    if got != want or pre != plain:
        raise AssertionError(f"{tag} the sharded MSM disagrees")


def sharded_ntt_check(torch, mesh, counts):
    """Phase 9 (b): the sharded coset NTT and iNTT of 2^(LM_LOG_N + 2) equal
    the radix-2 plan's words, in 2 K9 launches per shard each."""
    import algoplonk_tpu_torch as apt
    from algoplonk_tpu_torch.ops import ntt_kernels as nk
    from algoplonk_tpu_torch.ops.ntt import ntt_plan
    from algoplonk_tpu_torch.parallel import all_gather, sharded_ntt_fn

    log_n, g, d = LM_LOG_N + 2, apt.BN254.coset_shift, len(mesh.devices)
    plan = ntt_plan("bn254", log_n, "cuda")
    coeffs = random_residues(torch, plan.f, plan.n, torch.Generator(device="cpu").manual_seed(12))
    evals = plan.coset_ntt(coeffs, g)
    ok, secs, k9_before = True, {}, counts.by_width.get(("ntt_pass", 8), 0)
    for inverse, x, want in ((False, coeffs, evals), (True, evals, plan.coset_intt(evals, g))):
        name = "coset iNTT" if inverse else "coset NTT"
        t0 = time.perf_counter()
        fn, (n1, n2) = sharded_ntt_fn("bn254", mesh, "x", log_n, inverse=inverse, coset_shift=g)
        torch.cuda.synchronize()
        t_tables = time.perf_counter() - t0

        def run():
            parts = fn(mesh.shard(x.reshape(n1, n2, -1).transpose(0, 1), 0))
            return all_gather(parts, x.device).reshape(x.shape)

        got = counts(run)
        k9 = counts.by_width.get(("ntt_pass", 8), 0) - k9_before
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            run()
        torch.cuda.synchronize()
        secs[name] = (time.perf_counter() - t0) / 5
        same = torch.equal(got, want)
        log(f"sharded {name} of 2^{log_n} on {d} shards ({n1} x {n2}): equal to the plan's words: "
            f"{same}; K9 launches in this check so far: {k9}; tables {t_tables:.3f} s; warm "
            f"{secs[name] * 1e3:.2f} ms a transform (host clock, synchronised, layout and "
            "gather included)")
        ok = ok and same
    if not ok or k9 != 4 * d:
        raise AssertionError("the sharded coset transforms disagree with the plan, or K9 "
                             f"launched {k9} times, not {4 * d}")


def sharded_prove_check(torch, mesh, counts, cc, circuit, tag):
    """Phase 9 (c): Prover(rng=False, mesh) on cc's keys gives the
    single-device Prover(rng=False)'s bytes with every size-n iNTT, lift and
    coset iNTT sharded, and the proof verifies; then a warm sharded prove
    under torch.profiler."""
    from algoplonk_tpu_torch.frontend import witness as witness_mod
    from algoplonk_tpu_torch.plonk import verify as V
    from algoplonk_tpu_torch.plonk.marshal import marshal_proof
    from algoplonk_tpu_torch.plonk.prove import Prover

    wit = witness_mod.solve(cc.ccs, circuit)
    one = Prover(cc.pk, cc.ccs, rng=False)
    t0 = time.perf_counter()
    want = marshal_proof(cc.curve, one.prove(wit))
    t_one = time.perf_counter() - t0
    before = {k: v for k, v in counts.by_width.items()}
    torch.cuda.reset_peak_memory_stats()
    prover = Prover(cc.pk, cc.ccs, rng=False, mesh=mesh)
    t0 = time.perf_counter()
    proof = counts(lambda: prover.prove(wit))
    t_sh = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    got = marshal_proof(cc.curve, proof)
    ok = V.verify(cc.vk, proof, wit.public_values)
    nbsb = len(cc.ccs.commitments)
    expect = 5 + nbsb + 13 + 2 * nbsb + 1
    launched = {f"{k}[w{w}]": v - before.get((k, w), 0) for (k, w), v in counts.by_width.items()
                if v != before.get((k, w), 0)}
    log(f"{tag} sharded prove, Prover(rng=False, mesh of {len(mesh.devices)} shards): "
        f"{t_sh:.2f} s (first, tables built), phases (s): "
        + json.dumps({k: round(v, 4) for k, v in prover.phase_seconds.items()})
        + f"; single device {t_one:.2f} s, phases (s): "
        + json.dumps({k: round(v, 4) for k, v in one.phase_seconds.items()})
        + f"; sharded NTTs {prover.sharded_ntt_hits} of {expect}; bytes equal: {got == want}; "
        f"native verify: {ok}; launches: {launched}; peak device memory {peak / 2**30:.3f} GiB")
    if got != want or not ok or prover.sharded_ntt_hits != expect:
        raise AssertionError(f"{tag} the sharded prove disagrees with the single-device prove")
    warm = Prover(cc.pk, cc.ccs, rng=False, mesh=mesh)
    n_kernels, by_type, busy, wall = profile_device(torch, lambda: warm.prove(wit))
    log(f"{tag} sharded prove under torch.profiler: {wall:.2f} s, {n_kernels} CUDA kernel "
        f"launches, device busy {busy:.1%}; device events by type: {by_type}")


def batch_check(torch, apt, cc, SquareChain, chain, rounds: int = 2):
    """Phase 9 (d): prove_batch of BATCH witnesses (different x) with
    BATCH workers on one card (one stream each) and with one worker, beside
    BATCH sequential proves + self-verifies, alternating (sequential, four
    streams, one worker, then the reverse); every batch proof must equal
    its sequential proof."""
    from algoplonk_tpu_torch.frontend import witness as witness_mod
    from algoplonk_tpu_torch.parallel import prove_batch
    from algoplonk_tpu_torch.plonk import verify as V
    from algoplonk_tpu_torch.plonk.marshal import marshal_proof
    from algoplonk_tpu_torch.plonk.prove import Prover

    r = cc.curve.fr.modulus
    xs = [(0xA1607 + 977 * i) % r for i in range(BATCH)]
    circuits = [SquareChain(x=x, y=pow(x, 1 << chain, r)) for x in xs]
    dev = torch.device("cuda", 0)

    def sequential():
        out = []
        for c in circuits:
            prover = Prover(cc.pk, cc.ccs, rng=False)
            wit = witness_mod.solve(cc.ccs, c, commitment_solver=prover.bsb_solver)
            proof = prover.prove(wit)
            if not V.verify(cc.vk, proof, wit.public_values):
                raise AssertionError("a sequential proof failed verification")
            out.append(marshal_proof(cc.curve, proof))
        return out

    runs = {"sequential": sequential,
            f"{BATCH} streams": lambda: [vp.marshal_proof() for vp in prove_batch(
                cc, circuits, devices=[dev] * BATCH, rng=False)],
            "1 worker": lambda: [vp.marshal_proof() for vp in prove_batch(
                cc, circuits, devices=[dev], rng=False)]}
    order = list(runs)
    secs, blobs = {k: [] for k in runs}, {}
    for i in range(rounds):
        for name in order if i % 2 == 0 else order[::-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            blobs[name, i] = runs[name]()
            secs[name].append(time.perf_counter() - t0)
    want = blobs["sequential", 0]
    same = all(b == want for b in blobs.values())
    torch.cuda.reset_peak_memory_stats()
    n_kernels, by_type, busy, wall = profile_device(torch, runs[f"{BATCH} streams"])
    peak = torch.cuda.max_memory_allocated()
    log(f"[{cc.curve.name} n = {cc.pk.n}] batch of {BATCH} proves + self-verifies "
        "(Prover(rng=False)), "
        f"alternating, s: " + json.dumps({k: [round(t, 3) for t in v] for k, v in secs.items()})
        + f"; proofs a second: " + json.dumps(
            {k: round(BATCH / min(v), 3) for k, v in secs.items()})
        + f"; every batch proof == its sequential proof: {same}; {BATCH} streams under "
        f"torch.profiler: {wall:.2f} s, {n_kernels} CUDA kernel launches, device busy "
        f"{busy:.1%}, peak device memory {peak / 2**30:.3f} GiB")
    if not same or len(want) != BATCH or len(set(want)) != BATCH:
        raise AssertionError("the batch proofs differ from the sequential ones")


class call_counter:
    """Calls of ``module.name`` while the context is open; the module's own
    global is replaced, so the module's calls of it count too."""

    def __init__(self, module, name):
        self.module, self.name = module, name

    def __enter__(self):
        self.calls = 0
        self.orig = orig = getattr(self.module, self.name)

        def counted(*args, **kwargs):
            self.calls += 1
            return orig(*args, **kwargs)

        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


# the warm Prover(rng=False) proves of a large path: (name, environment,
# EVICT_MIN_LOG, None for the default)
WARM_RUNS = (("evicting, profiled", {"AP_PROVE_PROFILE": "1"}, None), ("evicting", {}, None),
             ("no eviction", {}, 99), ("no eviction", {}, 99), ("evicting", {}, None))
WARM_FIRST = WARM_RUNS[:1]


def large_path(torch, apt, curve, log_n, reset_counts, warm=WARM_RUNS):
    """Phases 10 and 11 on one curve: the 2^log_n SquareChain on the test
    SRS.  The SRS is built first (timed, the device-side path of
    setups/srs.py, then cached), then the circuit compiled (the SRS read
    back from that cache); with the counts zeroed just before, a prove +
    self-verify (CompiledCircuit.verify, four-step quotient) whose proof
    must have the curve's length, reject a flipped public input, and
    launch K1, K2, K3 (its scan, phase 4 and the pieces' add_window_sums),
    K8, field_add_sub, K9 (2 per lift and the iNTT) and, where the coset's
    n2 is above K9's MAX_C, ntt_stage (one a transform at 2^23), and no
    ntt_stage below it.  Then the ``warm`` Prover(rng=False) proves of one
    witness (by default five: the first under AP_PROVE_PROFILE=1, its
    sub-phases, memory and launches printed, then evicting, not evicting,
    EVICT_MIN_LOG raised to 99, twice, evicting, unprofiled, so that the
    eviction's cost reads off one card in one run); all their bytes must be
    equal and verify.  Returns the prove + self-verify's launches by
    (kernel, width) and by (kernel, field)."""
    import io

    from algoplonk_tpu_torch.frontend import witness as witness_mod
    from algoplonk_tpu_torch.ops import curve_kernels as ck
    from algoplonk_tpu_torch.ops import field_kernels as fk
    from algoplonk_tpu_torch.ops import msm as M
    from algoplonk_tpu_torch.ops import ntt_kernels as nk
    from algoplonk_tpu_torch.plonk import verify as V
    from algoplonk_tpu_torch.plonk.marshal import expected_proof_len, marshal_proof
    from algoplonk_tpu_torch.plonk import prove as prove_mod
    from algoplonk_tpu_torch.plonk.prove import Prover
    from algoplonk_tpu_torch.setups import srs as srs_mod

    dev = torch.device("cuda")
    r = curve.fr.modulus
    W = M.msm_ctx(curve, dev).ops.W
    x = 0xA1607 % r
    SquareChain, chain = square_chain(apt, log_n)
    y = pow(x, 1 << chain, r)
    circuit = SquareChain(x=x, y=y)
    tag = f"[{curve.name} 2^{log_n}]"
    gib = 2**-30

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    srs_mod.test_only_srs(curve, (1 << log_n) + 3, dev)
    torch.cuda.synchronize()
    t_srs = time.perf_counter() - t0
    srs_launches = sum(launch_counts().values())
    t0 = time.perf_counter()
    cc = apt.compile(SquareChain, curve, apt.test_only_setup(curve), device=dev)
    t_compile = time.perf_counter() - t0
    log(f"{tag} test SRS of {(1 << log_n) + 3} points built on the device and cached: "
        f"{t_srs:.2f} s, {srs_launches} launches; compile (circuit + SRS read from that cache "
        f"+ setup): {t_compile:.2f} s; peak device memory {torch.cuda.max_memory_allocated() * gib:.3f} "
        f"GiB")
    if cc.pk.n != 1 << log_n:
        raise AssertionError(f"{tag} domain {cc.pk.n} != 2^{log_n}")

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    in_use = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with msm_timer() as msm_t, call_counter(M, "add_window_sums") as pieces:
        vp = cc.verify(circuit)
    t_verify = time.perf_counter() - t0
    by_width = {k: v for k, v in launches_by_width().items() if v}
    by_field = {k: v for k, v in fk.LAUNCHES_BY_FIELD.items() if v}
    blob = vp.marshal_proof()
    log(f"{tag} prove + self-verify (first, tables built): {t_verify:.2f} s; phases (s): "
        + json.dumps({k: round(v, 4) for k, v in vp.phase_seconds.items()})
        + f"; MSMs {msm_t.calls} calls, {msm_t.seconds:.2f} s, add_window_sums {pieces.calls} "
        f"calls; launches {by_width}, by field {by_field}; memory in use before "
        f"{in_use * gib:.3f} GiB, peak {torch.cuda.max_memory_allocated() * gib:.3f} GiB")
    if len(blob) != expected_proof_len(curve, 0):
        raise AssertionError(f"{tag} proof blob is {len(blob)} bytes")
    if V.verify(cc.vk, vp.proof, [(y + 1) % r]):
        raise AssertionError(f"{tag} a flipped public input was accepted")
    missing = [k for k in ck.MSM_KERNELS if not by_width.get((k, W))]
    missing += [k for k in fk.KERNELS if not by_field.get((k, curve.fr.name))]
    transforms = 14   # 13 lifts and the 4n iNTT (no BSB22 commitment)
    k9, stages = (transforms * c for c in four_step_launches(log_n + 2))
    for name, want in (("ntt_pass", k9), ("ntt_stage", stages)):
        if by_width.get((name, 8), 0) != want:
            missing.append(f"{name} x {want} (launched {by_width.get((name, 8), 0)})")
    missing += [] if pieces.calls else ["add_window_sums"]
    if missing:
        raise AssertionError(f"kernels not launched on the {tag} path: {missing}")

    wit = witness_mod.solve(cc.ccs, circuit)
    runs, seconds = {}, {}
    evict_min_log = prove_mod.EVICT_MIN_LOG
    for name, env, min_log in warm:
        os.environ.update(env)
        prove_mod.EVICT_MIN_LOG = evict_min_log if min_log is None else min_log
        try:
            torch.cuda.reset_peak_memory_stats()
            in_use = torch.cuda.memory_allocated()
            before = sum(launch_counts().values())
            prover = Prover(cc.pk, cc.ccs, rng=False)
            err = io.StringIO()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(err):
                proof = prover.prove(wit)
            torch.cuda.synchronize()
            t_prove = time.perf_counter() - t0
            launches = sum(launch_counts().values()) - before
            peak = torch.cuda.max_memory_allocated()
        finally:
            for k in env:
                os.environ.pop(k)
            prove_mod.EVICT_MIN_LOG = evict_min_log
        t0 = time.perf_counter()
        ok = V.verify(cc.vk, proof, [y])
        t_self = time.perf_counter() - t0
        runs.setdefault(name, set()).add(marshal_proof(curve, proof))
        seconds.setdefault(name, []).append(t_prove)
        log(f"{tag} warm Prover(rng=False), {name}: prove {t_prove:.2f} s, self-verify "
            f"{t_self:.2f} s, {launches} launches; phases (s): "
            + json.dumps({k: round(v, 4) for k, v in prover.phase_seconds.items()})
            + f"; memory in use before {in_use * gib:.3f} GiB, peak {peak * gib:.3f} GiB "
            f"(+{(peak - in_use) * gib:.3f}); verified: {ok}")
        if err.getvalue():
            log(f"{tag} AP_PROVE_PROFILE=1:\n" + err.getvalue().rstrip())
        if not ok:
            raise AssertionError(f"{tag} the Prover(rng=False) proof failed verification")
    same = len(set.union(*runs.values())) == 1
    if "no eviction" in seconds:
        log(f"{tag} warm prove seconds, evicting then not, not then evicting: "
            f"{seconds['evicting']} vs {seconds['no eviction']}; "
            f"proof bytes with and without table eviction equal: {same}")
    if not same:
        raise AssertionError(f"{tag} table eviction changed the proof")
    return by_width, by_field


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import algoplonk_tpu_torch as apt
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 2
    from algoplonk_tpu_torch.frontend import witness as witness_mod
    from algoplonk_tpu_torch.ops import _build
    from algoplonk_tpu_torch.ops import curve_kernels as ck
    from algoplonk_tpu_torch.ops import field_kernels as fk
    from algoplonk_tpu_torch.ops import msm as M
    from algoplonk_tpu_torch.ops import ntt_kernels as nk
    from algoplonk_tpu_torch.plonk import verify as V
    from algoplonk_tpu_torch.plonk.marshal import expected_proof_len, marshal_proof
    from algoplonk_tpu_torch.plonk.prove import Prover
    from algoplonk_tpu_torch.setups import registry

    def smi(query):
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]

    card = smi("name,power.limit")
    max_sm_mhz = float(smi("clocks.max.sm").split()[0])
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    rng = random.Random(0xA1607)
    dev = torch.device("cuda")
    bound = Bound(torch, max_sm_mhz)
    # each path takes the quotient the default rule gives its size
    for var in ("AP_QUOTIENT_LM", "AP_NTT_LM_MIN_LOG"):
        os.environ.pop(var, None)

    def reset_counts():
        ck.reset_launch_counts()
        nk.reset_launch_counts()
        fk.reset_launch_counts()

    # ---- phase 1: build + kernels vs plain
    t0 = time.perf_counter()
    _build.library()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s (nvcc {_build.build_seconds:.1f} s)")
    log(_build.build_log.strip())
    kernels = kernel_phase(torch, rng, apt.BN254, (1 << LOG_N) + 3, bound, "",
                           k2_lanes=(commit_widths((1 << LM_LOG_N) + 3)[2],),
                           scan_E=(commit_windows((1 << LM_LOG_N) + 3)[1],
                                   commit_windows(M.CHUNK)[1]))
    kernels += kernel_phase(torch, rng, apt.BLS12_381, (1 << BLS_LOG_N) + 3, bound, "[w12]",
                            scan_E=(commit_windows(M.CHUNK)[1],))
    piece_shapes(torch, rng, apt.BN254, bound, kernels, "")
    piece_shapes(torch, rng, apt.BLS12_381, bound, kernels, "[w12]")
    kernels += field_phase(torch, apt, bound)
    kernels.extend(ntt_kernel_phase(torch, bound))
    for k in kernels:   # K5-K7 at both widths carry the width in the name
        if k["kernel"] in ("mixed_add", "mixed_add_signed", "jac_add_multi") and k["width"] == 8:
            k["name"] += "[w8]"

    field_paths = {}   # curve -> field launches (in its first prove, in its whole path)

    def drive(curve, setup, log_n, expect):
        """Compile, prove + self-verify and check the 2^log_n SquareChain
        with the launch counts zeroed just before it; every kernel named in
        ``expect`` and both field kernels must have launched, the field
        kernels in the prove itself.  Returns (cc, circuit, x, y, launches
        by kernel and width, launches by kernel, the card proof, compile
        seconds).  The field kernels' launches by field go to
        ``field_paths``."""
        r = curve.fr.modulus
        x = 0xA1607 % r
        SquareChain, chain = square_chain(apt, log_n)
        y = pow(x, 1 << chain, r)
        tag = f"[{curve.name} 2^{log_n}]"
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cc = apt.compile(SquareChain, curve, setup, device=dev)
        t_compile = time.perf_counter() - t0
        at_compile = launches_by_width()
        field_at_compile, copies_at_compile = dict(fk.LAUNCHES_BY_FIELD), fk.COPIES
        t0 = time.perf_counter()
        with msm_timer() as msm_t:
            vp = cc.verify(SquareChain(x=x, y=y))
        t_verify = time.perf_counter() - t0
        blob = vp.marshal_proof()
        launches = launch_counts()
        by_width = {k: v for k, v in launches_by_width().items() if v}
        in_prove = counts_since(at_compile)
        field_in_prove = {k: v - field_at_compile.get(k, 0)
                          for k, v in fk.LAUNCHES_BY_FIELD.items()}
        field_paths.setdefault(curve.name, (field_in_prove, dict(fk.LAUNCHES_BY_FIELD)))
        peak = torch.cuda.max_memory_allocated()
        log(f"{tag} compile (circuit + SRS + setup, {setup.name}) at n = {cc.pk.n}: "
            f"{t_compile:.2f} s")
        log(f"{tag} prove + self-verify: {t_verify:.2f} s; phases (s): "
            + json.dumps({k: round(v, 4) for k, v in vp.phase_seconds.items()}))
        log(f"{tag} prove MSMs: {msm_t.calls} calls, {msm_t.seconds:.2f} s, "
            f"{msm_t.seconds / t_verify:.1%} of prove + self-verify")
        log(f"{tag} launches: {launches}; by width: {by_width}; by width in prove + "
            f"self-verify alone: {in_prove}")
        per_prove = {k: sum(v for (kk, _), v in field_in_prove.items() if kk == k)
                     for k in fk.KERNELS}
        log(f"{tag} field kernel launches per prove + self-verify: {per_prove}, by field "
            f"{field_in_prove}; operands copied in the prove: "
            f"{fk.COPIES - copies_at_compile}, in compile: {copies_at_compile}")
        log(f"{tag} peak device memory: {peak / 2**30:.3f} GiB")
        if cc.pk.n != 1 << log_n:
            raise AssertionError(f"domain {cc.pk.n} != 2^{log_n}")
        if len(blob) != expected_proof_len(curve, 0):
            raise AssertionError(f"proof blob is {len(blob)} bytes")
        if V.verify(cc.vk, vp.proof, [(y + 1) % r]):
            raise AssertionError("a flipped public input was accepted")
        missing = [k for k in expect if launches[k] == 0]
        missing += [k for k in fk.KERNELS if per_prove[k] == 0]
        if missing:
            raise AssertionError(f"kernels not launched on the {tag} path: {missing}")
        return (cc, SquareChain, x, y, launches_by_width(), launches, vp, t_compile)

    # ---- phase 2: the 2^16 path, then one warm prove of it under the profiler
    cc, SquareChain, x, y, _, _, vp16, t_compile16 = drive(
        apt.BN254, apt.SetupName.TEST_ONLY_BN254, LOG_N, ck.MSM_KERNELS)
    cc16, circuit16, square16 = cc, SquareChain(x=x, y=y), SquareChain
    n_kernels, by_type, busy, wall = profile_device(torch, lambda: cc.verify(SquareChain(x=x, y=y)))
    log(f"[bn254 2^{LOG_N}] warm prove + self-verify under torch.profiler: {wall:.2f} s, "
        f"{n_kernels} CUDA kernel launches, device busy {busy:.1%}; device events by type: "
        f"{by_type}")
    if n_kernels == 0:
        raise AssertionError("the profiler saw no CUDA kernel in a prove")
    quotient_paths(torch, apt, cc, SquareChain(x=x, y=y), f"[bn254 2^{LOG_N}]")

    # ---- phase 3: one commit-sized MSM, kernels vs plain; a prefix vs host
    r = apt.BN254.fr.modulus
    pts = cc.pk.srs_g1
    n = pts.shape[0]
    scalars = [rng.randrange(r) for _ in range(n)]
    ctx = M.msm_ctx(apt.BN254, dev)
    mont = ctx.fr.encode(scalars)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = ctx.msm_to_affine_int(pts, mont, kind="mont")
    t_kernel = time.perf_counter() - t0
    plain_ctx = M.msm_ctx(apt.BN254, dev, plain=True)
    t0 = time.perf_counter()
    plain = plain_launches_nothing(
        lambda: plain_ctx.msm_to_affine_int(pts, mont, kind="mont"), "the MSM")
    t_plain = time.perf_counter() - t0
    pre = ctx.msm_to_affine_int(pts[:HOST_PREFIX], mont[:HOST_PREFIX], kind="mont")
    t0 = time.perf_counter()
    host = M.host_msm(apt.BN254, ctx.ops.decode_affine(pts[:HOST_PREFIX]), scalars[:HOST_PREFIX])
    t_host = time.perf_counter() - t0
    log(f"MSM n={n}: kernel path {t_kernel:.3f} s, plain path {t_plain:.3f} s; equal: "
        f"{got == plain}; {HOST_PREFIX}-point prefix: host {t_host:.1f} s, equal: {pre == host}")
    if not (got == plain and pre == host):
        raise AssertionError("commit-sized MSM disagrees")
    msm_split(torch, ctx, pts, mont, got, f"[bn254] {n}-point commit")
    bn_msm = (pts, mont, got)   # phase 9's sharded MSM

    def gpu_equals_cpu(curve, setup, P, assignment, public):
        """Prove ``P`` with every commit on the device MSM, on the GPU and
        on the CPU, through both quotient paths: all four must agree."""
        host_max = M.HOST_MSM_MAX
        M.HOST_MSM_MAX = 0
        k9 = {}
        try:
            blobs = {}
            for d in (dev, torch.device("cpu")):
                small = apt.compile(P, curve, setup, device=d)
                for lm in ("0", "1"):
                    os.environ["AP_QUOTIENT_LM"] = lm
                    before = nk.LAUNCHES["ntt_pass"]
                    prover = Prover(small.pk, small.ccs, rng=False)
                    wit = witness_mod.solve(small.ccs, P(**assignment),
                                            commitment_solver=prover.bsb_solver)
                    proof = prover.prove(wit)
                    k9[d.type, lm] = nk.LAUNCHES["ntt_pass"] - before
                    if not V.verify(small.vk, proof, public):
                        raise AssertionError(f"small proof on {d} failed verification")
                    blobs[d.type, lm] = marshal_proof(curve, proof)
        finally:
            M.HOST_MSM_MAX = host_max
            os.environ.pop("AP_QUOTIENT_LM", None)
        same = len(set(blobs.values())) == 1
        log(f"[{curve.name}] small circuit, device MSM: GPU proof == CPU proof, both "
            f"quotient paths: {same}; K9 launches by (device, path): {k9}")
        if not same or k9["cuda", "1"] == 0:
            raise AssertionError(f"small-circuit proofs differ: {sorted(blobs)}")

    # ---- phase 4: small circuits
    P = pythagorean(apt)
    gpu_equals_cpu(apt.BN254, apt.SetupName.TEST_ONLY_BN254, P, dict(a=3, b=4, c=5), [3, 4])
    OneCommit = one_commit(apt)
    t0 = time.perf_counter()
    bcc = apt.compile(OneCommit, apt.BN254, apt.SetupName.TEST_ONLY_BN254, device=dev)
    bvp = bcc.verify(OneCommit(x=49, y=7))
    if len(bvp.marshal_proof()) != expected_proof_len(apt.BN254, 1) or len(bvp.proof.bsb_commitments) != 1:
        raise AssertionError("BSB22 proof has the wrong layout")
    log(f"BSB22 circuit proved + verified: {time.perf_counter() - t0:.2f} s")

    # ---- phase 5: the 2^17 path (four-step quotient, K9)
    four_step_check(torch)
    cc, SquareChain, x, y, _, launches, _, _ = drive(
        apt.BN254, apt.SetupName.TEST_ONLY_BN254, LM_LOG_N, (*ck.MSM_KERNELS, "ntt_pass"))
    cc17, circuit17 = cc, SquareChain(x=x, y=y)   # phase 9's sharded prove
    lifts = 13 + 2 * len(cc.ccs.commitments)
    if launches["ntt_pass"] != 2 * (lifts + 1):
        raise AssertionError(f"K9 launched {launches['ntt_pass']} times, "
                             f"expected {2 * (lifts + 1)}")
    if launches["ntt_stage"]:
        raise AssertionError(f"the 2^{LM_LOG_N} path ran {launches['ntt_stage']} HBM stages")
    for k in kernels:
        if k["kernel"] in ck.MSM_KERNELS + ("ntt_pass",) and k["width"] == 8:
            k["launches"] = launches[k["kernel"]]
    k9_before = nk.LAUNCHES["ntt_pass"]
    n_kernels, by_type, busy, wall = profile_device(torch, lambda: cc.verify(SquareChain(x=x, y=y)))
    k9 = nk.LAUNCHES["ntt_pass"] - k9_before
    log(f"[bn254 2^{LM_LOG_N}] warm prove + self-verify under torch.profiler: {wall:.2f} s, "
        f"{n_kernels} CUDA kernel launches ({k9} of them K9), device busy {busy:.1%}; "
        f"device events by type: {by_type}")
    if k9 != 2 * (lifts + 1):
        raise AssertionError(f"the traced 2^{LM_LOG_N} prove launched K9 {k9} times")
    blobs, r3 = {}, {}
    for lm in ("1", "0"):
        os.environ["AP_QUOTIENT_LM"] = lm
        prover = Prover(cc.pk, cc.ccs, rng=False)
        wit = witness_mod.solve(cc.ccs, SquareChain(x=x, y=y), commitment_solver=prover.bsb_solver)
        proof = prover.prove(wit)
        blobs[lm] = marshal_proof(apt.BN254, proof)
        r3[lm] = prover.phase_seconds["r3"]
        log(f"[2^{LM_LOG_N}] Prover(rng=False), AP_QUOTIENT_LM={lm}: phases (s): "
            + json.dumps({k: round(v, 4) for k, v in prover.phase_seconds.items()}))
    os.environ.pop("AP_QUOTIENT_LM", None)
    if not V.verify(cc.vk, proof, [y]):
        raise AssertionError("the unblinded 2^17 proof failed verification")
    log(f"[2^{LM_LOG_N}] round 3: four-step {r3['1']:.3f} s, batch-major {r3['0']:.3f} s; "
        f"proof bytes equal: {blobs['1'] == blobs['0']}")
    if blobs["1"] != blobs["0"]:
        raise AssertionError("the two quotient paths give different proofs")
    del proof, prover, wit

    # ---- phase 6: the BLS12-381 path on the Ethereum KZG ceremony
    bls = apt.BLS12_381
    ceremony = apt.SetupName.ETHEREUM_KZG_CEREMONY_BLS12_381
    bcc, BSquare, bx, by, by_width, _, bvp14, _ = drive(bls, ceremony, BLS_LOG_N, ck.MSM_KERNELS)
    missing = [k for k in ck.MSM_KERNELS if by_width[k, 12] == 0]
    if missing:
        raise AssertionError(f"kernels not launched at W = 12 on the BLS12-381 path: {missing}")
    for k in kernels:
        if k["kernel"] in ck.MSM_KERNELS and k["width"] == 12:
            k["launches"] = by_width[k["kernel"], 12]
    quotient_paths(torch, apt, bcc, BSquare(x=bx, y=by), f"[bls12_381 2^{BLS_LOG_N}]")
    gpu_equals_cpu(bls, ceremony, P, dict(a=3, b=4, c=5), [3, 4])

    t0 = time.perf_counter()
    srs = registry.load_trusted(registry.get(ceremony), BLS_MSM_POINTS)
    t_load = time.perf_counter() - t0
    r = bls.fr.modulus
    ctx = M.msm_ctx(bls, dev)
    pts = ctx.ops.encode_affine(srs.g1)
    scalars = [rng.randrange(r) for _ in range(BLS_MSM_POINTS)]
    mont = ctx.fr.encode(scalars)
    results, secs = {}, {}
    default_fuse = M.FUSE_STEPS
    try:
        for fuse in (16, 8):
            M.FUSE_STEPS = fuse
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results[f"kernel fuse {fuse}"] = ctx.msm_to_affine_int(pts, mont, kind="mont")
            secs[f"kernel fuse {fuse}"] = time.perf_counter() - t0
    finally:
        M.FUSE_STEPS = default_fuse
    plain_ctx = M.msm_ctx(bls, dev, plain=True)
    t0 = time.perf_counter()
    results["plain"] = plain_launches_nothing(
        lambda: plain_ctx.msm_to_affine_int(pts, mont, kind="mont"), "the MSM")
    secs["plain"] = time.perf_counter() - t0
    pre = ctx.msm_to_affine_int(pts[:HOST_PREFIX], mont[:HOST_PREFIX], kind="mont", window_bits=11)
    t0 = time.perf_counter()
    host = M.host_msm(bls, srs.g1[:HOST_PREFIX], scalars[:HOST_PREFIX])
    secs["host prefix"] = time.perf_counter() - t0
    same = len(set(results.values())) == 1
    log(f"[bls12_381] MSM over {BLS_MSM_POINTS} ceremony points (host load {t_load:.1f} s): "
        + ", ".join(f"{k} {v:.3f} s" for k, v in secs.items())
        + f"; kernel (16, 8) == plain: {same}; {HOST_PREFIX}-point prefix at c = 11 == host: "
        f"{pre == host}")
    if not (same and pre == host):
        raise AssertionError("the BLS12-381 ceremony MSM disagrees")
    n_commit = (1 << BLS_LOG_N) + 3
    want = ctx.msm_to_affine_int(pts[:n_commit], mont[:n_commit], kind="mont")
    msm_split(torch, ctx, pts[:n_commit], mont[:n_commit], want,
              f"[bls12_381] {n_commit}-point commit")
    bls_msm = (pts[:n_commit], mont[:n_commit], want)

    # ---- phase 7: the kernel-test path of K4-K8
    off_path, off_path_field = {}, {}
    for curve in (apt.BN254, bls):
        reset_counts()
        t0 = time.perf_counter()
        ok = kernel_test_path(torch, curve)
        off_path_field.update(fk.LAUNCHES_BY_FIELD)
        launched = {k: v for k, v in launches_by_width().items() if v}
        log(f"[{curve.name}] kernel-test path of K4-K8: {time.perf_counter() - t0:.2f} s, "
            f"equal to host: {ok}; launches: {launched}")
        if not ok:
            raise AssertionError(f"K4-K8 disagree with host arithmetic on {curve.name}")
        for key, v in launched.items():
            off_path[curve.name, key] = v
    for k in kernels:
        if k["kernel"] in ck.OFF_PATH_KERNELS:
            curve = "bn254" if k["width"] == 8 else "bls12_381"
            k["launches"] = off_path.get((curve, (k["kernel"], k["width"])), 0)
        elif k["kernel"] in fk.KERNELS:
            # the prove of its curve's first path (BN254 2^16, BLS12-381
            # 2^14); a field that prove does not compute in counts that
            # path's compile (BN254's Fp: the test SRS), or else the
            # kernel-test path (BLS12-381's Fp: the MSM's curve arithmetic
            # is K1-K3 and the ceremony's points are decoded on the host)
            key = (k["kernel"], k["field"])
            in_prove, on_path = field_paths[k["field"].rsplit("_", 1)[0]]
            for where, got in (("prove", in_prove), ("compile", on_path),
                               ("kernel-test path", off_path_field)):
                if got.get(key):
                    k["launches"], k["launches_on"] = got[key], where
                    break

    # ---- phase 8: the modules off the prove path, on phase 2's and phase
    # 6's circuits, with the counts zeroed just before
    reset_counts()
    t0 = time.perf_counter()
    budgets = {"bn254": emit_and_run(apt, cc16, vp16, f"[bn254 2^{LOG_N}]"),
               "bls12_381": emit_and_run(apt, bcc, bvp14, f"[bls12_381 2^{BLS_LOG_N}]")}
    t_emit = time.perf_counter() - t0
    gen = torch.Generator(device="cpu").manual_seed(11)
    kzg = kzg_check(torch, cc16, rng, gen)
    g1_ntt_check(torch, kzg, gen)
    cache_check(torch, cc16, circuit16, t_compile16, f"[bn254 2^{LOG_N}]")
    slice_launches = launches_by_width()
    log(f"phase 8: {time.perf_counter() - t0:.1f} s (emit and run {t_emit:.1f} s); "
        f"opcode budgets {budgets}; launches {dict((k, v) for k, v in slice_launches.items() if v)}")
    missing = [k for k in ck.MSM_KERNELS + fk.KERNELS if not slice_launches[k, 8]]
    if missing:
        raise AssertionError(f"kernels not launched on phase 8's paths: {missing}")
    for k in kernels:
        if k["kernel"] in ck.MSM_KERNELS and k["width"] == 8:
            k["phase8_launches"] = slice_launches[k["kernel"], 8]
        elif k["kernel"] in fk.KERNELS:
            k["phase8_launches"] = fk.LAUNCHES_BY_FIELD.get((k["kernel"], k["field"]), 0)

    # ---- phase 9: sharded and batch proving (parallel/) on a mesh of
    # MESH_SHARDS shards, all on the one card; each sharded call with the
    # counts zeroed just before it and read just after
    from algoplonk_tpu_torch.parallel import Mesh

    t0 = time.perf_counter()
    mesh = Mesh([dev] * MESH_SHARDS)
    counts = Phase9Counts(torch)
    sharded_msm_check(torch, mesh, counts, apt.BN254, *bn_msm, "[bn254]")
    sharded_msm_check(torch, mesh, counts, bls, *bls_msm, "[bls12_381]")
    sharded_ntt_check(torch, mesh, counts)
    sharded_prove_check(torch, mesh, counts, cc17, circuit17, f"[bn254 2^{LM_LOG_N}]")
    sharded_prove_check(torch, mesh, counts, bcc, BSquare(x=bx, y=by),
                        f"[bls12_381 2^{BLS_LOG_N}]")
    t_sharded = time.perf_counter() - t0
    batch_check(torch, apt, cc16, square16, (1 << LOG_N) - 3)
    log(f"phase 9: {time.perf_counter() - t0:.1f} s (sharded {t_sharded:.1f} s); launches of "
        f"its sharded calls: {dict((k, v) for k, v in counts.by_width.items() if v)}; by field: "
        f"{counts.by_field}")
    for k in kernels:
        k["phase9_launches"] = (counts.by_field.get((k["kernel"], k["field"]), 0)
                                if k["kernel"] in fk.KERNELS
                                else counts.by_width.get((k["kernel"], k["width"]), 0))
    missing = [k["name"] for k in kernels if not k["phase9_launches"] and (
        k["kernel"] in ck.MSM_KERNELS + ("ntt_pass",)
        or (k["kernel"] in fk.KERNELS and k["field"].endswith("_fr")))]
    if missing:
        raise AssertionError(f"kernels not launched on phase 9's sharded paths: {missing}")

    # ---- phase 10: the 2^20 path on both curves, on the test SRS; each
    # curve's prove + self-verify with the counts zeroed just before it.
    # BLS12-381's warm proves are cut to one: phase 11 runs its K9 shapes
    # and the eviction pairs at 2^21
    t0 = time.perf_counter()
    large = {apt.BN254.name: large_path(torch, apt, apt.BN254, LARGE_LOG_N, reset_counts),
             bls.name: large_path(torch, apt, bls, LARGE_LOG_N, reset_counts, WARM_FIRST)}
    log(f"phase 10: {time.perf_counter() - t0:.1f} s")

    def path_launches(runs, key):
        """Each kernel's launches in a large path's prove + self-verify: a
        field kernel's on its field's curve, a curve kernel's on the curve
        of its width, K9's and ntt_stage's on BN254 where it ran, else on
        BLS12-381."""
        for k in kernels:
            if k["kernel"] in fk.KERNELS:
                curve = k["field"].rsplit("_", 1)[0]
                k[key] = runs.get(curve, ({}, {}))[1].get((k["kernel"], k["field"]), 0)
                continue
            if k["kernel"] in nk.KERNELS:
                curve = "bn254" if "bn254" in runs else "bls12_381"
            else:
                curve = "bn254" if k["width"] == 8 else "bls12_381"
            k[key] = runs.get(curve, ({}, {}))[0].get((k["kernel"], k["width"]), 0)

    path_launches(large, "phase10_launches")

    # ---- phase 11: Dusk's cap, the 2^21 path on BLS12-381 on the test SRS
    # (a 2^23 coset: P2 and P2' one ntt_stage and one K9 launch each), with
    # the counts zeroed just before its prove + self-verify
    t0 = time.perf_counter()
    dusk = {bls.name: large_path(torch, apt, bls, DUSK_LOG_N, reset_counts)}
    log(f"phase 11: {time.perf_counter() - t0:.1f} s")
    path_launches(dusk, "phase11_launches")
    for k in kernels:
        if k["kernel"] == "ntt_stage":   # its main path is phase 11's
            k["launches"] = k["phase11_launches"]

    unlaunched = [k["name"] for k in kernels if not k.get("launches")]
    if unlaunched:
        raise AssertionError(f"kernels never launched on their path: {unlaunched}")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "events_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "T", "depth", "work_adds",
            "rounds_ms", "passes", "shapes", "host_us", "launches_on", "phase8_launches",
            "phase9_launches", "phase10_launches", "phase11_launches")
    line = [{key: k[key] for key in keys if key in k} for k in kernels]
    print(card, flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

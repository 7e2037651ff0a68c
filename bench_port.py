#!/usr/bin/env python3
"""Times of one tree of the port, for comparing two trees on one card.

    python3 bench_port.py [--root DIR] [--parts msm,ntt,prove,lm,curve,bytes] [--prove] [--reps N]

``--root`` is the directory that holds the ``algoplonk_tpu_torch`` package
to measure (default: this file's directory), so that a checkout of another
commit unpacked elsewhere is timed by the same script in the same call: run
it as parent, change, change, parent.  Each tree builds its kernels on first
use and caches its test SRS under its own ``.cache/``.

``--parts`` picks the measurements (default ``msm``; ``--prove`` adds
``prove``):

- ``msm``: K1 (``mixed_add_signed_multi``, 16 steps) and K2 (``jac_add_multi_scan``,
  16 steps) on chip_smoke.py's inputs (``CommitInputs``) at the lane widths
  of one commit: K1 on a table of the commit's size at the phase-1 and
  phase-3 widths, K2 at the wrapper's threads per lane at the phase-2a
  widths of BN254 2^16 and 2^17 and BLS12-381 2^14.  CUDA events over
  ``--reps`` launches after one warm-up; the inputs come from fixed seeds,
  so two trees see the same data.
  Then one commit-sized MSM per curve (BN254 65,539 and BLS12-381 16,387
  points of that table, random scalars), warm, split by the tree's own
  marks (host seconds between synchronised marks).
- ``ntt``: K9 (``ntt_pass``) on both scalar fields at the four pass shapes
  of a four-step transform of 2^19 (the BN254 2^17 prove's round 3),
  contiguous, and where the tree's ``ntt_pass`` takes strides also in the
  column layout through which its four-step transforms run P1 and P1';
  device milliseconds per launch from a torch.profiler trace (chip_smoke.py's
  ``device_ms``) on chip_smoke.py's random residues.  Then one coset
  ``ntt_scr`` and one ``intt_scr`` of 2^19 on each field, CUDA events over
  ``--reps`` calls: whatever the tree launches for them (the parent's
  transposes included).
- ``prove``: chip_smoke.py's SquareChain at BN254 2^16 on the test
  SRS and at BLS12-381 2^14 on the Ethereum KZG ceremony, compiled, then
  proved and self-verified twice (``CompiledCircuit.verify``); host
  seconds, with each prove's rounds and its MSMs' share.  Then one more
  warm BN254 prove under ``torch.profiler``: its CUDA kernel launches and
  the device's busy share (chip_smoke.py's ``profile_device``, which reads
  any tree's prove).
- ``lm``: the SquareChain at BN254 2^17 (the four-step quotient), compiled,
  one warm prove + self-verify, then one more under torch.profiler: its
  CUDA kernel launches by kind, its K9 launches and the busy share.
- ``curve``: K4 (``canon``) at one commit's phase-3 width and at 2^20
  lanes (chip_smoke.py's ``canon_words``: three rows of random words with
  the ladder's edges), K5 (``mixed_add``), K6 (``mixed_add_signed``) and K7
  (``jac_add_multi``, 16 steps) at the kernel-test shapes of chip_smoke.py
  (K5 and K6 at one commit's phase-1 width, K7 at its phase-2a width: BN254
  2^16 at W = 8, BLS12-381 2^14 at W = 12) on ``CommitInputs``; device
  milliseconds per launch from a torch.profiler trace (``device_ms``; K4's
  with the L2 flushed before each launch) and CUDA events over ``--reps``
  launches after one warm-up (``events_ms``, which read the host's launch
  rate too), at the wrapper's threads per lane, and where the tree's K5, K6
  or K7 takes a thread count (``mixed_threads``, ``multi_threads``) at
  every one of them too.
- ``bytes``: the sha256 of ``Prover(rng=False)``'s proof bytes of
  chip_smoke.py's SquareChain at BN254 2^16 and 2^17 on the test SRS and
  at BLS12-381 2^14 on the Ethereum KZG ceremony: two trees that prove
  alike print equal digests.  Beside each, the tree's kernel launches
  (its launch counters, by kernel) in a second, warm prove of the same
  witness.

The measuring code is this file's and the chip_smoke.py beside it, whatever
``--root`` names, so that both trees are measured by the same code.

Prints the card's name and power limit, one JSON line per measurement, and
a last JSON line with all of them.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import random
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def _chip_smoke():
    """The chip_smoke.py beside this file (it imports the port lazily, so
    it measures the tree that ``--root`` puts first on the path)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()


def msm_part(torch, apt, reps, record):
    from algoplonk_tpu_torch.ops import curve_kernels as ck
    from algoplonk_tpu_torch.ops import msm as M

    for curve, n, extra in ((apt.BN254, (1 << 16) + 3, ((1 << 17) + 3,)),
                            (apt.BLS12_381, (1 << 14) + 3, ())):
        s = cs.CommitInputs(torch, random.Random(curve.fp.nbits), curve, n)
        ops, W = s.ops, s.ops.W
        for phase, lanes in (("w1p", s.w1p), ("w2p", s.w2p)):
            acc, _, _, packed = s.k1_inputs(lanes)
            ms = cs.cuda_ms(lambda: ck.mixed_add_signed_multi(ops, acc, s.table, packed),
                            reps)
            record("mixed_add_signed_multi", W=W, lanes=lanes, table_rows=s.nrows,
                   phase=phase, ms=ms)
        for lanes in (s.wsbp, *(cs.commit_widths(m)[2] for m in extra)):
            acc, qs = s.k2_inputs(lanes)
            ms = cs.cuda_ms(lambda: ck.jac_add_multi_scan(ops, acc, qs), reps)
            record("jac_add_multi_scan", W=W, lanes=lanes, steps=M.SUPER, ms=ms)
        ctx = M.msm_ctx(curve, s.dev)
        pts = s.table[:n].reshape(n, 2, W)
        gen = random.Random(n)
        mont = ctx.fr.encode([gen.randrange(curve.fr.modulus) for _ in range(n)])
        want = ctx.msm_to_affine_int(pts, mont, kind="mont")
        split = cs.Split(torch)
        got = ctx.msm_to_affine_int(pts, mont, kind="mont", mark=split)
        record("msm_split", curve=curve.name, points=n, total_s=split.last - split.t0,
               parts=split.parts, equal=got == want)


def curve_part(torch, apt, reps, record):
    import inspect

    from algoplonk_tpu_torch.ops import curve_kernels as ck
    from algoplonk_tpu_torch.ops import msm as M

    flush = torch.zeros(cs.L2_FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")

    def times(fn, kernel, **kw):
        return dict(ms=cs.device_ms(torch, fn, reps, kernel, **kw),
                    events_ms=cs.cuda_ms(fn, reps))

    for curve, n in ((apt.BN254, (1 << 16) + 3), (apt.BLS12_381, (1 << 14) + 3)):
        s = cs.CommitInputs(torch, random.Random(curve.fp.nbits), curve, n)
        ops, W = s.ops, s.ops.W
        for lanes in (s.w2p, cs.CANON_LANES):
            x = cs.canon_words(torch, ops, lanes, s.g)
            record("canon", W=W, lanes=lanes,
                   **times(lambda: ck.canon(ops, x), "canon", flush=flush))
        acc, rows, sign, _ = s.k1_inputs(s.w1p)
        aff = s.table[rows[0]].reshape(s.w1p, 2, W).permute(1, 2, 0).contiguous()
        neg = sign[:1].to(torch.int32).contiguous()
        acc2, qs = s.k2_inputs(s.wsbp)
        for name, lanes, fn, kernel, chooser, choices, shape in (
                ("mixed_add", s.w1p, lambda: ck.mixed_add(ops, acc, aff), "mixed_add",
                 "mixed_threads", "MIXED_THREADS", (W,)),
                ("mixed_add_signed", s.w1p, lambda: ck.mixed_add_signed(ops, acc, aff, neg),
                 "mixed_add", "mixed_threads", "MIXED_THREADS", (W,)),
                ("jac_add_multi", s.wsbp, lambda: ck.jac_add_multi(ops, acc2, qs),
                 "jac_add_multi", "multi_threads", "MULTI_THREADS", (s.wsbp, M.SUPER))):
            record(name, W=W, lanes=lanes, T="wrapper", **times(fn, kernel))
            wrapper = getattr(ck, name)
            if hasattr(ck, chooser) and chooser in inspect.getsource(wrapper):
                picked = getattr(ck, chooser)(*shape)
                for T in getattr(ck, choices):
                    with cs.forced_threads(T, chooser):
                        record(name, W=W, lanes=lanes, T=T, picked=T == picked,
                               **times(fn, kernel))


def ntt_part(torch, apt, reps, record):
    import inspect

    from algoplonk_tpu_torch.ops import ntt_kernels as nk

    strided = "in_strides" in inspect.signature(nk.ntt_pass).parameters
    log_n = cs.LM_LOG_N + 2
    for curve in (apt.BN254, apt.BLS12_381):
        fsp = nk.four_step_plan(curve.name, log_n, "cuda")
        f, N = fsp.f, fsp.n
        g = torch.Generator(device="cpu").manual_seed(9)
        for C, inverse, fused in cs.k9_shapes(fsp):
            x = cs.random_residues(torch, f, N, g)
            tw = fsp.twiddles(C, inverse)
            kw = dict(entry=cs.random_residues(torch, f, N, g),
                      exit_=cs.random_residues(torch, f, N, g)) if fused else {}
            layouts = [("contiguous", {})]
            if strided and fused:
                layouts.append(("column", dict(in_strides=(N // C, 1), out_strides=(N // C, 1))))
            for name, st in layouts:
                ms = cs.device_ms(torch, lambda: nk.ntt_pass(f, x, tw, C, inverse, **kw, **st),
                                  reps, "ntt_pass")
                record("ntt_pass", field=f.fp.name, N=N, C=C, inverse=inverse, fused=fused,
                       layout=name, ms=ms)
        coeffs = cs.random_residues(torch, f, N, g)
        shift = curve.coset_shift
        ev = fsp.ntt_scr(coeffs, coset_shift=shift)
        record("ntt_scr", field=f.fp.name, N=N,
               ms=cs.cuda_ms(lambda: fsp.ntt_scr(coeffs, coset_shift=shift), reps))
        record("intt_scr", field=f.fp.name, N=N,
               ms=cs.cuda_ms(lambda: fsp.intt_scr(ev, coset_shift=shift), reps))


def lm_trace(torch, apt, record):
    from algoplonk_tpu_torch.ops import ntt_kernels as nk

    r = apt.BN254.fr.modulus
    x = 0xA1607 % r
    SquareChain, chain = cs.square_chain(apt, cs.LM_LOG_N)
    y = pow(x, 1 << chain, r)
    cc = apt.compile(SquareChain, apt.BN254, apt.SetupName.TEST_ONLY_BN254,
                     device=torch.device("cuda"))
    cc.verify(SquareChain(x=x, y=y))
    nk.reset_launch_counts()
    n_kernels, by_type, busy, wall = cs.profile_device(
        torch, lambda: cc.verify(SquareChain(x=x, y=y)))
    record("prove_trace", curve="bn254", log_n=cs.LM_LOG_N, kernel_launches=n_kernels,
           k9_launches=nk.LAUNCHES["ntt_pass"], device_events=by_type, device_busy=busy,
           prove_verify_s=wall)


def bytes_part(torch, apt, record):
    import hashlib

    from algoplonk_tpu_torch.frontend import witness as witness_mod
    from algoplonk_tpu_torch.plonk.marshal import marshal_proof
    from algoplonk_tpu_torch.plonk.prove import Prover

    for curve, setup, log_n in (
            (apt.BN254, apt.SetupName.TEST_ONLY_BN254, cs.LOG_N),
            (apt.BN254, apt.SetupName.TEST_ONLY_BN254, cs.LM_LOG_N),
            (apt.BLS12_381, apt.SetupName.ETHEREUM_KZG_CEREMONY_BLS12_381, cs.BLS_LOG_N)):
        r = curve.fr.modulus
        x = 0xA1607 % r
        SquareChain, chain = cs.square_chain(apt, log_n)
        cc = apt.compile(SquareChain, curve, setup, device=torch.device("cuda"))
        prover = Prover(cc.pk, cc.ccs, rng=False)
        wit = witness_mod.solve(cc.ccs, SquareChain(x=x, y=pow(x, 1 << chain, r)),
                                commitment_solver=prover.bsb_solver)
        blob = marshal_proof(curve, prover.prove(wit))
        before = cs.launch_counts()
        warm = marshal_proof(curve, Prover(cc.pk, cc.ccs, rng=False).prove(wit))
        torch.cuda.synchronize()
        launches = {k: v - before[k] for k, v in cs.launch_counts().items() if v != before[k]}
        record("proof_bytes", curve=curve.name, log_n=log_n, nbytes=len(blob),
               sha256=hashlib.sha256(blob).hexdigest(), warm_equal=warm == blob,
               warm_launches=sum(launches.values()), warm_launches_by_kernel=launches)
        del cc, prover


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--parts", default="msm",
                    help="comma list of msm, ntt, prove, lm, curve, bytes")
    ap.add_argument("--prove", action="store_true", help="also compile and prove")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    parts = set(args.parts.split(",")) | ({"prove"} if args.prove else set())
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        print("bench_port: no CUDA device", file=sys.stderr)
        return 2
    import algoplonk_tpu_torch as apt
    from algoplonk_tpu_torch.ops import _build

    if not os.path.abspath(apt.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {apt.__file__}, not the package under {root}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.library()
    print(f"root {root}: kernel build {time.perf_counter() - t0:.1f} s", flush=True)
    print(card, flush=True)
    results = []

    def record(name, **kw):
        row = {"what": name, **kw}
        results.append(row)
        print(json.dumps(row), flush=True)

    if "msm" in parts:
        msm_part(torch, apt, args.reps, record)
    if "curve" in parts:
        curve_part(torch, apt, args.reps, record)
    if "ntt" in parts:
        ntt_part(torch, apt, args.reps, record)
    if "lm" in parts:
        lm_trace(torch, apt, record)
    if "bytes" in parts:
        bytes_part(torch, apt, record)
    if "prove" in parts:
        for curve, setup, log_n in (
                (apt.BN254, apt.SetupName.TEST_ONLY_BN254, cs.LOG_N),
                (apt.BLS12_381, apt.SetupName.ETHEREUM_KZG_CEREMONY_BLS12_381, cs.BLS_LOG_N)):
            r = curve.fr.modulus
            x = 0xA1607 % r
            SquareChain, chain = cs.square_chain(apt, log_n)
            y = pow(x, 1 << chain, r)
            t0 = time.perf_counter()
            cc = apt.compile(SquareChain, curve, setup, device=torch.device("cuda"))
            t_compile = time.perf_counter() - t0
            for run in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with cs.msm_timer() as msm_t:
                    vp = cc.verify(SquareChain(x=x, y=y))
                record("prove", curve=curve.name, log_n=log_n, run=run,
                       compile_s=t_compile, prove_verify_s=time.perf_counter() - t0,
                       msm_s=msm_t.seconds, msm_calls=msm_t.calls,
                       phases=vp.phase_seconds)
            if curve is apt.BN254:
                n_kernels, by_type, busy, wall = cs.profile_device(
                    torch, lambda: cc.verify(SquareChain(x=x, y=y)))
                record("prove_trace", curve=curve.name, log_n=log_n, kernel_launches=n_kernels,
                       device_events=by_type, device_busy=busy, prove_verify_s=wall)
            del cc, vp
    print(json.dumps({"root": root, "card": card, "results": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

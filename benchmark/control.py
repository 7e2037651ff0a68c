"""The control and the faults that show that ``correct`` can come out
false, and the command that reads them on the card at a cell's own size:

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 --seconds 10 [--with blinding_off]

Each seed is one run of the cell (core/cell.py ``run_cell``, set-up
included) with the window's proofs made under ``--with``; the numbers that
decide ``correct`` are printed per seed, one JSON object a line.  The
benchmark's own runs (run.py) never do this; benchmark/tests/ plants them
under CPU runs.

Each is a ``before_window`` for ``run_cell``: it wraps the program for the
window through ``run.patches``, which the run takes off again.

  blinding_off   the control: the program's own ``Prover(rng=False)`` path,
                 which leaves the wire polynomials unblinded and so breaks
                 the configurations' zero-knowledge guarantee
  stale_proof    a step that returns its state unchanged: every verify (or
                 prove_batch) of the window returns the window's first proofs
  altered_byte   an answer altered where it is produced: one byte of each
                 marshalled proof flipped
  half_batch     half of a batch left out: prove_batch proves the first half
                 of its assignments and hands those proofs back for the rest
There is no exchange between cards to leave out: every cell runs on one.
"""

import argparse
import json
import sys


def blinding_off(run):
    from algoplonk_tpu_torch.plonk import prove as prove_mod

    def make(orig):
        def init(self, pk, ccs, rng=None, *args, **kwargs):
            orig(self, pk, ccs, False, *args, **kwargs)
        return init

    run.patches.wrap(prove_mod.Prover, "__init__", make)


def stale_proof(run):
    import algoplonk_tpu_torch as apt
    from algoplonk_tpu_torch.parallel import batch_prove

    first, first_batch = [], []

    def make(orig):
        def verify(self, assignment):
            if not first:
                first.append(orig(self, assignment))
            return first[0]
        return verify

    def make_batch(orig):
        def prove_batch(cc, assignments, *args, **kwargs):
            if not first_batch:
                first_batch.extend(orig(cc, assignments, *args, **kwargs))
            return list(first_batch)
        return prove_batch

    run.patches.wrap(apt.CompiledCircuit, "verify", make)
    run.patches.wrap(batch_prove, "prove_batch", make_batch)


def altered_byte(run):
    import algoplonk_tpu_torch as apt

    def make(orig):
        def marshal_proof(self):
            blob = bytearray(orig(self))
            blob[len(blob) // 2] ^= 0x01
            return bytes(blob)
        return marshal_proof

    run.patches.wrap(apt.VerifiedProof, "marshal_proof", make)


def half_batch(run):
    from algoplonk_tpu_torch.parallel import batch_prove

    def make(orig):
        def prove_batch(cc, assignments, *args, **kwargs):
            assignments = list(assignments)
            half = max(1, len(assignments) // 2)
            done = orig(cc, assignments[:half], *args, **kwargs)
            return [done[i % half] for i in range(len(assignments))]
        return prove_batch

    run.patches.wrap(batch_prove, "prove_batch", make)


ALL = {"blinding_off": blinding_off, "stale_proof": stale_proof,
       "altered_byte": altered_byte, "half_batch": half_batch}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--with", dest="control", default="blinding_off", choices=sorted(ALL))
    args = ap.parse_args(argv)
    import run as bench_run       # benchmark/run.py, beside this file

    bench_run.prepare()
    from benchmark.core import cell as cell_mod
    from benchmark.core import spec as spec_mod

    cell = spec_mod.cell(spec_mod.load_spec(bench_run.ROOT), args.workload)
    why = bench_run.refusal(cell.chips)
    if why:
        bench_run.log(f"refused: {why}")
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        out = cell_mod.run_cell(cell, seed, args.seconds, False,
                                devices=[f"cuda:{i}" for i in range(cell.chips)],
                                log=bench_run.log, before_window=ALL[args.control])
        print(json.dumps({"workload": args.workload, "with": args.control, "seed": seed,
                          "correct": out["correct"], "attempted": out["attempted"],
                          "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

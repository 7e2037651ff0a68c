"""One run of a cell on the CPU, for the tests: the harness less its look
for a card.

    python benchmark/tests/cpu_run.py --root <checkout> --workload <cell> --seed <n>
        --seconds <s> [--trace 1] [--with <control or fault>]

``--root`` holds BENCHMARK.json and benchmark/ (a temporary copy, with
test-only configurations added); the program is imported from this
repository.  Prints the run's result as one JSON line, then one JSON line
with the top-level names of every module loaded once the run is over.
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=0.5)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--with", dest="control", default="")
    args = ap.parse_args()
    sys.path[:1] = [args.root, REPO]
    import torch

    torch.set_num_threads(1)      # tests run several of these side by side
    from benchmark import control
    from benchmark.core import cell as cell_mod
    from benchmark.core import spec as spec_mod

    cell = spec_mod.cell(spec_mod.load_spec(args.root), args.workload, root=args.root,
                         bench=os.path.join(args.root, "benchmark"))
    out = cell_mod.run_cell(cell, args.seed, args.seconds, bool(args.trace), devices=["cpu"],
                            log=lambda *a: print(*a, file=sys.stderr),
                            before_window=control.ALL[args.control] if args.control else None)
    print(json.dumps(out))
    print(json.dumps(sorted({m.split(".", 1)[0] for m in sys.modules})))
    return 0


if __name__ == "__main__":
    sys.exit(main())

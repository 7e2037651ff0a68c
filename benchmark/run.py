"""The benchmark of algoplonk_tpu_torch, the PyTorch and CUDA prover.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  BENCHMARK.json names the cells, metrics and bounds; benchmark/core/
holds the harness; configs/, circuits/, traffic/ and metrics/ hold what
belongs to one configuration, mix or per-layer metric, found by name.

The last line of standard output is the result as one JSON object; the
last lines of standard error give each number that decides ``correct``
beside its limit.  Without a CUDA card, or with fewer than the cell asks
for, or where JAX or the JAX package is loaded once the window has
closed, the run prints no result and exits non-zero.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".cache")

# the program's own variables would change its path: the benchmark runs
# its defaults
PROGRAM_ENV = ("AP_QUOTIENT_LM", "AP_NTT_LM_MIN_LOG", "AP_PROVE_PROFILE", "AP_PERSIST_CACHE")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def prepare() -> None:
    """The process's environment, before torch is imported: the program's
    defaults, every build and kernel cache in the checkout at a fixed
    path, and the checkout's root first on the import path."""
    for var in PROGRAM_ENV:
        os.environ.pop(var, None)
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    here = os.path.dirname(os.path.abspath(__file__))
    if sys.path and os.path.abspath(sys.path[0]) == here:
        sys.path.pop(0)
    sys.path.insert(0, ROOT)


def refusal(chips: int):
    """Why this machine cannot run a cell on ``chips`` cards, or None."""
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        return f"the cell needs {chips} CUDA card(s), this machine has {have}"
    try:
        import algoplonk_tpu_torch  # noqa: F401
    except ImportError as e:
        return f"the program is not in this checkout ({e})"
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    prepare()

    from benchmark.core import cell as cell_mod
    from benchmark.core import spec as spec_mod

    cell = spec_mod.cell(spec_mod.load_spec(ROOT), args.workload)
    why = refusal(cell.chips)
    if why:
        log(f"refused: {why}")
        return 2
    try:
        out = cell_mod.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                devices=[f"cuda:{i}" for i in range(cell.chips)],
                                t_start=T_START, log=log)
    except cell_mod.Refused as e:
        log(f"refused: {e}")
        return 3
    for name, c in out["checks"].items():
        log(f"{name} {c['value']} limit {c['limit']}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

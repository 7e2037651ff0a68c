"""The benchmark's description, and the files each name in it resolves to.

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in files of its own, found by name:

  configs/<config>.json      the deployment's sizes, setup and guarantees;
                             its "circuit" names
  circuits/<circuit>.py      the circuit for either frontend, the
                             assignment drawn from the seed, and the
                             reference's account of the public inputs
  traffic/<traffic>.json     the mix: the entry it drives, proofs per
                             request, streams, warm-up requests
  entries/<entry>.py         the loop of one request through an entry of
                             the program, which a mix names
  metrics/<metric>.py        one reader per per-layer metric

so that a later change adds a cell or a metric by adding files and
entries, and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))   # benchmark/
ROOT = os.path.dirname(HERE)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    cfg: dict               # the configuration's file
    circuit: object         # circuits/<name>.py
    traffic: dict           # traffic/<name>.json
    entry: object           # entries/<traffic's entry>.py
    end_to_end: list        # the metric entries this cell reports
    per_layer: list
    chips: int
    bench: str = HERE       # the benchmark's folder the cell's files came from


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def circuit_file(cfg: dict, bench: str = HERE) -> str:
    return os.path.join(bench, "circuits", f"{cfg['circuit']}.py")


def traffic_file(name: str, bench: str = HERE) -> str:
    return os.path.join(bench, "traffic", f"{name}.json")


def entry_file(name: str, bench: str = HERE) -> str:
    return os.path.join(bench, "entries", f"{name}.py")


def metric_file(name: str, bench: str = HERE) -> str:
    return os.path.join(bench, "metrics", f"{name}.py")


def cell(spec: dict, workload: str, root: str = ROOT, bench: str = HERE) -> Cell:
    """The cell named ``workload`` with its files loaded; KeyError for a
    name BENCHMARK.json does not hold."""
    wl = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    config = next(c for c in spec["configs"] if c["name"] == wl["config"])
    with open(os.path.join(root, config["file"])) as fh:
        cfg = json.load(fh)
    circuit = load_module(circuit_file(cfg, bench), f"bench_circuit_{cfg['circuit']}")
    with open(traffic_file(wl["traffic"], bench)) as fh:
        traffic = json.load(fh)
    entry = load_module(entry_file(traffic["entry"], bench), f"bench_entry_{traffic['entry']}")
    return Cell(
        cfg=cfg, circuit=circuit, traffic=traffic, entry=entry,
        end_to_end=[m for m in spec["end_to_end"] if applies(m, workload)],
        per_layer=[m for m in spec["per_layer"] if applies(m, workload)],
        chips=wl["chips"], bench=bench,
    )


def metric_reader(name: str, bench: str = HERE):
    return load_module(metric_file(name, bench), "bench_metric_" + name.replace(".", "_"))

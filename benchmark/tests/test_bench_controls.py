"""``correct`` can come out false: the control (the program's own
unblinded path) and each fault a cell can have, planted underneath a CPU
run of the harness at a tiny size, each read as not correct beside a sound
run.  On the card, the control at a cell's own size (control.py)."""

import json
import os
import subprocess
import sys

import pytest

from benchmark.tests.conftest import BENCH, REPO, cpu_run

SEQ = ("tiny_squarechain.bn254.seq", "tiny_rangecommit.bn254.seq")
BATCH = "tiny_rangecommit.bn254.pair"


@pytest.mark.parametrize("workload,trace", [(w, 0) for w in SEQ + (BATCH,)] + [(BATCH, 1)])
def test_sound_run_is_correct(tiny_root, workload, trace):
    out, _ = cpu_run(tiny_root, workload, trace=trace)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    rate = "batch_proofs_per_s" if workload == BATCH else "proofs_per_s"
    read = "inflight_proofs.batch" if trace else rate
    assert out["metrics"][read]["value"] > 0
    assert out["checks"]["bad_proofs"] == {"value": 0, "limit": 0}


@pytest.mark.parametrize("workload,control,seconds", [
    (SEQ[0], "blinding_off", 1), (SEQ[1], "blinding_off", 1), (BATCH, "blinding_off", 1),
    (SEQ[0], "stale_proof", 10), (SEQ[1], "altered_byte", 1),
    (BATCH, "half_batch", 1), (BATCH, "stale_proof", 30), (BATCH, "altered_byte", 1),
])
def test_control_and_faults_are_not_correct(tiny_root, workload, control, seconds):
    """A stale proof shows from the window's second request on, so its
    windows hold two: a CPU verify at n = 16 takes up to 5 s, a prove_batch
    of two 15-20 s."""
    out, _ = cpu_run(tiny_root, workload, seconds=seconds, control=control)
    assert out["attempted"] >= (2 * (1 + (workload == BATCH)) if control == "stale_proof" else 1)
    assert not out["correct"] and out["checks"]["bad_proofs"]["value"] > 0


@pytest.mark.cuda
def test_control_on_card(card):
    """The control at the BSB22 cell's own size on the card: not correct."""
    p = subprocess.run([sys.executable, os.path.join(BENCH, "control.py"), "--workload",
                        "rangecommit640.bn254.2p17.seq", "--seeds", "3141592653",
                        "--seconds", "5"], cwd=REPO, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert not line["correct"] and line["checks"]["bad_proofs"]["value"] > 0

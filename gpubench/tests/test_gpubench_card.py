"""Each cell for a few seconds on the CUDA card, through the command the
driver runs. Skips without a card (decided inside each test):

    python3 -m pytest gpubench/tests/test_gpubench_card.py -q
"""

import json
import subprocess
import sys

import pytest

from gpubench import harness

BENCH = harness.load_benchmark()


def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")


def command(cell, seed, trace):
    out = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", cell, "--seed",
         str(seed), "--seconds", "3", "--trace", str(trace)],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.card
@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_cell_runs_correct(cell):
    card()
    r = command(cell, 2 ** 31 + 99, 0)
    assert r["correct"] is True and r["failed"] == 0
    want = {m["name"] for m in harness.cell_metrics(BENCH, cell,
                                                    "end_to_end")}
    assert set(r["metrics"]) == want
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1


@pytest.mark.card
@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_cell_traced(cell):
    card()
    r = command(cell, 2 ** 31 + 98, 1)
    assert r["correct"] is True
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    want = {m["name"] for m in harness.cell_metrics(BENCH, cell,
                                                    "per_layer")}
    assert set(r["metrics"]) == want
    for name, m in r["metrics"].items():
        if name.endswith("_roofline"):
            assert 0 < m["value"] <= 100

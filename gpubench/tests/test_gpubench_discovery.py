"""Every cell finds its configuration, traffic and metrics by name, and a new
one needs new files and entries only."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from gpubench import harness, workload

ROOT = harness.ROOT
BENCH = harness.load_benchmark()
CELLS = [c["name"] for c in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    spec = harness.find_cell(BENCH, cell)
    config = harness.load_config(BENCH, spec)
    for key in ("field", "log_n", "coset_shift", "source", "reduced",
                "assumed", "deployment"):
        assert key in config, key
    traffic = workload.Traffic.load(spec["traffic"])
    W = config["element_words"]
    if spec["chips"] == 1:
        x = torch.zeros(traffic.shape(W, 4))
    else:           # one sharded step, its input a block a card
        sh = harness.sharding(traffic, W, 1 << 12,
                              [torch.device("cpu")] * spec["chips"])
        x = [torch.zeros(sh.inp.shape)] * spec["chips"]
    assert sum(workload.load_op(op).points(x)
               for op, _, _ in traffic.steps) > 0      # it transforms
    e2e = harness.cell_metrics(BENCH, cell, "end_to_end")
    layers = harness.cell_metrics(BENCH, cell, "per_layer")
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layers
    for m in e2e + layers:
        assert callable(harness.load_reader(m["name"]).read), m["name"]
    for m in layers:
        assert m["moves"] in names, (m["name"], m["moves"])


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_states_the_programs_field(config):
    """The reference takes its prime from the configuration file; the
    program names its field: both must be the same field."""
    from ntt_tpu_torch.fields import get_field
    c = harness.load_config(BENCH, {"config": config})
    f = get_field(c["field"])
    assert int(c["modulus"], 16) == f.p
    assert c["generator"] == f.generator
    assert c["element_words"] == f.n_words


def test_benchmark_keys_and_bounds():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for c in BENCH["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]
    chips = [c["chips"] for c in BENCH["workloads"]]
    assert set(chips) <= {1, 4}
    # at most a quarter of the cells, rounded down, on four cards; one may
    assert chips.count(4) <= max(1, len(chips) // 4)


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        harness.find_cell(BENCH, "no-such-cell")
    with pytest.raises(FileNotFoundError):
        workload.Traffic.load("no-such-mix")


@pytest.mark.parametrize("steps", [
    [{"op": "mont_mul", "args": ["x", "y"], "out": "z"}],
    [{"op": "mont_mul", "args": ["x"], "out": "z"}],
    [{"op": "no_such_op", "args": ["x"], "out": "z"}],
])
def test_bad_traffic_is_refused(tmp_path, steps):
    (tmp_path / "bad.json").write_text(json.dumps({
        "inputs": ["x"], "pool_slots": 1, "steps": steps, "output": "z",
        "check_units": 1}))
    with pytest.raises(ValueError):
        workload.Traffic.load("bad", str(tmp_path))


#: an operation no shipped file names: a forward transform whose every
#: point is then squared, in the program and plainly
SQUARE_NTT = """
ARGS = 1


def points(x):
    return x[0].numel()


def program(prog, x):
    y = prog.api.ntt(x, prog.field, **prog.io)
    return prog.limbs.mont_mul(y, y, prog.field)


def reference(ref, x):
    y = ref.ntt(x)
    return ref.mont_mul(y, y)
"""


def test_new_cell_is_files_and_entries_only(tmp_path):
    """A copy of the benchmark gains a configuration, an operation, a
    traffic mix (batched, standard-form I/O, several units to a wait for
    the card), a metric and a cell, as new files and new entries, and runs
    it (on the CPU, at a small domain) with no code edited."""
    shutil.copytree(os.path.join(ROOT, "gpubench"), tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    (tmp_path / "gpubench/configs/goldilocks-2e8.json").write_text(
        json.dumps({"name": "goldilocks-2e8", "field": "goldilocks",
                    "log_n": 8, "coset_shift": 7, "source": "test",
                    "modulus": "0xffffffff00000001", "generator": 7,
                    "reduced": [], "assumed": {}, "deployment": "test"}))
    (tmp_path / "gpubench/ops/square_ntt.py").write_text(SQUARE_NTT)
    (tmp_path / "gpubench/traffic/squares.json").write_text(json.dumps({
        "inputs": ["x"], "pool_slots": 3, "batch": 3, "mont_io": False,
        "sync_every": 4,
        "steps": [{"op": "square_ntt", "args": ["x"], "out": "y"},
                  {"op": "coset_intt", "args": ["y"], "out": "z"}],
        "output": "z", "check_units": 2}))
    (tmp_path / "gpubench/metrics/square_ms.py").write_text(
        "def read(run):\n    return 1e3 * run.window.seconds / "
        "run.window.units\n")
    bench["configs"].append({"name": "goldilocks-2e8", "source": "test",
                             "file": "gpubench/configs/goldilocks-2e8.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "gold-squares",
                               "config": "goldilocks-2e8",
                               "traffic": "squares", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "square_ms", "unit": "ms",
                                "better": "lower", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["gold-squares"]})
    bench["end_to_end"].append({"name": "ntt_gelem_s.squares",
                                "unit": "Gelem/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["gold-squares"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, sys; from gpubench import harness; "
            "r = harness.run_cell('gold-squares', 5, 0.3, False, "
            "devices=['cpu']); print(json.dumps(r))")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), ROOT]))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True
    assert r["checks"]["outputs_checked"]["value"] == min(2, r["attempted"])
    assert set(r["metrics"]) == {"square_ms", "ntt_gelem_s.squares",
                                 "peak_gib", "setup_s"}
    # two transforms a unit, each of 3 columns of 2^8 points
    assert r["metrics"]["ntt_gelem_s.squares"]["value"] == pytest.approx(
        r["attempted"] * 2 * 3 * 256 / r["notes"]["window_s"] / 1e9)

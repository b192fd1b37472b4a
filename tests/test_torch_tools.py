"""The tools of ntt_tpu_torch.tools, run in-process on the CPU at tiny
sizes (``--device cpu``: the kernels' plain versions).

Each tool's ``main`` takes the reference tool's arguments; the records and
lines it prints are checked for the reference's keys and for bit-exact
results, a corrupted algorithm must turn into MISMATCH and exit 1, and
without ``--device`` on a machine with no card every tool exits non-zero
without running. Timed chains are pinned to one call (``SHOOT_CHAIN=1``).
"""

import json
import subprocess
import sys

import pytest
import torch

from ntt_tpu_torch import api
from ntt_tpu_torch.tools import (_common, healthcheck, microbench, scaling,
                                 shootout, sweep)

torch.set_num_threads(1)

TOOLS = {"healthcheck": healthcheck, "sweep": sweep, "shootout": shootout,
         "microbench": microbench, "scaling": scaling}


@pytest.fixture(autouse=True)
def _one_call_chains(monkeypatch):
    monkeypatch.setenv("SHOOT_CHAIN", "1")


def _run(tool, argv, capsys):
    rc = tool.main(list(argv) + ["--device", "cpu"])
    out = capsys.readouterr()
    return rc, out.out, out.err


def _records(text):
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


def _corrupt(monkeypatch, name):
    """``name`` in the registry flips the low bit of its first output word;
    the runner cache is emptied so that the next call takes it."""
    fn, prepare = api.ALGORITHMS[name]

    def flipped(x, field, inverse, aux):
        y = fn(x, field, inverse, aux).clone()
        y[0, 0] = int(y[0, 0]) ^ 1
        return y
    monkeypatch.setitem(api.ALGORITHMS, name, (flipped, prepare))
    monkeypatch.setattr(api, "_runner_cache", {})


def test_healthcheck_ok(capsys):
    names = ["naive", "fourstep", "pallas_fused", "mxu_sub", "auto"]
    rc, out, _ = _run(healthcheck, ["small-proth", "6", ",".join(names)],
                      capsys)
    assert rc == 0, out
    lines = [ln for ln in out.splitlines() if not ln.startswith("#")]
    assert [ln.split()[2] for ln in lines] == names
    assert all(ln.split()[3] == "OK" for ln in lines)


def test_healthcheck_mismatch(capsys, monkeypatch):
    _corrupt(monkeypatch, "stockham")
    rc, out, _ = _run(healthcheck, ["small-proth", "6", "stockham,naive"],
                      capsys)
    assert rc == 1
    assert "stockham       MISMATCH" in out
    assert "naive          OK" in out


def test_healthcheck_fail_line(capsys):
    rc, out, _ = _run(healthcheck, ["goldilocks", "5", "no-such-name"],
                      capsys)
    assert rc == 1 and "no-such-name   FAIL: " in out


@pytest.mark.parametrize("mode", ["1", "full"])
def test_sweep_records(capsys, monkeypatch, mode):
    monkeypatch.setenv("SWEEP_VERIFY", mode)
    monkeypatch.setenv("SWEEP_FULL_CHUNK_LOG", "5")
    rc, out, err = _run(sweep, ["small-proth", "auto", "6,8"], capsys)
    assert rc == 0, out + err
    recs = _records(out)
    assert [r["log_n"] for r in recs] == [6, 8]
    for r in recs:
        assert {"log_n", "algo", "ms", "butterflies_per_s", "bitexact",
                "verify"} <= set(r)
        assert r["algo"] == "mxu_sub" and r["bitexact"] is True
        assert r["ms"] > 0 and r["chain"] == 1
    want = ("full:" if mode == "full" else "subsampled:")
    assert all(r["verify"].startswith(want) for r in recs)
    assert f"full={mode == 'full'}" in err


def test_sweep_catches_a_wrong_word(capsys, monkeypatch):
    monkeypatch.setenv("SWEEP_VERIFY", "full")
    _corrupt(monkeypatch, "mxu_sub")
    rc, out, _ = _run(sweep, ["goldilocks", "auto", "6"], capsys)
    assert rc == 1 and _records(out)[0]["bitexact"] is False


def test_shootout(capsys):
    rc, out, _ = _run(shootout, ["8", "small-proth", "stockham,mxu_sub"],
                      capsys)
    assert rc == 0, out
    rows = [ln.split() for ln in out.splitlines() if not ln.startswith("#")]
    assert [r[0] for r in rows] == ["stockham", "mxu_sub"]
    assert all(r[2] == "ms/iter" and r[4] == "Mbfly/s" and r[6] == "1,"
               for r in rows)


def test_shootout_failed(capsys):
    rc, out, _ = _run(shootout, ["6", "goldilocks", "mxu_sub,bogus"], capsys)
    assert rc == 1
    assert "bogus          FAILED: " in out and "mxu_sub " in out


def test_microbench(capsys, monkeypatch):
    monkeypatch.setattr(microbench, "RATE_K", 64)
    monkeypatch.setattr(microbench, "CHAIN_SHAPE", (64, 64))
    rc, out, _ = _run(microbench, ["10", "bls12-381-fr"], capsys)
    assert rc == 0
    rows = [ln for ln in out.splitlines() if " ms" in ln]
    assert len(rows) == 15
    for label in ("K1 base32", "ntt mxu_chunked (full)", "ntt fourstep",
                  "ntt mxu_pallas", "int8 torch._int_mm 64^3",
                  "bf16 torch.matmul 64^3", "int32 mul+add chain x64"):
        assert any(r.startswith(label) for r in rows), label
    assert "MXU" not in out and "VPU" not in out


def test_microbench_knockout(capsys):
    rc, out, _ = _run(microbench, ["knockout", "10", "bls12-381-fr"], capsys)
    assert rc == 0
    rows = [ln.split()[0] for ln in out.splitlines()
            if not ln.startswith("#")]
    assert rows == ["stream", "digits", "matmul", "reduce", "tw", "stack"]


def test_microbench_knockout_without_stack(capsys):
    """At 2^8, m = 64 leaves B = 4 columns, which 64 does not divide: K2
    has no stack of that shape, and the stack row says so."""
    rc, out, _ = _run(microbench, ["knockout", "8", "goldilocks", "64"],
                      capsys)
    assert rc == 0
    assert "# stack: K2 takes m <= 64 dividing B; not m = 64, B = 4" in out


def test_microbench_knockout_at_m_64(capsys):
    """K7's five stages and K2's 64-entry stack at m = 64 (the knockout
    ``chip_smoke.py`` runs under NTT_MXU_BASE_LOG=6), on the plain
    versions."""
    rc, out, _ = _run(microbench, ["knockout", "12", "goldilocks", "64"],
                      capsys)
    assert rc == 0 and "m=64" in out
    rows = [ln.split()[0] for ln in out.splitlines()
            if not ln.startswith("#")]
    assert rows == ["stream", "digits", "matmul", "reduce", "tw", "stack"]


def test_scaling(capsys):
    rc, out, err = _run(scaling, ["small-proth", "6"], capsys)
    assert rc == 0, out + err
    recs = _records(out)
    assert [r["D"] for r in recs] == [1, 2, 4, 8]
    for r in recs:
        assert set(r) == {"D", "n", "ms_per_step", "per_device_elems",
                          "weak_scaling_vs_d1", "bitexact"}
        assert r["bitexact"] is True and r["n"] == 64 * r["D"]
    assert recs[0]["weak_scaling_vs_d1"] == 1.0
    assert "does not model NVLink" in err


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_no_card_no_run(capsys, monkeypatch, name):
    """Without --device and without a card a tool exits 2 with a clear
    error, and prints nothing on stdout: it does not run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = TOOLS[name].main([])
    out = capsys.readouterr()
    assert rc == 2 and out.out == ""
    assert f"{name}: no CUDA device" in out.err and "--device cpu" in out.err


def test_module_entry_point_without_card():
    """``python3 -m ntt_tpu_torch.tools.<name>`` without a card and without
    --device exits non-zero."""
    code = ("import sys, torch; torch.cuda.is_available = lambda: False; "
            "import runpy; sys.argv = ['healthcheck']; "
            "runpy.run_module('ntt_tpu_torch.tools.healthcheck', "
            "run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 2, out.stdout + out.stderr
    assert "no CUDA device" in out.stderr and out.stdout == ""


def test_time_call_chain(monkeypatch):
    calls = []
    dev = torch.device("cpu")
    t = _common.time_call(lambda: calls.append(1), dev)
    assert t.chain == 1 and len(calls) == 2       # warm + the pinned chain
    monkeypatch.setenv("SHOOT_CHAIN", "7")
    calls.clear()
    assert _common.time_call(lambda: calls.append(1), dev).chain == 7
    assert len(calls) == 8
    monkeypatch.delenv("SHOOT_CHAIN")
    monkeypatch.setenv("SHOOT_TARGET_S", "0")
    calls.clear()
    t = _common.time_call(lambda: calls.append(1), dev)
    assert t.chain == 1 and len(calls) == 3       # warm, estimate, chain
    monkeypatch.setenv("SHOOT_TARGET_S", "1e9")
    assert _common.time_call(lambda: None, dev).chain == _common.MAX_CHAIN
    assert _common.card_line(dev).startswith("cpu")

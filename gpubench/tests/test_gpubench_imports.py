"""Nothing the benchmark runs loads JAX or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and the
reference loads nothing of the program."""

import os
import subprocess
import sys

from gpubench import harness

ROOT = harness.ROOT


def modules_after(code: str) -> set:
    prog = (code + "\nimport sys\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(out.stdout.split())


def test_reference_traffic_ops_and_metrics_load_nothing_foreign():
    top = modules_after(
        "import glob, os, torch\n"
        "from gpubench import harness, workload, roofline, trace\n"
        "from gpubench.reference.ops import Reference\n"
        "for p in glob.glob('gpubench/traffic/*.json'):\n"
        "    workload.Traffic.load(os.path.basename(p)[:-5])\n"
        "for p in glob.glob('gpubench/metrics/*.py'):\n"
        "    harness.load_reader(os.path.basename(p)[:-3])\n"
        "r = Reference((1 << 64) - (1 << 32) + 1, 7, 7, 'cpu')\n"
        "x = torch.zeros((2, 16), dtype=torch.int64).to(torch.uint32)\n"
        "for p in sorted(glob.glob('gpubench/ops/*.py')):\n"
        "    name = os.path.basename(p)[:-3]\n"
        "    op = workload.load_op(name)\n"
        "    v = x\n"
        "    if getattr(op, 'SHARDED', False):\n"
        "        v = [torch.zeros(op.input_layout(2, 16, 2).shape,\n"
        "                         dtype=torch.int64).to(torch.uint32)] * 2\n"
        "    r.call(name, *[v] * op.ARGS)\n")
    assert not top & set(harness.FOREIGN)
    assert "ntt_tpu_torch" not in top


def test_a_run_loads_nothing_foreign():
    top = modules_after(
        "from gpubench import harness\n"
        "r = harness.run_cell('bls381-hterm-2e22', 3, 0.01, False, "
        "devices=['cpu'], log_n=5)\n"
        "assert r['correct']\n")
    assert "ntt_tpu_torch" in top
    assert not top & set(harness.FOREIGN)


def test_foreign_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ntt_tpu_torch_like", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_like", object())
    assert "ntt_tpu_torch_like" not in harness.foreign_modules()
    assert "jaxtyping_like" not in harness.foreign_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "ntt_tpu.api", object())
    assert {"jax.numpy", "ntt_tpu.api"} <= set(harness.foreign_modules())


def test_command_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload",
         "goldilocks-ntt-2e24", "--seed", "1", "--seconds", "1"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""

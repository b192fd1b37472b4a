"""The benchmark's command: one run of one cell on its CUDA card(s).

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout. A cell runs on the cards ``cuda:0`` ..
``cuda:{chips-1}``. It makes the cell's inputs on the card(s) from the
seed, builds and warms the cell's own runners (the program keeps
its kernel builds in ``build/kernels/`` and its host library in
``build/hostlib/`` inside the checkout), measures for ``--seconds``, checks
the outputs of units drawn from the seed against the plain reference, and
prints one JSON object as the last line of standard output: the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics read from
the profiler's trace. The numbers compared, each beside its limit, are the
last lines of standard error and the last key of that object. It exits
with 2, printing no result, without a CUDA card or with fewer cards than
the cell asks for, and with 3 if JAX or the JAX package was loaded.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def _process_age() -> float:
    """Seconds since this process started, from /proc (0 where absent)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


_STARTED = _T0 - _process_age()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from gpubench import harness

    bench = harness.load_benchmark()
    cell = harness.find_cell(bench, args.workload)
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run_cell(
        args.workload, args.seed, args.seconds, bool(args.trace),
        devices=[f"cuda:{i}" for i in range(cell["chips"])],
        started=_STARTED, bench=bench)
    foreign = harness.foreign_modules()
    if foreign:
        print(f"the run loaded {foreign}: nothing it runs may load JAX or "
              "the JAX package", file=sys.stderr)
        return 3
    sys.stderr.write("\n".join(harness.check_lines(result["checks"])) + "\n")
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

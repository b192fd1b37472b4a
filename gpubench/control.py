"""The readings that the check's limit is set from, at a cell's own size.

    python3 gpubench/control.py --workload <cell> \\
        --program-seeds <s> ... --control-seeds <s> ...

For each program seed it runs ``check_units`` units of the cell's traffic
through the program (the runners built once), and for each control seed
through the control: the plain reference with its Montgomery product left
without its final subtraction, so its words are no longer canonical, the
guarantee the configurations state. Each unit's output is compared with the
exact reference on the same inputs. It prints one line a seed and, last, a
JSON object with the lower reading (the most mismatched elements any
program seed gave) and the upper one (the fewest any control seed gave).
A control that raises counts as failed and gives no reading. It reads on
the CUDA card at the cell's configured domain, and exits with 2 without
one. The benchmark's own runs do not run this.
"""

import argparse
import contextlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def readings(cell: str, seeds: list, executor: str) -> list:
    """[(seed, mismatched elements or None if the executor raised,
    outputs checked)] for one executor over ``seeds``."""
    import torch

    from gpubench import harness, workload
    from gpubench.reference.ops import for_config

    _, config, traffic, n, field = harness.cell_parts(
        harness.load_benchmark(), cell)
    device = torch.device("cuda")
    if executor == "program":
        from gpubench.program import Program
        run = Program(config["field"], config["coset_shift"], device,
                      traffic.mont_io)
    else:
        run = for_config(config, device, lazy=True)
    quiet = lambda name: contextlib.nullcontext()  # noqa: E731
    out = []
    for seed in seeds:
        pool = harness.make_pool(traffic, field, n, seed, device)
        try:
            kept = [(i, workload.run_unit(
                run, traffic, workload.unit_inputs(traffic, i, pool),
                quiet)[0]) for i in range(traffic.check_units)]
        except RuntimeError as e:
            print(f"{cell} {executor} seed {seed}: raised {e}", flush=True)
            out.append((seed, None, 0))
            continue
        del pool
        checks = harness.check(traffic, config, n, seed, kept, device)
        m = checks["mismatched_elements"]["value"]
        k = checks["outputs_checked"]["value"]
        print(f"{cell} {executor} seed {seed}: mismatched_elements {m} "
              f"of {k} x {n}", flush=True)
        out.append((seed, m, k))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    prog = readings(args.workload, args.program_seeds, "program")
    ctrl = readings(args.workload, args.control_seeds, "control")
    lower = max((m for _, m, _ in prog if m is not None), default=None)
    upper = min((m for _, m, _ in ctrl if m is not None), default=None)
    print(json.dumps({"workload": args.workload, "lower": lower,
                      "upper": upper,
                      "program": prog, "control": ctrl}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

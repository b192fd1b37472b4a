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
the cell's CUDA cards (``cuda:0`` .. ``cuda:{chips-1}``; over several, the
outputs at r + S·t as a run's check compares them) at the cell's configured
domain, and exits with 2 without them. The benchmark's own runs do not run
this.
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

    spec, config, traffic, n, field = harness.cell_parts(
        harness.load_benchmark(), cell)
    devices = [torch.device("cuda", i) for i in range(spec["chips"])]
    device = devices[0]
    sh = (harness.sharding(traffic, field.words, n, devices)
          if len(devices) > 1 else None)
    if executor == "program":
        from gpubench.program import Program
        run = Program(config["field"], config["coset_shift"],
                      device if sh is None else devices, traffic.mont_io,
                      options=config)
    else:
        run = for_config(config, device, lazy=True)
    quiet = lambda name: contextlib.nullcontext()  # noqa: E731
    out = []
    for seed in seeds:
        take = harness.keep_whole if sh is None else sh.take(seed)
        pool = harness.make_pool(traffic, field, n, seed, device, sh)
        try:
            kept = [take(i, workload.run_unit(
                run, traffic, workload.unit_inputs(traffic, i, pool),
                quiet)[0]) for i in range(traffic.check_units)]
        except RuntimeError as e:
            print(f"{cell} {executor} seed {seed}: raised {e}", flush=True)
            out.append((seed, None, 0))
            continue
        del pool
        checks = harness.check(traffic, config, n, seed, kept, device, sh)
        m = checks["mismatched_elements"]["value"]
        k = checks["outputs_checked"]["value"]
        print(f"{cell} {executor} seed {seed}: mismatched_elements {m} "
              f"of {checks['elements']} in {k} outputs", flush=True)
        out.append((seed, m, k))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    import torch

    from gpubench import harness
    chips = harness.find_cell(harness.load_benchmark(),
                              args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s)", file=sys.stderr)
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

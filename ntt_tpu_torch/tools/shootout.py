"""Algorithm shootout (the port of ``tools/shootout.py``): every algorithm
name timed at one size on the card, Montgomery I/O, tables resident.

Usage: python3 -m ntt_tpu_torch.tools.shootout [logn] [field] [algos,csv]
           [--device DEV]
       (default 18, bls12-381-fr, every name but naive; the CUDA card)
Env: SHOOT_TARGET_S (default 1.5) the seconds of timed calls a name aims
at; SHOOT_CHAIN pins the chain (``_common``).

One line a name: ms a call, million butterflies a second (n log n / 2 a
call), the chain, and the seconds of its runner's build and first call. A
name that raises prints ``FAILED: ...`` and makes the exit code 1.
"""

from __future__ import annotations

import os
import sys
import time
import traceback

from .. import api
from ..fields import get_field
from . import _common


def main(argv=None) -> int:
    a, dev = _common.start("shootout", argv, __doc__)
    if dev is None:
        return 2
    args = a.args
    log_n = int(args[0]) if args else 18
    field = get_field(args[1] if len(args) > 1 else "bls12-381-fr")
    algos = (args[2].split(",") if len(args) > 2
             else [name for name in api.ALGORITHMS if name != "naive"])
    n = 1 << log_n
    target = os.environ.get("SHOOT_TARGET_S", str(_common.TARGET_S))
    chain = os.environ.get("SHOOT_CHAIN", "auto")
    print(f"# n=2^{log_n} field={field.name} target={target}s chain={chain} "
          f"device={_common.card_line(dev)}", flush=True)
    x = api.ramp_mont(field, n, device=dev)
    butterflies = n * log_n / 2
    failures = 0
    for algo in algos:
        try:
            t0 = time.perf_counter()
            run, aux = api.get_runner(field, n, False, algo, True, None, dev)
            build = time.perf_counter() - t0
            t = _common.time_call(lambda: run(x, aux), dev)
            print(f"{algo:14s} {t.per_s * 1e3:10.4f} ms/iter "
                  f"{butterflies / t.per_s / 1e6:10.1f} Mbfly/s "
                  f"(chain {t.chain}, build+first {build + t.first_s:.1f} s)",
                  flush=True)
            del run, aux
        except Exception as e:  # noqa: BLE001 -- every name gets its line
            traceback.print_exc(file=sys.stderr)
            print(f"{algo:14s} FAILED: {type(e).__name__}: {str(e)[:180]}",
                  flush=True)
            failures += 1
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

"""Size sweep (the port of ``tools/sweep.py``; the reference's benchmark
shape, big-num.cu:370, loops sizes 2^5..2^24): one JSON line a size with
the forward transform's time on the card (Montgomery I/O, tables resident)
and its output checked against the native hostlib NTT of the ramp.

Usage: python3 -m ntt_tpu_torch.tools.sweep [field] [algo] [logn,logn,...]
           [--device DEV]
       (default bls12-381-fr, auto, 8,10,...,22; the device the CUDA card)
Env: SWEEP_VERIFY=0 skips the check (it costs one exact host NTT a size,
about 20 s at 2^24); 1 (default) compares 64 output positions;
SWEEP_FULL_CHUNK_LOG=18 (default) the slice of ``hostlib.full_compare``
for SWEEP_VERIFY=full, which compares every position (the reference checks
all elements, GZKP-NTT.cu:1627-1631). SHOOT_TARGET_S and SHOOT_CHAIN set
the timed chain (``_common``).

Keys: ``log_n``, ``algo`` (resolved), ``ms`` and ``butterflies_per_s``
(n log n / 2 a call), ``chain``, and with the check ``bitexact`` and
``verify``. Exit 1 if a size is not bit-exact.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

from .. import api, hostlib
from ..fields import get_field
from . import _common


def main(argv=None) -> int:
    a, dev = _common.start("sweep", argv, __doc__)
    if dev is None:
        return 2
    args = a.args
    field = get_field(args[0] if args else "bls12-381-fr")
    algo = args[1] if len(args) > 1 else "auto"
    logns = ([int(s) for s in args[2].split(",")] if len(args) > 2
             else [8, 10, 12, 14, 16, 18, 20, 22])
    vmode = os.environ.get("SWEEP_VERIFY", "1")
    verify, full = vmode != "0", vmode == "full"
    chunk_log = int(os.environ.get("SWEEP_FULL_CHUNK_LOG", "18"))
    print(f"# sweep field={field.name} algo={algo} verify={verify} "
          f"full={full} device={_common.card_line(dev)}", file=sys.stderr,
          flush=True)
    bad = 0
    for log_n in logns:
        n = 1 << log_n
        run, aux = api.get_runner(field, n, False, algo, True, None, dev)
        x = api.ramp_mont(field, n, device=dev)
        t = _common.time_call(lambda: run(x, aux), dev)
        rec = {"log_n": log_n, "algo": api.resolve_algorithm(algo, field, n),
               "ms": t.per_s * 1e3,
               "butterflies_per_s": n * log_n / 2 / t.per_s,
               "chain": t.chain}
        if verify:
            # the check's call is the input's last use (the reference
            # donates it there)
            y = run(x, aux)
            del x
            want = hostlib.ntt_np(hostlib.ramp_np(n), field)
            if full:
                rec["bitexact"] = hostlib.full_compare(y, want, field,
                                                       chunk_log)
                rec["verify"] = f"full:{n}"
            else:
                idx = np.linspace(0, n - 1, 64, dtype=np.int64)
                rec["bitexact"] = _common.subsample_equal(y, want, idx,
                                                          field)
                rec["verify"] = f"subsampled:{len(idx)}"
            bad += not rec["bitexact"]
            del y
        print(json.dumps(rec), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

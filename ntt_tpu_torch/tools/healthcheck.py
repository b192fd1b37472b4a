"""Health check: run every algorithm name at a small size on the card and
check each output word against the golden NTT (the port of
``tools/healthcheck.py``).

Usage:
    python3 -m ntt_tpu_torch.tools.healthcheck [field] [logn] [algos-csv]
        one configuration (default small-proth 2^9, every name of
        ``api.ALGORITHMS`` and auto): forward against the golden NTT and
        ``intt`` back to the input, one OK / MISMATCH / FAIL line a name
    python3 -m ntt_tpu_torch.tools.healthcheck --deep
        the production ladder: mxu_chunked, mxu_sub and auto on
        BLS12-381 Fr 2^13 and on small-proth and Goldilocks 2^19 (every
        four-step level past the first, the deep level past the narrow
        fields' 2^18 peel), then the BLS12-381 Fr forward at 2^20 on 2 x
        256 subsampled positions and at 2^22 on every position
    --device DEV  (default: the CUDA card; cpu runs the plain versions)

The golden result is the native hostlib's NTT where it builds, the Python
oracle otherwise. Exit 1 if any line is not OK.
"""

from __future__ import annotations

import sys
import traceback

import numpy as np
import torch

from .. import api, hostlib, limbs, oracle
from ..fields import Field, get_field
from . import _common


def _golden(x: list, f: Field, inverse: bool = False) -> list:
    """Exact host transform: the native hostlib when it builds, the Python
    oracle otherwise (the hostlib is about 100x faster: needed from
    2^18)."""
    if hostlib.available():
        return hostlib.ntt(x, f, inverse)
    return (oracle.intt_golden if inverse else oracle.ntt_golden)(x, f)


def _line(f: Field, log_n: int, algo: str, what: str) -> None:
    print(f"{f.name:14s} 2^{log_n:<3d} {algo:14s} {what}", flush=True)


def _fail(f: Field, log_n: int, algo: str, e: Exception) -> None:
    traceback.print_exc(file=sys.stderr)
    _line(f, log_n, algo, f"FAIL: {type(e).__name__}: {str(e)[:140]}")


def _check(f: Field, log_n: int, algos, dev) -> int:
    """Forward of the ramp against the golden NTT and ``intt`` of the
    golden result back to the ramp, under each name; the failures."""
    n = 1 << log_n
    x = oracle.ramp(n, f)
    golden = _golden(x, f)
    xw, gw = limbs.from_ints(x, f), limbs.from_ints(golden, f)
    failures = 0
    for algo in algos:
        try:
            y = api.ntt(xw, f, algorithm=algo, device=dev)
            ok = torch.equal(y.cpu(), gw)
            rt = api.intt(gw, f, algorithm=algo, device=dev)
            ok = ok and torch.equal(rt.cpu(), xw)
            _line(f, log_n, algo, "OK" if ok else "MISMATCH")
        except Exception as e:  # noqa: BLE001 -- every name gets its line
            _fail(f, log_n, algo, e)
            ok = False
        failures += not ok
    return failures


def _check_big(f: Field, log_n: int, algos, dev, k: int = 256,
               full: bool = False) -> int:
    """The forward on the card at a production size, Montgomery I/O,
    against the hostlib NTT of the ramp: on ``k`` positions of two index
    draws, or with ``full=True`` on every position
    (``hostlib.full_compare``, the reference's all-elements check,
    GZKP-NTT.cu:1627-1631). The failures."""
    n = 1 << log_n
    want = hostlib.ntt_np(hostlib.ramp_np(n), f)
    rng = np.random.default_rng(log_n)
    draws = [np.linspace(0, n - 1, k, dtype=np.int64),
             np.sort(rng.choice(n, size=k, replace=False))]
    failures = 0
    for algo in algos:
        try:
            run, aux = api.get_runner(f, n, False, algo, True, None, dev)
            # the input lives only for the call, as the reference donates it
            y = run(api.ramp_mont(f, n, device=dev), aux)
            if full:
                ok = hostlib.full_compare(y, want, f)
                how = f"full:{n}"
            else:
                ok = all(_common.subsample_equal(y, want, idx, f)
                         for idx in draws)
                how = f"subsampled 2x{k}"
            del y, aux
            _line(f, log_n, algo, f"{'OK' if ok else 'MISMATCH'} ({how})")
        except Exception as e:  # noqa: BLE001 -- every name gets its line
            _fail(f, log_n, algo, e)
            ok = False
        failures += not ok
    return failures


def main(argv=None) -> int:
    a, dev = _common.start("healthcheck", argv, __doc__, ("--deep",))
    if dev is None:
        return 2
    card = _common.card_line(dev)
    if a.deep:
        print(f"# healthcheck --deep device={card}", flush=True)
        prod = ["mxu_chunked", "mxu_sub", "auto"]
        bls = get_field("bls12-381-fr")
        failures = _check(bls, 13, prod, dev)
        failures += _check(get_field("small-proth"), 19, prod, dev)
        failures += _check(get_field("goldilocks"), 19, prod, dev)
        failures += _check_big(bls, 20, ["mxu_chunked"], dev)
        failures += _check_big(bls, 22, ["mxu_chunked"], dev, full=True)
        return 1 if failures else 0
    args = a.args
    f = get_field(args[0] if args else "small-proth")
    log_n = int(args[1]) if len(args) > 1 else 9
    algos = (args[2].split(",") if len(args) > 2
             else list(api.ALGORITHMS) + ["auto"])
    print(f"# healthcheck field={f.name} n=2^{log_n} device={card}",
          flush=True)
    return 1 if _check(f, log_n, algos, dev) else 0


if __name__ == "__main__":
    sys.exit(main())

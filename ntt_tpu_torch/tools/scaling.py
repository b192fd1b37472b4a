"""Weak-scaling series of the multi-device four-step (the port of
``tools/scaling.py``): fixed work a shard, D = 1, 2, 4, 8 shards of one
card (``parallel.make_mesh([device] * D)``, the counterpart of the
reference's D virtual devices on one host), the exchange kernel K8
(``exchange="pallas"``) between the steps.

Usage: python3 -m ntt_tpu_torch.tools.scaling [field] [log_per_device] [algo]
           [--device DEV]
       (default small-proth, 14, the plain local transform "jnp"; the CUDA
       card)
Env: SHOOT_TARGET_S and SHOOT_CHAIN set the timed chain (``_common``).

One JSON line a D: ``D``, ``n``, ``ms_per_step`` (one forward transform,
Montgomery I/O), ``per_device_elems``, ``weak_scaling_vs_d1`` (ideal 1.0)
and ``bitexact`` (every output word against the Python oracle, or the
hostlib above 2^16). Caveat, printed with the data: the shards share one
card's SMs and memory, so the series shows that the sharded program runs
and bounds the exchange's share; it does not model NVLink. Exit 1 if a
point is not bit-exact.
"""

from __future__ import annotations

import json
import sys

import numpy as np

from .. import api, hostlib, limbs, oracle
from ..fields import Field, get_field
from ..parallel import make_dist_ntt, make_mesh, shard_for_ntt, unshard
from . import _common

#: the largest n checked against the Python oracle; the hostlib above
ORACLE_MAX = 1 << 16


def _golden_planes(f: Field, n: int) -> np.ndarray:
    """The NTT of the ramp as np.uint32[W, n] word planes."""
    if n <= ORACLE_MAX:
        return limbs.from_ints(
            oracle.ntt_golden(oracle.ramp(n, f), f), f).numpy()
    return hostlib.host_planes(hostlib.ntt_np(hostlib.ramp_np(n), f),
                               f.n_words)


def main(argv=None) -> int:
    a, dev = _common.start("scaling", argv, __doc__)
    if dev is None:
        return 2
    args = a.args
    f = get_field(args[0] if args else "small-proth")
    log_pd = int(args[1]) if len(args) > 1 else 14
    algo = args[2] if len(args) > 2 else "jnp"
    print(f"# scaling field={f.name} per_device=2^{log_pd} algo={algo} "
          f"device={_common.card_line(dev)} x D shards: the shards share "
          "one card's SMs and memory, so the series shows that the sharded "
          "program runs and bounds the exchange (K8) share; it does not "
          "model NVLink", file=sys.stderr, flush=True)
    t1 = None
    bad = 0
    for D in (1, 2, 4, 8):
        n = (1 << log_pd) * D
        mesh = make_mesh([dev] * D)
        xs = shard_for_ntt(api.ramp_mont(f, n, device=dev), f, mesh)
        fwd = make_dist_ntt(f, n, mesh, mont_io=True, algorithm=algo,
                            exchange="pallas")
        t = _common.time_call(lambda: fwd(xs), dev).per_s
        t1 = t if t1 is None else t1
        y = unshard([limbs.from_mont(s, f) for s in fwd(xs)]).numpy()
        ok = np.array_equal(y, _golden_planes(f, n))
        bad += not ok
        print(json.dumps({
            "D": D, "n": n, "ms_per_step": t * 1e3,
            "per_device_elems": 1 << log_pd,
            # fixed work a shard: ideal 1.0; the shards share one card
            "weak_scaling_vs_d1": t1 / t, "bitexact": ok}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

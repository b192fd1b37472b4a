"""What the tools share: their command line (the reference tool's
positional arguments plus ``--device``), the card line of their headers,
the subsampled golden check, and their timing.

Timing: one warm call, then CUDA events around ``chain`` back-to-back calls
on the card's stream (a host clock on the CPU), the chain scaled so that the
timed calls take about ``SHOOT_TARGET_S`` seconds (default 1.5, the
reference tools' target); ``SHOOT_CHAIN`` pins the chain. The reference's
tunnel-floor calibration has no counterpart: CUDA events time the card's
stream, with no tunnel in between.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from .. import hostlib, limbs
from ..fields import Field

#: seconds of timed calls a measurement aims at (``SHOOT_TARGET_S``)
TARGET_S = 1.5
#: the longest chain of calls one measurement makes
MAX_CHAIN = 16384


def start(prog: str, argv, doc: str, flags: tuple = ()):
    """(parsed arguments, device) of a tool's command line: the positional
    arguments in ``.args``, each of ``flags`` a boolean, ``--device`` the
    device (default: the CUDA card). The device is None, and a line on
    stderr says why, when there is no card and none was named."""
    ap = argparse.ArgumentParser(
        prog=f"python3 -m ntt_tpu_torch.tools.{prog}", description=doc,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("args", nargs="*")
    for flag in flags:
        ap.add_argument(flag, action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    a = ap.parse_args(argv)
    try:
        dev = limbs.resolve_device(a.device)
    except RuntimeError:
        print(f"{prog}: no CUDA device; the tools run on the card, or on "
              "the device --device names (--device cpu runs the plain "
              "versions)", file=sys.stderr)
        return a, None
    return a, dev


def card_line(dev: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    what a CPU run is."""
    if dev.type != "cuda":
        return f"{dev.type} (the kernels' plain versions; no device time)"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    lines = out.stdout.strip().splitlines()
    return lines[min(dev.index or 0, len(lines) - 1)]


def subsample_equal(y_mont, want_rows: np.ndarray, idx: np.ndarray,
                    field: Field) -> bool:
    """Columns ``idx`` of the Montgomery-form result uint32[W, n] against
    the same rows of the standard-form golden np.uint64[n, 4]."""
    cols = torch.from_numpy(idx).to(y_mont.device)
    # (CUDA indexes no uint32 tensor: as int32 bits)
    sel = y_mont.view(torch.int32)[:, cols].view(torch.uint32)
    got = limbs.from_mont(sel, field).cpu().numpy()
    return np.array_equal(got, hostlib.host_planes(want_rows[idx],
                                                   field.n_words))


class Timing(NamedTuple):
    per_s: float      # seconds a call, over the timed chain
    chain: int        # calls in the timed chain
    first_s: float    # the warm call, host clock to its end


def _elapsed_s(fn, count: int, dev: torch.device) -> float:
    if dev.type == "cuda":
        start_ev = torch.cuda.Event(enable_timing=True)
        end_ev = torch.cuda.Event(enable_timing=True)
        start_ev.record()
        for _ in range(count):
            fn()
        end_ev.record()
        end_ev.synchronize()
        return start_ev.elapsed_time(end_ev) / 1e3
    t0 = time.perf_counter()
    for _ in range(count):
        fn()
    return time.perf_counter() - t0


def time_call(fn, dev: torch.device) -> Timing:
    """Seconds a call of ``fn()`` takes on ``dev``: one warm call, one
    call to estimate, then a chain of calls sized to ``SHOOT_TARGET_S``
    (or ``SHOOT_CHAIN`` calls), timed as one."""
    t0 = time.perf_counter()
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    first = time.perf_counter() - t0
    pinned = os.environ.get("SHOOT_CHAIN")
    if pinned:
        chain = int(pinned)
    else:
        target = float(os.environ.get("SHOOT_TARGET_S", TARGET_S))
        est = max(_elapsed_s(fn, 1, dev), 1e-7)
        chain = int(min(MAX_CHAIN, max(1, target / est)))
    return Timing(_elapsed_s(fn, chain, dev) / chain, chain, first)

"""Component micro-benchmarks on the card (the port of
``tools/microbench.py``): each building block of the transform timed alone,
to attribute a transform's time between the int8 tensor cores, the
Montgomery arithmetic on the CUDA cores and the relayouts.

Usage: python3 -m ntt_tpu_torch.tools.microbench [logn] [field] [--device DEV]
       python3 -m ntt_tpu_torch.tools.microbench knockout [logn] [field] [m]
           [--device DEV]
       (default 18, bls12-381-fr, m = ``mxu.BASE``; the CUDA card)
Env: SHOOT_TARGET_S and SHOOT_CHAIN set the timed chain (``_common``).

The components, on the ramp in Montgomery form: ``limbs.mont_mul`` and
``add_mod`` over the whole vector; ``digits.extract_digits``; the plain
digit-matmul level ``mxu._base_ntt`` at m = 64; ``core.dit_stage`` at
s = 32; the relayout; kernel K1 (``base_ntt_mxu``) at m = ``mxu.BASE``; the
twiddle ``mont_mul`` over [W, BASE, n/BASE]; the swapaxes round trip; the full
``mxu_chunked``, ``fourstep`` and ``mxu_pallas`` transforms; then the rate
rows, measurement calibrations and not ports of a kernel: ``torch._int_mm``
int8 and bf16 ``torch.matmul`` at 2048^3, and an int32 multiply-add chain
(eager: one pass over memory an operation).

``knockout`` times kernel K7 (``fused_level_probe``), the fused level at
[W, m, n/m] cut after each of its stages (stream, digits, matmul, reduce,
tw; T3 from ``core.host_power_matrix``), each stage's time and its increase
over the stage before; then kernel K2 (``fused_level_stack``) with the
m-entry twiddle stack at rep = n/m^2, where K2 takes that shape
(m <= 64, m dividing n/m).
"""

from __future__ import annotations

import sys

import torch

from .. import api, digits, limbs
from ..fields import get_field
from ..kernels import mxu_level
from ..kernels.mxu_ntt import base_ntt_mxu
from ..transforms import core, mxu
from . import _common

#: the side of the square rate matmuls
RATE_K = 2048
#: the shape and length of the int32 multiply-add chain
CHAIN_SHAPE = (4096, 4096)
CHAIN_OPS = 64


def _row(name: str, fn, dev) -> float:
    per = _common.time_call(fn, dev).per_s
    print(f"{name:46s} {per * 1e3:10.4f} ms", flush=True)
    return per


def _mats(field, m: int, dev) -> dict:
    """The conv matrix of m points (and its fold matrices on the 256-bit
    fields) on ``dev``."""
    return api.aux_from_numpy([], mxu._mats_for(field, {m}, False),
                              device=dev)["mats"]


def knockout(args, dev) -> int:
    log_n = int(args[0]) if args else 18
    field = get_field(args[1] if len(args) > 1 else "bls12-381-fr")
    m = int(args[2]) if len(args) > 2 else mxu.BASE
    n, W = 1 << log_n, field.n_words
    B = n // m
    print(f"# knockout device={_common.card_line(dev)} n=2^{log_n} "
          f"field={field.name} m={m}", flush=True)
    x = api.ramp_mont(field, n, device=dev).reshape(W, m, B)
    A = _mats(field, m, dev)[m]
    w = field.root_of_unity(n)
    T = torch.from_numpy(core.host_power_matrix(field, w, m, B)).to(dev)
    prev = 0.0
    for stage in mxu_level.PROBE_STAGES:
        t3 = T if stage == "tw" else None
        per = _common.time_call(lambda: mxu_level.fused_level_probe(
            x, field, A, stage, t3), dev).per_s
        print(f"{stage:12s} {per * 1e3:10.4f} ms   "
              f"(+{(per - prev) * 1e3:9.4f})", flush=True)
        prev = per
    # the twiddle-fold level at the same geometry: level 0's stack (m
    # entries, rep = B/m); against 'reduce' the cost of streaming the
    # stack, against 'tw' what the fold saves a level
    if B % m or m > mxu_level.LEVEL_MAX_M:
        print(f"# stack: K2 takes m <= {mxu_level.LEVEL_MAX_M} dividing B; "
              f"not m = {m}, B = {B}", flush=True)
        return 0
    s0 = B // m
    tvals = [[pow(w, k * a * s0, field.p) for k in range(m)]
             for a in range(m)]
    As = torch.from_numpy(mxu.twiddle_matrix_stack(field, m, False,
                                                   tvals)).to(dev)
    per = _common.time_call(lambda: mxu_level.fused_level_stack(
        x, field, As, s0), dev).per_s
    print(f"{'stack':12s} {per * 1e3:10.4f} ms   (vs tw {prev * 1e3:.4f})",
          flush=True)
    return 0


def main(argv=None) -> int:
    a, dev = _common.start("microbench", argv, __doc__)
    if dev is None:
        return 2
    args = a.args
    if args and args[0] == "knockout":
        return knockout(args[1:], dev)
    log_n = int(args[0]) if args else 18
    field = get_field(args[1] if len(args) > 1 else "bls12-381-fr")
    n, W = 1 << log_n, field.n_words
    tc, cc = (("tensor cores", "CUDA cores") if dev.type == "cuda"
              else ("CPU", "CPU"))
    print(f"# device={_common.card_line(dev)} n=2^{log_n} "
          f"field={field.name}", flush=True)
    x = api.ramp_mont(field, n, device=dev)

    m = 64
    xt = x.reshape(W, m, n // m)
    _row(f"mont_mul (full vector, {cc})",
         lambda: limbs.mont_mul(x, x, field), dev)
    _row(f"add_mod (full vector, {cc})",
         lambda: limbs.add_mod(x, x, field), dev)
    _row(f"extract_digits ({cc})",
         lambda: digits.extract_digits(x, field), dev)
    mats = _mats(field, m, dev)
    _row(f"base{m} digit-matmul level (plain, FP64 matmul)",
         lambda: mxu._base_ntt(xt, field, False, mats), dev)
    master = core.twiddle_master_on(field, m, False, dev)
    _row(f"dit_stage s=32 over [{m}, B] ({cc})",
         lambda: core.dit_stage(xt, 32, master[:, :32], field), dev)
    _row(f"relayout [W,{m},B] -> [W,B,{m}] (copy)",
         lambda: xt.transpose(1, 2).contiguous(), dev)

    # the level pipeline of mxu_chunked, piece by piece on its level shape
    mb = mxu.BASE
    xb = x.reshape(W, mb, n // mb)
    mats_b = _mats(field, mb, dev)
    _row(f"K1 base{mb} (digits, int8 {tc}, reduce)",
         lambda: base_ntt_mxu(xb, field, mats_b[mb], mats_b.get(-mb)), dev)
    Tb = torch.from_numpy(core.host_power_matrix(
        field, field.root_of_unity(n), mb, n // mb)).to(dev)
    _row(f"twiddle mont_mul [W,{mb},n/{mb}] ({cc})",
         lambda: limbs.mont_mul(xb, Tb, field), dev)
    _row("swapaxes(1,2) round trip (two copies)",
         lambda: xb.transpose(1, 2).contiguous().transpose(1, 2)
         .contiguous(), dev)

    for algo in ("mxu_chunked", "fourstep", "mxu_pallas"):
        run, aux = api.get_runner(field, n, False, algo, True, None, dev)
        _row(f"ntt {algo} (full)", lambda: run(x, aux), dev)
        del run, aux

    # rate calibrations
    k = RATE_K
    a8 = torch.ones((k, k), dtype=torch.int8, device=dev)
    t = _row(f"int8 torch._int_mm {k}^3 ({tc})",
             lambda: torch._int_mm(a8, a8), dev)
    print(f"  -> int8 MAC rate: {k ** 3 / t / 1e12:.2f} T MAC/s")
    bf = torch.ones((k, k), dtype=torch.bfloat16, device=dev)
    t = _row(f"bf16 torch.matmul {k}^3 ({tc})",
             lambda: torch.matmul(bf, bf), dev)
    print(f"  -> bf16 MAC rate: {k ** 3 / t / 1e12:.2f} T MAC/s")
    u = torch.ones(CHAIN_SHAPE, dtype=torch.int32, device=dev)

    def chain():
        r = u
        for _ in range(CHAIN_OPS):
            r = r * 12345 + u
        return r

    t = _row(f"int32 mul+add chain x{CHAIN_OPS} ({cc}, eager)", chain, dev)
    print(f"  -> int32 op rate: {u.numel() * CHAIN_OPS * 2 / t / 1e12:.2f} "
          "T op/s (one pass over memory an operation)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

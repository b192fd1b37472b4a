#!/usr/bin/env python3
"""Chip smoke test of ntt_tpu_torch on one NVIDIA GPU (written for an H100).

Run from the repository root with no arguments: ``python3 chip_smoke.py``.

1. Prints the card (``nvidia-smi`` name and power limit) and builds the
   CUDA kernels from ``ntt_tpu_torch/csrc`` (one nvcc per source, in
   parallel).
2. Holds each kernel, word for word, against its plain PyTorch version on
   the card at the shapes the 2^18 BLS12-381 forward transform gives it,
   plus K3 at rep = 32 and K2 with a residual twiddle, and times kernel,
   plain version and ``torch._int_mm`` on the same int8 operands; then at
   small shapes for every m of the slice (ragged batches, odd reps).
3. Drives the main path, ``ntt_tpu_torch.ntt(..., mont_io=True)``, and
   checks every output word against the hostlib golden NTT: BLS12-381 Fr
   2^18 on the ramp and on a random input, BN254 Fr 2^18, BLS 2^14 and
   BLS 2^20 (random inputs from fixed seeds). The launch counts of the
   2^18 ramp transform show which kernels it ran.
4. Prints a ``kernels`` JSON line, the card line, and last the result line
   ``{"ok": true, "device": {...}}``.

Any failure raises and the script exits non-zero, printing no result. It
needs a CUDA device; it imports neither JAX nor ``ntt_tpu``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

#: NVIDIA H100 SXM data-sheet peaks (dense): device memory and int8 tensor rate
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
SEED = 2026


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 2) -> float:
    """Median of ``iters`` CUDA-event-timed calls of ``fn``."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def random_words(field, shape, rng) -> np.ndarray:
    """Canonical random elements as uint32[W, *shape] word planes: the top
    word stays below p's, so every value is < p."""
    W = field.n_words
    x = rng.integers(0, 1 << 32, size=(W,) + tuple(shape), dtype=np.uint64)
    x[W - 1] = rng.integers(0, field.p >> (32 * (W - 1)), size=shape,
                            dtype=np.uint64)
    return x.astype(np.uint32)


def planes_to_rows(planes: np.ndarray) -> np.ndarray:
    """uint32[8, n] word planes -> uint64[n, 4] hostlib limb rows."""
    return np.ascontiguousarray(planes.T).view(np.uint64)


def bound(bytes_moved: int, int8_macs: int) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * int8_macs / INT8_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_kernels(f, aux, rng, dev) -> dict:
    """Every kernel against its plain version, at the main path's shapes."""
    from ntt_tpu_torch import digits
    from ntt_tpu_torch.kernels import mxu_level, mxu_ntt

    D = digits.n_digits(f)
    mats = aux["mats"]
    stack0, batch1, stack2 = aux["tws"]

    def rand(*shape):
        return torch.from_numpy(random_words(f, shape, rng)).to(dev)

    def int_mm(A, x):
        m = x.shape[1]
        d = digits.extract_digits(x, f).reshape(D * m, -1).contiguous()
        return lambda: torch._int_mm(A, d)

    cases = []
    # (kernel, label, kernel call, plain call, bytes read+written, MACs,
    #  int8 operands of the library yardstick, on the main path)
    x = rand(32, 8192)
    A = stack0.As
    cases.append(("fused_level_stack", "level 0 [8,32,8192] stack 32 rep 256",
                  lambda: mxu_level.fused_level_stack(x, f, A, 256, mats[-32]),
                  lambda: mxu_level.fused_level_stack_plain(
                      x, f, A, 256, mats[-32]),
                  2 * x.numel() * 4 + A.numel(), A.numel() * 256,
                  int_mm(A[0], x), True))
    x1 = rand(32, 8192)
    T1 = batch1.T4.reshape(8, 32, 8192)
    sub = {k: mats[k] for k in (32, -32, -1)}
    cases.append(("fused_subntt", "level 1 [8,32,8192] TwBatch rep 1",
                  lambda: mxu_level.fused_subntt(x1, f, sub, T1, rep=1),
                  lambda: mxu_level.fused_subntt_plain(x1, f, sub, T1, rep=1),
                  3 * x1.numel() * 4 + mats[32].numel(),
                  mats[32].numel() * 8192, int_mm(mats[32], x1), True))
    x2 = rand(32, 8192)
    A2 = stack2.As
    cases.append(("fused_level_stack", "level 2 [8,32,8192] stack 8 rep 1024",
                  lambda: mxu_level.fused_level_stack(x2, f, A2, 1024,
                                                      mats[-32]),
                  lambda: mxu_level.fused_level_stack_plain(
                      x2, f, A2, 1024, mats[-32]),
                  2 * x2.numel() * 4 + A2.numel(), A2.numel() * 1024,
                  int_mm(A2[0], x2), True))
    x3 = rand(8, 32768)
    cases.append(("base_ntt_mxu", "base [8,8,32768]",
                  lambda: mxu_ntt.base_ntt_mxu(x3, f, mats[8], mats[-8]),
                  lambda: mxu_ntt.base_ntt_mxu_plain(x3, f, mats[8], mats[-8]),
                  2 * x3.numel() * 4 + mats[8].numel(),
                  mats[8].numel() * 32768, int_mm(mats[8], x3), True))
    # off the 2^18 path: K3 at rep = 32 (2^14 level 1), K2 with a residual
    x4 = rand(32, 512)
    T4 = rand(16, 32)
    cases.append(("fused_subntt", "rep 32 [8,32,512] table [8,16,32]",
                  lambda: mxu_level.fused_subntt(x4, f, sub, T4, rep=32),
                  lambda: mxu_level.fused_subntt_plain(x4, f, sub, T4, rep=32),
                  2 * x4.numel() * 4 + T4.numel() * 4 + mats[32].numel(),
                  mats[32].numel() * 512, None, False))
    x5 = rand(32, 256)
    T5 = rand(32, 256)
    A5 = A[:2]
    cases.append(("fused_level_stack", "residual T3 [8,32,256] stack 2 rep 128",
                  lambda: mxu_level.fused_level_stack(x5, f, A5, 128,
                                                      mats[-32], T3=T5),
                  lambda: mxu_level.fused_level_stack_plain(
                      x5, f, A5, 128, mats[-32], T3=T5),
                  3 * x5.numel() * 4 + A5.numel(), A5.numel() * 128,
                  None, False))

    results = {}
    for name, label, kern, plain, nbytes, macs, lib, on_path in cases:
        got = kern()
        torch.cuda.synchronize()
        want = plain()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        if err != 0 or not torch.equal(got, want):
            raise AssertionError(f"{name} ({label}): kernel != plain, "
                                 f"max abs err {err}")
        ms = time_ms(kern)
        plain_ms = time_ms(plain, iters=5)
        lib_ms = time_ms(lib) if lib is not None else None
        b_ms, b_by = bound(nbytes, macs)
        print(f"check {name:18s} {label:40s} word-equal  kernel {ms:.4f} ms"
              f"  plain {plain_ms:.4f} ms  _int_mm "
              f"{'-' if lib_ms is None else f'{lib_ms:.4f} ms'}"
              f"  bound {b_ms:.4f} ms ({b_by})", flush=True)
        call = {"shape": label, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                "max_abs_err": err, "bytes": nbytes, "int8_macs": macs}
        r = results.setdefault(name, {"calls": [], "path": []})
        r["calls"].append(call)
        if on_path:
            r["path"].append(call)
    return results


def check_small_shapes(f, rng, dev) -> int:
    """Every kernel against its plain version at every m of the slice, with
    ragged batch sizes (masked columns), reps that split a warp between
    stack entries, and both twiddle layouts. Returns the number of checks."""
    from ntt_tpu_torch import digits
    from ntt_tpu_torch.kernels import mxu_level, mxu_ntt
    from ntt_tpu_torch.transforms import mxu

    def rand(*shape):
        return torch.from_numpy(random_words(f, shape, rng)).to(dev)

    def same(label, got, want):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{f.name} {label}: kernel != plain")

    D = digits.n_digits(f)
    checks = 0
    for m in (2, 4, 8, 16, 32):
        mats = {m: mxu._base_matrix(f, m), -m: mxu._fold_matrix(f, m),
                -1: digits.fold_mul_matrix(f)}
        mats = {k: torch.from_numpy(v).to(dev) for k, v in mats.items()}
        for B in (1, 37, 300):
            x, T = rand(m, B), rand(m, B)
            same(f"base m={m} B={B}",
                 mxu_ntt.base_ntt_mxu(x, f, mats[m], mats[-m]),
                 mxu_ntt.base_ntt_mxu_plain(x, f, mats[m], mats[-m]))
            same(f"subntt m={m} B={B}",
                 mxu_level.fused_subntt(x, f, mats, T),
                 mxu_level.fused_subntt_plain(x, f, mats, T))
            checks += 2
        for n2, rep in ((4, 8), (2, 128)):
            x, T = rand(m, n2 * rep), rand(n2, m)
            same(f"subntt m={m} rep={rep}",
                 mxu_level.fused_subntt(x, f, mats, T, rep=rep),
                 mxu_level.fused_subntt_plain(x, f, mats, T, rep=rep))
            checks += 1
        for NT, rep in ((3, 16), (4, 7)):
            x, T = rand(m, NT * rep), rand(m, NT * rep)
            As = torch.from_numpy(rng.integers(
                0, 128, size=(NT, D * m, D * m), dtype=np.int8)).to(dev)
            for T3 in (None, T):
                same(f"stack m={m} NT={NT} rep={rep} T3={T3 is not None}",
                     mxu_level.fused_level_stack(x, f, As, rep, mats[-m], T3),
                     mxu_level.fused_level_stack_plain(x, f, As, rep,
                                                       mats[-m], T3))
                checks += 1
    return checks


def verify(f, y_mont, x_std_planes) -> None:
    """Every output word against the hostlib golden NTT."""
    from ntt_tpu_torch import hostlib, limbs
    want = hostlib.host_planes(
        hostlib.ntt_np(planes_to_rows(x_std_planes), f), f.n_words)
    got = limbs.from_mont(y_mont, f).cpu().numpy()
    if got.shape != want.shape or not np.array_equal(got, want):
        bad = int((got != want).any(axis=0).sum()) if got.shape == want.shape \
            else -1
        raise AssertionError(f"{f.name}: {bad} positions differ from golden")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.time()
    from ntt_tpu_torch import BLS12_381_FR, BN254_FR, limbs
    from ntt_tpu_torch.api import get_runner, ntt, ramp_mont
    from ntt_tpu_torch.kernels import _build

    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}")
    print(f"device: {torch.cuda.get_device_name(0)}  torch {torch.__version__}"
          f"  cuda {torch.version.cuda}", flush=True)

    t0 = time.time()
    logs = _build.build_all()
    print(f"build: {time.time() - t0:.1f} s ({', '.join(_build.LIBRARIES)})")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    rng = np.random.default_rng(SEED)
    t0 = time.time()
    run, aux = get_runner(BLS12_381_FR, 1 << 18, device=dev)
    print(f"tables: bls12-381-fr 2^18 built and resident in "
          f"{time.time() - t0:.1f} s", flush=True)

    results = check_kernels(BLS12_381_FR, aux, rng, dev)
    for f in (BLS12_381_FR, BN254_FR):
        print(f"small shapes {f.name}: {check_small_shapes(f, rng, dev)} "
              "kernel calls word-equal to their plain versions", flush=True)

    # --- the main path: counts from a run of the 2^18 ramp transform ------
    f, n = BLS12_381_FR, 1 << 18
    x = ramp_mont(f, n, device=dev)
    torch.cuda.synchronize()
    _build.launches.clear()
    y = ntt(x, f, mont_io=True, device=dev)
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    print(f"main path bls12-381-fr 2^18 launches: {counts}")
    want_counts = {"base_ntt_mxu": 1, "fused_level_stack": 2,
                   "fused_subntt": 1}
    if counts != want_counts:
        raise AssertionError(f"launch counts {counts} != {want_counts}")
    ramp = np.zeros((8, n), dtype=np.uint32)
    ramp[0] = np.arange(n, dtype=np.uint32)
    verify(f, y, ramp)
    transform_ms = time_ms(lambda: run(x, aux))
    print(f"path bls12-381-fr 2^18 ramp    golden-equal  "
          f"{transform_ms:.4f} ms/transform (tables resident)", flush=True)

    runs = [(BLS12_381_FR, 18), (BN254_FR, 18), (BLS12_381_FR, 14),
            (BLS12_381_FR, 20)]
    path_ms = {"bls12-381-fr 2^18 ramp": transform_ms}
    for f, log_n in runs:
        n = 1 << log_n
        xs = random_words(f, (n,), rng)
        xm = limbs.to_mont(torch.from_numpy(xs).to(dev), f)
        y = ntt(xm, f, mont_io=True, device=dev)
        verify(f, y, xs)
        r, a = get_runner(f, n, device=dev)
        ms = time_ms(lambda: r(xm, a))
        path_ms[f"{f.name} 2^{log_n} random"] = ms
        print(f"path {f.name} 2^{log_n} random  golden-equal  {ms:.4f} "
              f"ms/transform (tables resident)", flush=True)

    sources = {"base_ntt_mxu": ("ntt_tpu_torch/csrc/mxu_ntt.cu",
                                "ntt_tpu/kernels/mxu_ntt.py:128"),
               "fused_level_stack": ("ntt_tpu_torch/csrc/mxu_level.cu",
                                     "ntt_tpu/kernels/mxu_level.py:410"),
               "fused_subntt": ("ntt_tpu_torch/csrc/mxu_level.cu",
                                "ntt_tpu/kernels/mxu_level.py:144")}
    kernels = []
    for name, (src, replaces) in sources.items():
        path = results[name]["path"]
        t_bytes = sum(c["bytes"] for c in path) / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * sum(c["int8_macs"] for c in path) / INT8_OPS_PER_S * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": max(c["max_abs_err"]
                               for c in results[name]["calls"]),
            "ms": sum(c["ms"] for c in path),
            "plain_ms": sum(c["plain_ms"] for c in path),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": sum(c["library_ms"] for c in path),
            "library_call": "torch._int_mm on the same int8 digit operands "
                            "(the matmul part only; a stack level times one "
                            "entry over all columns)",
            "calls": results[name]["calls"]})
    print(json.dumps({"path_ms": path_ms,
                      "seconds": round(time.time() - t_start, 1)}))
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

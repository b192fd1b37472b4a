#!/usr/bin/env python3
"""Where the time of the tensor-core levels K1-K4 goes, on one NVIDIA GPU.

Run from the repository root: ``python3 tc_knockout.py``. It builds variants
of the ``mxu_level`` library (``ntt_tpu_torch/csrc``) with one or more phases
of the tensor-core block compiled out, and reads each variant's device time
(``torch.profiler``) at the main path's shapes: K2 level 0 of the
BLS12-381 Fr 2^18 transform ([8,32,8192], a stack of 32 matrices, rep
256), K3 level 1 ([8,32,8192], the merged table, rep 1), K1 the last base
([8,8,32768]), K4 [8,32,8192] with T3 and the transposed store, K4
[8,8,32768]. The phases: ``stage`` (the digit tile), ``aload`` (the
conv-matrix rows: TMA ring or the whole chunk), ``mma`` (the wgmma steps),
``epi`` (reduce, T3, store). A variant's outputs are wrong by
construction; only its time is read. ``skeleton`` keeps none of the four:
launch, loop and Z tile. Prints one line a variant and last a JSON object
of all the times (ms). Needs a CUDA device; imports neither JAX nor
``ntt_tpu``.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

PHASES = {
    "stage": ["stage_digits<W>(L, b0, lo, hi, dig);"],
    "aload": [
        "for (int t = 0; t < STAGES && t < steps; ++t) issue(t);",
        "if (threadIdx.x == 0 && t >= 1 && t - 1 + STAGES < steps) issue(t - 1 + STAGES);",
        "if (L.tma) mbar_wait(&full[t % STAGES], (t / STAGES) & 1);",
        "if (!L.tma) load_chunk<W>(L.A + (s_lo + e) * L.a_stride, L.m, kt, k0, "
        "stage_bytes, rows);"],
    "mma": ["wgmma_s8(acc, desc(dig + kb * (N * BK) + mh * NM * BK), "
            "desc(stage + nh * NR * BK), t > 0);"],
    "epi": ["tc_epilogue<W>(L, b0, k0, smem);"],
}
VARIANTS = {"base": [], "no_stage": ["stage"], "no_aload": ["aload"],
            "no_mma": ["mma"], "no_epi": ["epi"]}
VARIANTS.update({f"only_{p}": [q for q in PHASES if q != p] for p in PHASES})
VARIANTS["skeleton"] = list(PHASES)


def guarded(src: str, macro: str, stmts) -> str:
    """Each statement under ``#ifndef macro`` (an empty statement else)."""
    for stmt in stmts:
        if stmt not in src:
            raise RuntimeError(f"tc_knockout: source changed, not found: {stmt}")
        src = src.replace(stmt, f"\n#ifndef {macro}\n{stmt}\n#else\n;\n#endif\n")
    return src


def build(work: str) -> dict:
    from ntt_tpu_torch.kernels import _build
    core = open(os.path.join(_build.CSRC, "mxu_core.cuh")).read()
    level = open(os.path.join(_build.CSRC, "mxu_level.cu")).read()
    for phase, stmts in PHASES.items():
        macro = f"NO_{phase.upper()}"
        if phase == "epi":
            level = guarded(level, macro, stmts)
        else:
            core = guarded(core, macro, stmts)
    with open(os.path.join(work, "mxu_core.cuh"), "w") as f:
        f.write(core)
    with open(os.path.join(work, "mxu_level.cu"), "w") as f:
        f.write(level)
    procs = {}
    for name, off in VARIANTS.items():
        flags = [f"-DNO_{p.upper()}" for p in off]
        out = os.path.join(work, f"lib_{name}.so")
        procs[name] = (out, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", out,
             os.path.join(work, "mxu_level.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{log}")
        libs[name] = out
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("tc_knockout: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from ntt_tpu_torch import BLS12_381_FR as f
    from ntt_tpu_torch.kernels import mxu_level, mxu_ntt

    print(f"card: {cs.card_line()}", flush=True)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(cs.SEED)
    x = torch.from_numpy(cs.random_words(f, (32, 8192), rng)).to(dev)
    T = torch.from_numpy(cs.random_words(f, (32, 8192), rng)).to(dev)
    x8 = torch.from_numpy(cs.random_words(f, (8, 32768), rng)).to(dev)
    As = torch.from_numpy(rng.integers(0, 128, size=(32, 37 * 32, 37 * 32),
                                       dtype=np.int8)).to(dev)
    mats = cs.sub_mats_on(f, {8, 32}, False, dev)
    sub = {32: mats[32]}
    calls = {
        "K2 level 0 [8,32,8192] stack 32 rep 256": (
            lambda: mxu_level.fused_level_stack(x, f, As, 256),
            "fused_level_stack_kernel<"),
        "K3 level 1 [8,32,8192] TwBatch rep 1": (
            lambda: mxu_level.fused_subntt(x, f, sub, T, rep=1),
            "fused_subntt_kernel<"),
        "K1 base [8,8,32768]": (
            lambda: mxu_ntt.base_ntt_mxu(x8, f, mats[8]),
            "base_ntt_mxu_kernel<"),
        "K4 [8,32,8192] T3, transposed store": (
            lambda: mxu_level.fused_level(x, f, mats[32], T, True),
            "fused_level_kernel<"),
        "K4 [8,8,32768] no T3, direct store": (
            lambda: mxu_level.fused_level(x8, f, mats[8], None, False),
            "fused_level_kernel<"),
    }
    built = mxu_level._lib()
    print("variant     device ms: " + " | ".join(calls), flush=True)
    times = {}
    from ntt_tpu_torch.kernels import _build
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as work:
        for name, path in build(work).items():
            lib = ctypes.CDLL(path)
            for fn in ("mxu_fused_level_stack", "mxu_fused_level",
                       "mxu_fused_subntt", "mxu_base_ntt"):
                getattr(lib, fn).argtypes = getattr(built, fn).argtypes
                getattr(lib, fn).restype = ctypes.c_int
            mxu_level._lib = lambda lib=lib: lib
            times[name] = {what: cs.kernel_device_ms(fn, key, iters=20)
                           for what, (fn, key) in calls.items()}
            print(f"{name:11s} " + "  ".join(
                "-" if ms is None else f"{ms:.4f}"
                for ms in times[name].values()), flush=True)
    print(json.dumps({"device_ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

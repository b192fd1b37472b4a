#!/usr/bin/env python3
"""Where the time of the tensor-core kernels goes, on one NVIDIA GPU.

Run from the repository root: ``python3 tc_knockout.py``. It builds variants
of the ``mxu_level`` and ``mxu_sub`` libraries (``ntt_tpu_torch/csrc``) with
one or more phases of the tensor-core block compiled out, and reads each
variant's device time (``torch.profiler``) at the main path's shapes: K2
level 0 of the BLS12-381 Fr 2^18 transform ([8,32,8192], a stack of 32
matrices, rep 256), K3 level 1 ([8,32,8192], the merged table, rep 1), K1
the last base ([8,8,32768]), K4 [8,32,8192] with T3 and the transposed
store, K4 [8,8,32768], and the multi-level K3 of the Goldilocks 2^18
transform ([2,512,512], rep 1: both levels, each with its own phases). The
phases: ``stage`` (the digit tile), ``aload`` (the conv-matrix rows: TMA
ring or the whole chunk), ``mma`` (the wgmma steps), ``epi`` (reduce, the
twiddles, the store; for the multi-level K3 also level A's result tile). A
variant's outputs are wrong by construction; only its time is read.
``skeleton`` keeps none of the four: launch, loop and Z tile. Prints one
line a variant and last a JSON object of all the times (ms). Needs a CUDA
device; imports neither JAX nor ``ntt_tpu``.
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

#: phase -> {source: the statements compiled out with it}
PHASES = {
    "stage": {"mxu_core.cuh": ["stage_cols(lo, hi, dig);"]},
    "aload": {"mxu_core.cuh": [
        "for (int t = 0; t < STAGES && t < steps; ++t) issue(t);",
        "if (threadIdx.x == 0 && t >= 1 && t - 1 + STAGES < steps) issue(t - 1 + STAGES);",
        "if (L.tma) mbar_wait(&full[t % STAGES], (t / STAGES) & 1);",
        "if (!L.tma) load_chunk<W>(L.A + (s_lo + e) * L.a_stride, L.m, kt, k0, "
        "stage_bytes, rows);"]},
    "mma": {"mxu_core.cuh": [
        "wgmma_s8(acc, desc(dig + kb * (N * BK) + mh * NM * BK), "
        "desc(stage + nh * NR * BK), t > 0);"]},
    "epi": {"mxu_level.cu": ["tc_epilogue<W>(L, b0, k0, smem, stage);"],
            "mxu_sub.cu": ["epilogue_a<W>(S, k0, smem, Y);",
                           "epilogue_b<W>(S, b0, k0, u0, k2, smem);"]},
}
VARIANTS = {"base": [], "no_stage": ["stage"], "no_aload": ["aload"],
            "no_mma": ["mma"], "no_epi": ["epi"]}
VARIANTS.update({f"only_{p}": [q for q in PHASES if q != p] for p in PHASES})
VARIANTS["skeleton"] = list(PHASES)
#: the libraries a variant builds, by their source
LIBS = {"mxu_level": "mxu_level.cu", "mxu_sub": "mxu_sub.cu"}


def guarded(src: str, macro: str, stmts) -> str:
    """Each statement under ``#ifndef macro`` (an empty statement else)."""
    for stmt in stmts:
        if stmt not in src:
            raise RuntimeError(f"tc_knockout: source changed, not found: {stmt}")
        src = src.replace(stmt, f"\n#ifndef {macro}\n{stmt}\n#else\n;\n#endif\n")
    return src


def build(work: str) -> dict:
    """{variant: {library: path}}, every variant of both libraries compiled
    at once."""
    from ntt_tpu_torch.kernels import _build
    srcs = {name: open(os.path.join(_build.CSRC, name)).read()
            for name in ("mxu_core.cuh", *LIBS.values())}
    for phase, where in PHASES.items():
        for name, stmts in where.items():
            srcs[name] = guarded(srcs[name], f"NO_{phase.upper()}", stmts)
    for name, src in srcs.items():
        with open(os.path.join(work, name), "w") as f:
            f.write(src)
    procs = []
    for variant, off in VARIANTS.items():
        flags = [f"-DNO_{p.upper()}" for p in off]
        for lib, src in LIBS.items():
            out = os.path.join(work, f"lib{lib}_{variant}.so")
            procs.append((variant, lib, out, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", out,
                 os.path.join(work, src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for variant, lib, out, proc in procs:
        log, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"{variant} {lib}: nvcc exit {proc.returncode}"
                               f"\n{log}")
        libs.setdefault(variant, {})[lib] = out
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("tc_knockout: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from ntt_tpu_torch import BLS12_381_FR as f
    from ntt_tpu_torch import GOLDILOCKS
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
    xg = torch.from_numpy(cs.random_words(GOLDILOCKS, (512, 512), rng)).to(dev)
    Tg = torch.from_numpy(cs.random_words(GOLDILOCKS, (512, 512), rng)).to(dev)
    gmats = cs.sub_mats_on(GOLDILOCKS, {32, 16}, False, dev)
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
        "K3 multi [2,512,512] rep 1": (
            lambda: mxu_level.fused_subntt(xg, GOLDILOCKS, gmats, Tg, rep=1),
            "fused_subntt_multi_kernel<"),
    }
    built = {"mxu_level": mxu_level._lib(), "mxu_sub": mxu_level._lib_sub()}
    entries = {"mxu_level": ("mxu_fused_level_stack", "mxu_fused_level",
                             "mxu_fused_subntt", "mxu_base_ntt"),
               "mxu_sub": ("mxu_fused_subntt_multi",)}
    print("variant     device ms: " + " | ".join(calls), flush=True)
    times = {}
    from ntt_tpu_torch.kernels import _build
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as work:
        for name, paths in build(work).items():
            libs = {}
            for which, path in paths.items():
                lib = libs[which] = ctypes.CDLL(path)
                for fn in entries[which]:
                    getattr(lib, fn).argtypes = getattr(built[which],
                                                        fn).argtypes
                    getattr(lib, fn).restype = ctypes.c_int
            mxu_level._lib = lambda lib=libs["mxu_level"]: lib
            mxu_level._lib_sub = lambda lib=libs["mxu_sub"]: lib
            times[name] = {what: cs.kernel_device_ms(fn, key, iters=20)
                           for what, (fn, key) in calls.items()}
            print(f"{name:11s} " + "  ".join(
                "-" if ms is None else f"{ms:.4f}"
                for ms in times[name].values()), flush=True)
    print(json.dumps({"device_ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

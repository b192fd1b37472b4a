#!/usr/bin/env python3
"""Where the time of the butterfly-ladder kernels K5 and K6 goes, on one
NVIDIA GPU.

Run from the root of a checkout: ``python3 ladder_knockout.py``. It builds
variants of the ``vmem_ntt`` library (``ntt_tpu_torch/csrc/vmem_ntt.cu``)
with one phase of the kernel compiled out (or replaced by a cheap stand-in
that keeps the data flowing), and reads each variant's device time
(``torch.profiler``) at the shapes the transforms give the kernels: the
BLS12-381 Fr 2^18 ``pallas`` / ``pallas_fused`` levels [8,64,4096] and the
Goldilocks 2^20 levels [2,256,4096], [2,128,8192], [2,64,16384]; K5
(``stage_ntt``) and K6 (``fused_stage_level`` with T3 and the transposed
store) at each, and K6 without T3, direct store, at [8,64,4096].

The phases:

- ``load``: the load of the input tile (bit reversal folded in);
- ``twiddle``: the reads of the stage twiddles;
- ``mont``: the ladder's Montgomery products (the stage twiddles);
- ``addsub``: the butterflies' modular add and subtract, and the barriers
  or exchanges between stages;
- ``epi``: K6's T3 product and the store of the result.

``skeleton`` keeps none of them. A variant's outputs are wrong by
construction; only its time is read. The script knows the statements of
two versions of the kernel, the earlier one-stage-per-round-trip kernel
and the register-pass kernel that replaced it, and patches whichever it
finds, so it also measures the earlier kernel when it is copied into a
checkout that has it.

It also prints, from ``-Xptxas=-v``, each instantiation's registers and
spills, and from ``cuobjdump -sass`` of every variant the instruction
count (all, and the IMAD family) of the W = 8 kernels: the difference
between ``base`` and ``no_mont`` is the cost of the ladder's products.
Last a JSON object of all the times (ms) and counts. Needs a CUDA device;
imports neither JAX nor ``ntt_tpu``.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

#: version -> phase -> [(statement, its stand-in)]
PHASES = {
    "one stage a round trip": {
        "load": [(
            "tile[q * plane + r * rs + bl] = b < S.B ? "
            "S.x[((long long)q * m + i) * S.B + b] : 0u;", ";")],
        "twiddle": [(
            "for (int q = 0; q < W; ++q) t[q] = __ldg(S.tw + q * half + "
            "pos * step);",
            "for (int q = 0; q < W; ++q) t[q] = S.fc.p[q] ^ (uint32_t)pos;")],
        "mont": [(
            "mxu::mont_mul<W>(b, t, S.fc, r);",
            "for (int q = 0; q < W; ++q) r[q] = b[q] ^ t[q];")],
        "addsub": [
            ("add_mod<W>(a, b, S.fc, lo);",
             "for (int q = 0; q < W; ++q) lo[q] = a[q] + b[q];"),
            ("sub_mod<W>(a, b, S.fc, hi);",
             "for (int q = 0; q < W; ++q) hi[q] = a[q] - b[q];"),
            ("    }\n    __syncthreads();\n  }\n", "    }\n  }\n")],
        "epi": [(
            "  // epilogue: the twiddle product where T3 reads are coalesced "
            "over columns",
            "  return;")],
    },
    "register passes": {
        "load": [(
            "for (int q = 0; q < W; ++q) v[j][q] = in ? __ldg(S.x + "
            "((long long)q * m + i) * S.B + b) : 0u;",
            "for (int q = 0; q < W; ++q) v[j][q] = (uint32_t)(b + i) ^ q;")],
        "twiddle": [(
            "load_words<W>(tws + (pos << sh) * W, w);",
            "for (int q = 0; q < W; ++q) w[q] = fc.p[q] ^ (uint32_t)pos;")],
        "mont": [(
            "mxu::mont_mul<W>(v[j | (1 << u)], w, fc, r);",
            "for (int q = 0; q < W; ++q) r[q] = v[j | (1 << u)][q] ^ w[q];")],
        "addsub": [
            ("add_mod<W>(a, b, fc, lo);",
             "for (int q = 0; q < W; ++q) lo[q] = a[q] + b[q];"),
            ("sub_mod<W>(a, b, fc, hi);",
             "for (int q = 0; q < W; ++q) hi[q] = a[q] - b[q];"),
            ("exchange<W, R>(v, tile + bl, plane, rs, base, s0, base1, s1);",
             ";")],
        "epi": [
            ("for (int q = 0; q < W; ++q) t3[j][q] = in ? __ldg(S.T3 + "
             "((long long)q * m + k) * S.B + b) : 0u;",
             "for (int q = 0; q < W; ++q) t3[j][q] = S.fc.p[q] ^ (uint32_t)k;"),
            ("mxu::mont_mul<W>(v[j], t3[j], S.fc, r);",
             "for (int q = 0; q < W; ++q) r[q] = v[j][q] ^ t3[j][q];"),
            ("      if (in) {", "      if (in && S.B < 0) {"),
            ("for (int idx = threadIdx.x; idx < cols * m; "
             "idx += blockDim.x) {",
             "for (int idx = threadIdx.x; idx < cols * m && S.B < 0; "
             "idx += blockDim.x) {")],
    },
}
VARIANTS = {"base": [], "no_load": ["load"], "no_twiddle": ["twiddle"],
            "no_mont": ["mont"], "no_addsub": ["addsub"], "no_epi": ["epi"],
            "skeleton": ["load", "twiddle", "mont", "addsub", "epi"]}


def patched(src: str) -> tuple:
    """(version, source with every phase's statements under its macro)."""
    for version, phases in PHASES.items():
        if all(stmt in src for subs in phases.values() for stmt, _ in subs):
            for phase, subs in phases.items():
                macro = f"NO_{phase.upper()}"
                for stmt, stand_in in subs:
                    src = src.replace(stmt, f"\n#ifndef {macro}\n{stmt}\n"
                                      f"#else\n{stand_in}\n#endif\n")
            return version, src
    raise RuntimeError("ladder_knockout: vmem_ntt.cu matches no known "
                       "version of the kernel")


def build(work: str) -> tuple:
    """(version, {variant: library path}, {variant: ptxas log}), every
    variant compiled at once."""
    from ntt_tpu_torch.kernels import _build
    with open(os.path.join(_build.CSRC, "vmem_ntt.cu")) as f:
        version, src = patched(f.read())
    with open(os.path.join(work, "vmem_ntt.cu"), "w") as f:
        f.write(src)
    for name in _build._HEADERS:
        shutil.copy(os.path.join(_build.CSRC, name), work)
    procs = []
    for variant, off in VARIANTS.items():
        out = os.path.join(work, f"libvmem_ntt_{variant}.so")
        procs.append((variant, out, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS,
             *[f"-DNO_{p.upper()}" for p in off], "-o", out,
             os.path.join(work, "vmem_ntt.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs, logs = {}, {}
    for variant, out, proc in procs:
        logs[variant], _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"{variant}: nvcc exit {proc.returncode}\n"
                               f"{logs[variant]}")
        libs[variant] = out
    return version, libs, logs


def sass_counts(path: str) -> dict:
    """{kernel function: (instructions, IMAD-family instructions)} of the
    W = 8 instantiations in the library at ``path``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", path], check=True,
                         capture_output=True, text=True, timeout=300).stdout
    counts = {}
    for part in out.split("Function : ")[1:]:
        name = part.split()[0]
        if "ILi8E" not in name:     # W = 8 (and any R)
            continue
        ins = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                         part)
        counts[name] = (len(ins), sum(1 for i in ins if i.startswith("IMAD")))
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("ladder_knockout: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from ntt_tpu_torch import BLS12_381_FR, GOLDILOCKS
    from ntt_tpu_torch.kernels import _build, vmem_ntt

    print(f"card: {cs.card_line()}", flush=True)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(cs.SEED)
    calls = {}
    for f, m, B in ((BLS12_381_FR, 64, 4096), (GOLDILOCKS, 256, 4096),
                    (GOLDILOCKS, 128, 8192), (GOLDILOCKS, 64, 16384)):
        x = torch.from_numpy(cs.random_words(f, (m, B), rng)).to(dev)
        T = torch.from_numpy(cs.random_words(f, (m, B), rng)).to(dev)
        shape = f"[{f.n_words},{m},{B}]"
        calls[f"K5 {shape}"] = (
            lambda x=x, f=f: vmem_ntt.stage_ntt(x, f), "stage_ntt_kernel<")
        calls[f"K6 {shape} T3, transposed"] = (
            lambda x=x, T=T, f=f: vmem_ntt.fused_stage_level(x, f, False, T,
                                                             True),
            "fused_stage_level_kernel<")
        if f is BLS12_381_FR:
            calls[f"K6 {shape} direct"] = (
                lambda x=x, f=f: vmem_ntt.fused_stage_level(x, f, False,
                                                            None, False),
                "fused_stage_level_kernel<")
    built = vmem_ntt._lib()
    entries = ("vmem_stage_ntt", "vmem_fused_stage_level")
    times, sass = {}, {}
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as work:
        version, libs, logs = build(work)
        print(f"kernel version: {version}", flush=True)
        for line in logs["base"].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas base: {line.strip()}", flush=True)
        print("variant     device ms: " + " | ".join(calls), flush=True)
        for name, path in libs.items():
            lib = ctypes.CDLL(path)
            for fn in entries:
                getattr(lib, fn).argtypes = getattr(built, fn).argtypes
                getattr(lib, fn).restype = ctypes.c_int
            vmem_ntt._lib = lambda lib=lib: lib
            times[name] = {what: cs.kernel_device_ms(fn, key, iters=20)
                           for what, (fn, key) in calls.items()}
            sass[name] = sass_counts(path)
            print(f"{name:11s} " + "  ".join(
                "-" if ms is None else f"{ms:.4f}"
                for ms in times[name].values()), flush=True)
        for name, counts in sass.items():
            for fn, (n, imad) in sorted(counts.items()):
                print(f"sass {name:11s} {fn}: {n} instructions, {imad} IMAD*",
                      flush=True)
    print(json.dumps({"version": version, "device_ms": times,
                      "sass_w8": {v: {k: list(c) for k, c in s.items()}
                                  for v, s in sass.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where the time of the tensor-core kernels goes, on one NVIDIA GPU.

Run from the repository root: ``python3 tc_knockout.py``. It builds variants
of the ``mxu_level`` and ``mxu_sub`` libraries (``ntt_tpu_torch/csrc``) with
one or more phases of the tensor-core block compiled out, and reads each
variant's device time (``torch.profiler``) at the main path's shapes: K2
level 0 of the BLS12-381 Fr 2^18 transform ([8,32,8192], a stack of 32
matrices, rep 256), K3 level 1 ([8,32,8192], the merged table, rep 1), K1
the last base ([8,8,32768]), K4 [8,32,8192] with T3 and the transposed
store, K4 [8,8,32768], the multi-level K3 of the Goldilocks 2^18
transform ([2,512,512], rep 1: both levels, each with its own phases), and
K1's short form at the last bases of 2^22 ([8,4,2^20]) and 2^23
([8,2,2^22]). The phases: ``stage`` (the digit tile), ``aload`` (the
conv-matrix rows: TMA ring or the whole chunk; the short form's matrix,
staged once a block), ``mma`` (the wgmma steps), ``epi`` (reduce, the
twiddles, the store; for the multi-level K3 also level A's result tile).
A variant's outputs are wrong by construction; only its time is read.
``skeleton`` keeps none of the four: launch, loop and Z tile. Prints one
line a variant and last a JSON object of all the times (ms). Needs a CUDA
device; imports neither JAX nor ``ntt_tpu``.

``python3 tc_knockout.py --parent DIR`` compares instead the ``mxu_level``
library built from the checkout at DIR (another commit of this
repository, unpacked with ``git archive``) with this one's, in one
process, in the order parent, change, change, parent: each library's
device time for K1 at [8,8,32768], [8,4,2^20], [8,2,2^22] and
[8,2,2^25] and for K2, K3 and K4 at the BLS12-381 Fr 2^18 shapes, every
output word-equal between the two. K1 runs the plan each tree gives it:
DIR's is ``tc_plan``'s at every m (the plan of the kernels other than
K1, which both trees share). Then K1's short form at [8,4,2^20] and
[8,2,2^25] under other spans of tiles a block beside the plan's own (one
wave of two blocks an SM): one tile a block, one block an SM, and two
waves. Prints one line a measurement and last a JSON object of them.
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
    "stage": {"mxu_core.cuh": ["stage_cols(lo, hi, h, dig);"],
              "mxu_level.cu": ["short_digits<W>(L, b0, dig);"]},
    "aload": {"mxu_level.cu": ["short_matrix<W>(L.A, m, L.k_pad, mat);"],
              "mxu_core.cuh": [
        "for (int t = 0; t < STAGES && t < steps; ++t) issue(t);",
        "if (threadIdx.x == 0 && t >= 1 && t - 1 + STAGES < steps) issue(t - 1 + STAGES);",
        "if (L.tma) mbar_wait(&full[t % STAGES], (t / STAGES) & 1);",
        "if (!L.tma) load_chunk<W>(L.A + (s_lo + e) * L.a_stride, L.m, kt, k0, "
        "stage_bytes, rows);"]},
    "mma": {"mxu_core.cuh": [
        "wgmma_s8(acc, desc(dig + kb * (N * BK) + mh * NM * BK), "
        "desc(stage + nh * NR * BK), t > 0);"],
            "mxu_level.cu": [
        "wgmma_s8(acc, desc(dig + kb * (N * BK) + g * NM * BK), "
        "desc(mat + kb * (NR * BK)), kb > 0);"]},
    "epi": {"mxu_level.cu": ["tc_epilogue<W>(L, b0, k0, smem, stage);",
                             "short_epilogue<W>(L, b0, Z);"],
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


def build_parent(parent: str, work: str) -> str:
    """The ``mxu_level`` library of the checkout at ``parent``, built into
    ``work``."""
    from ntt_tpu_torch.kernels import _build
    out = os.path.join(work, "libmxu_level_parent.so")
    src = os.path.join(parent, "ntt_tpu_torch", "csrc", LIBS["mxu_level"])
    p = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, src],
                       capture_output=True, text=True, timeout=900)
    if p.returncode != 0:
        raise RuntimeError(f"parent mxu_level: nvcc exit {p.returncode}\n"
                           f"{p.stdout}{p.stderr}")
    return out


def parent_against_change(parent: str) -> int:
    """``--parent DIR``: the two trees' ``mxu_level`` libraries in turn
    (parent, change, change, parent), then K1's short form under other
    spans."""
    import chip_smoke as cs
    from ntt_tpu_torch import BLS12_381_FR as f
    from ntt_tpu_torch.kernels import _build, mxu_level, mxu_ntt

    print(f"card: {cs.card_line()}", flush=True)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(cs.SEED)
    mats = cs.sub_mats_on(f, {2, 4, 8, 32}, False, dev)
    x = torch.from_numpy(cs.random_words(f, (32, 8192), rng)).to(dev)
    T = torch.from_numpy(cs.random_words(f, (32, 8192), rng)).to(dev)
    As = torch.from_numpy(rng.integers(0, 128, size=(32, 37 * 32, 37 * 32),
                                       dtype=np.int8)).to(dev)
    sub = {32: mats[32]}
    xs = {(8, 32768): cs.random_on_card(f, (8, 32768), dev),
          (4, 1 << 20): cs.random_on_card(f, (4, 1 << 20), dev),
          (2, 1 << 22): cs.random_on_card(f, (2, 1 << 22), dev),
          (2, 1 << 25): cs.random_on_card(f, (2, 1 << 25), dev)}

    def k1(m, B):
        return lambda: mxu_ntt.base_ntt_mxu(xs[m, B], f, mats[m])
    calls = {f"K1 base [8,{m},{B}]": (k1(m, B), "base_ntt_mxu_")
             for m, B in xs}
    calls.update({
        "K2 level 0 [8,32,8192] stack 32 rep 256": (
            lambda: mxu_level.fused_level_stack(x, f, As, 256),
            "fused_level_stack_kernel<"),
        "K3 level 1 [8,32,8192] TwBatch rep 1": (
            lambda: mxu_level.fused_subntt(x, f, sub, T, rep=1),
            "fused_subntt_kernel<"),
        "K4 [8,32,8192] T3, transposed store": (
            lambda: mxu_level.fused_level(x, f, mats[32], T, True),
            "fused_level_kernel<"),
        "K4 [8,8,32768] no T3, direct store": (
            lambda: mxu_level.fused_level(xs[8, 32768], f, mats[8], None,
                                          False),
            "fused_level_kernel<")})
    change = mxu_level._lib()
    own_plan = mxu_level.base_plan_args
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    times, outs = {}, {}
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as work:
        old = ctypes.CDLL(build_parent(parent, work))
        for fn in ("mxu_fused_level_stack", "mxu_fused_level",
                   "mxu_fused_subntt", "mxu_base_ntt"):
            getattr(old, fn).argtypes = getattr(change, fn).argtypes
            getattr(old, fn).restype = ctypes.c_int
        for turn, which in enumerate(("parent", "change", "change",
                                      "parent")):
            lib = old if which == "parent" else change
            mxu_level._lib = lambda lib=lib: lib
            mxu_level.base_plan_args = (
                own_plan if which == "change" else
                lambda fl, m, B, sms=None: mxu_level.plan_args(fl, m, B))
            got = {}
            for what, (fn, key) in calls.items():
                y = fn()
                torch.cuda.synchronize()
                if what in outs and not torch.equal(y, outs[what]):
                    raise AssertionError(f"{what}: parent and change differ")
                outs.setdefault(what, y)
                del y
                got[what] = cs.kernel_device_ms(fn, key, iters=10)
                print(f"{which:6s} {what:40s} device "
                      f"{'-' if got[what] is None else f'{got[what]:.4f}'}"
                      " ms", flush=True)
            times[f"{turn} {which}"] = got
    mxu_level._lib = lambda: change
    mxu_level.base_plan_args = own_plan
    outs.clear()
    # the short form under other spans: one tile a block (the matrix
    # staged for every tile), one block an SM (nothing runs under a
    # block's epilogue but its own loads in flight), two waves of two
    # blocks an SM, and the plan's one wave of two
    sms = _build.sm_count(dev)
    spans = {}
    for m, B in ((4, 1 << 20), (2, 1 << 25)):
        plan = mxu_level.base_plan(f, m, B, sms)
        tiles = plan.col_tiles
        for label, span in (("one tile a block", 1),
                            ("one block an SM", -(-tiles // sms)),
                            ("two waves", -(-tiles // (4 * sms))),
                            ("one wave (the plan)", plan.span)):
            blocks = -(-tiles // span)
            mxu_level.base_plan_args = (
                lambda fl, mm, BB, s=None, blocks=blocks, plan=plan:
                (plan.kt, plan.k_pad, plan.m_pad, blocks, plan.smem_bytes))
            fn = k1(m, B)
            ms = cs.kernel_device_ms(fn, "base_ntt_mxu_", iters=10)
            spans[f"K1 [8,{m},{B}] {label}: {blocks} blocks of {span} "
                  "tiles"] = ms
            print(f"span   K1 [8,{m},{B}] {label:20s} {blocks:7d} blocks of "
                  f"{span:5d} tiles: device "
                  f"{'-' if ms is None else f'{ms:.4f}'} ms", flush=True)
        mxu_level.base_plan_args = own_plan
    print(json.dumps({"device_ms": times, "spans": spans}))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("tc_knockout: no CUDA device", file=sys.stderr)
        return 1
    if "--parent" in sys.argv[1:]:
        return parent_against_change(sys.argv[sys.argv.index("--parent") + 1])
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
    mats = cs.sub_mats_on(f, {2, 4, 8, 32}, False, dev)
    sub = {32: mats[32]}
    x4 = cs.random_on_card(f, (4, 1 << 20), dev)
    x2 = cs.random_on_card(f, (2, 1 << 22), dev)
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
        "K1 short [8,4,2^20]": (
            lambda: mxu_ntt.base_ntt_mxu(x4, f, mats[4]),
            "base_ntt_mxu_short_kernel<"),
        "K1 short [8,2,2^22]": (
            lambda: mxu_ntt.base_ntt_mxu(x2, f, mats[2]),
            "base_ntt_mxu_short_kernel<"),
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

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

``python3 tc_knockout.py --sub`` does the same for the multi-level K3 alone
at the launches of the narrow fields' paths (``SUB_SHAPES``: the last bases
of Goldilocks 2^24, 2^25, 2^26, the levels of Goldilocks 2^24 and
small-proth 2^22, one launch of Goldilocks 2^18), in whichever form its
wrapper takes there, each level's phases apart (``SUB_PHASES``: the
matrices, the digit tile of each level, each level's wgmma steps, each
level's epilogue).

``python3 tc_knockout.py --parent DIR`` compares instead the ``mxu_level``
and ``mxu_sub`` libraries built from the checkout at DIR (another commit of
this repository, unpacked with ``git archive``) with this one's, in one
process, in the order parent, change, change, parent: each library's
device time for K1 at [8,8,32768], [8,4,2^20], [8,2,2^22] and
[8,2,2^25], for K2, K3 and K4 at the BLS12-381 Fr 2^18 shapes and for the
multi-level K3 at ``SUB_SHAPES``, every output word-equal between the
two, each under this tree's plans; the multi-level K3 runs DIR's
present form and this tree's choice of form. DIR's C entries must take
this tree's arguments (its wrappers call both libraries): since the
transposed store of K2 and K3, each takes a ``transpose`` flag after
``out``.
Then the wide form at its launches of m = 64 and 512 under other spans of
tiles a block beside the plan's (one wave): one tile a block, two waves;
and the launch that keeps the present form (Goldilocks 2^18, one wave of
its blocks) in both forms. Prints one line a measurement and last a JSON
object of them.
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

#: the multi-level K3's launches on the narrow fields' paths, which
#: ``--sub`` and ``--parent`` time: (label, field, m, B, rep; None for no
#: twiddle). The last bases of Goldilocks 2^24, 2^25, 2^26 (m = 64, 128,
#: 256 over 2^18 columns), the two levels of Goldilocks 2^24 and of
#: small-proth 2^22, and one launch of Goldilocks 2^18 (one wave of blocks)
SUB_SHAPES = (
    ("goldilocks 2^24 base", "goldilocks", 64, 1 << 18, None),
    ("goldilocks 2^24 level 0", "goldilocks", 512, 32768, 1),
    ("goldilocks 2^24 level 1", "goldilocks", 512, 32768, 512),
    ("goldilocks 2^25 base", "goldilocks", 128, 1 << 18, None),
    ("goldilocks 2^26 base", "goldilocks", 256, 1 << 18, None),
    ("small-proth 2^22 level 0", "small-proth", 512, 8192, 1),
    ("small-proth 2^22 level 1", "small-proth", 512, 8192, 512),
    ("goldilocks 2^18 level 0", "goldilocks", 512, 512, 1),
)
#: the wgmma step of tc::contract, which both levels of the present form run
_CORE_MMA = ("wgmma_s8(acc, desc(dig + kb * (N * BK) + mh * NM * BK), "
             "desc(stage + nh * NR * BK), t > 0);")
#: phase of the multi-level K3 -> {source: [(statement, condition)]}: in a
#: variant that knocks the phase out, the statement runs only where its
#: condition holds ("false": never). In the present form level A's
#: contraction is the one of m = 32 (the peel), level B's the one of m / 32
SUB_PHASES = {
    "aload": {"mxu_core.cuh": [(s, "false")
                               for s in PHASES["aload"]["mxu_core.cuh"]],
              "mxu_sub.cu": [("wide_matrices<W>(S, k0, a1, a2);", "false")]},
    "stage_a": {"mxu_sub.cu": [("tc::stage_tile<W>(PEEL, S.a.k_pad,", "false"),
                               ("tc::stage_tile<W>(PEEL, Gw::KA,", "false")]},
    "stage_b": {"mxu_sub.cu": [("tc::stage_tile<W>(S.m2, S.b.k_pad,", "false"),
                               ("wide_stage_b<W>(S, Y, dig);", "false")]},
    "mma_a": {"mxu_core.cuh": [(_CORE_MMA, "L.m != 32")],
              "mxu_sub.cu": [("wgmma_s8(acc, desc(dig + (kb * N + mh * NM) "
                              "* BK),", "false")]},
    "mma_b": {"mxu_core.cuh": [(_CORE_MMA, "L.m == 32")],
              "mxu_sub.cu": [("wgmma_s8(acc, desc(dig + (kb * cb + cg * NM) "
                              "* BK),", "false")]},
    "epi_a": {"mxu_sub.cu": [("epilogue_a<W>(S, k0, smem, Y);", "false"),
                             ("wide_epilogue_a<W>(S, k0, mh, ua, acc, Y);",
                              "false")]},
    "epi_b": {"mxu_sub.cu": [("epilogue_b<W>(S, b0, k0, u0, k2, smem);",
                              "false"),
                             ("wide_epilogue_b<W>(S, b0, k0, cg, ub, acc);",
                              "false")]},
}
#: the C entry points of the ``mxu_sub`` library
SUB_ENTRIES = ("mxu_fused_subntt_multi", "mxu_fused_subntt_wide")
SUB_VARIANTS = {"base": [], **{f"no_{p}": [p] for p in SUB_PHASES},
                "skeleton": list(SUB_PHASES)}


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


def build_sub(work: str) -> dict:
    """{variant: path} of the ``mxu_sub`` library with the phases of
    ``SUB_VARIANTS`` knocked out, each variant's sources in a directory
    of its own, every variant compiled at once."""
    from ntt_tpu_torch.kernels import _build
    base = {name: open(os.path.join(_build.CSRC, name)).read()
            for name in ("mxu_core.cuh", LIBS["mxu_sub"])}
    procs = []
    for variant, off in SUB_VARIANTS.items():
        srcs = dict(base)
        for phase in off:
            for name, stmts in SUB_PHASES[phase].items():
                for stmt, cond in stmts:
                    if stmt not in srcs[name]:
                        raise RuntimeError("tc_knockout: source changed, not "
                                           f"found: {stmt}")
                    srcs[name] = srcs[name].replace(stmt,
                                                    f"if ({cond}) {stmt}")
        where = os.path.join(work, variant)
        os.makedirs(where)
        for name, src in srcs.items():
            with open(os.path.join(where, name), "w") as f:
                f.write(src)
        out = os.path.join(where, "libmxu_sub.so")
        procs.append((variant, out, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", out,
             os.path.join(where, LIBS["mxu_sub"])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for variant, out, proc in procs:
        log, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"{variant} mxu_sub: nvcc exit "
                               f"{proc.returncode}\n{log}")
        libs[variant] = out
    return libs


def sub_calls(dev) -> dict:
    """{label: call} of the multi-level K3 through its wrapper at each of
    ``SUB_SHAPES``, on random canonical words drawn on the card."""
    import chip_smoke as cs
    from ntt_tpu_torch import get_field
    from ntt_tpu_torch.kernels import mxu_level

    calls = {}
    for label, name, m, B, rep in SUB_SHAPES:
        f = get_field(name)
        mats = cs.sub_mats_on(f, {32, m // 32}, False, dev)
        x = cs.random_on_card(f, (m, B), dev)
        T3 = None
        if rep is not None:
            T3 = cs.random_on_card(f, (m, B) if rep == 1 else (B // rep, m),
                                   dev)
        tw = "no twiddle" if rep is None else f"rep {rep}"
        calls[f"K3 multi {label} [{f.n_words},{m},{B}] {tw}"] = (
            lambda x=x, f=f, mats=mats, T3=T3, rep=rep:
            mxu_level.fused_subntt(x, f, False, mats, T3, rep=rep or 1))
    return calls


def sub_knockout() -> int:
    """``--sub``: the multi-level K3 at ``SUB_SHAPES`` under every
    variant of ``SUB_VARIANTS``."""
    import chip_smoke as cs
    from ntt_tpu_torch.kernels import _build, mxu_level

    print(f"card: {cs.card_line()}", flush=True)
    dev = torch.device("cuda", 0)
    calls = sub_calls(dev)
    built = mxu_level._lib_sub()
    print("variant     device ms: " + " | ".join(calls), flush=True)
    times = {}
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as work:
        for name, path in build_sub(work).items():
            lib = ctypes.CDLL(path)
            for fn in SUB_ENTRIES:
                getattr(lib, fn).argtypes = getattr(built, fn).argtypes
                getattr(lib, fn).restype = ctypes.c_int
            mxu_level._lib_sub = lambda lib=lib: lib
            times[name] = {what: cs.kernel_device_ms(fn, "fused_subntt_",
                                                     iters=10)
                           for what, fn in calls.items()}
            print(f"{name:11s} " + "  ".join(
                "-" if ms is None else f"{ms:.4f}"
                for ms in times[name].values()), flush=True)
    mxu_level._lib_sub = lambda: built
    print(json.dumps({"device_ms": times}))
    return 0


def build_parent(parent: str, work: str) -> dict:
    """{library: path} of the ``mxu_level`` and ``mxu_sub`` libraries of the
    checkout at ``parent``, built into ``work``, both at once."""
    from ntt_tpu_torch.kernels import _build
    procs = []
    for lib, src in LIBS.items():
        out = os.path.join(work, f"lib{lib}_parent.so")
        procs.append((lib, out, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", out,
             os.path.join(parent, "ntt_tpu_torch", "csrc", src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for lib, out, proc in procs:
        log, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"parent {lib}: nvcc exit {proc.returncode}\n"
                               f"{log}")
        libs[lib] = out
    return libs


def parent_against_change(parent: str) -> int:
    """``--parent DIR``: the two trees' ``mxu_level`` and ``mxu_sub``
    libraries in turn (parent, change, change, parent), then K1's short
    form under other spans."""
    import chip_smoke as cs
    from ntt_tpu_torch import BLS12_381_FR as f
    from ntt_tpu_torch import get_field
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
            lambda: mxu_level.fused_subntt(x, f, False, sub, T),
            "fused_subntt_kernel<"),
        "K4 [8,32,8192] T3, transposed store": (
            lambda: mxu_level.fused_level(x, f, mats[32], T, True),
            "fused_level_kernel<"),
        "K4 [8,8,32768] no T3, direct store": (
            lambda: mxu_level.fused_level(xs[8, 32768], f, mats[8], None,
                                          False),
            "fused_level_kernel<")})
    # the multi-level K3: the parent's present form, the change's form
    # (the wide one above one wave of blocks)
    calls.update({what: (fn, "fused_subntt_")
                  for what, fn in sub_calls(dev).items()})
    change = {"mxu_level": mxu_level._lib(), "mxu_sub": mxu_level._lib_sub()}
    entries = {"mxu_level": ("mxu_fused_level_stack", "mxu_fused_level",
                             "mxu_fused_subntt", "mxu_base_ntt"),
               "mxu_sub": ("mxu_fused_subntt_multi",)}
    own_wide = mxu_level.sub_wide
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    times, outs = {}, {}
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as work:
        old = {lib: ctypes.CDLL(path)
               for lib, path in build_parent(parent, work).items()}
        for lib, fns in entries.items():
            for fn in fns:
                getattr(old[lib], fn).argtypes = getattr(change[lib],
                                                         fn).argtypes
                getattr(old[lib], fn).restype = ctypes.c_int
        for turn, which in enumerate(("parent", "change", "change",
                                      "parent")):
            libs = old if which == "parent" else change
            mxu_level._lib = lambda lib=libs["mxu_level"]: lib
            mxu_level._lib_sub = lambda lib=libs["mxu_sub"]: lib
            mxu_level.sub_wide = (own_wide if which == "change" else
                                  lambda *a, **k: False)
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
    mxu_level._lib = lambda: change["mxu_level"]
    mxu_level._lib_sub = lambda: change["mxu_sub"]
    mxu_level.sub_wide = own_wide
    outs.clear()
    # the wide multi-level K3 under other spans: one tile a block (the
    # matrices staged for every tile, as the present form does), two waves
    # of blocks, and the plan's one wave
    sms = _build.sm_count(dev)
    spans = {}
    own_args = mxu_level.sub_wide_args
    for what, fn in sub_calls(dev).items():
        name, m, B = next((n, m, B) for lab, n, m, B, _ in SUB_SHAPES
                          if lab in what)
        fl = get_field(name)
        if not mxu_level.sub_wide(fl, m, B, sms) or m not in (64, 512):
            continue
        plan = mxu_level.sub_wide_plan(fl, m, B, sms)
        tiles = plan.col_tiles
        for label, span in (("one tile a block", 1),
                            ("two waves", -(-tiles // (sms // plan.chunks
                                                       * 2))),
                            ("one wave (the plan)", plan.span)):
            blocks = plan.chunks * -(-tiles // span)
            mxu_level.sub_wide_args = (
                lambda *a, p=plan, span=span, blocks=blocks:
                (p.kt, p.lb, p.ka_pad, p.kb_pad, span, blocks, p.smem_bytes))
            ms = cs.kernel_device_ms(fn, "fused_subntt_wide_kernel<",
                                     iters=10)
            spans[f"{what} {label}: {blocks} blocks of {span} tiles"] = ms
            print(f"span   {what} {label:20s} {blocks:7d} blocks of "
                  f"{span:5d} tiles: device "
                  f"{'-' if ms is None else f'{ms:.4f}'} ms", flush=True)
        mxu_level.sub_wide_args = own_args
    # the launches that keep the present form (one wave of its blocks), in
    # the wide form beside it
    for what, fn in sub_calls(dev).items():
        name, m, B = next((n, m, B) for lab, n, m, B, _ in SUB_SHAPES
                          if lab in what)
        if mxu_level.sub_wide(get_field(name), m, B, sms):
            continue
        ms = {}
        for form, wide in (("present", False), ("wide", True)):
            mxu_level.sub_wide = lambda *a, wide=wide, **k: wide
            ms[form] = cs.kernel_device_ms(fn, "fused_subntt_", iters=10)
        mxu_level.sub_wide = own_wide
        spans[f"{what} present form"], spans[f"{what} wide form"] = (
            ms["present"], ms["wide"])
        print(f"form   {what}: " + ", ".join(
            f"{form} {'-' if v is None else f'{v:.4f}'} ms"
            for form, v in ms.items()), flush=True)
    print(json.dumps({"device_ms": times, "spans": spans}))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("tc_knockout: no CUDA device", file=sys.stderr)
        return 1
    if "--sub" in sys.argv[1:]:
        return sub_knockout()
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
            lambda: mxu_level.fused_subntt(x, f, False, sub, T),
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
            lambda: mxu_level.fused_subntt(xg, GOLDILOCKS, False, gmats,
                                            Tg),
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

#!/usr/bin/env python3
"""Chip smoke test of ntt_tpu_torch on one NVIDIA GPU (written for an H100).

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
``--quick`` stops after the kernel checks at small shapes and K8 at its
main-path shape (a short first call after a kernel change) and prints no
result line. ``--passes`` runs only the elementwise pass kernels: at small
shapes on the four fields, then at the benchmark cells' shapes, timed (the
``pass`` lines and a ``{"passes": ...}`` JSON line). ``--cross-cards`` runs only the multi-device forward across
distinct cards (on a machine with two or more) and what it is compared
with, and prints no result line. ``--persist`` runs only the persistent
form of the 256-bit m = 32 level (``csrc/mxu_persist.cu``): at small shapes
on BLS12-381 Fr and BN254 Fr (in ``--quick`` and the full run too), then at
the cells' shapes (``check_persist``), word-equal to the present form and
the plain version and timed in both forms (the ``persist`` lines and a
``{"persist": ...}`` JSON line).

1. Prints the card (``nvidia-smi`` name and power limit) and builds the
   CUDA kernels from ``ntt_tpu_torch/csrc`` (one nvcc per source, in
   parallel); reads the SASS of the level and multi-level libraries
   (``cuobjdump -sass``): every instantiation of every digit-matmul kernel
   (K1 in both its forms, K2, K3 single- and multi-level, K4, K7) must
   hold int8 tensor-core instructions (IGMMA, the integer wgmma) and no
   IDP.4A.
2. Holds each kernel, word for word, against its plain PyTorch version on
   the card and times kernel, plain version and ``torch._int_mm`` on the
   same int8 operands (K1-K7 also by profiler device time, and
   ``torch._int_mm`` beside the tensor-core kernels K1-K4 and K7; a K5/K6
   line sets its device time beside its bound):
   - K1, K2, K3 (single-level) at the shapes the 2^18 BLS12-381 forward
     transform gives them, plus K3 at rep = 32 and K2 with a residual
     twiddle, and K3 at rep = 1024 and K1 at m = 4 and 16 at the full
     width of the 2^22 and 2^24 transforms; K1's short form (E * m <= 160)
     at [8,4,2^20] and [8,2,2^22] with ``torch._int_mm`` on the same
     digits, each held below it by device time (``target`` lines);
   - K2 with a periodic residual T3[W, 32, s0] (level 0 above 2^24): BLS
     NT = 2 rep 128, a ragged B (NT = 5 rep 64), small-proth NT = 4 rep
     128, and the level-0 launch of the BLS 2^26 transform at full width
     ([8,32,2^21], T3 [8,32,2^16]; three stack entries' columns against
     the plain version), timed beside its bound;
   - the device table generators (``power_matrix_chunked``,
     ``geometric_outer_chunked``, ``geometric_outer``) against the host
     tables at 2^20 entries;
   - the elementwise pass kernels (``kernels/passes.py``: the Montgomery
     product by a vector, by one element and by n^-1 with and without the
     coset table, sub, add, neg, the conversion to Montgomery form) at
     BLS12-381 Fr 2^22 and Goldilocks 2^24, one launch each, timed beside
     their bound and the plain version (the ``pass`` lines; at 2^10 on the
     four fields first, in ``--quick`` too);
   - K3 multi-level at the shapes of the narrow-field transforms:
     Goldilocks 2^18 and 2^24, small-proth 2^22, and at m = 1024 the small
     Proth prime's launches under NTT_MXU_SUBBASE_LOG=10 (2^20 and 2^22);
   - the transposed store (``transpose_out=True``) of K2, K3 single and
     K3 multi in both forms, timed beside the plain store at main-path
     shapes (``transposed`` lines);
   - K4 (``fused_level``), K5 (``stage_ntt``), K6 (``fused_stage_level``)
     and the five stages of K7 (``fused_level_probe``) at the shapes the
     BLS12-381 Fr 2^18 transforms give them under ``mxu_fused``, ``pallas``
     and ``pallas_fused``, K5/K6 also at the Goldilocks 2^20 shapes; a
     ``probe`` JSON line says what each stage of the fused level adds;
   - K8 (``a2a_transpose``) at the shapes of the BLS12-381 Fr 2^22
     distributed transform on four shards of one card, against its plain
     version and ``permute().contiguous()`` of the stacked shards;
   - at small shapes: K1-K3 for every m from 2 to 32 on all four fields
     (ragged batches, odd reps, stack entries that straddle K2's column
     tiles; K2 with periodic T3s), K1's short form at every m that takes
     it on every field, at batch sizes that cross its column tile and its
     spans of tiles a block (under the card's plan and the plan for 4
     SMs), K3 multi-level for m = 64 .. 512 on both
     narrow fields and on BLS12-381 Fr, and at m = 1024 on W = 1, 2, 8 in
     both forms (the wide one on W = 1) through the C entries, the wide
     one under the plan for 4 SMs, and through the wrapper; the transposed
     store of K2, K3 single and K3 multi in both forms against the plain
     versions; K4 and K7 for every m from 2 to
     32, K5 and K6 for every m from 2 to 256, with and without T3, both
     store orders, forward and inverse, and at B one column short of the
     launch plan's tile and B = 4097, 8193; K8 for D in {2, 4, 8}, W in
     {1, 2, 8}, 16-byte and word moves, unaligned shards.
3. Runs every op of the big-integer layer (``ntt_tpu_torch.bigint``, the
   68 public names, and ``limbs.eq``) on the card at W = 2 and W = 8 on
   2^14 columns of seeded operands (``tests/test_bigint.py``'s special
   values in the first columns, zero divisors, moduli without inverses)
   and holds every output column against Python-int arithmetic, sentinels
   included, with every output on the card. Before
   that, while no host thread computes a golden result, it times each op
   at W = 8 on 2^20 columns, 2^18 for ``gcd``, ``modular_inverse`` and
   ``modular_power`` (one warm call traced by ``torch.profiler`` for its
   device kernels, then the median of three by CUDA events), holds 4096
   sampled columns of the result against Python ints and prints the
   ``bigint`` JSON line (op -> ms, launches, elements, W). These ops are
   plain PyTorch: no TPU kernel stands behind ``ntt_tpu.bigint``.
4. Drives the entry points of ``ntt_tpu_torch`` on the card and checks
   every output word against the hostlib golden result:
   - the 256-bit path: BLS12-381 Fr 2^18 forward on the ramp (launch
     counts asserted) and on random input, BN254 Fr 2^18, BLS 2^14, BLS
     2^20; BLS 2^18 ``intt`` and ``coset_ntt`` (the coset folded into the
     same four launches, asserted), BLS 2^12 ``coset_ntt``; BLS 2^22 and
     2^24 forward, 2^24 ``coset_ntt`` and ``lde`` 2^22 -> 2^24 (launch
     counts asserted; the golden results computed on host threads while
     the card works);
   - above 2^24 (level 0 the stack with its periodic residual, no table of
     n entries): the tables' build time at 2^24 and 2^26 all on the host
     against generated on the card (word-compared); BLS 2^25 and 2^26
     forward, 2^26 ``coset_ntt`` and the 2^26 ``intt`` back to the
     forward's input (Montgomery I/O, launch counts asserted, golden results
     started on host threads before the kernel checks), each with its
     runner's build time, its tables' shapes and the peak allocated
     memory; BN254 Fr 2^25 under ``mxu_sub`` and ``lde`` 2^23 -> 2^25;
     then every distinct K1, K2 and K3 launch those paths made (kernel,
     field, operand shapes, rep, direction), again at its own shape with
     the path's own tables on random input, three column spans of the
     output against the plain version on those columns;
   - at 2^27 and 2^28 (a 128-entry deep stack and K1 [8,4,2^25] at 2^27,
     a third deep level and K1 [8,8,2^25] at 2^28): BLS12-381 Fr 2^27
     forward against the golden result (started on a host thread first),
     BLS12-381 Fr and BN254 Fr 2^28 forward on random words, launch counts
     asserted, each with its runner's build time, its time and the peak
     allocated memory; then every distinct K1-K3 launch of the three
     against the plain version on three column spans;
   - the narrow path: Goldilocks 2^18 and 2^24 and small-proth 2^22
     forward (launch counts asserted: 2, 3 and 2 + 1); Goldilocks 2^20
     ``intt(ntt(x)) == x``, ``intt`` and ``coset_ntt``; ``lde`` blowup 4
     from 2^18; ``polymul`` at n = 2^17;
   - the knobs (``ntt_tpu_torch.config``): each setting of ``KNOB_RUNS``
     (the peel sizes NTT_MXU_BASE_LOG=4, NTT_MXU_SUBBASE_LOG=8 and 10,
     NTT_MXU_SUB256_LOG=6, 7 and 9; NTT_TW_MATFOLD=0 with NTT_FUSE_TW 1 and
     0; NTT_TW_RESID=1; NTT_TW_STACK_MAX_NT=32) on the runs it changes
     (BLS12-381 Fr 2^18 to 2^22, Goldilocks 2^20, small-proth 2^20 and
     2^22: the JAX package's peels, 1024 on the small Proth prime under
     NTT_MXU_SUBBASE_LOG=10 and 256 on BLS12-381 Fr under
     NTT_MXU_SUB256_LOG=9, their K3 shapes asserted), every
     output word against the golden result, a fresh runner under each
     setting (``config_key()`` changes, and comes back after), the runner
     built under the knob golden-equal again once the knobs are restored
     (it keeps its plan), one ``knob`` line a run with its time beside the
     default knobs' and the card; every distinct K1-K3 launch under the
     knobs against the plain
     version on three column spans; NTT_MXU_BASE_LOG=6 rejected by design
     (K1-K4 take m <= 32) and NTT_DEBUG=1 firing on one corrupted word;
   - every explicit algorithm name (``naive``, ``stockham``, ``fourstep``,
     ``fourstep_st``, ``pallas``, ``pallas_fused``, ``mxu``,
     ``mxu_pallas``, ``mxu_fused`` and the cross pairs ``mxu_sub`` on a
     256-bit field, ``mxu_chunked`` on a narrow one) forward at BLS12-381
     Fr 2^18 and Goldilocks 2^20 (launch counts asserted), the three
     kernel-backed ladders also on the ramp, through ``intt(ntt(x)) == x``
     and ``coset_ntt``; the probe entry through its five stages;
   - the multi-device four-step (``ntt_tpu_torch.parallel``) on a mesh of
     four shards of one card, exchange K8: BLS12-381 Fr 2^22 (``mxu_sub``)
     forward, ``dist_intt`` back to the input, forward coset, the
     ``all_to_all`` and ``ring`` exchanges (same words), five random
     inputs through K8 against the plain exchange; BLS 2^20 (``pallas``);
     Goldilocks 2^24 forward and ``dist_lde`` 2^22 -> 2^24 (launch counts
     asserted: K8 four times a transform); the BLS 2^22 forward across
     distinct cards where the machine has two or more (a line says so
     where it has one);
   and times each transform and the elementwise passes around it; for
   the two 2^18 forward transforms it prints where the time goes (the
   transposes between levels timed alone, and device time by kernel from
   ``torch.profiler`` where that traces the card).
5. Runs the checking and timing tools (``ntt_tpu_torch.tools``) on the
   card: the default health check through ``python3 -m`` (small-proth
   2^9, every name and ``auto``), then in-process ``healthcheck
   bls12-381-fr 12`` and ``--deep`` (up to BLS12-381 Fr 2^22, every output
   word), ``sweep`` over BLS12-381 Fr 2^8-2^22 with every position checked
   and over Goldilocks 2^18, 2^20, 2^24, ``shootout`` at BLS 2^18 and
   Goldilocks 2^20, ``microbench`` and its ``knockout`` (K7's five stages,
   K2's stack) at BLS 2^18, ``scaling`` on 1-8 shards of the card
   (small-proth, and BLS12-381 Fr under ``mxu_sub``), each timed chain
   sized to ``TOOLS_TARGET_S``; fails on an exit code other than 0, a
   MISMATCH / FAIL / FAILED line or a record not bit-exact, and if one of
   K1-K8 was not launched by the in-process runs (their counts set to 0
   before them and read after). One ``tools`` line a run, with the tool's
   output indented below it.
6. Holds the tensor-core kernels to their device-time targets where the
   profiler traces the card: the two K3 multi-level launches of Goldilocks
   2^18 below ``torch._int_mm`` on their two matmuls, K7's ``matmul``,
   ``reduce`` and ``tw`` stages below ``_int_mm`` on the level's matmul,
   ``tw`` within 15% of K3 single-level at [8,32,8192] rep 1, and K1's
   short form at [8,4,2^20] and [8,2,2^22] below ``_int_mm`` on its
   digits (asserted in step 2).
7. Prints a ``kernels`` JSON
   line (a kernel's bound is the sum of its launches' own bounds,
   ``bound_by`` the kind with the larger share and ``bound_split`` both
   shares), the card line, and last the result line
   ``{"ok": true, "device": {...}}``.

Any failure raises and the script exits non-zero, printing no result. It
needs a CUDA device; it imports neither JAX nor ``ntt_tpu``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

#: NVIDIA H100 SXM data-sheet peaks (dense): device memory and int8 tensor rate
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
#: NVLink between the H100s of one host: 450 GB/s each way
NVLINK_BYTES_PER_S = 450e9
#: 32-bit integer multiply results a second outside the tensor cores: 132 SMs
#: x 64 a clock (the CUDA throughput table for compute capability 9.0: 32-bit
#: integer multiply, multiply-add) x 1.98 GHz boost clock. The low and the
#: high half of a 32 x 32 -> 64-bit product are one result each (IMAD and
#: IMAD.HI in the SASS)
INT32_MADS_PER_S = 132 * 64 * 1.98e9
SEED = 2026
#: the tensor-core kernels (K1-K4, K7), by the name of their kernel in a
#: profiler trace
TENSOR_CORE = {"base_ntt_mxu": "base_ntt_mxu_kernel<",
               "fused_level_stack": "fused_level_stack_kernel<",
               "fused_subntt": "fused_subntt_kernel<",
               "fused_subntt_multi": "fused_subntt_multi_kernel<",
               "fused_subntt_wide": "fused_subntt_wide_kernel<",
               "fused_level": "fused_level_kernel<",
               "fused_level_probe": "fused_level_probe_kernel<"}
#: K1's short form (E * m <= 160: W = 8 at m = 2 and 4), a kernel of its own
SHORT_FORM = "base_ntt_mxu_short_kernel<"
#: the kernels timed on the device too: the tensor-core kernels and the
#: butterfly ladders K5 and K6; K1 by the name its two forms share
DEVICE_TIMED = {**TENSOR_CORE, "base_ntt_mxu": "base_ntt_mxu_",
                "stage_ntt": "stage_ntt_kernel<",
                "fused_stage_level": "fused_stage_level_kernel<"}


def check_sass() -> None:
    """Every digit-matmul kernel contracts on the int8 tensor cores: the
    SASS of the built ``mxu_level`` and ``mxu_sub`` libraries
    (``cuobjdump -sass``) shows tensor-core instructions (IGMMA, the
    integer wgmma, or IMMA) and no IDP.4A in each instantiation of each
    kernel of ``TENSOR_CORE`` (W = 1, 2, 8; the single-level kernels each
    with the digit tile in one pass and in two, for m = 64; the wide
    multi-level K3 for W = 1, 2) and of K1's short form (``SHORT_FORM``,
    W = 1, 2, 8), and no IDP.4A anywhere in them."""
    from ntt_tpu_torch.kernels import _build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    counts = {}
    for lib in ("mxu_level", "mxu_sub", "mxu_persist"):
        out = subprocess.run([tool, "-sass", _build._target(lib)],
                             check=True, capture_output=True, text=True,
                             timeout=300).stdout
        for part in out.split("Function : ")[1:]:
            counts[part.split()[0]] = (
                len(re.findall(r"\b(?:IGMMA|HGMMA|IMMA)\b", part)),
                len(re.findall(r"\bIDP\.?4A", part)))
    for kernel in (k.rstrip("<") for k in (*TENSOR_CORE.values(),
                                           SHORT_FORM,
                                           *PERSIST_NAMES.values())):
        got = [c for name, c in counts.items() if kernel + "I" in name]
        imma, dp4a = sum(c[0] for c in got), sum(c[1] for c in got)
        want = (1 if kernel + "<" in PERSIST_NAMES.values() else
                2 if kernel == "fused_subntt_wide_kernel" else
                3 if kernel in ("fused_subntt_multi_kernel",
                                SHORT_FORM.rstrip("<")) else 6)
        print(f"sass {kernel}: {len(got)} instantiations, {imma} tensor-core "
              f"(IGMMA/HGMMA/IMMA), {dp4a} IDP.4A", flush=True)
        if len(got) != want or not all(i > 0 and d == 0 for i, d in got):
            raise AssertionError(
                f"{kernel}: expected tensor-core instructions and no IDP.4A "
                f"in each of its {want} instantiations, got {got}")
    dp4a = sum(c[1] for c in counts.values())
    print(f"sass: {dp4a} IDP.4A in the {len(counts)} functions of both "
          "libraries", flush=True)
    if dp4a:
        raise AssertionError(f"{dp4a} IDP.4A left in the digit-matmul "
                             "libraries")


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


def bound(bytes_moved: int, int8_macs: int, int32_mads: int = 0) -> tuple:
    """The least time in ms the card could take: bytes at the memory rate
    against int8 MACs at the tensor rate plus 32-bit multiply-adds at the
    int32 rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = (2 * int8_macs / INT8_OPS_PER_S
             + int32_mads / INT32_MADS_PER_S) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def conv_macs(f, A, cols: int) -> int:
    """int8 MACs that the digit matmul of the conv matrix ``A`` over
    ``cols`` columns needs: every entry of the pre-folded wide-field
    matrices, only the band of the narrow fields' (D of each E digit
    blocks in a row; the rest is zero by construction)."""
    from ntt_tpu_torch import digits
    return A.numel() * digits.n_digits(f) // digits.out_planes(f) * cols


def device_target(what: str, kern_ms, lib_ms, factor: float = 1.0) -> None:
    """Asserts a device-time target, ``kern_ms < factor * lib_ms``, where
    the profiler measured both; says so where it did not."""
    if kern_ms is None or lib_ms is None:
        print(f"target {what}: not checked (no device time)", flush=True)
        return
    if not kern_ms < factor * lib_ms:
        raise AssertionError(f"{what}: {kern_ms:.4f} ms device, not below "
                             f"{factor} x {lib_ms:.4f} ms")
    print(f"target {what}: {kern_ms:.4f} ms < {factor} x {lib_ms:.4f} ms "
          "(device)", flush=True)


def mont_mul_mads(f) -> int:
    """32-bit multiply results of one Montgomery product of W-word elements
    (CIOS): a low and a high half of each of the W^2 partial products of
    a*b and of the W^2 of q*p, and the W quotient words q (low halves
    only)."""
    return 4 * f.n_words ** 2 + f.n_words


def ladder_products(m: int) -> int:
    """Montgomery products of an m-point radix-2 ladder on one column: the
    stage twiddles other than 1. The stage of half-size s has m/2
    butterflies, m/(2s) of them at twiddle w^0 (none at all for s = 1)."""
    return sum(m // 2 - m // (2 * s) for s in (1 << i for i in range(
        m.bit_length() - 1)))


def int_mm(A, d):
    """A call of ``torch._int_mm`` on int8 A[r, c] and d[c, N], the
    operands padded with zeros to shapes the library takes: more than 16
    rows, c and N multiples of 8, and for the small matrices whatever
    larger multiple cuBLAS accepts (tried once, here)."""
    r, c = A.shape
    Np = -(-d.shape[1] // 8) * 8
    for mult in (8, 16, 32, 64):
        rp, cp = max(-(-r // mult) * mult, 24), -(-c // mult) * mult
        Ap = torch.nn.functional.pad(A, (0, cp - c, 0, rp - r)).contiguous()
        dp = torch.nn.functional.pad(
            d, (0, Np - d.shape[1], 0, cp - c)).contiguous()
        try:
            torch._int_mm(Ap, dp)
        except RuntimeError:
            if mult == 64:
                raise
            continue
        return lambda: torch._int_mm(Ap, dp)


def measure(cases, results, plain_iters: int = 5) -> None:
    """Runs each case (kernel name, label, kernel call, plain call, bytes
    read and written, int8 MACs, library call or None, launches of this
    shape on the main path, and optionally 32-bit multiply-adds) once
    against its plain version, word for word, then times it."""
    for name, label, kern, plain, nbytes, macs, lib, on_path, *more in cases:
        mads = more[0] if more else 0
        got = kern()
        torch.cuda.synchronize()
        want = plain()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        if err != 0 or not torch.equal(got, want):
            raise AssertionError(f"{name} ({label}): kernel != plain, "
                                 f"max abs err {err}")
        del got, want
        ms = time_ms(kern)
        plain_ms = time_ms(plain, iters=plain_iters, warmup=1)
        lib_ms = time_ms(lib) if lib is not None else None
        b_ms, b_by = bound(nbytes, macs, mads)
        timed = ""
        call = {}
        if name in DEVICE_TIMED:
            # a trace now and then comes back without device events: twice
            dev_ms = (kernel_device_ms(kern, DEVICE_TIMED[name])
                      or kernel_device_ms(kern, DEVICE_TIMED[name]))
            lib_dev = None
            if lib is not None:
                lib_dev = library_device_ms(lib)
            call = {"device_ms": dev_ms, "library_device_ms": lib_dev}
            timed = (f"  device {'-' if dev_ms is None else f'{dev_ms:.4f}'}"
                     f" ms, library device "
                     f"{'-' if lib_dev is None else f'{lib_dev:.4f}'} ms")
        print(f"check {name:18s} {label:44s} word-equal  kernel {ms:.4f} ms"
              f"  plain {plain_ms:.4f} ms  _int_mm "
              f"{'-' if lib_ms is None else f'{lib_ms:.4f} ms'}"
              f"  bound {b_ms:.4f} ms ({b_by}){timed}", flush=True)
        call.update({"shape": label, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                     "max_abs_err": err, "bytes": nbytes, "int8_macs": macs,
                     "int32_mads": mads, "path_launches": int(on_path)})
        r = results.setdefault(name, {"calls": [], "path": []})
        r["calls"].append(call)
        r["path"].extend([call] * int(on_path))


def check_kernels(f, aux, rng, dev, results) -> None:
    """K1, K2 and single-level K3 against their plain versions, at the
    256-bit main path's shapes, and K1 and K3 at the full width of the
    2^22 and 2^24 transforms; K1's short form at [8,4,2^20] and
    [8,2,2^22], each held below ``torch._int_mm`` on its digits by device
    time."""
    from ntt_tpu_torch import digits
    from ntt_tpu_torch.kernels import mxu_level, mxu_ntt

    D = digits.n_digits(f)
    mats = aux["mats"]
    stack0, batch1, stack2 = aux["tws"]

    def rand(*shape):
        return torch.from_numpy(random_words(f, shape, rng)).to(dev)

    def mm(A, x):
        m = x.shape[1]
        return int_mm(A, digits.extract_digits(x, f).reshape(D * m, -1))

    cases = []
    x = rand(32, 8192)
    A = stack0.As
    cases.append(("fused_level_stack", "level 0 [8,32,8192] stack 32 rep 256",
                  lambda: mxu_level.fused_level_stack(x, f, A, 256, mats[-32]),
                  lambda: mxu_level.fused_level_stack_plain(
                      x, f, A, 256, mats[-32]),
                  2 * x.numel() * 4 + A.numel(), A.numel() * 256,
                  mm(A[0], x), True))
    x1 = rand(32, 8192)
    T1 = batch1.T4.reshape(8, 32, 8192)
    sub = {k: mats[k] for k in (32, -32, -1)}
    cases.append(("fused_subntt", "level 1 [8,32,8192] TwBatch rep 1",
                  lambda: mxu_level.fused_subntt(x1, f, False, sub, T1),
                  lambda: mxu_level.fused_subntt_plain(x1, f, False, sub, T1),
                  3 * x1.numel() * 4 + mats[32].numel(),
                  mats[32].numel() * 8192, mm(mats[32], x1), True))
    x2 = rand(32, 8192)
    A2 = stack2.As
    cases.append(("fused_level_stack", "level 2 [8,32,8192] stack 8 rep 1024",
                  lambda: mxu_level.fused_level_stack(x2, f, A2, 1024,
                                                      mats[-32]),
                  lambda: mxu_level.fused_level_stack_plain(
                      x2, f, A2, 1024, mats[-32]),
                  2 * x2.numel() * 4 + A2.numel(), A2.numel() * 1024,
                  mm(A2[0], x2), True))
    x3 = rand(8, 32768)
    cases.append(("base_ntt_mxu", "base [8,8,32768]",
                  lambda: mxu_ntt.base_ntt_mxu(x3, f, mats[8], mats[-8]),
                  lambda: mxu_ntt.base_ntt_mxu_plain(x3, f, mats[8], mats[-8]),
                  2 * x3.numel() * 4 + mats[8].numel(),
                  mats[8].numel() * 32768, mm(mats[8], x3), True))
    # off the 2^18 path: K3 at rep = 32 (2^14 level 1), K2 with a residual
    x4 = rand(32, 512)
    T4 = rand(16, 32)
    cases.append(("fused_subntt", "rep 32 [8,32,512] table [8,16,32]",
                  lambda: mxu_level.fused_subntt(x4, f, False, sub, T4,
                                                 rep=32),
                  lambda: mxu_level.fused_subntt_plain(x4, f, False, sub, T4,
                                                       rep=32),
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
    measure(cases, results)

    # off the 2^18 path, at full width: K3 at 2^24 level 2 (a deep table,
    # rep 1024), K1 as the last base of 2^22 (m = 4) and 2^24 (m = 16)
    big = sub_mats_on(f, {4, 16}, False, dev)
    x6 = rand(32, 1 << 19)
    T6 = rand(512, 32)
    measure([("fused_subntt", "2^24 level 2 [8,32,524288] rep 1024",
              lambda: mxu_level.fused_subntt(x6, f, False, sub, T6, rep=1024),
              lambda: mxu_level.fused_subntt_plain(x6, f, False, sub, T6,
                                                   rep=1024),
              2 * x6.numel() * 4 + T6.numel() * 4 + mats[32].numel(),
              mats[32].numel() * (1 << 19), mm(mats[32], x6), False)],
            results, plain_iters=1)
    del x6, T6
    for m, log_n in ((4, 22), (16, 24)):
        xb = rand(m, 1 << 20)
        measure([("base_ntt_mxu", f"2^{log_n} base [8,{m},1048576]",
                  lambda: mxu_ntt.base_ntt_mxu(xb, f, big[m], big[-m]),
                  lambda: mxu_ntt.base_ntt_mxu_plain(xb, f, big[m], big[-m]),
                  2 * xb.numel() * 4 + big[m].numel(),
                  big[m].numel() * (1 << 20), mm(big[m], xb), False)],
                results, plain_iters=1)
        del xb
        if m == 4:
            call = results["base_ntt_mxu"]["calls"][-1]
            device_target("K1 short form [8,4,2^20] below _int_mm",
                          call["device_ms"], call["library_device_ms"])
    torch.cuda.empty_cache()
    # K1's short form at m = 2 over 2^22 columns (the last base of 2^23),
    # where _int_mm still runs (an int32 output of 1.34 GB)
    two = sub_mats_on(f, {2}, False, dev)
    xb = random_on_card(f, (2, 1 << 22), dev)
    measure([("base_ntt_mxu", "2^23 base [8,2,4194304]",
              lambda: mxu_ntt.base_ntt_mxu(xb, f, two[2], two[-2]),
              lambda: mxu_ntt.base_ntt_mxu_plain(xb, f, two[2], two[-2]),
              2 * xb.numel() * 4 + two[2].numel(),
              two[2].numel() * (1 << 22), mm(two[2], xb), False)],
            results, plain_iters=1)
    del xb
    call = results["base_ntt_mxu"]["calls"][-1]
    device_target("K1 short form [8,2,2^22] below _int_mm",
                  call["device_ms"], call["library_device_ms"])
    torch.cuda.empty_cache()


def check_ladder_kernels(rng, dev, results) -> None:
    """K4, K5, K6 and the five stages of K7 against their plain versions
    at the shapes the BLS12-381 Fr 2^18 transforms give them (``mxu_fused``:
    three levels [8,32,8192] with T3 and the transposed store, a last one
    [8,8,32768]; ``pallas``: three [8,64,4096]; ``pallas_fused``: two
    levels [8,64,4096] with T3 and the transposed store, a last one
    without), and K5/K6 at the Goldilocks 2^20 shapes. K5 and K6 have no
    library line: no single PyTorch call computes a butterfly ladder."""
    from ntt_tpu_torch import BLS12_381_FR, GOLDILOCKS, digits
    from ntt_tpu_torch.kernels import mxu_level, vmem_ntt

    f = BLS12_381_FR
    D = digits.n_digits(f)
    mats = sub_mats_on(f, {8, 32}, False, dev)

    def rand(fld, *shape):
        return torch.from_numpy(random_words(fld, shape, rng)).to(dev)

    def mm(A, x):
        m = x.shape[1]
        return int_mm(A, digits.extract_digits(x, f).reshape(D * m, -1))

    x, T = rand(f, 32, 8192), rand(f, 32, 8192)
    A, F, F2 = mats[32], mats[-32], mats[-1]
    lib = mm(A, x)
    nb, macs = x.numel() * 4, A.numel() * 8192
    cases = [("fused_level", "level [8,32,8192] T3, transposed store",
              lambda: mxu_level.fused_level(x, f, A, T, True, F, F2),
              lambda: mxu_level.fused_level_plain(x, f, A, T, True, F, F2),
              3 * nb + A.numel(), macs, lib, 3)]
    x8 = rand(f, 8, 32768)
    cases.append(("fused_level", "last level [8,8,32768] no T3, direct store",
                  lambda: mxu_level.fused_level(x8, f, mats[8], None, False,
                                                mats[-8]),
                  lambda: mxu_level.fused_level_plain(x8, f, mats[8], None,
                                                      False, mats[-8]),
                  2 * nb + mats[8].numel(), mats[8].numel() * 32768,
                  mm(mats[8], x8), 1))
    # the probe: bytes and MACs of what each truncation still does
    work = {"stream": (2 * nb, 0, None), "digits": (2 * nb, 0, None),
            "matmul": (2 * nb + A.numel(), macs, lib),
            "reduce": (2 * nb + A.numel(), macs, lib),
            "tw": (3 * nb + A.numel(), macs, lib)}
    for stage in mxu_level.PROBE_STAGES:
        T3 = T if stage == "tw" else None
        b, ops, libfn = work[stage]
        cases.append(("fused_level_probe", f"{stage} [8,32,8192]",
                      lambda st=stage, T3=T3: mxu_level.fused_level_probe(
                          x, f, A, st, T3),
                      lambda st=stage, T3=T3:
                      mxu_level.fused_level_probe_plain(x, f, A, st, T3),
                      b, ops, libfn, 1))
    measure(cases, results)
    del x, T, x8, cases
    probe = {c["shape"].split()[0]: c
             for c in results["fused_level_probe"]["calls"]}
    for stage in ("matmul", "reduce", "tw"):
        device_target(f"K7 {stage} against _int_mm",
                      probe[stage]["device_ms"],
                      probe[stage]["library_device_ms"])
    k3 = next(c for c in results["fused_subntt"]["calls"]
              if c["shape"].startswith("level 1 [8,32,8192]"))
    device_target("K7 tw against K3 single-level rep 1",
                  probe["tw"]["device_ms"], k3["device_ms"], 1.15)

    # (field, m, B, launches on the path as K5, as K6 with T3 and the
    # transposed store, as K6 without)
    for fld, m, B, n5, n6t, n6 in ((BLS12_381_FR, 64, 4096, 3, 2, 1),
                                   (GOLDILOCKS, 256, 4096, 0, 0, 0),
                                   (GOLDILOCKS, 128, 8192, 0, 0, 0),
                                   (GOLDILOCKS, 64, 16384, 0, 0, 0)):
        W = fld.n_words
        x, T = rand(fld, m, B), rand(fld, m, B)
        nb = x.numel() * 4
        ladder = ladder_products(m) * B * mont_mul_mads(fld)
        tw = m * B * mont_mul_mads(fld)
        shape = f"[{W},{m},{B}]"
        measure([
            ("stage_ntt", f"{fld.name} {shape}",
             lambda: vmem_ntt.stage_ntt(x, fld),
             lambda: vmem_ntt.stage_ntt_plain(x, fld),
             2 * nb, 0, None, n5, ladder),
            ("fused_stage_level", f"{fld.name} {shape} T3, transposed store",
             lambda: vmem_ntt.fused_stage_level(x, fld, False, T, True),
             lambda: vmem_ntt.fused_stage_level_plain(x, fld, False, T, True),
             3 * nb, 0, None, n6t, ladder + tw),
            ("fused_stage_level", f"{fld.name} {shape} no T3, direct store",
             lambda: vmem_ntt.fused_stage_level(x, fld, False, None, False),
             lambda: vmem_ntt.fused_stage_level_plain(x, fld, False, None,
                                                      False),
             2 * nb, 0, None, n6, ladder)], results)
        del x, T
        torch.cuda.empty_cache()


#: the knob setting of the 64-point single-level contraction
BASE64 = {"mxu.BASE_LOG": 6, "mxu.BASE": 64}


def check_base64_kernels(rng, dev, results) -> None:
    """K1, K2, K3 single-level, K4 and the five stages of K7 at m = 64
    (the digit tile streamed over the depth in two passes) against their
    plain versions at the shapes NTT_MXU_BASE_LOG=6 gives them on
    BLS12-381 Fr: the 2^18 transform's levels [8,64,4096] (K3 with the
    top-level table at rep 1 and the deep table at rep 64; K4 with T3 and
    the transposed store; K1 the last base; K7 the level's stages) and the
    2^20 level 0 [8,64,16384] (K2, a 64-entry stack, rep 256); each timed
    beside its bound, ``torch._int_mm`` on its digit operands and its
    device time. Off the main path (the kernels line counts none of them).
    """
    from ntt_tpu_torch import BLS12_381_FR as f
    from ntt_tpu_torch import digits
    from ntt_tpu_torch.kernels import mxu_level, mxu_ntt

    D = digits.n_digits(f)
    mats = sub_mats_on(f, {64}, False, dev)
    A, F, F2 = mats[64], mats[-64], mats[-1]

    def rand(*shape):
        return torch.from_numpy(random_words(f, shape, rng)).to(dev)

    def mm(A, x):
        m = x.shape[1]
        return int_mm(A, digits.extract_digits(x, f).reshape(D * m, -1))

    x, T, Td = rand(64, 4096), rand(64, 4096), rand(64, 64)
    nb, macs, lib = x.numel() * 4, A.numel() * 4096, mm(A, x)
    tw = mont_mul_mads(f) * 64 * 4096
    cases = [
        ("base_ntt_mxu", "BASE 64: base [8,64,4096]",
         lambda: mxu_ntt.base_ntt_mxu(x, f, A, F),
         lambda: mxu_ntt.base_ntt_mxu_plain(x, f, A, F),
         2 * nb + A.numel(), macs, lib, 0),
        ("fused_subntt", "BASE 64: level 0 [8,64,4096] T3 rep 1",
         lambda: mxu_level.fused_subntt(x, f, False, mats, T),
         lambda: mxu_level.fused_subntt_plain(x, f, False, mats, T),
         3 * nb + A.numel(), macs, lib, 0, tw),
        ("fused_subntt", "BASE 64: level 1 [8,64,4096] rep 64 table [8,64,64]",
         lambda: mxu_level.fused_subntt(x, f, False, mats, Td, rep=64),
         lambda: mxu_level.fused_subntt_plain(x, f, False, mats, Td,
                                              rep=64),
         2 * nb + Td.numel() * 4 + A.numel(), macs, lib, 0, tw),
        ("fused_level", "BASE 64: level [8,64,4096] T3, transposed store",
         lambda: mxu_level.fused_level(x, f, A, T, True, F, F2),
         lambda: mxu_level.fused_level_plain(x, f, A, T, True, F, F2),
         3 * nb + A.numel(), macs, lib, 0, tw)]
    work = {"stream": (2 * nb, 0, None, 0), "digits": (2 * nb, 0, None, 0),
            "matmul": (2 * nb + A.numel(), macs, lib, 0),
            "reduce": (2 * nb + A.numel(), macs, lib, 0),
            "tw": (3 * nb + A.numel(), macs, lib, tw)}
    for stage in mxu_level.PROBE_STAGES:
        T3 = T if stage == "tw" else None
        b, ops, libfn, mads = work[stage]
        cases.append(("fused_level_probe", f"BASE 64: {stage} [8,64,4096]",
                      lambda st=stage, T3=T3: mxu_level.fused_level_probe(
                          x, f, A, st, T3),
                      lambda st=stage, T3=T3:
                      mxu_level.fused_level_probe_plain(x, f, A, st, T3),
                      b, ops, libfn, 0, mads))
    measure(cases, results)
    del x, T, Td, cases, lib
    x0 = rand(64, 16384)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    As = torch.randint(0, 128, (64, 37 * 64, 37 * 64), generator=gen,
                       device=dev, dtype=torch.int8)   # 359 MB, on the card
    measure([("fused_level_stack",
              "BASE 64: 2^20 level 0 [8,64,16384] stack 64 rep 256",
              lambda: mxu_level.fused_level_stack(x0, f, As, 256, F),
              lambda: mxu_level.fused_level_stack_plain(x0, f, As, 256, F),
              2 * x0.numel() * 4 + As.numel(), As[0].numel() * 16384,
              mm(As[0], x0), 0)], results)
    del x0, As
    torch.cuda.empty_cache()


def sub_mats_on(f, sizes, inverse, dev) -> dict:
    """{m: conv matrix, -m: fold matrix, -1: twiddle fold matrix} on the
    card for the sizes given (fold matrices for wide fields only)."""
    from ntt_tpu_torch.transforms import mxu
    return {k: torch.from_numpy(v).to(dev)
            for k, v in mxu._mats_for(f, sizes, inverse).items()}


def check_multi_level(rng, dev, results) -> None:
    """K3 multi-level (and the single-level last base of small-proth 2^22)
    against the plain version at the shapes the narrow-field transforms
    give them, each in the form its wrapper takes there: the present form
    at one wave of blocks (Goldilocks 2^18, ``on_path`` of
    ``fused_subntt_multi``), the wide form above (Goldilocks 2^24,
    ``on_path`` of ``fused_subntt_wide``; small-proth 2^22). The last bases
    of Goldilocks 2^25 and 2^26 ([2,128,2^18], [2,256,2^18]) are held on
    three column spans (the plain version on a whole launch would need
    tens of GB). The small Proth prime's launches at m = 1024 under
    NTT_MXU_SUBBASE_LOG=10 (2^20: [1,1024,1024] with T3 at rep 1 and the
    base; 2^22: [1,1024,4096] at rep 1 and 1024) are measured only.
    ``target`` lines assert, by device time, the 2^18 launches and each
    wide launch up to m = 512 below ``torch._int_mm``."""
    from ntt_tpu_torch import GOLDILOCKS, SMALL, digits
    from ntt_tpu_torch.kernels import _build, mxu_level

    sms = _build.sm_count(dev)
    # (field, m, B, twiddle: None / 1 / rep, what, on its form's path)
    shapes = [
        (GOLDILOCKS, 512, 512, 1, "goldilocks 2^18 level 0", True),
        (GOLDILOCKS, 512, 512, None, "goldilocks 2^18 base", True),
        (GOLDILOCKS, 512, 32768, 1, "goldilocks 2^24 level 0", True),
        (GOLDILOCKS, 512, 32768, 512, "goldilocks 2^24 level 1", True),
        (GOLDILOCKS, 64, 1 << 18, None, "goldilocks 2^24 base", True),
        (GOLDILOCKS, 128, 1 << 18, None, "goldilocks 2^25 base", False),
        (GOLDILOCKS, 256, 1 << 18, None, "goldilocks 2^26 base", False),
        (SMALL, 512, 8192, 1, "small-proth 2^22 level 0", False),
        (SMALL, 512, 8192, 512, "small-proth 2^22 level 1", False),
        (SMALL, 16, 1 << 18, None, "small-proth 2^22 base", False),
        # under NTT_MXU_SUBBASE_LOG=10, the small Proth prime's peel of 1024
        (SMALL, 1024, 1024, 1, "small-proth 2^20 level 0, SUBBASE_LOG=10",
         False),
        (SMALL, 1024, 1024, None, "small-proth 2^20 base, SUBBASE_LOG=10",
         False),
        (SMALL, 1024, 4096, 1, "small-proth 2^22 level 0, SUBBASE_LOG=10",
         False),
        (SMALL, 1024, 4096, 1024, "small-proth 2^22 level 1, SUBBASE_LOG=10",
         False),
    ]
    wide = []
    for f, m, B, tw, what, on_path in shapes:
        W, D, E = f.n_words, digits.n_digits(f), digits.out_planes(f)
        sizes = {m} if m <= 32 else {32, m // 32}
        mats = sub_mats_on(f, sizes, False, dev)
        x = random_on_card(f, (m, B), dev)
        rep = 1 if tw is None else tw
        T3 = None
        if tw is not None:
            shape = (m, B) if rep == 1 else (B // rep, m)
            T3 = torch.from_numpy(random_words(f, shape, rng)).to(dev)
        nbytes = 2 * x.numel() * 4 + (T3.numel() * 4 if tw else 0)
        if m <= 32:
            name = "fused_subntt"
            nbytes += mats[m].numel()
            macs = conv_macs(f, mats[m], B)
            d = digits.extract_digits(x, f).reshape(D * m, -1)
            libs = [int_mm(mats[m], d)]
        else:
            name = ("fused_subntt_wide" if mxu_level.sub_wide(f, m, B, sms)
                    else "fused_subntt_multi")
            m2 = m // 32
            nbytes += mats[32].numel() + mats[m2].numel() + W * m * 4
            macs = (conv_macs(f, mats[32], m2 * B)
                    + conv_macs(f, mats[m2], 32 * B))
            # the two matmuls on digit operands of the right shapes (the
            # second one's values are stand-ins: the time is the point)
            d1 = digits.extract_digits(x, f).reshape(D, 32, m2 * B).reshape(
                D * 32, -1)
            d2 = d1.reshape(-1)[:D * m2 * 32 * B].reshape(D * m2, 32 * B)
            libs = [int_mm(mats[32], d1), int_mm(mats[m2], d2)]
            del d1, d2
        label = (f"{what} [{W},{m},{B}] "
                 + ("no twiddle" if tw is None else f"rep {rep}"))

        def kern():
            return mxu_level.fused_subntt(x, f, False, mats, T3, rep=rep)

        def lib():
            return [g() for g in libs]
        if m * B > 1 << 24:
            step = 1 << 14
            check_full_width(
                name, label, kern,
                [slice(i, i + step) for i in (0, B // 2, B - step)],
                lambda c: mxu_level.fused_subntt_plain(
                    x[:, :, c].contiguous(), f, False, mats),
                (nbytes, macs, 0),
                results, lib)
        else:
            measure([(name, label, kern,
                      lambda: mxu_level.fused_subntt_plain(
                          x, f, False, mats, T3, rep=rep),
                      nbytes, macs, lib, on_path)],
                    results, plain_iters=2 if m * B >= 1 << 24 else 5)
        if name == "fused_subntt_wide" and m <= 512:
            call = results[name]["calls"][-1]
            wide.append((label, call["device_ms"], call["library_device_ms"]))
        del x, T3, libs
        torch.cuda.empty_cache()
    path = results["fused_subntt_multi"]["path"]
    dev_ms = [c["device_ms"] for c in path]
    lib_ms = [c["library_device_ms"] for c in path]
    device_target("K3 multi, goldilocks 2^18's two launches, against "
                  "_int_mm", None if None in dev_ms else sum(dev_ms),
                  None if None in lib_ms else sum(lib_ms))
    for label, kern_ms, lib_ms in wide:
        device_target(f"K3 wide {label} against _int_mm", kern_ms, lib_ms)


def time_transposed(rng, dev, card) -> None:
    """The transposed store (``transpose_out=True``) beside the plain store
    at main-path shapes, the two outputs word-compared (the transposed one
    against the plain one transposed): K2 at BLS12-381 Fr 2^18's level 0
    ([8,32,8192], 32 stack entries, rep 256), K3 single at its level 1
    ([8,32,8192], T3 at rep 1), K3 multi in its present form at
    Goldilocks 2^18 ([2,512,512], T3 at rep 1) and in its wide form at
    Goldilocks 2^24 ([2,512,32768], T3 at rep 1) and at the small Proth
    prime's m = 1024 ([1,1024,1024], T3 at rep 1): one ``transposed`` line
    each, events and device time of both stores. Measured only: no path of
    either package asks for the transposed store."""
    from ntt_tpu_torch import BLS12_381_FR, GOLDILOCKS, SMALL
    from ntt_tpu_torch.kernels import _build, mxu_level

    def show(v):
        return "-" if v is None else f"{v:.4f}"

    cases = [("fused_level_stack", BLS12_381_FR, 32, 8192,
              "bls12-381-fr 2^18 level 0, stack 32 rep 256"),
             ("fused_subntt", BLS12_381_FR, 32, 8192,
              "bls12-381-fr 2^18 level 1 rep 1"),
             ("fused_subntt", GOLDILOCKS, 512, 512,
              "goldilocks 2^18 level 0 rep 1"),
             ("fused_subntt", GOLDILOCKS, 512, 32768,
              "goldilocks 2^24 level 0 rep 1"),
             ("fused_subntt", SMALL, 1024, 1024,
              "small-proth 2^20 level 0 rep 1, SUBBASE_LOG=10")]
    sms = _build.sm_count(dev)
    for name, f, m, B, what in cases:
        x = random_on_card(f, (m, B), dev)
        if name == "fused_level_stack":
            As = random_stack(f, 32, m, rng, dev)
            F = sub_mats_on(f, {m}, False, dev).get(-m)

            def call(t, x=x, As=As, F=F, f=f):
                return mxu_level.fused_level_stack(x, f, As, 256, F,
                                                   transpose_out=t)
            key = DEVICE_TIMED[name]
        else:
            T3 = random_on_card(f, (m, B), dev)
            mats = sub_mats_on(f, {m} if m <= 32 else {32, m // 32}, False,
                               dev)

            def call(t, x=x, T3=T3, mats=mats, f=f):
                return mxu_level.fused_subntt(x, f, False, mats, T3, t)
            key = DEVICE_TIMED[
                "fused_subntt" if m <= 32 else "fused_subntt_wide"
                if mxu_level.sub_wide(f, m, B, sms) else "fused_subntt_multi"]
        plain_store, transposed = call(False), call(True)
        torch.cuda.synchronize()
        if not torch.equal(transposed, plain_store.transpose(1, 2)):
            raise AssertionError(f"{name} {what}: the transposed store != "
                                 "the plain store transposed")
        del plain_store, transposed
        times = []
        for t in (False, True):
            times.append((time_ms(lambda: call(t)),
                          kernel_device_ms(lambda: call(t), key)
                          or kernel_device_ms(lambda: call(t), key)))
        (ms, dev_ms), (ms_t, dev_t) = times
        print(f"transposed {name} [{f.n_words},{m},{B}] {what} "
              f"({key.rstrip('<')}): store [W,m,B] {ms:.4f} ms (device "
              f"{show(dev_ms)}), transposed [W,B,m] {ms_t:.4f} ms (device "
              f"{show(dev_t)})  ({card})", flush=True)
        del x, call
        torch.cuda.empty_cache()


def check_narrow_short_bases(dev, results) -> None:
    """The narrow fields' short last bases on the single-level K3 (no
    twiddle), where ``auto`` at Goldilocks 2^19-2^21 and small-proth
    2^19-2^22 ends: [2,2,2^18], [2,4,2^18], [2,8,2^18] and [1,16,2^18],
    against the plain version and timed beside their bound and
    ``torch._int_mm`` (``check`` lines, off the main path), then K1's
    short form on the same input, word-equal to K3 (the same function),
    by device time (``short base`` lines). Measured only: the next
    candidates."""
    from ntt_tpu_torch import GOLDILOCKS, SMALL, digits
    from ntt_tpu_torch.kernels import mxu_level, mxu_ntt

    B = 1 << 18
    for f, m in ((GOLDILOCKS, 2), (GOLDILOCKS, 4), (GOLDILOCKS, 8),
                 (SMALL, 16)):
        mats = sub_mats_on(f, {m}, False, dev)
        x = random_on_card(f, (m, B), dev)
        d = digits.extract_digits(x, f).reshape(digits.n_digits(f) * m, -1)
        lib = int_mm(mats[m], d)
        del d
        label = f"narrow short base [{f.n_words},{m},{B}] no twiddle"

        def k3():
            return mxu_level.fused_subntt(x, f, False, mats)

        def k1():
            return mxu_ntt.base_ntt_mxu(x, f, mats[m])
        measure([("fused_subntt", label, k3,
                  lambda: mxu_level.fused_subntt_plain(x, f, False, mats),
                  2 * x.numel() * 4 + mats[m].numel(),
                  conv_macs(f, mats[m], B), lib, False)], results)
        if not torch.equal(k1(), k3()):
            raise AssertionError(f"{label}: K1 != K3")
        k1_ms = (kernel_device_ms(k1, SHORT_FORM)
                 or kernel_device_ms(k1, SHORT_FORM))
        call = results["fused_subntt"]["calls"][-1]

        def show(v):
            return "-" if v is None else f"{v:.4f}"
        print(f"short base {label}: K3 single device "
              f"{show(call['device_ms'])} ms, K1 short form device "
              f"{show(k1_ms)} ms, _int_mm device "
              f"{show(call['library_device_ms'])} ms, bound "
              f"{call['bound_ms']:.4f} ms ({call['bound_by']})", flush=True)
        del x, lib
        torch.cuda.empty_cache()


@contextlib.contextmanager
def level_form(which: str):
    """While the block runs, the W = 8, m = 32 launches take the form
    ``which``: "present" (the one-level block, ``tc_level``) or "persist"
    (``csrc/mxu_persist.cu`` at every tile count, the plan's ``waves``
    threshold set to 0)."""
    import functools

    from ntt_tpu_torch.kernels import mxu_level
    own = mxu_level.persist_plan
    mxu_level.persist_plan = (functools.partial(own, waves=0)
                              if which == "persist" else
                              lambda *a, **k: None)
    try:
        yield
    finally:
        mxu_level.persist_plan = own


#: the kernel names of the two forms of each W = 8, m = 32 launch
PERSIST_NAMES = {"fused_level_stack": "fused_level_stack_persist_kernel<",
                 "fused_subntt": "fused_subntt_persist_kernel<",
                 "fused_level": "fused_level_persist_kernel<",
                 "base_ntt_mxu": "base_ntt_mxu_persist_kernel<"}
PRESENT_NAMES = {"fused_level_stack": "fused_level_stack_kernel<",
                 "fused_subntt": "fused_subntt_kernel<",
                 "fused_level": "fused_level_kernel<",
                 "base_ntt_mxu": "base_ntt_mxu_kernel<"}


def persist_cases(f, dev, big: bool) -> list:
    """(label, wrapper name, x, the wrapper's and the plain version's
    keyword arguments) of the W = 8, m = 32 launches: with ``big`` the
    2^22 levels and the 2^30 local K3 (``tc_knockout.BIG_SHAPES``), two
    levels of 2^20 (K2 level 0, K3 level 1: two waves of tiles) and the
    m = 32 levels of 2^18 (K2 levels 0 and 2, K3 level 1), which keep the
    present form (here forced; they and 2^20 set
    ``mxu_level.PERSIST_WAVES``), and K4 (T3, the direct store) and K1 at
    [8,32,2^17]; else small shapes (ragged B, a
    stack entry of one and of two tiles, the periodic residual, K3 at rep
    1 and 4)."""
    import tc_knockout
    from ntt_tpu_torch import digits
    D, E = digits.n_digits(f), digits.out_planes(f)
    mats = sub_mats_on(f, {32}, False, dev)
    A, F, F2 = mats[32], mats[-32], mats[-1]
    sub = {32: A, -32: F, -1: F2}
    xs = {}

    def x_of(B):
        if B not in xs:
            xs[B] = random_on_card(f, (32, B), dev, seed=SEED + B)
        return xs[B]

    def stack(NT, seed):
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + seed)
        return torch.randint(0, 128, (NT, E * 32, D * 32), generator=gen,
                             device=dev, dtype=torch.int8)

    def K2(label, B, NT, T3=None):
        return (label, "fused_level_stack", x_of(B),
                {"As": stack(NT, NT), "rep": B // NT, "F": F, "T3": T3})

    def K3(label, B, shape, rep):
        T = random_on_card(f, shape, dev, seed=SEED + rep)
        return (label, "fused_subntt", x_of(B),
                {"inverse": False, "mats": sub, "T3": T, "rep": rep})

    if not big:
        return [K2("K2 [8,32,256] stack 2 rep 128", 256, 2),
                K2("K2 [8,32,512] stack 2 rep 256 periodic T3 s0 128", 512, 2,
                   random_on_card(f, (32, 128), dev, seed=SEED + 3)),
                K2("K2 [8,32,384] stack 3 rep 128 T3", 384, 3,
                   random_on_card(f, (32, 384), dev, seed=SEED + 4)),
                K3("K3 [8,32,300] rep 1", 300, (32, 300), 1),
                K3("K3 [8,32,1000] rep 4", 1000, (250, 32), 4),
                ("K4 [8,32,130] T3", "fused_level", x_of(130),
                 {"A": A, "T3": random_on_card(f, (32, 130), dev),
                  "transpose_out": False, "F": F, "F2": F2}),
                ("K1 [8,32,129]", "base_ntt_mxu", x_of(129),
                 {"A": A, "F": F})]
    cases = []
    for label, kind, B, arg in tc_knockout.BIG_SHAPES:
        cases.append(K2(label, B, arg) if kind == "stack" else
                     K3(label, B, *arg))
    cases += [K2("K2 2^20 level 0 [8,32,2^15] stack 32 rep 1024", 1 << 15,
                 32),
              K3("K3 2^20 level 1 [8,32,2^15] merged table rep 1", 1 << 15,
                 (32, 1 << 15), 1),
              K2("K2 2^18 level 0 [8,32,8192] stack 32 rep 256", 8192, 32),
              K3("K3 2^18 level 1 [8,32,8192] merged table rep 1", 8192,
                 (32, 8192), 1),
              K2("K2 2^18 level 2 [8,32,8192] stack 8 rep 1024", 8192, 8),
              ("K4 [8,32,2^17] T3, direct store", "fused_level",
               x_of(1 << 17), {"A": A, "T3": random_on_card(
                   f, (32, 1 << 17), dev), "transpose_out": False,
                   "F": F, "F2": F2}),
              ("K1 [8,32,2^17]", "base_ntt_mxu", x_of(1 << 17),
               {"A": A, "F": F})]
    return cases


def check_persist(f, dev, big: bool) -> list:
    """Each of :func:`persist_cases` in the persistent form, its launch
    counted under ``<wrapper>_persist``, word-equal to the present form
    and to the plain version (whole at small shapes; on three spans of
    2048 columns with ``big``); with ``big`` both forms timed (median of
    events, and device time by the profiler) beside the launch's bound.
    Returns the rows of the ``persist`` lines."""
    from ntt_tpu_torch.kernels import _build
    kernels = path_kernels()
    rows = []
    for label, name, x, args in persist_cases(f, dev, big):
        kern, plain = kernels[name]
        call = (lambda kern=kern, x=x, kw=args: kern(x, f, **kw))
        y = {}
        for which in ("persist", "present"):
            with level_form(which):
                _build.launches.clear()
                y[which] = call()
                torch.cuda.synchronize()
                got = dict(_build.launches)
            want = {f"{name}_persist" if which == "persist" else name: 1}
            if got != want:
                raise AssertionError(f"{label}: {which} form launched {got}")
        if not torch.equal(y["persist"], y["present"]):
            raise AssertionError(f"{label}: persistent form != present form")
        B = x.shape[2]
        L = min(B, 2048) if big else B
        for a in sorted({0, B // 2 // L * L, B - L}):
            want = plain(x[:, :, a:a + L].contiguous(), f,
                         **span_args(name, args, a, L))
            if not torch.equal(y["persist"][:, :, a:a + L], want):
                raise AssertionError(f"{label}: persistent form != plain, "
                                     f"columns {a}..{a + L - 1}")
        del y
        line = f"persist {label}: word-equal to the present form and plain"
        if not big:
            rows.append({"what": label})
            continue
        row = {"what": label}
        for which in ("present", "persist"):
            key = (PERSIST_NAMES if which == "persist" else
                   PRESENT_NAMES)[name]
            with level_form(which):
                row[which] = (time_ms(call, iters=5, warmup=1),
                              kernel_device_ms(call, key, iters=5))
        T3 = args.get("T3")
        nbytes = 2 * x.numel() * 4 + (0 if T3 is None else T3.numel() * 4)
        mads = 0 if T3 is None else mont_mul_mads(f) * x.shape[1] * B
        A0 = args["As"][0] if "As" in args else (
            args["A"] if "A" in args else args["mats"][32])
        nbytes += args["As"].numel() if "As" in args else A0.numel()
        row["bound"] = bound(nbytes, conv_macs(f, A0, B), mads)
        rows.append(row)

        def show(v):
            return "-" if v is None else f"{v:.4f}"
        print(f"{line}; present {show(row['present'][0])} ms "
              f"(device {show(row['present'][1])}), persistent "
              f"{show(row['persist'][0])} ms (device "
              f"{show(row['persist'][1])}), bound {row['bound'][0]:.4f} ms "
              f"({row['bound'][1]})", flush=True)
        torch.cuda.empty_cache()
    if not big:
        print(f"small shapes {f.name}: {len(rows)} persistent-form calls "
              "word-equal to the present form and the plain versions",
              flush=True)
    return rows


def random_stack(f, NT, m, rng, dev):
    """A random conv-matrix stack int8[NT, E*m, D*m] that K2 takes: any
    digits for a wide field (every digit matrix is within the folded
    reduction's window), random twiddles for a narrow one (a banded stack
    must hold entries below p)."""
    from ntt_tpu_torch import digits
    from ntt_tpu_torch.transforms import mxu
    if digits.fold_active(f):
        D, E = digits.n_digits(f), digits.out_planes(f)
        return torch.from_numpy(rng.integers(
            0, 128, size=(NT, E * m, D * m), dtype=np.int8)).to(dev)
    tvals = [[int(v) % f.p for v in rng.integers(1, 1 << 62, size=m)]
             for _ in range(NT)]
    return torch.from_numpy(
        mxu.twiddle_matrix_stack(f, m, False, tvals)).to(dev)


#: the SMs that K1's short-form checks at small shapes plan for besides
#: the card's own: spans of two and more tiles a block at a few thousand
#: columns
SHORT_CHECK_SMS = 4


def short_base_batches(sms: int) -> tuple:
    """Batch sizes that cross the edges of K1's short form planned for
    ``sms`` SMs (S = 2 * sms blocks a wave): its 128-column tile (1, 37,
    127, 128, 129) and two tiles (255, 256, 257); one wave of blocks of
    one tile and of two tiles, each one column short (the last tile
    ragged) and over (the span grows, the last block holds one column);
    and a ragged size of several tiles a block."""
    from ntt_tpu_torch.kernels import mxu_level
    N, S = mxu_level.TC_COLS, mxu_level.TC_SHORT_BLOCKS * sms
    return (1, 37, N - 1, N, N + 1, 2 * N - 1, 2 * N, 2 * N + 1,
            S * N - 1, S * N + 1, 2 * S * N - 1, 2 * S * N + 1,
            5 * S * N + 3 * N + 77)


def short_base_at(x, f, A, sms: int) -> torch.Tensor:
    """K1's short form on x under its plan for ``sms`` SMs, through the C
    entry point (the wrapper plans for the card's SMs); not counted."""
    from ntt_tpu_torch.kernels import _build, mxu_level
    W, m, B = x.shape
    out = torch.empty_like(x)
    rc = mxu_level._lib().mxu_base_ntt(
        _build.ptr(x), _build.ptr(A), _build.ptr(out), m, B,
        *_build.field_args(f), *mxu_level.base_plan_args(f, m, B, sms),
        _build.stream(x))
    _build.check(rc, "base_ntt_mxu, short form")
    return out


def check_small_shapes(f, rng, dev) -> int:
    """K1-K3 (single-level) against their plain versions at every m from 2
    to 64 (at 64 the digit tile streamed in two passes), with ragged batch
    sizes (masked columns), reps that split a warp between stack entries,
    both twiddle layouts and K2's periodic T3; K1 in its short form at
    every m that takes it, at the batch sizes of
    :func:`short_base_batches` for ``SHORT_CHECK_SMS``, under the card's
    plan (the wrapper) and under the plan for that many SMs. Returns the
    number of checks."""
    from ntt_tpu_torch.kernels import _build, mxu_level, mxu_ntt

    def rand(*shape):
        return torch.from_numpy(random_words(f, shape, rng)).to(dev)

    def same(label, got, want):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{f.name} {label}: kernel != plain")

    checks = 0
    for m in (2, 4, 8, 16, 32, 64):
        mats = sub_mats_on(f, {m}, False, dev)
        for B in (1, 37, 300):
            x, T = rand(m, B), rand(m, B)
            same(f"base m={m} B={B}",
                 mxu_ntt.base_ntt_mxu(x, f, mats[m], mats.get(-m)),
                 mxu_ntt.base_ntt_mxu_plain(x, f, mats[m], mats.get(-m)))
            same(f"subntt m={m} B={B}",
                 mxu_level.fused_subntt(x, f, False, mats, T),
                 mxu_level.fused_subntt_plain(x, f, False, mats, T))
            checks += 2
        for n2, rep in ((4, 8), (2, 128)):
            x, T = rand(m, n2 * rep), rand(n2, m)
            same(f"subntt m={m} rep={rep}",
                 mxu_level.fused_subntt(x, f, False, mats, T, rep=rep),
                 mxu_level.fused_subntt_plain(x, f, False, mats, T,
                                              rep=rep))
            checks += 1
        for NT, rep in ((3, 16), (4, 7), (3, 100)):
            x, T = rand(m, NT * rep), rand(m, NT * rep)
            As = random_stack(f, NT, m, rng, dev)
            for T3 in (None, T):
                same(f"stack m={m} NT={NT} rep={rep} T3={T3 is not None}",
                     mxu_level.fused_level_stack(x, f, As, rep, mats.get(-m),
                                                 T3),
                     mxu_level.fused_level_stack_plain(x, f, As, rep,
                                                       mats.get(-m), T3))
                checks += 1
            # a periodic T3 [W, m, s0], read at column b mod s0
            B = NT * rep
            for s0 in (s for s in (1, 4, 16, 64) if B % s == 0):
                T3 = rand(m, s0)
                same(f"stack m={m} NT={NT} rep={rep} periodic T3 s0={s0}",
                     mxu_level.fused_level_stack(x, f, As, rep, mats.get(-m),
                                                 T3),
                     mxu_level.fused_level_stack_plain(x, f, As, rep,
                                                       mats.get(-m), T3))
                checks += 1
    for m in (m for m in (2, 4, 8, 16) if mxu_level.short_form(f, m)):
        mats = sub_mats_on(f, {m}, False, dev)
        for B in short_base_batches(SHORT_CHECK_SMS):
            x = rand(m, B)
            want = mxu_ntt.base_ntt_mxu_plain(x, f, mats[m], mats.get(-m))
            same(f"short base m={m} B={B} plan "
                 f"{mxu_level.base_plan(f, m, B, SHORT_CHECK_SMS)}",
                 short_base_at(x, f, mats[m], SHORT_CHECK_SMS), want)
            same(f"short base m={m} B={B} plan "
                 f"{mxu_level.base_plan(f, m, B, _build.sm_count(dev))}",
                 mxu_ntt.base_ntt_mxu(x, f, mats[m], mats.get(-m)), want)
            checks += 2
    return checks


def check_small_multi(f, ms, rng, dev) -> int:
    """K3 multi-level against its plain version for every m in ``ms``:
    B in {1, 37, 300}, no twiddle and rep 1; rep 25 at B = 300 (a rep that
    divides no block's columns) and rep 128 at B = 512; forward and
    inverse. Returns the number of checks."""
    from ntt_tpu_torch.kernels import mxu_level

    def rand(*shape):
        return torch.from_numpy(random_words(f, shape, rng)).to(dev)

    checks = 0
    for inverse in (False, True):
        for m in ms:
            mats = sub_mats_on(f, {32, m // 32}, inverse, dev)
            todo = [(B, tw) for B in (1, 37, 300) for tw in (None, 1)]
            todo += [(300, 25), (512, 128)]
            for B, tw in todo:
                x = rand(m, B)
                rep = tw or 1
                T3 = None
                if tw is not None:
                    T3 = rand(m, B) if rep == 1 else rand(B // rep, m)
                got = mxu_level.fused_subntt(x, f, inverse, mats, T3,
                                             rep=rep)
                torch.cuda.synchronize()
                want = mxu_level.fused_subntt_plain(x, f, inverse, mats, T3,
                                                    rep=rep)
                if not torch.equal(got, want):
                    bad = int((got != want).any(dim=0).sum())
                    raise AssertionError(
                        f"{f.name} multi m={m} B={B} tw={tw} "
                        f"inverse={inverse}: kernel != plain at {bad} "
                        f"of {m * B} elements")
                checks += 1
    return checks


#: the SMs that the wide multi-level K3's checks at small shapes plan for
#: besides the card's own: spans of several tiles at a few thousand columns
WIDE_CHECK_SMS = 4


def wide_batches(f, m, sms: int) -> tuple:
    """Batch sizes that cross the edges of the wide multi-level K3 planned
    for ``sms`` SMs (P = sms / chunks spans a wave): its column tile of bt
    = 128 / m2 columns (1, bt - 1, bt, bt + 1, 2 bt + 1); one wave of spans
    of one tile and of two, each one column short (the last tile ragged),
    exact and over (the span grows, the last block holds one column); and
    a ragged size of several tiles a block. The sizes at the positions 2,
    5, 8 (the twiddle at rep > 1 in :func:`check_small_wide`) are even
    but for P * bt - 1."""
    from ntt_tpu_torch.kernels import mxu_level
    p = mxu_level.sub_wide_plan(f, m, 1, sms)
    bt, P = p.bt, max(1, sms // p.chunks)
    return (1, bt - 1, bt, bt + 1, 2 * bt + 1, P * bt - 1, P * bt + 1,
            2 * P * bt - 1, 2 * P * bt, 2 * P * bt + 1,
            5 * P * bt + 3 * bt + 7)


def sub_wide_at(x, f, mats, T3, rep, inverse, sms: int,
                transpose_out: bool = False) -> torch.Tensor:
    """The wide multi-level K3 on x under its plan for ``sms`` SMs, through
    the C entry point (the wrapper plans for the card's SMs, and takes the
    wide form only above one wave); not counted."""
    from ntt_tpu_torch.kernels import _build, mxu_level
    W, m, B = x.shape
    Tin = mxu_level.inner_twiddle(f, m, inverse, x.device)
    out = mxu_level._output(x, transpose_out)
    rc = mxu_level._lib_sub().mxu_fused_subntt_wide(
        _build.ptr(x), _build.ptr(mats[32]), _build.ptr(mats[m // 32]),
        _build.ptr(Tin), _build.ptr(T3), rep, _build.ptr(out),
        int(transpose_out), m, B, *_build.field_args(f),
        *mxu_level.sub_wide_args(f, m, B, sms), _build.stream(x))
    _build.check(rc, "fused_subntt_wide")
    return out


def sub_multi_at(x, f, mats, T3, rep, inverse,
                 transpose_out: bool = False) -> torch.Tensor:
    """The present form of the multi-level K3 on x through its C entry
    point (the wrapper takes the wide form above one wave of its blocks on
    the narrow fields); not counted."""
    from ntt_tpu_torch.kernels import _build, mxu_level
    W, m, B = x.shape
    Tin = mxu_level.inner_twiddle(f, m, inverse, x.device)
    out = mxu_level._output(x, transpose_out)
    rc = mxu_level._lib_sub().mxu_fused_subntt_multi(
        _build.ptr(x), _build.ptr(mats[32]), _build.ptr(mats[m // 32]),
        _build.ptr(Tin), _build.ptr(T3), rep, _build.ptr(out),
        int(transpose_out), m, B, *_build.field_args(f),
        *mxu_level.sub_plan_args(f, m, B), _build.stream(x))
    _build.check(rc, "fused_subntt_multi")
    return out


def check_small_wide(f, rng, dev) -> int:
    """The wide multi-level K3 against its plain version at every m from 64
    to 512, forward and inverse, at the batch sizes of :func:`wide_batches`
    for ``WIDE_CHECK_SMS`` SMs (through the C entry under that plan) and
    for the card's (through the wrapper, its wide launch counted, at the
    sizes where it takes the wide form), the twiddle taken in turn as
    none, T3 at rep 1 and the i2-resolution table at rep > 1 (the largest
    power of two up to 64 that divides B). Returns the number of
    checks."""
    from ntt_tpu_torch.kernels import _build, mxu_level

    def rand(*shape):
        return torch.from_numpy(random_words(f, shape, rng)).to(dev)

    card = _build.sm_count(dev)
    checks = 0
    for inverse in (False, True):
        for m in (64, 128, 256, 512):
            mats = sub_mats_on(f, {32, m // 32}, inverse, dev)
            for sms in (WIDE_CHECK_SMS, card):
                for i, B in enumerate(wide_batches(f, m, sms)):
                    if sms == card and not mxu_level.sub_wide(f, m, B, card):
                        continue
                    rep = min(B & -B, 64) if i % 3 == 2 else 1
                    x, T3 = rand(m, B), None
                    if i % 3 and rep == 1:
                        T3 = rand(m, B)
                    elif i % 3:
                        T3 = rand(B // rep, m)
                    if sms == card:
                        got, c = counted(lambda: mxu_level.fused_subntt(
                            x, f, inverse, mats, T3, rep=rep))
                        expect_counts(f"{f.name} wide m={m} B={B}", c,
                                      {"fused_subntt_wide": 1})
                    else:
                        got = sub_wide_at(x, f, mats, T3, rep, inverse, sms)
                    torch.cuda.synchronize()
                    want = mxu_level.fused_subntt_plain(
                        x, f, inverse, mats, T3, rep=rep)
                    if not torch.equal(got, want):
                        bad = int((got != want).any(dim=0).sum())
                        raise AssertionError(
                            f"{f.name} wide m={m} B={B} rep={rep} "
                            f"T3={T3 is not None} inverse={inverse} plan "
                            f"{mxu_level.sub_wide_plan(f, m, B, sms)}: "
                            f"kernel != plain at {bad} of {m * B} elements")
                    checks += 1
    return checks


#: batch sizes of the m = 1024 checks at small shapes (bt = 4 columns a
#: tile): the tile and its edges (1, 3, 4, 5, 9); one wave of the wide
#: form's spans for WIDE_CHECK_SMS (4 spans: one tile each at 16 columns,
#: two at 32) one column short and over; a ragged size of several tiles a
#: span (99); and one wave of the present form's blocks on an H100 at
#: W = 1 (132 blocks of one tile: 528 columns) one column short and over
SUB1024_BATCHES = (1, 3, 4, 5, 9, 15, 17, 31, 33, 99, 527, 529)


def check_small_1024(f, rng, dev) -> int:
    """K3 at m = 1024 (two 32-point levels) against its plain version on
    ``f``, forward and inverse, at ``SUB1024_BATCHES``, the twiddle taken in
    turn as none, T3 at rep 1 and the i2-resolution table at rep > 1 (the
    largest power of two up to 64 that divides B): the present form through
    its C entry; the wide form (W = 1 only: at W = 2 the block does not
    hold it) through its C entry under the plan for ``WIDE_CHECK_SMS`` SMs;
    and the wrapper under the card's plan, its launch counted (the wide
    form where ``sub_wide``, else the present one). Returns the number of
    checks."""
    from ntt_tpu_torch.kernels import _build, mxu_level

    def rand(*shape):
        return torch.from_numpy(random_words(f, shape, rng)).to(dev)

    m, card = 1024, _build.sm_count(dev)
    checks = 0
    for inverse in (False, True):
        mats = sub_mats_on(f, {32}, inverse, dev)
        for i, B in enumerate(SUB1024_BATCHES):
            rep = min(B & -B, 64) if i % 3 == 2 else 1
            x, T3 = rand(m, B), None
            if i % 3 and rep == 1:
                T3 = rand(m, B)
            elif i % 3:
                T3 = rand(B // rep, m)
            form = ("fused_subntt_wide" if mxu_level.sub_wide(f, m, B, card)
                    else "fused_subntt_multi")
            got, c = counted(lambda: mxu_level.fused_subntt(
                x, f, inverse, mats, T3, rep=rep))
            expect_counts(f"{f.name} m=1024 B={B}", c, {form: 1})
            runs = [("wrapper, " + form, got),
                    ("present form", sub_multi_at(x, f, mats, T3, rep,
                                                  inverse))]
            if mxu_level.sub_wide_holds(f, m):
                runs.append((f"wide form, {WIDE_CHECK_SMS} SMs", sub_wide_at(
                    x, f, mats, T3, rep, inverse, WIDE_CHECK_SMS)))
            torch.cuda.synchronize()
            want = mxu_level.fused_subntt_plain(x, f, inverse, mats, T3,
                                                rep=rep)
            for what, y in runs:
                if not torch.equal(y, want):
                    bad = int((y != want).any(dim=0).sum())
                    raise AssertionError(
                        f"{f.name} m=1024 {what} B={B} rep={rep} "
                        f"T3={T3 is not None} inverse={inverse}: kernel != "
                        f"plain at {bad} of {m * B} elements")
                checks += 1
    return checks


def check_small_transposed(f, rng, dev) -> int:
    """The transposed store (``transpose_out=True``, output [W, B, m]) of
    K2, K3 single-level, K3 multi-level in its present form and, on the
    narrow fields, in its wide form, against the plain versions with the
    same flag: K2 at m = 8, 32 and 64 (two stack entries, a ragged one,
    with T3 at batch resolution and periodic); K3 single at m = 4, 32 and
    64 (no twiddle, T3 at rep 1, the table at rep 8); K3 multi at m = 64,
    512 and 1024 through the present form's C entry, the wide form's under
    the plan for ``WIDE_CHECK_SMS`` SMs where the field has it, and the
    wrapper at a width where it takes the wide form on the card (its
    launch counted); ragged batches. Returns the number of checks."""
    from ntt_tpu_torch.kernels import _build, mxu_level

    def rand(*shape):
        return torch.from_numpy(random_words(f, shape, rng)).to(dev)

    def same(label, got, want):
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"{f.name} {label}, transposed store: "
                                 "kernel != plain")

    checks = 0
    for m in (8, 32, 64):
        mats = sub_mats_on(f, {m}, False, dev)
        for NT, rep in ((2, 64), (3, 100)):
            x = rand(m, NT * rep)
            As = random_stack(f, NT, m, rng, dev)
            for T3 in (None, rand(m, NT * rep), rand(m, 4)):
                if T3 is not None and (NT * rep) % T3.shape[2]:
                    continue
                same(f"stack m={m} NT={NT} rep={rep} T3 "
                     f"{None if T3 is None else list(T3.shape)}",
                     mxu_level.fused_level_stack(x, f, As, rep, mats.get(-m),
                                                 T3, transpose_out=True),
                     mxu_level.fused_level_stack_plain(
                         x, f, As, rep, mats.get(-m), T3, transpose_out=True))
                checks += 1
    for m in (4, 32, 64):
        mats = sub_mats_on(f, {m}, False, dev)
        for B, rep, tw in ((37, 1, False), (300, 1, True), (296, 8, True)):
            x = rand(m, B)
            T3 = None if not tw else rand(m, B) if rep == 1 else rand(
                B // rep, m)
            same(f"subntt m={m} B={B} rep={rep} T3={tw}",
                 mxu_level.fused_subntt(x, f, False, mats, T3, True, rep),
                 mxu_level.fused_subntt_plain(x, f, False, mats, T3, True,
                                              rep))
            checks += 1
    wide = f.n_words in mxu_level.SUB_WIDE_WORDS
    card = _build.sm_count(dev)
    for m in (64, 512, 1024):
        for inverse in (False, True):
            mats = sub_mats_on(f, {32, m // 32}, inverse, dev)
            for B, rep, tw in ((37, 1, False), (300, 1, True),
                               (300, 25, True)):
                x = rand(m, B)
                T3 = None if not tw else rand(m, B) if rep == 1 else rand(
                    B // rep, m)
                want = mxu_level.fused_subntt_plain(x, f, inverse, mats, T3,
                                                    True, rep)
                label = f"multi m={m} B={B} rep={rep} inverse={inverse}"
                same(label + " present form",
                     sub_multi_at(x, f, mats, T3, rep, inverse, True), want)
                checks += 1
                if mxu_level.sub_wide_holds(f, m):
                    same(label + " wide form", sub_wide_at(
                        x, f, mats, T3, rep, inverse, WIDE_CHECK_SMS, True),
                        want)
                    checks += 1
            if wide and m != 64:
                # a launch above one wave, where the wrapper takes the wide
                # form on the narrow fields (else the present one)
                B = 2 * card * mxu_level.TC_COLS // (m // 32) + 3
                x, T3 = rand(m, B), rand(m, B)
                form = ("fused_subntt_wide" if mxu_level.sub_wide(
                    f, m, B, card) else "fused_subntt_multi")
                got, c = counted(lambda: mxu_level.fused_subntt(
                    x, f, inverse, mats, T3, True))
                expect_counts(f"{f.name} transposed m={m} B={B}", c,
                              {form: 1})
                same(f"multi m={m} B={B} wrapper, {form}", got,
                     mxu_level.fused_subntt_plain(x, f, inverse, mats, T3,
                                                  True))
                checks += 1
    return checks


def check_small_level(f, rng, dev) -> int:
    """K4 and every stage of K7 against their plain versions at every m
    from 2 to 64: ragged batch sizes, with and without T3, both store
    orders, forward and inverse matrices. Returns the number of checks."""
    from ntt_tpu_torch.kernels import mxu_level

    def rand(*shape):
        return torch.from_numpy(random_words(f, shape, rng)).to(dev)

    checks = 0
    for inverse in (False, True):
        for m in (2, 4, 8, 16, 32, 64):
            mats = sub_mats_on(f, {m}, inverse, dev)
            A, F, F2 = mats[m], mats.get(-m), mats.get(-1)
            for B in (1, 37, 300):
                x, T = rand(m, B), rand(m, B)
                for T3 in (None, T):
                    for tr in (False, True):
                        got = mxu_level.fused_level(x, f, A, T3, tr, F, F2)
                        torch.cuda.synchronize()
                        want = mxu_level.fused_level_plain(x, f, A, T3, tr,
                                                           F, F2)
                        if not torch.equal(got, want):
                            raise AssertionError(
                                f"{f.name} fused_level m={m} B={B} "
                                f"T3={T3 is not None} transpose={tr} "
                                f"inverse={inverse}: kernel != plain")
                        checks += 1
                if inverse or B == 1:
                    continue
                for stage in mxu_level.PROBE_STAGES:
                    T3 = T if stage == "tw" else None
                    got = mxu_level.fused_level_probe(x, f, A, stage, T3)
                    torch.cuda.synchronize()
                    want = mxu_level.fused_level_probe_plain(x, f, A, stage,
                                                             T3)
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"{f.name} fused_level_probe {stage} m={m} "
                            f"B={B}: kernel != plain")
                    checks += 1
    return checks


def check_small_stages(f, rng, dev) -> int:
    """K5 and K6 against their plain versions at every m the kernels take
    (2 to 256; to 128 on the 256-bit fields, twice what their transforms
    use): ragged batch sizes, with and without T3, both store orders,
    forward and inverse; and, forward, at B one column short of the
    plan's column tile and at B = 4097 and 8193, ragged against every
    tile width (K5, K6 with T3 and the transposed store, K6 without T3,
    direct). Returns the number of checks."""
    from ntt_tpu_torch.kernels import vmem_ntt

    def rand(*shape):
        return torch.from_numpy(random_words(f, shape, rng)).to(dev)

    def check(what, got, want):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{f.name} {what}: kernel != plain")

    checks = 0
    top = 128 if f.n_words >= 8 else vmem_ntt.MAX_M
    for inverse in (False, True):
        m = 2
        while m <= top:
            for B in (1, 37, 300):
                x, T = rand(m, B), rand(m, B)
                check(f"stage_ntt m={m} B={B} inverse={inverse}",
                      vmem_ntt.stage_ntt(x, f, inverse),
                      vmem_ntt.stage_ntt_plain(x, f, inverse))
                checks += 1
                for T3 in (None, T):
                    for tr in (False, True):
                        check(f"fused_stage_level m={m} B={B} "
                              f"T3={T3 is not None} transpose={tr} "
                              f"inverse={inverse}",
                              vmem_ntt.fused_stage_level(x, f, inverse, T3,
                                                         tr),
                              vmem_ntt.fused_stage_level_plain(
                                  x, f, inverse, T3, tr))
                        checks += 1
            m *= 2
    m = 2
    while m <= top:
        bt = vmem_ntt.stage_plan(f.n_words, m, 1).bt
        for B in sorted({max(1, bt - 1), 4097, 8193}):
            x, T = rand(m, B), rand(m, B)
            check(f"stage_ntt m={m} B={B}", vmem_ntt.stage_ntt(x, f),
                  vmem_ntt.stage_ntt_plain(x, f))
            for T3, tr in ((T, True), (None, False)):
                check(f"fused_stage_level m={m} B={B} T3={T3 is not None} "
                      f"transpose={tr}",
                      vmem_ntt.fused_stage_level(x, f, False, T3, tr),
                      vmem_ntt.fused_stage_level_plain(x, f, False, T3, tr))
            checks += 3
            del x, T
        m *= 2
    return checks


def random_shards(W, D, n1, n2_loc, rng, devs, aligned=True) -> list:
    """D random uint32[W, n1, n2_loc] shards, shard d on devs[d %
    len(devs)]; with ``aligned`` False each one starts 4 bytes past a
    16-byte boundary."""
    out = []
    for d in range(D):
        dev = devs[d % len(devs)]
        host = torch.from_numpy(rng.integers(
            0, 1 << 32, size=(W, n1, n2_loc), dtype=np.uint64).astype(
                np.uint32))
        if aligned:
            out.append(host.to(dev))
        else:
            buf = torch.empty(host.numel() + 1, dtype=torch.uint32,
                              device=dev)
            t = buf[1:].view(W, n1, n2_loc)
            t.copy_(host)
            out.append(t)
    return out


def check_small_exchange(rng, devs) -> int:
    """K8 against its plain version at small shapes on the devices
    ``devs`` (shard d on devs[d % len(devs)]): D in {2, 4, 8}, W in
    {1, 2, 8}, n2_loc a multiple of 4 (16-byte moves) and not (word
    moves), and shards that are not 16-byte aligned. Returns the number of
    checks."""
    from ntt_tpu_torch.kernels import exchange

    checks = 0
    for D in (2, 4, 8):
        for W in (1, 2, 8):
            for n1, n2_loc, aligned in ((4 * D, 64, True), (2 * D, 5, True),
                                        (3 * D, 36, False)):
                shards = random_shards(W, D, n1, n2_loc, rng, devs, aligned)
                got = exchange.a2a_transpose(shards, D)
                torch.cuda.synchronize()
                want = exchange.a2a_transpose_plain(shards, D)
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise AssertionError(
                        f"a2a_transpose D={D} W={W} n1={n1} n2_loc={n2_loc} "
                        f"aligned={aligned} on {len(set(map(str, devs)))} "
                        "card(s): kernel != plain")
                checks += 1
    return checks


def library_device_ms(fn, iters: int = 10):
    """Device time of one call of a library call ``fn`` (every kernel it
    runs, summed), the larger of two traces: a trace that lost some calls'
    events divides what it kept by the calls it counts, so it can only
    read low (seen: half the time of an ``_int_mm`` call whose events
    read twice that). None where neither trace shows device time."""
    got = [ms for ms in (kernel_device_ms(fn, None, iters),
                         kernel_device_ms(fn, None, iters)) if ms is not None]
    return max(got) if got else None


def kernel_device_ms(fn, key=None, iters: int = 10):
    """Average device time from ``torch.profiler`` over ``iters`` calls of
    ``fn``: of one launch of the kernel whose name holds ``key``, or, with
    no key, of one call (every kernel it runs, summed: for a library call
    such as ``torch._int_mm``). None where the tracer shows no device
    time."""
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.count
                and e.self_device_time_total > 0]
        if key is None:
            # per call: a trace that lost some calls' events (seen: one of
            # ten) keeps the count of those it holds
            total = sum(e.self_device_time_total for e in rows)
            calls = max((e.count for e in rows), default=0)
            return total / 1e3 / min(calls, iters) if total > 0 else None
        for e in rows:
            if key in e.key:
                return e.self_device_time_total / 1e3 / e.count
    except Exception as e:      # the tracer is optional tooling
        print(f"profiler unavailable ({type(e).__name__}: {e})", flush=True)
    return None


def check_exchange(rng, dev, results) -> None:
    """K8 at the main path's shapes (BLS12-381 Fr 2^22 on D = 4 shards of
    one card: uint32[8, 2048, 512] a shard) against its plain version,
    word for word, then timed per launch (events around the call of four
    launches, and device time from the profiler) beside its bound, its
    plain version and one PyTorch call that computes the same exchange,
    ``permute().contiguous()`` of the stacked shards."""
    from ntt_tpu_torch.kernels import exchange

    D, W, n1, n2_loc = 4, 8, 2048, 512
    n1_loc = n1 // D
    shards = random_shards(W, D, n1, n2_loc, rng, [dev])
    got = exchange.a2a_transpose(shards, D)
    torch.cuda.synchronize()
    want = exchange.a2a_transpose_plain(shards, D)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("a2a_transpose [8,2048,512] x 4: kernel != plain")
    stacked = torch.stack(shards)                   # [s, W, n1, n2_loc]

    def library():
        return stacked.view(D, W, D, n1_loc, n2_loc).permute(
            2, 1, 3, 0, 4).contiguous()              # [t, W, n1_loc, s, n2]
    if not torch.equal(library().view(D, W, n1_loc, D * n2_loc),
                       torch.stack(got)):
        raise AssertionError("permute().contiguous() != the exchange")
    del got, want
    ms = time_ms(lambda: exchange.a2a_transpose(shards, D))
    plain_ms = time_ms(lambda: exchange.a2a_transpose_plain(shards, D))
    lib_ms = time_ms(library)
    dev_ms = kernel_device_ms(lambda: exchange.a2a_transpose(shards, D),
                              "a2a_pull_kernel")
    lib_dev = library_device_ms(library)
    nbytes = 2 * W * n1 * n2_loc * 4                 # one launch
    b_ms, b_by = bound(nbytes, 0)
    print(f"check a2a_transpose     [8,2048,512] x 4 (bls 2^22 dist)         "
          f"word-equal  {ms:.4f} ms a call of {D} launches "
          f"({ms / D:.4f} a launch; device time "
          f"{'-' if dev_ms is None else f'{dev_ms:.4f}'} ms a launch)  "
          f"plain {plain_ms:.4f} ms  permute().contiguous() {lib_ms:.4f} ms"
          f" (device {'-' if lib_dev is None else f'{lib_dev:.4f}'} ms)"
          f"  bound {b_ms:.4f} ms a launch ({b_by})", flush=True)
    call = {"shape": "[8,2048,512] x 4, one launch", "ms": ms / D,
            "device_ms": dev_ms,
            "library_device_ms": None if lib_dev is None else lib_dev / D,
            "plain_ms": plain_ms / D,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms / D,
            "max_abs_err": 0, "bytes": nbytes, "int8_macs": 0,
            "int32_mads": 0, "path_launches": D}
    results["a2a_transpose"] = {"calls": [call], "path": [call] * D}


# ---------------------------------------------------------------------------
# Golden results from the hostlib (standard form in and out, word planes)
# ---------------------------------------------------------------------------

def golden_ntt(f, x, inverse=False) -> np.ndarray:
    from ntt_tpu_torch import hostlib
    return hostlib.host_planes(
        hostlib.ntt_np(hostlib.planes_to_rows(x), f, inverse=inverse),
        f.n_words)


def golden_mul(f, a, b) -> np.ndarray:
    from ntt_tpu_torch import hostlib
    return hostlib.host_planes(hostlib.mul_mod_vec_np(
        hostlib.planes_to_rows(a), hostlib.planes_to_rows(b), f), f.n_words)


def golden_coset_ntt(f, x, shift) -> np.ndarray:
    from ntt_tpu_torch import hostlib
    pw = hostlib.powers_np(shift, x.shape[1], f)
    return golden_ntt(f, golden_mul(f, x, pw))


def golden_lde(f, x, blowup) -> np.ndarray:
    """The low-degree extension of the evaluations x: their coefficients,
    zero-padded to blowup * n, evaluated on the coset of the generator."""
    coeffs = golden_ntt(f, x, inverse=True)
    zeros = np.zeros((f.n_words, (blowup - 1) * x.shape[1]), dtype=np.uint32)
    return golden_coset_ntt(f, np.concatenate([coeffs, zeros], axis=1),
                            f.generator)


def same_words(what, got, want) -> None:
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    if got.shape != want.shape or not np.array_equal(got, want):
        bad = int((got != want).any(axis=0).sum()) if got.shape == want.shape \
            else -1
        raise AssertionError(f"{what}: {bad} positions differ from golden")


def verify(f, y_mont, x_std_planes) -> None:
    """Every output word of a forward transform against the golden NTT."""
    from ntt_tpu_torch import limbs
    same_words(f.name, limbs.from_mont(y_mont, f),
               golden_ntt(f, x_std_planes))


def counted(fn, seen=None) -> tuple:
    """(fn(), launch counts of that call's transform kernels: the pass
    kernels' launches, held by :func:`check_passes`, are left out); with a
    dict ``seen``, the call's K1-K3 launches recorded into it as well
    (:func:`recording`)."""
    from ntt_tpu_torch.kernels import _build
    torch.cuda.synchronize()
    _build.launches.clear()
    with recording(seen) if seen is not None else contextlib.nullcontext():
        out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in _build.launches.items()
                 if k not in PASS_KEYS}


def path_kernels() -> dict:
    """The kernel wrappers the digit-matmul drivers call (by their names
    in ``ntt_tpu_torch.transforms.mxu``: K1, K2, K3 and ``mxu_fused``'s
    K4) with their plain versions, which take the same arguments."""
    from ntt_tpu_torch.kernels import mxu_level, mxu_ntt
    return {"fused_level_stack": (mxu_level.fused_level_stack,
                                  mxu_level.fused_level_stack_plain),
            "fused_subntt": (mxu_level.fused_subntt,
                             mxu_level.fused_subntt_plain),
            "base_ntt_mxu": (mxu_ntt.base_ntt_mxu, mxu_ntt.base_ntt_mxu_plain),
            "fused_level": (mxu_level.fused_level,
                            mxu_level.fused_level_plain)}


def _on(v, dev):
    """A tensor, or the tensors of a dict of them, moved to ``dev``."""
    if isinstance(v, torch.Tensor):
        return v.to(dev)
    if isinstance(v, dict):
        return {k: _on(t, dev) for k, t in v.items()}
    return v


@contextlib.contextmanager
def recording(seen: dict):
    """While the block runs, the first call of each distinct K1-K4
    launch of the digit-matmul drivers goes into ``seen``: keyed by the kernel,
    the field, the operand shapes and the other arguments; kept as the
    kernel's name, the input's shape and the other arguments, their
    tensors copied to the host (so that no table stays on the card)."""
    import inspect

    from ntt_tpu_torch.transforms import mxu as drivers
    kept = {name: getattr(drivers, name) for name in path_kernels()}

    def wrap(name, kern):
        sig = inspect.signature(kern)

        def call(*args, **kw):
            a = dict(sig.bind(*args, **kw).arguments)
            x = a.pop(next(iter(sig.parameters)))
            key = (name, tuple(x.shape)) + tuple(
                (k, tuple(v.shape) if isinstance(v, torch.Tensor) else
                 tuple(sorted(v)) if isinstance(v, dict) else
                 getattr(v, "name", v)) for k, v in a.items())
            if key not in seen:
                seen[key] = (name, tuple(x.shape), _on(a, "cpu"))
            return kern(*args, **kw)
        return call

    for name, kern in kept.items():
        setattr(drivers, name, wrap(name, kern))
    try:
        yield
    finally:
        for name, kern in kept.items():
            setattr(drivers, name, kern)


def span_args(name, args, a, L) -> dict:
    """The arguments of the plain version of kernel ``name`` on columns
    a .. a+L-1 of the launch (L a power of two, a a multiple of it): the
    stack entries those columns use (one, cut to L columns, where an entry
    spans more), and the columns or rows of the twiddle they read."""
    out = dict(args)
    T3, rep = args.get("T3"), args.get("rep", 1)
    if name == "fused_level_stack":
        As = args["As"]
        out["As"], out["rep"] = ((As[a // rep:][:1], L) if rep >= L
                                 else (As[a // rep:(a + L) // rep], rep))
        if T3 is not None and T3.shape[2] > L:      # else L is its periods
            s = a % T3.shape[2]
            out["T3"] = T3[:, :, s:s + L].contiguous()
    elif T3 is not None and rep == 1:
        out["T3"] = T3[:, :, a:a + L].contiguous()
    elif T3 is not None:        # the i2-resolution table, row b // rep
        out["T3"], out["rep"] = ((T3[:, a // rep:][:, :1].contiguous(), L)
                                 if rep >= L else
                                 (T3[:, a // rep:(a + L) // rep].contiguous(),
                                  rep))
    return out


#: the largest digit operand (bytes) on which a launch's library call,
#: ``torch._int_mm``, is timed (it faults at 2^25 columns)
LIB_DIGIT_BYTES = 1 << 30


def launch_cost(name, f, shape, args) -> tuple:
    """(bytes, int8 MACs, 32-bit multiply-adds) of one K1-K4 or K7 launch
    with its recorded arguments: the data read and written once, its
    matrices (a stack's every entry) and twiddle table read once; the
    digit matmuls' MACs (the multi-level K3's two levels; none for K7's
    ``stream`` and ``digits``) and a Montgomery product an element for the
    twiddle (the multi-level K3's inner one too)."""
    from ntt_tpu_torch.kernels import mxu_level
    W, m, B = shape
    nbytes = 2 * W * m * B * 4
    T3 = args.get("T3")
    mads = 0 if T3 is None else mont_mul_mads(f) * m * B
    if T3 is not None:
        nbytes += T3.numel() * 4
    if name == "fused_level_stack":
        As = args["As"]
        return nbytes + As.numel(), conv_macs(f, As[0], B), mads
    if args.get("stage") in ("stream", "digits"):
        return nbytes, 0, 0
    mats = args.get("mats") or {m: args["A"]}
    if mxu_level.single_level(m, mats):
        A = mats[m]
        return nbytes + A.numel(), conv_macs(f, A, B), mads
    A1, A2 = mats[32], mats[m // 32]
    return (nbytes + A1.numel() + A2.numel(),
            conv_macs(f, A1, B * (m // 32)) + conv_macs(f, A2, B * 32),
            mads + mont_mul_mads(f) * m * B)


def check_path_launches(seen, dev, cols: int = 1 << 21,
                        timed: bool = False) -> None:
    """Each launch recorded on a path (:func:`recording`), again at its
    own shape with the path's own tables, on random input: three spans of
    output columns (``cols`` / m each) against the plain version on those
    columns, which over the whole width would need tens of GB of digit
    planes; then, when ``timed``, the launch timed (median of 3 by events)
    beside its bound (:func:`launch_cost`) and, for a single-level launch
    whose digit operand is at most ``LIB_DIGIT_BYTES``, ``torch._int_mm``
    on it (a stack level: one entry over all columns). Off the main path:
    not counted in the ``kernels`` line. K4's transposed output [W, B, m]
    is compared at rows a .. a+L-1."""
    from ntt_tpu_torch import digits
    from ntt_tpu_torch.kernels import mxu_level
    kernels = path_kernels()
    for name, shape, args in seen.values():
        kern, plain = kernels[name]
        args = _on(args, dev)
        f, (W, m, B) = args["field"], shape
        x = random_on_card(f, (m, B), dev)
        y = kern(x, **args)
        torch.cuda.synchronize()
        L = min(B, cols // m)
        spans = sorted({0, B // 2 // L * L, B - L})
        if B & (B - 1) or any(a % L for a in spans):
            raise AssertionError(f"{name} [{W},{m},{B}]: spans not aligned")
        rows = name == "fused_level" and args.get("transpose_out", True)
        for a in spans:
            want = plain(x[:, :, a:a + L].contiguous(),
                         **span_args(name, args, a, L))
            got = y[:, a:a + L] if rows else y[:, :, a:a + L]
            if not torch.equal(got, want):
                raise AssertionError(f"{name} {f.name} [{W},{m},{B}], "
                                     f"columns {a}..{a + L - 1}: kernel != "
                                     "plain")
        del y
        T3 = args.get("T3")
        line = (f"check {name:18s} path launch {f.name} [{W},{m},{B}]"
                + ("" if "rep" not in args else f" rep {args['rep']}")
                + ("" if T3 is None else f" T3 {list(T3.shape)}")
                + (" inverse" if args.get("inverse") else "")
                + (" transposed store" if rows else "")
                + f"  word-equal on {len(spans)} spans of {L} columns")
        if not timed:
            print(line, flush=True)
            del x, args
            torch.cuda.empty_cache()
            continue
        ms = time_ms(lambda: kern(x, **args), iters=3, warmup=1)
        b_ms, b_by = bound(*launch_cost(name, f, shape, args))
        D = digits.n_digits(f)
        lib = ""
        mats = args.get("mats") or {m: args.get("A")}
        if (mxu_level.single_level(m, mats)
                and D * m * B <= LIB_DIGIT_BYTES):
            A = args["As"][0] if name == "fused_level_stack" else mats[m]
            d = digits.extract_digits(x, f).reshape(D * m, B)
            lib_ms = time_ms(int_mm(A, d), iters=3, warmup=1)
            lib = f", _int_mm {lib_ms:.4f} ms"
            del d
        print(f"{line}  {ms:.4f} ms (bound {b_ms:.4f} ms, {b_by}{lib})",
              flush=True)
        del x, args
        torch.cuda.empty_cache()


def expect_counts(what, counts, want, persist=None) -> None:
    """The launch counts of a path against ``want``, by wrapper: a
    launch in the persistent form (``<wrapper>_persist``) counts as its
    wrapper's; where ``persist`` is given, that many launches took it."""
    print(f"launches {what}: {counts}", flush=True)
    by_wrapper = {}
    for k, v in counts.items():
        k = k.removesuffix("_persist")
        by_wrapper[k] = by_wrapper.get(k, 0) + v
    if by_wrapper != want:
        raise AssertionError(f"{what}: launch counts {counts} != {want}")
    took = sum(v for k, v in counts.items() if k.endswith("_persist"))
    if persist is not None and took != persist:
        raise AssertionError(f"{what}: {took} launches in the persistent "
                             f"form, not {persist}")


def wide_paths(rng, dev, run, aux, path_ms) -> dict:
    """The 256-bit path. Returns the launch counts of the 2^18 ramp
    transform."""
    from ntt_tpu_torch import BLS12_381_FR, BN254_FR, limbs
    from ntt_tpu_torch.api import (coset_ntt, get_runner, intt, ntt,
                                   ramp_mont)

    f, n = BLS12_381_FR, 1 << 18
    x = ramp_mont(f, n, device=dev)
    y, counts = counted(lambda: ntt(x, f, mont_io=True, device=dev))
    want_counts = {"base_ntt_mxu": 1, "fused_level_stack": 2,
                   "fused_subntt": 1}
    expect_counts("bls12-381-fr 2^18 forward", counts, want_counts)
    ramp = np.zeros((8, n), dtype=np.uint32)
    ramp[0] = np.arange(n, dtype=np.uint32)
    verify(f, y, ramp)
    ms = path_ms["bls12-381-fr 2^18 ramp"] = time_ms(lambda: run(x, aux))
    print(f"path bls12-381-fr 2^18 ramp    golden-equal  "
          f"{ms:.4f} ms/transform (tables resident)", flush=True)

    for f, log_n in [(BLS12_381_FR, 18), (BN254_FR, 18), (BLS12_381_FR, 14),
                     (BLS12_381_FR, 20)]:
        n = 1 << log_n
        xs = random_words(f, (n,), rng)
        xm = limbs.to_mont(torch.from_numpy(xs).to(dev), f)
        y = ntt(xm, f, mont_io=True, device=dev)
        verify(f, y, xs)
        r, a = get_runner(f, n, device=dev)
        ms = path_ms[f"{f.name} 2^{log_n} random"] = time_ms(lambda: r(xm, a))
        print(f"path {f.name} 2^{log_n} random  golden-equal  {ms:.4f} "
              f"ms/transform (tables resident)", flush=True)

    # inverse and coset on the 256-bit path
    f, n = BLS12_381_FR, 1 << 18
    xs = random_words(f, (n,), rng)
    xd = torch.from_numpy(xs).to(dev)
    y, c = counted(lambda: intt(xd, f, device=dev))
    expect_counts("bls12-381-fr 2^18 intt", c, want_counts)
    same_words("bls12-381-fr 2^18 intt", y, golden_ntt(f, xs, inverse=True))
    y, c = counted(lambda: coset_ntt(xd, f, device=dev))
    expect_counts("bls12-381-fr 2^18 coset_ntt (folded into the stack)", c,
                  want_counts)
    same_words("bls12-381-fr 2^18 coset_ntt", y,
               golden_coset_ntt(f, xs, f.generator))
    xm = limbs.to_mont(xd, f)
    for what, kw in (("intt", {"inverse": True}),
                     ("coset_ntt", {"coset_shift": f.generator})):
        r, a = get_runner(f, n, device=dev, **kw)
        ms = path_ms[f"{f.name} 2^18 {what}"] = time_ms(lambda: r(xm, a))
        print(f"path {f.name} 2^18 {what}  golden-equal  {ms:.4f} "
              f"ms/transform (Montgomery I/O, tables resident)", flush=True)
    n = 1 << 12
    xs = random_words(f, (n,), rng)
    y, c = counted(lambda: coset_ntt(torch.from_numpy(xs).to(dev), f,
                                     device=dev))
    expect_counts("bls12-381-fr 2^12 coset_ntt (coset in the first matrix)",
                  c, {"fused_subntt": 2, "base_ntt_mxu": 1})
    same_words("bls12-381-fr 2^12 coset_ntt", y,
               golden_coset_ntt(f, xs, f.generator))
    print("path bls12-381-fr 2^12 coset_ntt  golden-equal", flush=True)
    return counts


#: launches of one BLS12-381 Fr forward transform above 2^20: level 0 a
#: 32-entry stack, level 1 the merged table, the deeper levels a stack or,
#: at 2^24 level 2, a deep table at rep 1024 (the four m = 32 levels in the
#: persistent form); the last base m = 4 (2^22) or m = 16 (2^24) over 2^20
#: columns
WIDE_LARGE_COUNTS = {
    22: {"fused_level_stack": 3, "fused_subntt": 1, "base_ntt_mxu": 1},
    24: {"fused_level_stack": 2, "fused_subntt": 2, "base_ntt_mxu": 1},
}


def wide_large_paths(rng, dev, path_ms) -> None:
    """The 256-bit ``auto`` path above 2^20 on one card: BLS12-381 Fr
    forward at 2^22 and 2^24 (the runner ``ntt`` builds, Montgomery I/O,
    timed with its tables resident), ``coset_ntt`` at 2^24 (the coset
    folded into the same launches) and ``lde`` 2^22 -> 2^24 (blowup 4: the
    inverse at 2^22, then the coset transform at 2^24), random inputs,
    every output word against the hostlib golden result, launch counts
    asserted. The golden results are computed on host threads (the hostlib
    releases the GIL) while the card works."""
    from concurrent.futures import ThreadPoolExecutor

    from ntt_tpu_torch import BLS12_381_FR as f
    from ntt_tpu_torch import limbs
    from ntt_tpu_torch.api import coset_ntt, get_runner, lde

    xs = {log_n: random_words(f, (1 << log_n,), rng) for log_n in (22, 24)}
    xc = random_words(f, (1 << 24,), rng)
    xl = random_words(f, (1 << 22,), rng)
    both = {k: c + WIDE_LARGE_COUNTS[22][k]
            for k, c in WIDE_LARGE_COUNTS[24].items()}
    with ThreadPoolExecutor(max_workers=4) as pool:
        want = {log_n: pool.submit(golden_ntt, f, x)
                for log_n, x in xs.items()}
        want_coset = pool.submit(golden_coset_ntt, f, xc, f.generator)
        want_lde = pool.submit(golden_lde, f, xl, 4)
        for log_n, x in xs.items():
            tag = f"{f.name} 2^{log_n} random"
            xm = limbs.to_mont(torch.from_numpy(x).to(dev), f)
            r, a = get_runner(f, 1 << log_n, device=dev)
            y, c = counted(lambda: r(xm, a))
            expect_counts(f"{f.name} 2^{log_n} forward", c,
                          WIDE_LARGE_COUNTS[log_n], persist=4)
            same_words(tag, limbs.from_mont(y, f), want[log_n].result())
            ms = path_ms[tag] = time_ms(lambda: r(xm, a), iters=5, warmup=1)
            print(f"path {tag}  golden-equal  {ms:.4f} ms/transform (tables "
                  "resident)", flush=True)
            del xm, y, r, a
        xd = torch.from_numpy(xc).to(dev)
        y, c = counted(lambda: coset_ntt(xd, f, device=dev))
        expect_counts(f"{f.name} 2^24 coset_ntt (folded into the stack)", c,
                      WIDE_LARGE_COUNTS[24])
        same_words(f"{f.name} 2^24 coset_ntt", y, want_coset.result())
        ms = path_ms[f"{f.name} 2^24 coset_ntt"] = time_ms(
            lambda: coset_ntt(xd, f, device=dev), iters=3, warmup=1)
        print(f"path {f.name} 2^24 coset_ntt  golden-equal  {ms:.4f} ms "
              "(standard-form I/O)", flush=True)
        xd = torch.from_numpy(xl).to(dev)
        y, c = counted(lambda: lde(xd, f, blowup=4, device=dev))
        expect_counts(f"{f.name} lde 2^22 -> 2^24", c, both)
        same_words(f"{f.name} lde 2^22 x4", y, want_lde.result())
        ms = path_ms[f"{f.name} lde 2^22 x4"] = time_ms(
            lambda: lde(xd, f, blowup=4, device=dev), iters=3, warmup=1)
        print(f"path {f.name} lde 2^22 blowup 4  golden-equal  {ms:.4f} ms "
              "(standard-form I/O)", flush=True)
        del xd, y
    torch.cuda.empty_cache()


def check_periodic_t3(rng, dev, results, level0_log: int = 26) -> None:
    """K2 with a periodic residual T3[W, 32, s0] (level 0 above 2^24,
    ``TwStackResid``: column b reads column b mod s0) against its plain
    version: BLS12-381 Fr at the JAX package's test shape (NT = 2, rep 128),
    a ragged B (NT = 5, rep 64: two and a half column tiles), small-proth
    (NT = 4, rep 128); then the level-0 launch of the BLS12-381 Fr 2^26
    transform at full width ([8,32,2^21], 32 entries of rep 2^16, T3
    [8,32,2^16]), timed beside its bound, the columns of three stack entries
    held against the plain version on those columns (the plain version of
    the whole launch would need some 20 GB of digit planes)."""
    from ntt_tpu_torch import BLS12_381_FR, SMALL
    from ntt_tpu_torch.kernels import mxu_level

    cases = []
    for f, NT, rep in ((BLS12_381_FR, 2, 128), (BLS12_381_FR, 5, 64),
                       (SMALL, 4, 128)):
        m, B, W = 32, NT * rep, f.n_words
        F = sub_mats_on(f, {m}, False, dev).get(-m)
        x = torch.from_numpy(random_words(f, (m, B), rng)).to(dev)
        T3 = torch.from_numpy(random_words(f, (m, rep), rng)).to(dev)
        As = random_stack(f, NT, m, rng, dev)
        cases.append((
            "fused_level_stack",
            f"{f.name} [{W},32,{B}] stack {NT} rep {rep} T3 [{W},32,{rep}]",
            lambda f=f, x=x, As=As, rep=rep, F=F, T3=T3:
                mxu_level.fused_level_stack(x, f, As, rep, F, T3),
            lambda f=f, x=x, As=As, rep=rep, F=F, T3=T3:
                mxu_level.fused_level_stack_plain(x, f, As, rep, F, T3),
            2 * x.numel() * 4 + As.numel() + T3.numel() * 4,
            conv_macs(f, As[0], B), None, False, mont_mul_mads(f) * m * B))
    measure(cases, results)
    del cases

    f, m, NT, s0 = BLS12_381_FR, 32, 32, 1 << (level0_log - 10)
    B = NT * s0
    F = sub_mats_on(f, {m}, False, dev)[-m]
    x = random_on_card(f, (m, B), dev)
    T3 = torch.from_numpy(random_words(f, (m, s0), rng)).to(dev)
    As = random_stack(f, NT, m, rng, dev)
    # what the launch reads besides x: each block its kt rows of one or two
    # entries (from L2, mostly), and T3 at every column (the table itself
    # is 67 MB at 2^26)
    plan = mxu_level.tc_plan(f, m, B)
    a_read = plan.blocks * As[0].numel() // plan.chunks
    t_read = T3.numel() * 4 * NT
    check_full_width(
        "fused_level_stack",
        f"2^{level0_log} level 0 [8,32,{B}] stack 32 rep {s0} T3 [8,32,{s0}]",
        lambda: mxu_level.fused_level_stack(x, f, As, s0, F, T3),
        [slice(a * s0, (a + 1) * s0) for a in (0, 17, NT - 1)],
        lambda c: mxu_level.fused_level_stack_plain(
            x[:, :, c].contiguous(), f, As[c.start // s0:][:1], s0, F, T3),
        (2 * x.numel() * 4 + As.numel() + T3.numel() * 4,
         conv_macs(f, As[0], B), mont_mul_mads(f) * m * B), results,
        note=f"; the launch reads As {a_read / 1e9:.3f} GB and T3 "
             f"{t_read / 1e9:.3f} GB")
    del x, T3, As
    torch.cuda.empty_cache()


def random_on_card(f, shape, dev, seed: int = SEED) -> torch.Tensor:
    """Canonical random elements uint32[W, *shape] drawn on the card (a
    2 GiB operand would take seconds to draw on the host)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x = torch.randint(0, 1 << 32, (f.n_words,) + tuple(shape), generator=gen,
                      device=dev, dtype=torch.int64)
    x[-1] %= f.p >> (32 * (f.n_words - 1))
    return x.to(torch.uint32)


#: the pass kernels at the cells' shapes: BLS12-381 Fr 2^22 (the H-term's
#: passes) and Goldilocks 2^24 (the ZPrize transform's width)
PASS_SHAPES = (("bls12-381-fr", 22), ("goldilocks", 24))
#: the pass kernels' launch keys in ``_build.launches``
PASS_KEYS = ("mont_mul", "add_mod", "sub_mod", "neg_mod")


def pass_cases(f, n, dev) -> list:
    """(label, kernel call, plain call, vectors read and written, Montgomery
    products an element, launch key) of each pass on n elements: the
    H-term's a·b, its division by Z (a product by one element on the
    card, as the benchmark's ``scale`` holds it), the inverse transform's
    n⁻¹ scale with and without the coset table, a - b, a + b, -a and the
    conversion to Montgomery form."""
    from ntt_tpu_torch import limbs
    a = random_on_card(f, (n,), dev)
    b = random_on_card(f, (n,), dev, seed=SEED + 1)
    c = random_on_card(f, (1,), dev, seed=SEED + 2)
    ninv = f.to_mont_int(pow(n, -1, f.p))
    return [
        ("a*b", lambda: limbs.mont_mul(a, b, f),
         lambda: limbs.mont_mul_plain(a, b, f), 3, 1, "mont_mul"),
        ("a*const", lambda: limbs.mont_mul(a, c, f),
         lambda: limbs.mont_mul_plain(a, c, f), 2, 1, "mont_mul"),
        ("a*n^-1", lambda: limbs.mont_scale(a, ninv, f),
         lambda: limbs.mont_scale_plain(a, ninv, f), 2, 1, "mont_mul"),
        ("a*v*n^-1", lambda: limbs.mont_scale(a, ninv, f, b),
         lambda: limbs.mont_scale_plain(a, ninv, f, b), 3, 2, "mont_mul"),
        ("a-b", lambda: limbs.sub_mod(a, b, f),
         lambda: limbs.sub_mod_plain(a, b, f), 3, 0, "sub_mod"),
        ("a+b", lambda: limbs.add_mod(a, b, f),
         lambda: limbs.add_mod_plain(a, b, f), 3, 0, "add_mod"),
        ("-a", lambda: limbs.neg_mod(a, f),
         lambda: limbs.neg_mod_plain(a, f), 2, 0, "neg_mod"),
        ("to_mont", lambda: limbs.to_mont(a, f),
         lambda: limbs.mont_scale_plain(a, f.R2, f), 2, 1, "mont_mul"),
    ]


def check_passes(dev, shapes, timed: bool = True) -> list:
    """Each pass kernel at the shapes ``shapes`` ((field, log n) pairs)
    against its plain version on the card, word for word, one launch
    counted under its key; with ``timed``, each timed by events and by
    profiler device time beside its bound (its vectors' bytes at the memory
    rate against its products' 32-bit multiplies) and the plain version's
    time. Returns the timed rows."""
    from ntt_tpu_torch import get_field
    from ntt_tpu_torch.kernels import _build
    rows = []
    for name, log_n in shapes:
        f, n = get_field(name), 1 << log_n
        for label, kern, plain, vectors, products, key in pass_cases(f, n,
                                                                     dev):
            torch.cuda.synchronize()
            before = _build.launches.copy()
            y = kern()
            torch.cuda.synchronize()
            got = dict(_build.launches - before)
            if got != {key: 1}:
                raise AssertionError(f"pass {name} 2^{log_n} {label}: "
                                     f"launches {got}, not one {key}")
            if not torch.equal(y, plain()):
                raise AssertionError(f"pass {name} 2^{log_n} {label}: "
                                     "kernel != plain")
            del y
            if not timed:
                continue
            ms = time_ms(kern)
            dev_ms = kernel_device_ms(kern, "field_pass_kernel<")
            plain_ms = time_ms(plain, iters=3, warmup=1)
            nbytes = vectors * 4 * f.n_words * n
            b_ms, b_by = bound(nbytes, 0, products * mont_mul_mads(f) * n)
            dev_s = "-" if dev_ms is None else f"{dev_ms:.4f}"
            print(f"pass {name} 2^{log_n} {label:9s} word-equal, 1 launch  "
                  f"kernel {ms:.4f} ms  device {dev_s} ms  bound "
                  f"{b_ms:.4f} ms ({b_by}: {nbytes / 1e9:.4f} GB)  plain "
                  f"{plain_ms:.2f} ms", flush=True)
            rows.append({"field": name, "log_n": log_n, "pass": label,
                         "ms": ms, "device_ms": dev_ms, "bound_ms": b_ms,
                         "bound_by": b_by, "bytes": nbytes,
                         "plain_ms": plain_ms})
        torch.cuda.empty_cache()
    return rows


def check_full_width(name, label, kern, spans, plain, cost, results,
                     lib=None, note="") -> None:
    """One launch at a full-width shape of the path above 2^24: the columns
    of each span of ``spans`` against ``plain(span)``, the plain version on
    those columns (on the whole launch it would need tens of GB of digit
    planes), then the kernel and the library call ``lib`` timed by events
    and device time, beside the bound of ``cost`` = (bytes, int8 MACs,
    32-bit multiply-adds). Recorded as a call off the main path."""
    y = kern()
    torch.cuda.synchronize()
    for cols in spans:
        if not torch.equal(y[:, :, cols], plain(cols)):
            raise AssertionError(f"{name} {label}, columns {cols}: "
                                 "kernel != plain")
    del y
    torch.cuda.empty_cache()
    ms = time_ms(kern, iters=5, warmup=1)
    dev_ms = (kernel_device_ms(kern, DEVICE_TIMED[name], 3)
              or kernel_device_ms(kern, DEVICE_TIMED[name], 3))
    lib_ms = lib_dev = None
    if lib is not None:
        lib_ms = time_ms(lib, iters=5, warmup=1)
        lib_dev = library_device_ms(lib, 3)
    nbytes, macs, mads = cost
    b_ms, b_by = bound(nbytes, macs, mads)

    def show(v):
        return "-" if v is None else f"{v:.4f}"
    print(f"check {name:18s} {label}  word-equal on {len(spans)} column "
          f"spans  kernel {ms:.4f} ms  device {show(dev_ms)} ms  _int_mm "
          f"{show(lib_ms)} ms (device {show(lib_dev)} ms)  bound "
          f"{b_ms:.4f} ms ({b_by}: {nbytes / 1e9:.3f} GB, "
          f"{2 * macs / 1e12:.3f} T int8 ops, {mads / 1e9:.2f} G int32 "
          f"mads){note}", flush=True)
    results.setdefault(name, {"calls": [], "path": []})["calls"].append({
        "shape": label, "ms": ms, "device_ms": dev_ms,
        "library_device_ms": lib_dev, "plain_ms": None, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": lib_ms, "max_abs_err": 0,
        "bytes": nbytes, "int8_macs": macs, "int32_mads": mads,
        "path_launches": 0})


def check_base_m2(rng, dev, results, log_b: int = 25) -> None:
    """K1 at the last base of the BLS12-381 Fr 2^26 transform, m = 2 over
    2^25 columns ([8,2,2^25]), three spans of 2^20 columns against the
    plain version, timed beside its bound. No library time:
    ``torch._int_mm`` on the digit operands of these 2^25 columns (an
    int32 output of 2.7 G elements) stops at an illegal address, and K1
    does not (``k1_wide_probe.py`` runs each alone)."""
    from ntt_tpu_torch import BLS12_381_FR as f
    from ntt_tpu_torch.kernels import mxu_ntt

    m, B = 2, 1 << log_b
    mats = sub_mats_on(f, {m}, False, dev)
    A, F = mats[m], mats[-m]
    x = random_on_card(f, (m, B), dev)
    step = min(B, 1 << 20)
    check_full_width(
        "base_ntt_mxu", f"2^{log_b + 1} base [8,2,{B}]",
        lambda: mxu_ntt.base_ntt_mxu(x, f, A, F),
        [slice(i, i + step) for i in (0, B // 2, B - step)],
        lambda c: mxu_ntt.base_ntt_mxu_plain(x[:, :, c].contiguous(), f, A,
                                             F),
        (2 * x.numel() * 4 + A.numel(), conv_macs(f, A, B), 0), results)
    del x
    torch.cuda.empty_cache()


def check_table_generators(dev) -> None:
    """The device table generators against the host tables, word for word,
    at 2^20 entries of BLS12-381 Fr, with their times on the card and on
    the host (hostlib): ``power_matrix_chunked`` in one row chunk and in
    four, ``geometric_outer_chunked``, ``geometric_outer``."""
    from ntt_tpu_torch import BLS12_381_FR as f
    from ntt_tpu_torch.transforms import core

    w, c = f.root_of_unity(1 << 20), f.generator
    pm = lambda: core.host_power_matrix(f, w, 32, 1 << 15)   # noqa: E731
    pw = lambda: core.host_powers_fast(f, c, 1 << 20)         # noqa: E731
    todo = [
        ("power_matrix_chunked [8,32,32768]", pm,
         lambda: core.power_matrix_chunked(f, w, 32, 1 << 15, dev)),
        ("power_matrix_chunked [8,32,32768], chunks of 2^18", pm,
         lambda: core.power_matrix_chunked(f, w, 32, 1 << 15, dev,
                                           chunk=1 << 18)),
        ("geometric_outer_chunked [8,1048576]", pw,
         lambda: core.geometric_outer_chunked(f, c, 1 << 20, dev)),
        ("geometric_outer [8,1024,1024]", pw,
         lambda: core.geometric_outer(f, c, 1024, 1024, dev).reshape(8, -1)),
    ]
    for label, host, card in todo:
        card()                                  # the first call warms up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = card()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        want = host()
        t2 = time.perf_counter()
        same_words(f"table {label}", got, want)
        print(f"check tables {label}  word-equal to the host table  card "
              f"{(t1 - t0) * 1e3:.1f} ms  host {(t2 - t1) * 1e3:.1f} ms",
              flush=True)


def table_tensors(aux) -> list:
    """Every tensor of an aux table list: the bare tables and the fields of
    the fold objects (stacks, residuals, merged and deep tables)."""
    return [v for t in aux["tws"]
            for v in ([t] if isinstance(t, torch.Tensor) else vars(t).values())
            if isinstance(v, torch.Tensor)]


def table_build_times(dev, sizes=(24, 26)) -> None:
    """The twiddle tables of the BLS12-381 Fr forward transform at 2^24 and
    2^26, built the way the port built them before device generation (every
    table on the host, then uploaded) and the way it builds them now (those
    above ``core.HOST_TW_LIMIT`` entries generated on the card), host
    seconds to resident tables, the two word-compared."""
    from ntt_tpu_torch import BLS12_381_FR as f
    from ntt_tpu_torch.api import aux_from_numpy
    from ntt_tpu_torch.transforms import mxu

    for log_n in sizes:
        n = 1 << log_n
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = aux_from_numpy(mxu.matfold_tw_tables(f, n), {}, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        card = aux_from_numpy(mxu.matfold_tw_tables(f, n, device=dev), {},
                              device=dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if not all(torch.equal(a, b) for a, b in zip(
                table_tensors(host), table_tensors(card), strict=True)):
            raise AssertionError(f"tables 2^{log_n}: card != host")
        kinds = [k for k, _ in mxu.matfold_plan(f, n)]
        print(f"tables {f.name} 2^{log_n} forward {kinds}: all on the host "
              f"and uploaded {t1 - t0:.2f} s, large ones generated on the "
              f"card {t2 - t1:.2f} s (word-equal)", flush=True)
        del host, card
        torch.cuda.empty_cache()


#: launches of one BLS12-381 Fr forward transform above 2^24: level 0 the
#: 32-entry stack with its periodic residual (K2), level 1 a deep table at
#: rep 32 and level 2 one at rep 1024 (K3), the deeper levels stacks (K2),
#: the last base m = 32 over 2^20 columns (2^25) or m = 2 over 2^25 (2^26)
HUGE_COUNTS = {
    25: {"fused_level_stack": 2, "fused_subntt": 2, "base_ntt_mxu": 1},
    26: {"fused_level_stack": 3, "fused_subntt": 2, "base_ntt_mxu": 1},
}


#: BN254 Fr 2^25 under ``mxu_sub`` (the same levels, the last base K3);
#: ``lde`` BLS12-381 Fr 2^23 -> 2^25 (the inverse at 2^23: stack, merged
#: table, a deep table at rep 1024, stack, K1 m = 8; then the 2^25 coset)
SUB_COUNTS = {"fused_level_stack": 2, "fused_subntt": 3}
LDE_COUNTS = {"fused_level_stack": 4, "fused_subntt": 4, "base_ntt_mxu": 2}


def huge_inputs(rng) -> dict:
    """Random inputs of the checks above 2^24 (standard form, word planes),
    drawn as 32-bit words with the top word below p's: BLS12-381 Fr at
    2^25, 2^26 and 2^27 (keys 25, 26, 27), BN254 Fr at 2^25 ("bn254") and
    the BLS12-381 Fr ``lde`` input at 2^23 ("lde")."""
    from ntt_tpu_torch import BLS12_381_FR, BN254_FR

    def draw(f, log_n):
        x = rng.integers(0, 1 << 32, size=(8, 1 << log_n), dtype=np.uint32)
        x[7] %= np.uint32(f.p >> 224)
        return x
    out = {log_n: draw(BLS12_381_FR, log_n) for log_n in HUGE_COUNTS}
    out["bn254"] = draw(BN254_FR, 25)
    out["lde"] = draw(BLS12_381_FR, 23)
    out[GIANT_GOLDEN] = draw(BLS12_381_FR, GIANT_GOLDEN)
    return out


def start_huge_goldens(pool, xs) -> dict:
    """The golden results of the checks above 2^24, computed on host
    threads while the card works: the BLS12-381 Fr forward at 2^27 (the
    longest, first), 2^25 and 2^26,
    ``coset_ntt`` at 2^26 (the 2^26 ``intt`` is checked against the
    forward's input), BN254 Fr 2^25 and the ``lde`` 2^23 -> 2^25."""
    from ntt_tpu_torch import BLS12_381_FR as f
    from ntt_tpu_torch import BN254_FR
    big = max(HUGE_COUNTS)
    # the longest first: the 2^27 forward
    want = {str(GIANT_GOLDEN): pool.submit(golden_ntt, f, xs[GIANT_GOLDEN])}
    want.update({str(log_n): pool.submit(golden_ntt, f, xs[log_n])
                 for log_n in HUGE_COUNTS})
    want["coset"] = pool.submit(golden_coset_ntt, f, xs[big], f.generator)
    want["bn254"] = pool.submit(golden_ntt, BN254_FR, xs["bn254"])
    want["lde"] = pool.submit(golden_lde, f, xs["lde"], 4)
    return want


def huge_sub_and_lde(dev, path_ms, xs, want, seen) -> None:
    """Above 2^24 under the other names: BN254 Fr 2^25 forward under
    ``mxu_sub`` (Montgomery I/O) and ``lde`` BLS12-381 Fr 2^23 -> 2^25
    (blowup 4, standard-form I/O: its conversions, n^-1 scale and
    transfers are plain chunked passes), launch counts asserted, every
    output word against the golden result, each timed (median of 3)."""
    from ntt_tpu_torch import BLS12_381_FR, BN254_FR, limbs
    from ntt_tpu_torch.api import _chunked_pass, lde, ntt

    f, tag = BN254_FR, "bn254-fr 2^25 mxu_sub"
    xm = _chunked_pass(lambda a: limbs.to_mont(a, f),
                       torch.from_numpy(xs["bn254"]).to(dev))
    kw = dict(algorithm="mxu_sub", mont_io=True, device=dev)
    y, c = counted(lambda: ntt(xm, f, **kw), seen)
    expect_counts(tag, c, SUB_COUNTS)
    same_words(tag, _chunked_pass(lambda a: limbs.from_mont(a, f), y).cpu(),
               want["bn254"].result())
    ms = path_ms[tag] = time_ms(lambda: ntt(xm, f, **kw), iters=3, warmup=1)
    print(f"path {tag}  golden-equal  {ms:.4f} ms/transform (tables "
          "resident)", flush=True)
    del xm, y
    f, tag = BLS12_381_FR, "bls12-381-fr lde 2^23 x4"
    xd = torch.from_numpy(xs["lde"]).to(dev)
    y, c = counted(lambda: lde(xd, f, blowup=4, device=dev), seen)
    expect_counts(f"{f.name} lde 2^23 -> 2^25", c, LDE_COUNTS)
    same_words(tag, y, want["lde"].result())
    ms = path_ms[tag] = time_ms(lambda: lde(xd, f, blowup=4, device=dev),
                                iters=3, warmup=1)
    print(f"path {f.name} lde 2^23 blowup 4  golden-equal  {ms:.4f} ms "
          "(standard-form I/O)", flush=True)
    del xd, y
    torch.cuda.empty_cache()


def big_runner(f, n, tag, dev, **kw):
    """``get_runner`` above 2^24 with its build time, its tables' shapes
    and the largest table's entries printed (fewer than n: no table of
    the data's size)."""
    from ntt_tpu_torch.api import get_runner
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r, a = get_runner(f, n, device=dev, **kw)
    torch.cuda.synchronize()
    tables = [t for t in table_tensors(a) if t.dtype == torch.uint32]
    biggest = max(t.numel() for t in tables) // f.n_words
    if biggest >= n:
        raise AssertionError(f"{tag}: a table of {biggest} entries")
    print(f"tables {tag}: built and resident in "
          f"{time.perf_counter() - t0:.2f} s; twiddle tables "
          f"{[tuple(t.shape) for t in tables]}, the largest {biggest} "
          "entries", flush=True)
    return r, a


def memory_line(tag, x) -> None:
    print(f"memory {tag}: peak allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, the data "
          f"{x.numel() * 4 / 2**30:.2f} GiB", flush=True)


def huge_paths(dev, path_ms, xs, want, seen) -> None:
    """The 256-bit ``auto`` path above 2^24 on one card: BLS12-381 Fr forward
    at 2^25 and 2^26, ``coset_ntt`` at 2^26 (the coset folded into the same
    launches) and ``intt`` at 2^26 on the forward's output, back to its
    input word for word; Montgomery I/O (the conversions are plain passes),
    launch counts asserted, every output word against the hostlib golden
    result, each timed (median of 3, tables resident) with the runner's
    build time, its tables' shapes and the peak of allocated memory."""
    from ntt_tpu_torch import BLS12_381_FR as f
    from ntt_tpu_torch import limbs
    from ntt_tpu_torch.api import _chunked_pass

    def to_mont(x):
        return _chunked_pass(lambda a: limbs.to_mont(a, f),
                             torch.from_numpy(x).to(dev))

    def standard(y):
        return _chunked_pass(lambda a: limbs.from_mont(a, f), y).cpu()

    def runner(n, tag, **kw):
        return big_runner(f, n, tag, dev, **kw)

    for log_n in HUGE_COUNTS:
        n, tag = 1 << log_n, f"{f.name} 2^{log_n} random"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        r, a = runner(n, f"{f.name} 2^{log_n} forward")
        xm = to_mont(xs[log_n])
        y, c = counted(lambda: r(xm, a), seen)
        expect_counts(f"{f.name} 2^{log_n} forward", c, HUGE_COUNTS[log_n])
        same_words(tag, standard(y), want[str(log_n)].result())
        ms = path_ms[tag] = time_ms(lambda: r(xm, a), iters=3, warmup=1)
        print(f"path {tag}  golden-equal  {ms:.4f} ms/transform (tables "
              "resident)", flush=True)
        memory_line(f"{f.name} 2^{log_n} forward", xm)
        if log_n < max(HUGE_COUNTS):
            del xm, y, r, a
    breakdown(f, n, None, dev, xm=xm)
    big = max(HUGE_COUNTS)
    n, tag = 1 << big, f"{f.name} 2^{big} coset_ntt"
    torch.cuda.reset_peak_memory_stats()
    rc, ac = runner(n, tag, coset_shift=f.generator)
    yc, c = counted(lambda: rc(xm, ac), seen)
    expect_counts(f"{tag} (folded into the stack)", c, HUGE_COUNTS[big])
    same_words(tag, standard(yc), want["coset"].result())
    ms = path_ms[tag] = time_ms(lambda: rc(xm, ac), iters=3, warmup=1)
    print(f"path {tag}  golden-equal  {ms:.4f} ms/transform (Montgomery "
          "I/O, tables resident)", flush=True)
    memory_line(tag, xm)
    del yc, rc, ac
    tag = f"{f.name} 2^{big} intt"
    torch.cuda.reset_peak_memory_stats()
    ri, ai = runner(n, tag, inverse=True)
    back, c = counted(lambda: ri(y, ai), seen)
    expect_counts(tag, c, HUGE_COUNTS[big])
    if not torch.equal(back, xm):
        raise AssertionError(f"{tag}: intt(ntt(x)) != x")
    ms = path_ms[tag] = time_ms(lambda: ri(y, ai), iters=3, warmup=1)
    print(f"path {tag}  golden-equal (intt(ntt(x)) == x, word for word)  "
          f"{ms:.4f} ms/transform (Montgomery I/O, tables resident)",
          flush=True)
    memory_line(tag, xm)
    del back, y, xm, r, a, ri, ai
    torch.cuda.empty_cache()


#: launches of one forward transform at 2^27 and 2^28 (the plan of
#: ``mxu.matfold_plan``): level 0 the stack with its periodic residual
#: (K2), deep tables (K3: two at 2^27, three at 2^28, where 2^26 has a
#: stack), stacks (K2: 128 and 4 entries at 2^27, 8 at 2^28), the last
#: base over 2^25 columns (K1 at m = 4, m = 8)
GIANT_COUNTS = {
    27: {"fused_level_stack": 3, "fused_subntt": 2, "base_ntt_mxu": 1},
    28: {"fused_level_stack": 2, "fused_subntt": 3, "base_ntt_mxu": 1},
}
#: the size whose forward is held against the hostlib golden result (2^28
#: is held by its launches)
GIANT_GOLDEN = 27


def random_mont_on_card(f, n, dev) -> torch.Tensor:
    """Canonical random words uint32[W, n] drawn on the card a word plane
    at a time (at 2^28 one int64 draw of all planes would take 16 GiB),
    used as Montgomery-form input."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    x = torch.empty((f.n_words, n), dtype=torch.uint32, device=dev)
    for w in range(f.n_words):
        hi = (1 << 32) if w < f.n_words - 1 else f.p >> (32 * w)
        x[w] = torch.randint(0, hi, (n,), generator=gen, device=dev,
                             dtype=torch.int64).to(torch.uint32)
    return x


def giant_paths(dev, path_ms, xs, want, seen) -> None:
    """The 256-bit ``auto`` path at 2^27 and 2^28, where the plan has
    shapes no smaller size has (a 128-entry deep stack and K1 [8, 4, 2^25]
    at 2^27; a third deep level (8192, 32, 256) and K1 [8, 8, 2^25] at
    2^28): BLS12-381 Fr 2^27 forward against the hostlib golden result
    (computed on a host thread since the start of the run), BLS12-381 Fr
    and BN254 Fr 2^28 forward on random words; launch counts asserted,
    each launch recorded into ``seen`` for :func:`check_path_launches`,
    each transform timed (median of 3, tables resident) with its runner's
    build time and the peak of allocated memory."""
    from ntt_tpu_torch import BLS12_381_FR, BN254_FR, limbs
    from ntt_tpu_torch.api import _chunked_pass

    for f, log_n in ((BLS12_381_FR, 27), (BLS12_381_FR, 28), (BN254_FR, 28)):
        n, tag = 1 << log_n, f"{f.name} 2^{log_n} random"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        r, a = big_runner(f, n, f"{f.name} 2^{log_n} forward", dev)
        if log_n == GIANT_GOLDEN:
            xm = _chunked_pass(lambda c: limbs.to_mont(c, f),
                               torch.from_numpy(xs[log_n]).to(dev))
        else:
            xm = random_mont_on_card(f, n, dev)
        y, c = counted(lambda: r(xm, a), seen)
        expect_counts(f"{f.name} 2^{log_n} forward", c, GIANT_COUNTS[log_n])
        if tuple(y.shape) != (f.n_words, n):
            raise AssertionError(f"{tag}: output shape {tuple(y.shape)}")
        if log_n == GIANT_GOLDEN:
            same_words(tag, _chunked_pass(
                lambda c: limbs.from_mont(c, f), y).cpu(),
                want[str(log_n)].result())
            verdict = "golden-equal"
        else:
            verdict = "launches held below"
        del y
        ms = path_ms[tag] = time_ms(lambda: r(xm, a), iters=3, warmup=1)
        print(f"path {tag}  {verdict}  {ms:.4f} ms/transform (tables "
              "resident)", flush=True)
        memory_line(f"{f.name} 2^{log_n} forward", xm)
        del xm, r, a
    torch.cuda.empty_cache()


#: the Goldilocks transforms above 2^24 whose golden results start on a
#: host thread early (about 1.5 and 3 minutes on one thread)
NARROW_HUGE_LOGS = (25, 26)


def start_narrow_goldens(pool, rng) -> dict:
    """{log2 n: (input, future of its golden forward)} for the Goldilocks
    transforms of ``NARROW_HUGE_LOGS``, on the host threads of ``pool``."""
    from ntt_tpu_torch import GOLDILOCKS as f
    out = {}
    for log_n in NARROW_HUGE_LOGS:
        xs = random_words(f, (1 << log_n,), rng)
        out[log_n] = (xs, pool.submit(golden_ntt, f, xs))
    return out


def narrow_paths(rng, dev, path_ms, huge=None) -> dict:
    """The narrow-field path; with ``huge`` (:func:`start_narrow_goldens`)
    also Goldilocks 2^25 and 2^26 forward. Returns the launch counts of
    the Goldilocks 2^18 and 2^24 forward transforms (the main paths of the
    multi-level K3's two forms)."""
    from ntt_tpu_torch import GOLDILOCKS, SMALL, limbs
    from ntt_tpu_torch.api import (coset_ntt, get_runner, intt, lde, ntt,
                                   polymul)

    counts = {}
    # the wide form above one wave of blocks (2^24 and up: every K3 multi
    # launch; small-proth 2^22: the two levels), the present form at 2^18
    runs = [(GOLDILOCKS, 18, {"fused_subntt_multi": 2}),
            (GOLDILOCKS, 24, {"fused_subntt_wide": 3}),
            (SMALL, 22, {"fused_subntt_wide": 2, "fused_subntt": 1})]
    runs += [(GOLDILOCKS, log_n, {"fused_subntt_wide": 3})
             for log_n in (huge or {})]
    for f, log_n, want in runs:
        n = 1 << log_n
        if log_n in (huge or {}) and f is GOLDILOCKS:
            xs, golden = huge[log_n]
        else:
            xs = random_words(f, (n,), rng)
            golden = None
        xd = torch.from_numpy(xs).to(dev)
        t0 = time.time()
        r, a = get_runner(f, n, device=dev)
        t_tab = time.time() - t0
        y, c = counted(lambda: ntt(xd, f, algorithm="auto", device=dev))
        expect_counts(f"{f.name} 2^{log_n} forward", c, want)
        if f is GOLDILOCKS and log_n in (18, 24):
            counts.update(c)
        same_words(f"{f.name} 2^{log_n} forward", y,
                   golden_ntt(f, xs) if golden is None else golden.result())
        xm = limbs.to_mont(xd, f)
        ms = path_ms[f"{f.name} 2^{log_n} random"] = time_ms(lambda: r(xm, a))
        print(f"path {f.name} 2^{log_n} random  golden-equal  {ms:.4f} "
              f"ms/transform (Montgomery I/O, tables resident; tables built "
              f"in {t_tab:.1f} s)", flush=True)
        del xd, xm, y, r, a
        torch.cuda.empty_cache()

    f, n = GOLDILOCKS, 1 << 20
    g = f.generator
    xs = random_words(f, (n,), rng)
    xd = torch.from_numpy(xs).to(dev)
    back = intt(ntt(xd, f, device=dev), f, device=dev)
    same_words("goldilocks 2^20 intt(ntt(x))", back, xs)
    same_words("goldilocks 2^20 intt", intt(xd, f, device=dev),
               golden_ntt(f, xs, inverse=True))
    same_words("goldilocks 2^20 coset_ntt", coset_ntt(xd, f, device=dev),
               golden_coset_ntt(f, xs, g))
    xm = limbs.to_mont(xd, f)
    for what, kw in (("ntt", {}), ("intt", {"inverse": True}),
                     ("coset_ntt", {"coset_shift": g})):
        r, a = get_runner(f, n, device=dev, **kw)
        ms = path_ms[f"goldilocks 2^20 {what}"] = time_ms(lambda: r(xm, a))
        print(f"path goldilocks 2^20 {what}  golden-equal  {ms:.4f} "
              f"ms/transform (Montgomery I/O, tables resident)", flush=True)
    # the elementwise passes around a transform (the pass kernels of
    # limbs on the card; the scale's factor as int64 planes, as the dist
    # path passes its constants)
    ninv = limbs.const_planes(3, f, ndim=1, device=dev)
    cs = a["coset"] if "coset" in a else xm
    for what, fn in (("to_mont", lambda: limbs.to_mont(xd, f)),
                     ("from_mont", lambda: limbs.from_mont(xm, f)),
                     ("1/n scale", lambda: limbs.mont_mul(xm, ninv, f)),
                     ("coset or pointwise product",
                      lambda: limbs.mont_mul(xm, cs, f))):
        ms = path_ms[f"goldilocks 2^20 pass {what}"] = time_ms(fn, iters=10)
        print(f"pass goldilocks 2^20 {what}: {ms:.4f} ms (pass kernel, "
              "events)", flush=True)

    n = 1 << 18
    xs = random_words(f, (n,), rng)
    xd = torch.from_numpy(xs).to(dev)
    same_words("goldilocks lde 2^18 x4", lde(xd, f, blowup=4, device=dev),
               golden_lde(f, xs, 4))
    ms = path_ms["goldilocks lde 2^18 x4"] = time_ms(
        lambda: lde(xd, f, blowup=4, device=dev), iters=10)
    print(f"path goldilocks lde 2^18 blowup 4  golden-equal  {ms:.4f} ms "
          "(standard-form I/O)", flush=True)

    n = 1 << 17
    a_s, b_s = random_words(f, (n,), rng), random_words(f, (n,), rng)
    zero = np.zeros_like(a_s)
    fa = golden_ntt(f, np.concatenate([a_s, zero], axis=1))
    fb = golden_ntt(f, np.concatenate([b_s, zero], axis=1))
    want = golden_ntt(f, golden_mul(f, fa, fb), inverse=True)
    ad, bd = torch.from_numpy(a_s).to(dev), torch.from_numpy(b_s).to(dev)
    same_words("goldilocks polymul 2^17", polymul(ad, bd, f, device=dev),
               want)
    ms = path_ms["goldilocks polymul 2^17"] = time_ms(
        lambda: polymul(ad, bd, f, device=dev), iters=10)
    print(f"path goldilocks polymul n = 2^17 (full product)  golden-equal  "
          f"{ms:.4f} ms (standard-form I/O)", flush=True)
    return counts


#: the knob settings of the knobs phase: (label, constants, the runs it
#: changes as (field, log2 n, algorithm)). The constants are set on the
#: module that consumes them, as a test does
KNOB_RUNS = [
    ("NTT_MXU_BASE_LOG=4", {"mxu.BASE_LOG": 4, "mxu.BASE": 16},
     [("bls12-381-fr", 18, "auto"), ("bls12-381-fr", 20, "auto")]),
    ("NTT_MXU_SUBBASE_LOG=8", {"mxu.SUBBASE_LOG": 8, "mxu.SUBBASE": 256},
     [("goldilocks", 20, "auto")]),
    ("NTT_MXU_SUBBASE_LOG=10", {"mxu.SUBBASE_LOG": 10, "mxu.SUBBASE": 1024},
     [("goldilocks", 20, "auto"), ("small-proth", 20, "auto"),
      ("small-proth", 22, "auto")]),
    ("NTT_MXU_SUB256_LOG=6", {"mxu.SUB256_LOG": 6},
     [("bls12-381-fr", 18, "mxu_sub")]),
    ("NTT_MXU_SUB256_LOG=7", {"mxu.SUB256_LOG": 7},
     [("bls12-381-fr", 18, "mxu_sub")]),
    ("NTT_MXU_SUB256_LOG=9", {"mxu.SUB256_LOG": 9},
     [("bls12-381-fr", 18, "mxu_sub")]),
    ("NTT_TW_MATFOLD=0", {"mxu.TW_MATFOLD": False},
     [("bls12-381-fr", 18, "auto"), ("bls12-381-fr", 22, "auto")]),
    ("NTT_TW_MATFOLD=0 NTT_FUSE_TW=0",
     {"mxu.TW_MATFOLD": False, "mxu.FUSE_TW": False},
     [("bls12-381-fr", 18, "auto"), ("bls12-381-fr", 22, "auto")]),
    ("NTT_TW_RESID=1", {"mxu.TW_RESID": "1"}, [("bls12-381-fr", 20, "auto")]),
    ("NTT_TW_STACK_MAX_NT=32", {"mxu.TW_STACK_MAX_NT": 32},
     [("bls12-381-fr", 22, "auto")]),
    ("NTT_MXU_BASE_LOG=6", BASE64,
     [("bls12-381-fr", 18, "auto"), ("bls12-381-fr", 20, "auto"),
      ("bls12-381-fr", 24, "auto"), ("bls12-381-fr", 18, "mxu_fused"),
      ("bls12-381-fr", 18, "mxu_pallas"), ("bn254-fr", 20, "mxu_sub"),
      ("goldilocks", 20, "mxu_chunked"), ("small-proth", 18, "mxu_chunked")]),
]

#: launches asserted under a knob: (label, field, log2 n, algorithm) ->
#: counts. NTT_MXU_BASE_LOG=6 (every launch but the last base m = 4 of
#: 2^20 at m = 64): BLS12-381 Fr 2^18 has no fold (two levels with
#: tables, K3, and the base, K1); 2^20 and 2^24 fold (a 64-entry stack,
#: the merged table, a stack of 4 or 64 entries, the base); BN254 Fr 2^20
#: under mxu_sub the same levels with the base on K3. The peels of the JAX
#: package's rule: NTT_MXU_SUBBASE_LOG=10 peels 1024 on the small Proth
#: prime (2^20: two wide launches of [1,1024,1024]; 2^22: two of
#: [1,1024,4096] and the base m = 4 on K3 single), NTT_MXU_SUB256_LOG=9
#: peels 256 on BLS12-381 Fr (two present-form launches of [8,256,1024],
#: the base m = 4)
KNOB_COUNTS = {
    ("NTT_MXU_SUBBASE_LOG=10", "small-proth", 20, "auto"):
        {"fused_subntt_wide": 2},
    ("NTT_MXU_SUBBASE_LOG=10", "small-proth", 22, "auto"):
        {"fused_subntt_wide": 2, "fused_subntt": 1},
    ("NTT_MXU_SUB256_LOG=9", "bls12-381-fr", 18, "mxu_sub"):
        {"fused_subntt_multi": 2, "fused_subntt": 1},
    ("NTT_MXU_BASE_LOG=6", "bls12-381-fr", 18, "auto"):
        {"fused_subntt": 2, "base_ntt_mxu": 1},
    ("NTT_MXU_BASE_LOG=6", "bls12-381-fr", 20, "auto"):
        {"fused_level_stack": 2, "fused_subntt": 1, "base_ntt_mxu": 1},
    ("NTT_MXU_BASE_LOG=6", "bls12-381-fr", 24, "auto"):
        {"fused_level_stack": 2, "fused_subntt": 1, "base_ntt_mxu": 1},
    ("NTT_MXU_BASE_LOG=6", "bls12-381-fr", 18, "mxu_fused"):
        {"fused_level": 3},
    ("NTT_MXU_BASE_LOG=6", "bls12-381-fr", 18, "mxu_pallas"):
        {"base_ntt_mxu": 3},
    ("NTT_MXU_BASE_LOG=6", "bn254-fr", 20, "mxu_sub"):
        {"fused_level_stack": 2, "fused_subntt": 2},
    ("NTT_MXU_BASE_LOG=6", "goldilocks", 20, "mxu_chunked"):
        {"fused_subntt": 3, "base_ntt_mxu": 1},
    ("NTT_MXU_BASE_LOG=6", "small-proth", 18, "mxu_chunked"):
        {"fused_subntt": 2, "base_ntt_mxu": 1},
}
#: the input shapes [W, m, B] of the K3 launches asserted under a knob,
#: as :func:`recording` sees them (one entry a distinct shape)
KNOB_SHAPES = {
    ("NTT_MXU_SUBBASE_LOG=10", "small-proth", 20, "auto"): {(1, 1024, 1024)},
    ("NTT_MXU_SUBBASE_LOG=10", "small-proth", 22, "auto"):
        {(1, 1024, 4096), (1, 4, 1 << 20)},
    ("NTT_MXU_SUB256_LOG=9", "bls12-381-fr", 18, "mxu_sub"):
        {(8, 256, 1024), (8, 4, 65536)},
}
#: the knob run whose golden result starts on a host thread before the
#: narrow paths (about half a minute on one thread)
KNOB_EARLY_GOLDEN = ("bls12-381-fr", 24)


@contextlib.contextmanager
def knobs_set(settings: dict):
    """The knob constants (``"mxu.NAME"``) and environment variables
    (``"env.NAME"``) of ``settings`` set for the block, then restored."""
    import os

    from ntt_tpu_torch.transforms import mxu
    mods = {"mxu": mxu}
    saved = []
    for key, v in settings.items():
        where, name = key.split(".")
        if where == "env":
            saved.append((where, name, os.environ.get(name)))
            os.environ[name] = str(v)
        else:
            saved.append((where, name, getattr(mods[where], name)))
            setattr(mods[where], name, v)
    try:
        yield
    finally:
        for where, name, v in reversed(saved):
            if where != "env":
                setattr(mods[where], name, v)
            elif v is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = v


def knob_paths(rng, dev, path_ms, card, early=None) -> None:
    """Every knob setting of ``KNOB_RUNS`` on the card: each run it changes
    at its full width (random input, Montgomery I/O), every output word
    against the hostlib golden result, its launches counted (asserted
    where ``KNOB_COUNTS`` has them, and their K3 input shapes where
    ``KNOB_SHAPES`` has them: the peel of 1024) and each distinct K1-K4 launch
    recorded and then held against its plain version and timed
    (:func:`check_path_launches`); each run timed (median of 10, 5 at
    2^22 and above; tables resident) right after the same run at the
    default knobs, on one line with the card. ``api.ntt``'s runner cache
    must build a fresh runner under the knob (``config.config_key()``
    changes) and the key must come back after it; the runner built under
    the knob, run again after, must give the golden words again (a runner
    keeps the plan it was built under). ``early``: {(field, log2 n):
    (input, golden future)} started before this phase. Then the by-design
    rejection of NTT_MXU_BASE_LOG=7 (the single-level kernels take
    m <= 64) and the NTT_DEBUG tripwire on one corrupted word."""
    from concurrent.futures import ThreadPoolExecutor

    from ntt_tpu_torch import get_field, limbs
    from ntt_tpu_torch import api
    from ntt_tpu_torch.config import config_key

    runs = sorted({r for _, _, rs in KNOB_RUNS for r in rs})
    inputs = dict(early or {})
    with ThreadPoolExecutor(max_workers=4) as pool:
        for name, log_n, _ in runs:
            if (name, log_n) not in inputs:
                f = get_field(name)
                xs = random_words(f, (1 << log_n,), rng)
                inputs[(name, log_n)] = (xs, pool.submit(golden_ntt, f, xs))
        inputs = {k: (xs, w.result()) for k, (xs, w) in inputs.items()}
    def iters(log_n, alg):
        return 5 if log_n >= 22 else 10

    default_key = config_key()
    default = {}
    for name, log_n, alg in runs:
        f = get_field(name)
        default[(name, log_n, alg)] = api.get_runner(
            f, 1 << log_n, algorithm=alg, device=dev)
    seen = {}
    for label, settings, rs in KNOB_RUNS:
        for name, log_n, alg in rs:
            f = get_field(name)
            tag = f"{name} 2^{log_n} {alg}"
            xs, want = inputs[(name, log_n)]
            xm = limbs.to_mont(torch.from_numpy(xs).to(dev), f)
            # the default runner timed just before, at the default knobs
            rd, ad = default[(name, log_n, alg)]
            ms_d = time_ms(lambda: rd(xm, ad), iters=iters(log_n, alg))
            with knobs_set(settings):
                if config_key() == default_key:
                    raise AssertionError(f"{label}: config_key() unchanged")
                cached = len(api._runner_cache)
                mine = {}
                y, c = counted(lambda: api.ntt(xm, f, algorithm=alg,
                                               mont_io=True, device=dev),
                               mine)
                if len(api._runner_cache) != cached + 1:
                    raise AssertionError(f"{label} {tag}: no fresh runner")
                same_words(f"{label} {tag}", limbs.from_mont(y, f), want)
                want_c = KNOB_COUNTS.get((label, name, log_n, alg))
                if want_c is not None:
                    expect_counts(f"{label} {tag}", c, want_c)
                want_s = KNOB_SHAPES.get((label, name, log_n, alg))
                if want_s is not None:
                    got_s = {shape for k, shape, _ in mine.values()
                             if k == "fused_subntt"}
                    print(f"shapes {label} {tag}: K3 {sorted(got_s)}",
                          flush=True)
                    if got_s != want_s:
                        raise AssertionError(f"{label} {tag}: K3 shapes "
                                             f"{got_s} != {want_s}")
                seen.update(mine)
                r, a = list(api._runner_cache.values())[-1]
                ms = path_ms[f"knob {label} {tag}"] = time_ms(
                    lambda: r(xm, a), iters=iters(log_n, alg))
            if config_key() != default_key:
                raise AssertionError(f"{label}: the knobs were not restored")
            same_words(f"{label} {tag} (its runner, knobs restored)",
                       limbs.from_mont(r(xm, a), f), want)
            print(f"knob {label}  {tag}  golden-equal  {ms:.4f} "
                  f"ms/transform, default knobs {ms_d:.4f} ms  launches "
                  f"{c}  ({card})", flush=True)
            del y, r, a, xm
    del default
    api._runner_cache.clear()
    torch.cuda.empty_cache()
    check_path_launches(seen, dev, timed=True)

    f = get_field("bls12-381-fr")
    with knobs_set({"mxu.BASE_LOG": 7, "mxu.BASE": 128}):
        try:
            api.get_runner(f, 1 << 18, device=dev)
        except ValueError as e:
            print(f"knob NTT_MXU_BASE_LOG=7  bls12-381-fr 2^18 auto  "
                  f"rejected as designed: {e}", flush=True)
        else:
            raise AssertionError("NTT_MXU_BASE_LOG=7 ran a kernel at "
                                 "m = 128")
    xs = inputs[min(k for k in inputs if k[0] == f.name)][0]
    bad = xs.copy()
    bad[f.n_words - 1, 1234] = 0xFFFFFFFF            # one element >= p
    xd, bad = torch.from_numpy(xs).to(dev), torch.from_numpy(bad).to(dev)
    with knobs_set({"env.NTT_DEBUG": "1"}):
        api.ntt(xd, f, device=dev)                  # canonical: passes
        try:
            api.ntt(bad, f, device=dev)
        except ValueError as e:
            if "1 non-canonical" not in str(e):
                raise
            log_n = xs.shape[1].bit_length() - 1
            print(f"knob NTT_DEBUG=1  {f.name} 2^{log_n} on the card: {e}",
                  flush=True)
        else:
            raise AssertionError("NTT_DEBUG=1 let a non-canonical word by")
    del xd, bad
    api._runner_cache.clear()
    torch.cuda.empty_cache()


#: launches of one forward transform under each explicit algorithm name:
#: BLS12-381 Fr 2^18 (with the cross pair mxu_sub) and Goldilocks 2^20
#: (with the cross pair mxu_chunked)
LADDER_COUNTS = {
    "bls12-381-fr": {
        "naive": {}, "stockham": {}, "fourstep": {}, "fourstep_st": {},
        "mxu": {}, "pallas": {"stage_ntt": 3},
        "pallas_fused": {"fused_stage_level": 3},
        "mxu_pallas": {"base_ntt_mxu": 4}, "mxu_fused": {"fused_level": 4},
        "mxu_sub": {"fused_level_stack": 2, "fused_subntt": 2}},
    "goldilocks": {
        "naive": {}, "stockham": {}, "fourstep": {}, "fourstep_st": {},
        "mxu": {}, "pallas": {"stage_ntt": 3},
        "pallas_fused": {"fused_stage_level": 3},
        "mxu_pallas": {"base_ntt_mxu": 4}, "mxu_fused": {"fused_level": 4},
        "mxu_chunked": {"fused_subntt": 3, "base_ntt_mxu": 1}},
}


def ladder_paths(rng, dev, path_ms) -> dict:
    """Every explicit algorithm name through ``ntt_tpu_torch.api`` at
    BLS12-381 Fr 2^18 and Goldilocks 2^20, forward on random input, every
    output word against the golden NTT, launch counts asserted; the three
    kernel-backed ladder algorithms also on the ramp, and through
    ``intt(ntt(x)) == x`` and ``coset_ntt``. Returns the launch counts of
    the BLS 2^18 ``pallas``, ``pallas_fused`` and ``mxu_fused``
    transforms, merged."""
    from ntt_tpu_torch import BLS12_381_FR, GOLDILOCKS, limbs
    from ntt_tpu_torch.api import (coset_ntt, get_runner, intt, ntt,
                                   ramp_mont)

    merged = {}
    for f, log_n in ((BLS12_381_FR, 18), (GOLDILOCKS, 20)):
        n = 1 << log_n
        xs = random_words(f, (n,), rng)
        want = golden_ntt(f, xs)
        xd = torch.from_numpy(xs).to(dev)
        xm = limbs.to_mont(xd, f)
        ramp = np.zeros((f.n_words, n), dtype=np.uint32)
        ramp[0] = np.arange(n, dtype=np.uint32)
        want_ramp = None
        for alg, expect in LADDER_COUNTS[f.name].items():
            tag = f"{f.name} 2^{log_n} {alg}"
            y, c = counted(lambda: ntt(xm, f, algorithm=alg, mont_io=True,
                                       device=dev))
            expect_counts(tag, c, expect)
            same_words(tag, limbs.from_mont(y, f), want)
            if f is BLS12_381_FR and alg in ("pallas", "pallas_fused",
                                             "mxu_fused"):
                merged.update(c)
            if expect and alg not in ("mxu_sub", "mxu_chunked"):
                if want_ramp is None:
                    want_ramp = golden_ntt(f, ramp)
                y = ntt(ramp_mont(f, n, device=dev), f, algorithm=alg,
                        mont_io=True, device=dev)
                same_words(tag + " ramp", limbs.from_mont(y, f), want_ramp)
            r, a = get_runner(f, n, algorithm=alg, device=dev)
            slow = not expect or alg == "pallas"
            ms = path_ms[tag] = time_ms(lambda: r(xm, a),
                                        iters=3 if slow else 20,
                                        warmup=1 if slow else 2)
            print(f"path {tag}  golden-equal  {ms:.4f} ms/transform "
                  "(Montgomery I/O, tables resident)", flush=True)
            del r, a, y
            torch.cuda.empty_cache()
        # inverse round trip and coset through the three kernel ladders
        algs = (("pallas_fused",) if f is BLS12_381_FR
                else ("pallas", "mxu_fused"))
        for alg in algs:
            tag = f"{f.name} 2^{log_n} {alg}"
            back = intt(ntt(xd, f, algorithm=alg, device=dev), f,
                        algorithm=alg, device=dev)
            same_words(tag + " intt(ntt(x))", back, xs)
            same_words(tag + " coset_ntt",
                       coset_ntt(xd, f, algorithm=alg, device=dev),
                       golden_coset_ntt(f, xs, f.generator))
            print(f"path {tag} intt(ntt(x)) == x, coset_ntt golden-equal",
                  flush=True)
    return merged


def probe_path(rng, dev) -> dict:
    """Drives the probe entry once through its five stages at the BLS12-381
    Fr 2^18 level shape, as a caller attributing the level's time would;
    ``tw`` must equal the fused level itself. Returns the launch counts."""
    from ntt_tpu_torch import BLS12_381_FR as f
    from ntt_tpu_torch.kernels import mxu_level

    mats = sub_mats_on(f, {32}, False, dev)
    x = torch.from_numpy(random_words(f, (32, 8192), rng)).to(dev)
    T = torch.from_numpy(random_words(f, (32, 8192), rng)).to(dev)

    def drive():
        return [mxu_level.fused_level_probe(
            x, f, mats[32], stage, T if stage == "tw" else None)
            for stage in mxu_level.PROBE_STAGES]
    outs, c = counted(drive)
    expect_counts("probe bls12-381-fr [8,32,8192]", c,
                  {"fused_level_probe": 5})
    if not torch.equal(outs[0], x) or not torch.equal(
            outs[4], mxu_level.fused_level(x, f, mats[32], T, False)):
        raise AssertionError("probe: stream != x or tw != fused_level")
    return c


def gathered(y) -> torch.Tensor:
    """A distributed output (one [W, n2, n1/D] a shard) as one flat
    natural-order uint32[W, n] on the first shard's card."""
    dev = y[0].device
    full = torch.cat([t.to(dev) for t in y], dim=2)
    return full.reshape(full.shape[0], -1)


def same_shards(what, got, want) -> None:
    if len(got) != len(want) or not all(
            torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"{what}: shards differ")


#: the runs of the dist phase: (field, log2 n, local algorithm), every one
#: on a 1-D mesh of D = 4 shards of one card, exchange="pallas"
DIST_RUNS = (("bls12-381-fr", 22, "mxu_sub"), ("bls12-381-fr", 20, "pallas"),
             ("goldilocks", 24, "mxu_sub"))
DIST_D = 4
#: dist_lde: Goldilocks evaluations of this size, blowup 4
DIST_LDE_LOG = 22


def dist_counts(f, n, algorithm, D, exchange) -> dict:
    """Launches of one distributed transform: the local transforms' kernels
    (two local transforms a shard, each level of s points over the shard's
    n / D / s columns: the wide multi-level K3 above one wave of blocks)
    and D K8 launches under exchange "pallas"."""
    from ntt_tpu_torch.kernels import _build, mxu_level
    from ntt_tpu_torch.transforms import core, fourstep, mxu
    sms = _build.sm_count(torch.device("cuda", torch.cuda.current_device()))

    counts = {"a2a_transpose": D} if exchange == "pallas" else {}
    base = (mxu.effective_subbase(f) if algorithm == "mxu_sub"
            else fourstep.pallas_base_max(f))
    for m in core.split_log(n):
        sizes = []
        while m > base:
            sizes.append(base)
            m //= base
        sizes.append(m)
        for s in sizes:
            if s == 1:
                continue
            name = ("stage_ntt" if algorithm == "pallas"
                    else "fused_subntt" if s <= mxu_level.SUB_PEEL
                    else "fused_subntt_wide"
                    if mxu_level.sub_wide(f, s, n // D // s, sms)
                    else "fused_subntt_multi")
            counts[name] = counts.get(name, 0) + D
    return counts


def start_dist_goldens(pool, rng) -> dict:
    """The inputs of the multi-device phase and the futures of their golden
    results, on the host threads of ``pool`` (about a minute and a half of
    host time in all, most of it Goldilocks 2^24 and the LDE to 2^24):
    {(field, log2 n, algorithm): (input, forward)} for ``DIST_RUNS``,
    ``"coset"``: the BLS12-381 Fr forward coset of the first run's input,
    ``"lde"``: (Goldilocks 2^DIST_LDE_LOG evaluations, their LDE x4)."""
    from ntt_tpu_torch import get_field
    out = {}
    for fname, log_n, alg in DIST_RUNS:
        f = get_field(fname)
        xs = random_words(f, (1 << log_n,), rng)
        out[(fname, log_n, alg)] = (xs, pool.submit(golden_ntt, f, xs))
        if "coset" not in out:
            out["coset"] = pool.submit(golden_coset_ntt, f, xs, f.generator)
    f = get_field("goldilocks")
    xs = random_words(f, (1 << DIST_LDE_LOG,), rng)
    out["lde"] = (xs, pool.submit(golden_lde, f, xs, 4))
    return out


def dist_paths(rng, dev, path_ms, goldens) -> dict:
    """The multi-device four-step (``ntt_tpu_torch.parallel``) on a mesh of
    four shards of one card, every output word against the hostlib golden
    result, launch counts asserted: BLS12-381 Fr 2^22 (``mxu_sub``, K3)
    forward, ``dist_intt`` back to the input, forward ``coset_shift``, the
    forward under the exchanges ``all_to_all`` and ``ring`` (the same
    words), and five more random inputs through K8 against the plain
    exchange; BLS 2^20 under the local ``pallas`` (K5); Goldilocks 2^24
    (K3 multi-level) forward and ``dist_lde`` from 2^22 at blowup 4; then,
    where the machine has two cards or more, the BLS 2^22 forward across
    distinct cards. ``goldens``: the inputs and golden results
    (:func:`start_dist_goldens`). Returns the launch counts of the BLS
    2^22 forward."""
    from ntt_tpu_torch import get_field, limbs
    from ntt_tpu_torch.parallel import (dist_lde, make_dist_ntt, make_mesh,
                                        shard_for_ntt)

    mesh = make_mesh([dev] * DIST_D)
    main = None
    for fname, log_n, alg in DIST_RUNS:
        f, n = get_field(fname), 1 << log_n
        tag = f"{fname} 2^{log_n} dist D={DIST_D} {alg}"
        xs, want = goldens[(fname, log_n, alg)]
        want = want.result()
        xm = limbs.to_mont(torch.from_numpy(xs).to(dev), f)
        t0 = time.time()
        fwd = make_dist_ntt(f, n, mesh, algorithm=alg, exchange="pallas")
        t_tab = time.time() - t0
        shards = shard_for_ntt(xm, f, mesh)
        y, c = counted(lambda: fwd(shards))
        expect_counts(tag + " exchange=pallas", c,
                      dist_counts(f, n, alg, DIST_D, "pallas"))
        same_words(tag, limbs.from_mont(gathered(y), f), want)
        ms = path_ms[tag + " pallas"] = time_ms(lambda: fwd(shards), iters=5,
                                                warmup=1)
        print(f"path {tag} exchange=pallas  golden-equal  {ms:.4f} "
              f"ms/transform (Montgomery I/O, tables resident; tables built "
              f"in {t_tab:.1f} s)", flush=True)
        if main is None:
            main = c
            dist_bls_extras(f, n, alg, mesh, xs, xm, y, rng, dev, path_ms,
                            goldens["coset"])
        del y, shards, fwd
        torch.cuda.empty_cache()

    # dist_lde: Goldilocks 2^22 evaluations -> 2^24 coset evaluations
    f, n = get_field("goldilocks"), 1 << DIST_LDE_LOG
    xs, want = goldens["lde"]
    want = want.result()
    shards = shard_for_ntt(limbs.to_mont(torch.from_numpy(xs).to(dev), f), f,
                           mesh)
    y = dist_lde(shards, f, mesh, n, blowup=4, algorithm="mxu_sub")
    tag = f"goldilocks 2^{DIST_LDE_LOG} dist_lde x4 D={DIST_D} mxu_sub"
    same_words(tag, limbs.from_mont(gathered(y), f), want)
    ms = path_ms[tag] = time_ms(
        lambda: dist_lde(shards, f, mesh, n, blowup=4, algorithm="mxu_sub"),
        iters=3, warmup=1)
    print(f"path {tag} (to 2^{DIST_LDE_LOG + 2} points)  golden-equal  "
          f"{ms:.4f} ms (Montgomery I/O, tables resident)", flush=True)
    del y, shards
    torch.cuda.empty_cache()
    return main


def dist_bls_extras(f, n, alg, mesh, xs, xm, y, rng, dev, path_ms,
                    want_coset) -> None:
    """BLS12-381 Fr 2^22 beyond the forward: ``dist_intt`` back to the
    input, the forward coset (against the golden future ``want_coset``),
    the other two exchanges (the same words as K8's), five random inputs
    through K8 against the plain exchange, and the run across distinct
    cards where there are two or more."""
    from ntt_tpu_torch import limbs
    from ntt_tpu_torch.parallel import dist_intt, make_dist_ntt, shard_for_ntt

    tag = f"{f.name} 2^{n.bit_length() - 1} dist D={DIST_D} {alg}"
    back, c = counted(lambda: dist_intt(shard_for_ntt(gathered(y), f, mesh),
                                        f, mesh, n, algorithm=alg,
                                        exchange="pallas"))
    expect_counts(tag + " dist_intt", c,
                  dist_counts(f, n, alg, DIST_D, "pallas"))
    if not torch.equal(gathered(back), xm):
        raise AssertionError(f"{tag}: dist_intt(dist_ntt(x)) != x")
    del back
    inv = make_dist_ntt(f, n, mesh, inverse=True, algorithm=alg,
                        exchange="pallas")
    ys = shard_for_ntt(gathered(y), f, mesh)
    ms = path_ms[tag + " dist_intt"] = time_ms(lambda: inv(ys), iters=5,
                                               warmup=1)
    print(f"path {tag} dist_intt(dist_ntt(x)) == x  {ms:.4f} ms/transform",
          flush=True)
    del inv, ys

    shards = shard_for_ntt(xm, f, mesh)
    cos = make_dist_ntt(f, n, mesh, algorithm=alg, exchange="pallas",
                        coset_shift=f.generator)
    yc = cos(shards)
    same_words(tag + " coset", limbs.from_mont(gathered(yc), f),
               want_coset.result())
    ms = path_ms[tag + " coset"] = time_ms(lambda: cos(shards), iters=5,
                                           warmup=1)
    print(f"path {tag} coset_shift  golden-equal  {ms:.4f} ms/transform",
          flush=True)
    del cos, yc

    for exchange in ("all_to_all", "ring"):
        run = make_dist_ntt(f, n, mesh, algorithm=alg, exchange=exchange)
        got, c = counted(lambda: run(shards))
        expect_counts(f"{tag} exchange={exchange}", c,
                      dist_counts(f, n, alg, DIST_D, exchange))
        same_shards(f"{tag} exchange={exchange}", got, y)
        ms = path_ms[f"{tag} {exchange}"] = time_ms(lambda: run(shards),
                                                   iters=5, warmup=1)
        print(f"path {tag} exchange={exchange}  words equal to K8's  "
              f"{ms:.4f} ms/transform", flush=True)
        del got, run
    plain = make_dist_ntt(f, n, mesh, algorithm=alg, exchange="all_to_all")
    fwd = make_dist_ntt(f, n, mesh, algorithm=alg, exchange="pallas")
    for i in range(5):
        xi = shard_for_ntt(limbs.to_mont(torch.from_numpy(
            random_words(f, (n,), rng)).to(dev), f), f, mesh)
        same_shards(f"{tag} random input {i}: K8 against the plain exchange",
                    fwd(xi), plain(xi))
    print(f"path {tag}: five more random inputs, K8 and the plain exchange "
          "give the same words", flush=True)
    dist_where_the_time_goes(tag, lambda: fwd(shards))
    del plain, fwd, shards
    torch.cuda.empty_cache()
    cross_cards(f, n, alg, xs, y, path_ms, rng)


def dist_where_the_time_goes(tag, fn) -> None:
    """Device time by kernel of one distributed transform, from
    ``torch.profiler`` over three calls, and the host clock around it."""
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        iters = 3
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / iters
        rows = [(e.key, e.self_device_time_total / 1e3 / iters, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.count]
    except Exception as e:      # the tracer is optional tooling
        print(f"breakdown {tag}: profiler unavailable "
              f"({type(e).__name__}: {e})", flush=True)
        return
    busy = sum(r[1] for r in rows)
    if busy <= 0:
        print(f"breakdown {tag}: the profiler shows no device time",
              flush=True)
        return
    for key, ms, cnt in sorted(rows, key=lambda r: -r[1])[:8]:
        print(f"  {ms:.4f} ms a transform ({cnt / iters:g} launches)  "
              f"{key[:70]}")
    print(f"breakdown {tag}: device time {busy:.4f} ms a transform, host "
          f"clock {wall:.4f} ms with the profiler on", flush=True)


def cross_cards(f, n, alg, xs, y_one, path_ms, rng) -> None:
    """The BLS12-381 Fr 2^22 forward on a mesh of distinct cards (four, or
    two), K8 reading the other cards over peer access, against the golden
    NTT and the one-card run ``y_one``, six runs; K8 across the cards
    against its plain version (small shapes, and timed at the main path's
    shard shape). Says so where the machine has one card."""
    from ntt_tpu_torch import limbs
    from ntt_tpu_torch.kernels import exchange
    from ntt_tpu_torch.parallel import make_dist_ntt, make_mesh, shard_for_ntt

    count = torch.cuda.device_count()
    if count < 2:
        print(f"cross-card: not possible on this machine ({count} CUDA "
              "device); K8 ran on one card only, its sources all local",
              flush=True)
        return
    D = 4 if count >= 4 else 2
    devs = [torch.device("cuda", i) for i in range(D)]
    print(f"small shapes across {D} cards: "
          f"{check_small_exchange(rng, devs)} K8 calls word-equal to the "
          "plain version", flush=True)
    W, n1 = f.n_words, 2048
    n2_loc = 2048 // D
    C = random_shards(W, D, n1, n2_loc, rng, devs)
    same_shards(f"a2a_transpose across {D} cards",
                exchange.a2a_transpose(C, D),
                exchange.a2a_transpose_plain(C, D))
    ms = time_ms(lambda: exchange.a2a_transpose(C, D))
    plain_ms = time_ms(lambda: exchange.a2a_transpose_plain(C, D))
    per = W * n1 * n2_loc * 4                   # bytes a launch reads
    remote_ms = per * (D - 1) / D / NVLINK_BYTES_PER_S * 1e3
    local_ms = 2 * per / HBM_BYTES_PER_S * 1e3
    print(f"check a2a_transpose     [{W},{n1},{n2_loc}] x {D} on {D} cards  "
          f"word-equal  {ms:.4f} ms a call of {D} concurrent launches  "
          f"plain {plain_ms:.4f} ms  bound {max(remote_ms, local_ms):.4f} "
          f"ms a launch (its remote {per * (D - 1) // D} bytes over NVLink "
          f"at 450 GB/s)", flush=True)
    path_ms[f"a2a_transpose [{W},{n1},{n2_loc}] x {D} cards"] = ms
    del C

    mesh = make_mesh(devs)
    tag = f"{f.name} 2^{n.bit_length() - 1} dist D={D} distinct cards {alg}"
    xm = limbs.to_mont(torch.from_numpy(xs).to(devs[0]), f)
    run = make_dist_ntt(f, n, mesh, algorithm=alg, exchange="pallas")
    shards = shard_for_ntt(xm, f, mesh)
    y, c = counted(lambda: run(shards))
    expect_counts(tag, c, dist_counts(f, n, alg, D, "pallas"))
    same_words(tag, limbs.from_mont(gathered(y), f), golden_ntt(f, xs))
    if D == DIST_D and not torch.equal(gathered(y), gathered(y_one)):
        raise AssertionError(f"{tag}: differs from the one-card run")
    for i in range(5):
        same_shards(f"{tag} run {i + 2}", run(shards), y)
    ms = path_ms[tag] = time_ms(lambda: run(shards), iters=5, warmup=1)
    print(f"path {tag} exchange=pallas  golden-equal, six runs equal  "
          f"{ms:.4f} ms/transform", flush=True)


def probe_line(results) -> None:
    """The five truncations of the fused level at [8,32,8192] and what
    each stage adds, from the timed checks of ``fused_level_probe``: by
    events and by device time."""
    calls = results["fused_level_probe"]["calls"]
    ms = {c["shape"].split()[0]: c["ms"] for c in calls}
    dev = {c["shape"].split()[0]: c["device_ms"] for c in calls}
    prev, adds = 0.0, {}
    for stage in ("stream", "digits", "matmul", "reduce", "tw"):
        adds[stage] = ms[stage] - prev
        prev = ms[stage]
    print(json.dumps({"probe": {"shape": "bls12-381-fr [8,32,8192]",
                                "ms": ms, "added_ms": adds,
                                "device_ms": dev}}), flush=True)


def breakdown(f, n, rng, dev, algorithm="auto", xm=None) -> None:
    """Where the time of one forward transform (Montgomery I/O, tables
    resident) goes: the transposes between levels timed alone with CUDA
    events, then the device time of each kernel from ``torch.profiler``
    over ten transforms. The trace may drop events, so a kernel's time is
    its average over the launches captured, times the launches one
    transform makes (the wrappers' counts). ``xm``: the Montgomery-form
    input, else a random one."""
    from ntt_tpu_torch import limbs
    from ntt_tpu_torch.api import _chunked_pass, get_runner
    from ntt_tpu_torch.transforms import fourstep, mxu

    W = f.n_words
    tag = f"breakdown {f.name} 2^{n.bit_length() - 1}"
    if algorithm != "auto":
        tag += f" {algorithm}"
    run, aux = get_runner(f, n, algorithm=algorithm, device=dev)
    if xm is None:
        xm = _chunked_pass(lambda a: limbs.to_mont(a, f), torch.from_numpy(
            random_words(f, (n,), rng)).to(dev))
    base_max = mxu.BASE if W >= 8 else mxu.effective_subbase(f)
    total, m, R = 0.0, n, 1
    while algorithm == "auto" and m > base_max:
        n1, n2 = fourstep._split(m, base_max)
        y = xm.reshape(W, n1, n2, R)
        ms = time_ms(lambda: y.transpose(1, 2).contiguous())
        print(f"{tag}: transpose [{W},{n1},{n2},{R}] {ms:.4f} ms", flush=True)
        total += ms
        m, R = n2, R * n1
    transform_ms = time_ms(lambda: run(xm, aux), iters=10)
    if algorithm == "auto":
        print(f"{tag}: transposes {total:.4f} ms of {transform_ms:.4f} ms",
              flush=True)
    _, launches = counted(lambda: run(xm, aux))
    expected = {f"{name}_kernel<": c for name, c in launches.items()}
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        iters = 10
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                run(xm, aux)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / iters
        rows = [(e.key, e.self_device_time_total / 1e3 / max(e.count, 1),
                 e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.count]
        if not rows or sum(r[1] for r in rows) <= 0:
            print(f"{tag}: the profiler shows no device time", flush=True)
            return
        busy, shown, others = 0.0, 0, 0.0
        for key, avg_ms, cnt in sorted(rows, key=lambda r: -r[1] * r[2]):
            # the port's kernels by their wrappers' counts, PyTorch's own
            # (the levels' copies, the plain passes) as captured
            ours = next((c for k, c in expected.items() if k in key), None)
            per = cnt / iters if ours is None else ours
            busy += avg_ms * per
            if ours is None and shown >= 6:
                others += avg_ms * per
                continue
            shown += 1
            print(f"  {avg_ms:.4f} ms/launch x {per:g} launches = "
                  f"{avg_ms * per:.4f} ms ({cnt} of {per * iters:g} launches "
                  f"captured)  {key[:70]}")
        if others:
            print(f"  {others:.4f} ms in PyTorch's other kernels")
        print(f"{tag}: device time {busy:.4f} ms of the {transform_ms:.4f} "
              f"ms transform, gaps {transform_ms - busy:.4f} ms (share "
              f"{max(0.0, 1 - busy / transform_ms):.3f}); with the profiler "
              f"on the host clock reads {wall:.4f} ms/transform", flush=True)
    except Exception as e:      # the tracer is optional tooling
        print(f"{tag}: profiler unavailable ({type(e).__name__}: {e})",
              flush=True)


# ---------------------------------------------------------------------------
# The tools (ntt_tpu_torch.tools): the checking and timing tools on the card
# ---------------------------------------------------------------------------

#: seconds of timed calls a tool's measurement aims at in this phase (the
#: tools' own default is 1.5 s): keeps the phase near two minutes
TOOLS_TARGET_S = "0.25"

#: (tool, arguments, environment) of each in-process run, after the
#: default health check, which runs as ``python3 -m``; keys "mxu.NAME" of
#: the environment are knob constants (:func:`knobs_set`): under
#: NTT_MXU_BASE_LOG=6 the knockout at m = 64 and the four single-level
#: algorithms on every field, forward and inverse, at 2^12 (64 x 64)
TOOL_RUNS = (
    ("healthcheck", ["bls12-381-fr", "12"], {}),
    ("healthcheck", ["--deep"], {}),
    ("sweep", ["bls12-381-fr", "auto"], {"SWEEP_VERIFY": "full"}),
    ("sweep", ["goldilocks", "auto", "18,20,24"], {}),
    ("shootout", ["18", "bls12-381-fr"], {}),
    ("shootout", ["20", "goldilocks"], {}),
    ("microbench", ["18", "bls12-381-fr"], {}),
    ("microbench", ["knockout", "18", "bls12-381-fr"], {}),
    ("microbench", ["knockout", "18", "bls12-381-fr", "64"], BASE64),
    *(("healthcheck", [name, "12", "mxu_chunked,mxu_pallas,mxu_fused,mxu_sub"],
       BASE64) for name in ("bls12-381-fr", "bn254-fr", "goldilocks",
                            "small-proth")),
    ("scaling", [], {}),
    ("scaling", ["bls12-381-fr", "16", "mxu_sub"], {}),
)

#: the tools whose JSON records each carry a ``bitexact``
TOOLS_BITEXACT = ("sweep", "scaling")


@contextlib.contextmanager
def environment(values: dict):
    """``values`` set in ``os.environ`` while the block runs."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def tool_summary(what, name, rc, text) -> str:
    """Checks a tool's run (exit code 0, no MISMATCH / FAIL / FAILED line,
    every ``bitexact`` true) and says what it measured."""
    lines = text.splitlines()
    bad = [ln for ln in lines if re.search(r"\b(MISMATCH|FAIL)", ln)]
    recs = [json.loads(ln) for ln in lines if ln.startswith("{")]
    inexact = [r for r in recs if r.get("bitexact") is not True]
    if rc != 0 or bad or (name in TOOLS_BITEXACT and (inexact or not recs)):
        raise AssertionError(
            f"tools {what}: rc {rc}, {len(bad)} failed lines, "
            f"{len(inexact)} records not bit-exact:\n" + text[-4000:])
    if name == "healthcheck":
        return f"{sum(' OK' in ln for ln in lines)} OK"
    if name == "sweep":
        return "bit-exact; ms " + ", ".join(
            f"2^{r['log_n']} {r['ms']:.4f}" for r in recs)
    if name == "scaling":
        return "bit-exact; ms a step " + ", ".join(
            f"D={r['D']} {r['ms_per_step']:.4f}" for r in recs)
    if what.startswith("microbench knockout") or name == "shootout":
        rows = [ln.split() for ln in lines if not ln.startswith("#")]
        return "ms " + ", ".join(f"{r[0]} {r[1]}" for r in rows)
    return f"{sum(ln.endswith(' ms') for ln in lines)} components timed"


def tools_phase(card) -> None:
    """Runs the tools the way a user would on the card: the default health
    check through ``python3 -m``, then each run of ``TOOL_RUNS`` in-process
    with its output captured, at ``TOOLS_TARGET_S``. Each prints a ``tools``
    line (exit code, seconds, what it measured, the card) and its own
    output indented. Counts the kernels' launches of the in-process runs
    and fails if one of K1-K8 was never launched."""
    import importlib
    import io

    from ntt_tpu_torch.kernels import _build

    t_phase = time.time()
    t0 = time.time()
    out = subprocess.run(
        [sys.executable, "-m", "ntt_tpu_torch.tools.healthcheck"],
        capture_output=True, text=True, timeout=600)
    what = "healthcheck (python3 -m, defaults)"
    summary = tool_summary(what, "healthcheck", out.returncode,
                           out.stdout + out.stderr)
    print(f"tools {what}: rc 0 in {time.time() - t0:.1f} s, {summary}; "
          f"card: {card}")
    for ln in out.stdout.splitlines():
        print(f"  {ln}")
    torch.cuda.synchronize()
    _build.launches.clear()
    for name, argv, extra in TOOL_RUNS:
        tool = importlib.import_module(f"ntt_tpu_torch.tools.{name}")
        what = " ".join([name] + argv + [f"{k}={v}" for k, v in extra.items()])
        buf = io.StringIO()
        t0 = time.time()
        env = {k: v for k, v in extra.items() if not k.startswith("mxu.")}
        knobs = {k: v for k, v in extra.items() if k.startswith("mxu.")}
        with environment({"SHOOT_TARGET_S": TOOLS_TARGET_S, **env}), \
                knobs_set(knobs), contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(buf):
            rc = tool.main(argv)
        torch.cuda.synchronize()
        seconds = time.time() - t0
        summary = tool_summary(what, name, rc, buf.getvalue())
        print(f"tools {what}: rc 0 in {seconds:.1f} s, {summary}; "
              f"card: {card}")
        print("\n".join(f"  {ln}" for ln in buf.getvalue().splitlines()),
              flush=True)
    counts = dict(_build.launches)
    missing = [k for k in KERNELS
               if counts.get(k, 0) + counts.get(f"{k}_persist", 0) < 1]
    print(f"tools launches: {json.dumps(counts)}; phase "
          f"{time.time() - t_phase:.1f} s", flush=True)
    if missing:
        raise AssertionError(f"tools: {missing} never launched")


# ---------------------------------------------------------------------------
# The big-integer layer (ntt_tpu_torch.bigint): plain PyTorch on the card;
# no TPU kernel stands behind ntt_tpu.bigint, so it adds no kernel
# ---------------------------------------------------------------------------

#: columns every op is held on against Python ints, at W = 2 and W = 8
#: (2^16 before: cut to keep the script near half its time limit)
BIGINT_CHECK_COLS = 1 << 14
#: columns each op is timed on at W = 8 (one BLS12-381 Fr vector of 2^20),
#: and the ops timed on fewer
BIGINT_TIMED_COLS = 1 << 20
BIGINT_TIMED_LESS = {"modular_power": 1 << 18, "modular_inverse": 1 << 18,
                     "gcd": 1 << 18}
#: timed columns held against Python ints
BIGINT_SAMPLE = 4096
#: columns modular_power is checked on at W = 8 (Python's pow takes about
#: 0.17 ms a column there)
BIGINT_POWER_CHECK_COLS = 1 << 14
M32 = 0xFFFFFFFF


def col_ints(a) -> list:
    """uint32[W, n] words (numpy) -> Python ints, one ``int.from_bytes`` a
    column."""
    return [int.from_bytes(c.tobytes(), "little")
            for c in np.ascontiguousarray(a.T)]


def bigint_inputs(W, n, rng) -> dict:
    """Seeded operands, numpy uint32 [W, n] words (``u``: a uint32 [n]
    plane). The first columns hold tests/test_bigint.py's special values
    (0, 1, 2, 3, all-ones, the top bit, ...), some columns are equal, and
    the divisors hold zeros."""
    bits = 32 * W
    top = (1 << bits) - 1
    special = [0, 1, 2, 3, top, top - 1, top >> 1, (top >> 1) + 1,
               1 << (16 * W), (1 << (16 * W)) - 1]
    sp = np.frombuffer(b"".join(v.to_bytes(4 * W, "little")
                                for v in special),
                       dtype="<u4").reshape(len(special), W).T

    def words():
        return rng.integers(0, 1 << 32, size=(W, n),
                            dtype=np.uint64).astype(np.uint32)

    x, y, z, lo = words(), words(), words(), words()
    x[:, :10], y[:, :10] = sp, sp[:, ::-1]
    y[:, 10:14] = x[:, 10:14]                  # equal columns
    x[:, 14] = y[:, 14] = y[:, 15] = 0         # gcd(0, 0), x / 0
    dnz = y.copy()
    dnz[0, (y == 0).all(axis=0)] = 7

    def below(dv):
        """Random words below dv column by column (0 where dv's top word
        is 0)."""
        h = words()
        h[W - 1] = dv[W - 1] >> 1
        h[:, dv[W - 1] == 0] = 0
        return h

    hi = below(y)
    hi[:, 16:18] = y[:, 16:18]                 # hi >= y: q truncates
    u = rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    u[:6] = [0, 1, 2, M32, 0x80000000, 0x7FFFFFFF]
    u[10:14] = x[0, :4]                        # x == u
    m, pm = y.copy(), y.copy()
    m[0] |= 3                                  # odd moduli >= 3
    pm[0] |= 2                                 # power moduli >= 2
    odd = x.copy()
    odd[0] |= 1
    return {"x": x, "y": y, "z": z, "lo": lo, "d": y, "dnz": dnz,
            "hi": hi, "hib": below(dnz), "m": m, "pm": pm, "odd": odd,
            "u": u, "oddu": u | 1}


def bigint_cases(W, dev) -> list:
    """Every op of ``ntt_tpu_torch.bigint`` and ``limbs.eq`` as
    (name, output kinds, call on the device tensors T, Python-int result
    from the columns' ints v). Kinds: w words uint32 [W, n], u uint32 [n],
    i int32 [n], b bool [n]. The first case of a name is the one timed."""
    from ntt_tpu_torch import bigint as tb
    from ntt_tpu_torch import limbs

    bits, top = 32 * W, (1 << (32 * W)) - 1

    def each(f, *keys):
        return lambda v: [f(*t) for t in zip(*(v[k] for k in keys))]

    def pair(f, g, *keys):
        return lambda v: (each(f, *keys)(v), each(g, *keys)(v))

    def mask(nb):
        if 0 <= nb < bits:
            return (1 << nb) - 1
        if -bits < nb < 0:
            return ((1 << -nb) - 1) << (bits + nb)
        return top

    def field(start, length):
        return (1 << max(min(length, bits - start), 0)) - 1

    def inverse_2k(a):
        """a^-1 mod 2^bits (odd a) by Newton's steps on Python ints, each
        doubling the bits that are right; the result is checked."""
        r = a
        for _ in range(bits.bit_length()):
            r = r * (2 - a * r) & top
        assert a * r & top == 1
        return r

    def inv(a, m):
        return pow(a, -1, m) if math.gcd(a, m) == 1 else 0

    def wide(h, lo):
        return (h << bits) | lo

    def sqrt_rem_wide(v):
        root, r_lo, r_hi = [], [], []
        for lo, h in zip(v["x"], v["y"]):
            r = math.isqrt(wide(h, lo))
            root.append(r)
            r_lo.append((wide(h, lo) - r * r) & top)
            r_hi.append((wide(h, lo) - r * r) >> bits)
        return root, r_lo, r_hi

    def approx(dv):
        s = bits - dv.bit_length()
        return top if dv == 0 else ((1 << (2 * bits)) - 1) // (dv << s) \
            - (1 << bits)

    cases = [
        ("add", "wu", lambda T: tb.add(T["x"], T["y"]),
         pair(lambda a, b: (a + b) & top, lambda a, b: (a + b) >> bits,
              "x", "y")),
        ("sub", "wu", lambda T: tb.sub(T["x"], T["y"]),
         pair(lambda a, b: (a - b) & top, lambda a, b: int(a < b),
              "x", "y")),
        ("compare", "i", lambda T: tb.compare(T["x"], T["y"]),
         each(lambda a, b: (a > b) - (a < b), "x", "y")),
        ("equals", "b", lambda T: tb.equals(T["x"], T["y"]),
         each(lambda a, b: a == b, "x", "y")),
        ("limbs.eq", "b", lambda T: limbs.eq(T["x"], T["y"]),
         each(lambda a, b: a == b, "x", "y")),
        ("pop_count", "i", lambda T: tb.pop_count(T["x"]),
         each(lambda a: bin(a).count("1"), "x")),
        ("clz", "i", lambda T: tb.clz(T["x"]),
         each(lambda a: bits - a.bit_length(), "x")),
        ("ctz", "i", lambda T: tb.ctz(T["x"]),
         each(lambda a: bits if a == 0 else (a & -a).bit_length() - 1,
              "x")),
        ("set_", "w", lambda T: tb.set_(T["x"]), each(lambda a: a, "x")),
        ("swap", "ww", lambda T: tb.swap(T["x"], T["y"]),
         lambda v: (list(v["y"]), list(v["x"]))),
        ("negate", "w", lambda T: tb.negate(T["x"]),
         each(lambda a: -a & top, "x")),
        ("bitwise_and", "w", lambda T: tb.bitwise_and(T["x"], T["y"]),
         each(lambda a, b: a & b, "x", "y")),
        ("bitwise_ior", "w", lambda T: tb.bitwise_ior(T["x"], T["y"]),
         each(lambda a, b: a | b, "x", "y")),
        ("bitwise_xor", "w", lambda T: tb.bitwise_xor(T["x"], T["y"]),
         each(lambda a, b: a ^ b, "x", "y")),
        ("bitwise_complement", "w", lambda T: tb.bitwise_complement(T["x"]),
         each(lambda a: a ^ top, "x")),
        ("bitwise_select", "w",
         lambda T: tb.bitwise_select(T["x"], T["y"], T["z"]),
         each(lambda a, b, c: (a & ~c & top) | (b & c), "x", "y", "z")),
    ]
    for k in (37, 0, bits - 1, bits + 3):
        r = k % bits
        cases += [
            ("shift_left", "w", lambda T, k=k: tb.shift_left(T["x"], k),
             each(lambda a, k=k: (a << k) & top, "x")),
            ("shift_right", "w", lambda T, k=k: tb.shift_right(T["x"], k),
             each(lambda a, k=k: a >> k, "x")),
            ("rotate_left", "w", lambda T, k=k: tb.rotate_left(T["x"], k),
             each(lambda a, r=r: ((a << r) | (a >> (bits - r))) & top,
                  "x")),
            ("rotate_right", "w", lambda T, k=k: tb.rotate_right(T["x"], k),
             each(lambda a, r=r: ((a >> r) | (a << (bits - r))) & top,
                  "x"))]
    for nb in (-13, 45, 0, 2 * bits):
        mv = mask(nb)
        cases += [
            ("bitwise_mask_copy", "w",
             lambda T, nb=nb: tb.bitwise_mask_copy(W, nb, (T["n"],),
                                                   device=dev),
             lambda v, mv=mv: [mv] * len(v["x"])),
            ("bitwise_mask_and", "w",
             lambda T, nb=nb: tb.bitwise_mask_and(T["x"], nb),
             each(lambda a, mv=mv: a & mv, "x")),
            ("bitwise_mask_ior", "w",
             lambda T, nb=nb: tb.bitwise_mask_ior(T["x"], nb),
             each(lambda a, mv=mv: a | mv, "x")),
            ("bitwise_mask_xor", "w",
             lambda T, nb=nb: tb.bitwise_mask_xor(T["x"], nb),
             each(lambda a, mv=mv: a ^ mv, "x")),
            ("bitwise_mask_select", "w",
             lambda T, nb=nb: tb.bitwise_mask_select(T["x"], T["y"], nb),
             each(lambda a, b, mv=mv: (a & ~mv & top) | (b & mv),
                  "x", "y"))]
    for st, ln in ((13, 37), (bits - 5, 20)):
        f = field(st, ln)
        fu = field(st, min(ln, 32))
        cases += [
            ("bit_extract", "w",
             lambda T, st=st, ln=ln: tb.bit_extract(T["x"], st, ln),
             each(lambda a, st=st, f=f: (a >> st) & f, "x")),
            ("bit_insert", "w",
             lambda T, st=st, ln=ln: tb.bit_insert(T["x"], T["y"], st, ln),
             each(lambda a, b, st=st, f=f: (a & ~(f << st) & top)
                  | ((b & f) << st & top), "x", "y")),
            ("extract_bits_ui32", "u",
             lambda T, st=st, ln=ln: tb.extract_bits_ui32(T["x"], st, ln),
             each(lambda a, st=st, ln=ln: (a >> st) & ((1 << min(ln, 32))
                                                       - 1), "x")),
            ("insert_bits_ui32", "w",
             lambda T, st=st, ln=ln: tb.insert_bits_ui32(T["x"], st, ln,
                                                         T["u"]),
             each(lambda a, c, st=st, f=fu: (a & ~(f << st) & top)
                  | ((c & f) << st & top), "x", "u"))]
    cases += [
        ("mul_wide", "ww", lambda T: tb.mul_wide(T["x"], T["y"]),
         pair(lambda a, b: a * b & top, lambda a, b: a * b >> bits,
              "x", "y")),
        ("mul", "w", lambda T: tb.mul(T["x"], T["y"]),
         each(lambda a, b: a * b & top, "x", "y")),
        ("mul_high", "w", lambda T: tb.mul_high(T["x"], T["y"]),
         each(lambda a, b: a * b >> bits, "x", "y")),
        ("sqr", "w", lambda T: tb.sqr(T["x"]),
         each(lambda a: a * a & top, "x")),
        ("sqr_wide", "ww", lambda T: tb.sqr_wide(T["x"]),
         pair(lambda a: a * a & top, lambda a: a * a >> bits, "x")),
        ("sqr_high", "w", lambda T: tb.sqr_high(T["x"]),
         each(lambda a: a * a >> bits, "x")),
        ("div_rem", "ww", lambda T: tb.div_rem(T["x"], T["d"]),
         pair(lambda a, b: a // b if b else top,
              lambda a, b: a % b if b else a, "x", "d")),
        ("div", "w", lambda T: tb.div(T["x"], T["d"]),
         each(lambda a, b: a // b if b else top, "x", "d")),
        ("rem", "w", lambda T: tb.rem(T["x"], T["d"]),
         each(lambda a, b: a % b if b else a, "x", "d")),
        ("div_rem_wide", "ww",
         lambda T: tb.div_rem_wide(T["lo"], T["hi"], T["d"]),
         pair(lambda lo, h, b: wide(h, lo) // b & top if b else top,
              lambda lo, h, b: wide(h, lo) % b if b else lo,
              "lo", "hi", "d")),
        ("div_wide", "w", lambda T: tb.div_wide(T["lo"], T["hi"], T["d"]),
         each(lambda lo, h, b: wide(h, lo) // b & top if b else top,
              "lo", "hi", "d")),
        ("rem_wide", "w", lambda T: tb.rem_wide(T["lo"], T["hi"], T["d"]),
         each(lambda lo, h, b: wide(h, lo) % b if b else lo,
              "lo", "hi", "d")),
        ("sqrt", "w", lambda T: tb.sqrt(T["x"]),
         each(math.isqrt, "x")),
        ("sqrt_rem", "ww", lambda T: tb.sqrt_rem(T["x"]),
         pair(math.isqrt, lambda a: a - math.isqrt(a) ** 2, "x")),
        ("sqrt_wide", "w", lambda T: tb.sqrt_wide(T["x"], T["y"]),
         each(lambda lo, h: math.isqrt(wide(h, lo)), "x", "y")),
        ("sqrt_rem_wide", "www", lambda T: tb.sqrt_rem_wide(T["x"], T["y"]),
         sqrt_rem_wide),
        ("gcd", "w", lambda T: tb.gcd(T["x"], T["y"]),
         each(math.gcd, "x", "y")),
        ("modular_inverse", "w",
         lambda T: tb.modular_inverse(T["x"], T["m"]), each(inv, "x", "m")),
        ("binary_inverse", "w", lambda T: tb.binary_inverse(T["odd"]),
         each(inverse_2k, "odd")),
        ("modular_power", "w",
         lambda T: tb.modular_power(*(T[k][:, :T["power_cols"]]
                                      for k in ("x", "z", "pm"))),
         lambda v: [pow(*t) for t in zip(*(v[k][:v.get("power_cols")]
                                          for k in ("x", "z", "pm")))]),
        ("get_ui32", "u", lambda T: tb.get_ui32(T["x"]),
         each(lambda a: a & M32, "x")),
        ("set_ui32", "w",
         lambda T: tb.set_ui32(W, T["u"], (T["n"],), device=dev),
         each(lambda c: c, "u")),
        ("add_ui32", "wu", lambda T: tb.add_ui32(T["x"], T["u"]),
         pair(lambda a, c: (a + c) & top, lambda a, c: (a + c) >> bits,
              "x", "u")),
        ("sub_ui32", "wu", lambda T: tb.sub_ui32(T["x"], T["u"]),
         pair(lambda a, c: (a - c) & top, lambda a, c: int(a < c),
              "x", "u")),
        ("mul_ui32", "wu", lambda T: tb.mul_ui32(T["x"], T["u"]),
         pair(lambda a, c: a * c & top, lambda a, c: a * c >> bits & M32,
              "x", "u")),
        ("div_rem_ui32", "wu", lambda T: tb.div_rem_ui32(T["x"], T["u"]),
         pair(lambda a, c: a // c if c else top,
              lambda a, c: a % c if c else a & M32, "x", "u")),
        ("div_ui32", "w", lambda T: tb.div_ui32(T["x"], T["u"]),
         each(lambda a, c: a // c if c else top, "x", "u")),
        ("rem_ui32", "u", lambda T: tb.rem_ui32(T["x"], T["u"]),
         each(lambda a, c: a % c if c else a & M32, "x", "u")),
        ("equals_ui32", "b", lambda T: tb.equals_ui32(T["x"], T["u"]),
         each(lambda a, c: a == c, "x", "u")),
        ("compare_ui32", "i", lambda T: tb.compare_ui32(T["x"], T["u"]),
         each(lambda a, c: (a > c) - (a < c), "x", "u")),
        ("binary_inverse_ui32", "u",
         lambda T: tb.binary_inverse_ui32(T["oddu"]),
         each(lambda c: pow(c, -1, 1 << 32), "oddu")),
        ("gcd_ui32", "u", lambda T: tb.gcd_ui32(T["x"], T["u"]),
         each(lambda a, c: math.gcd(a, c) if c else 0, "x", "u")),
        ("barrett_approximation", "wi",
         lambda T: tb.barrett_approximation(T["d"]),
         pair(approx, lambda dv: bits - dv.bit_length(), "d")),
        ("barrett_div_rem", "ww",
         lambda T: tb.barrett_div_rem(T["x"], T["dnz"], *T["approx"]),
         pair(lambda a, b: a // b, lambda a, b: a % b, "x", "dnz")),
        ("barrett_div", "w",
         lambda T: tb.barrett_div(T["x"], T["dnz"], *T["approx"]),
         each(lambda a, b: a // b, "x", "dnz")),
        ("barrett_rem", "w",
         lambda T: tb.barrett_rem(T["x"], T["dnz"], *T["approx"]),
         each(lambda a, b: a % b, "x", "dnz")),
        ("barrett_div_rem_wide", "ww",
         lambda T: tb.barrett_div_rem_wide(T["lo"], T["hib"], T["dnz"],
                                           *T["approx"]),
         pair(lambda lo, h, b: wide(h, lo) // b,
              lambda lo, h, b: wide(h, lo) % b, "lo", "hib", "dnz")),
        ("barrett_div_wide", "w",
         lambda T: tb.barrett_div_wide(T["lo"], T["hib"], T["dnz"],
                                       *T["approx"]),
         each(lambda lo, h, b: wide(h, lo) // b, "lo", "hib", "dnz")),
        ("barrett_rem_wide", "w",
         lambda T: tb.barrett_rem_wide(T["lo"], T["hib"], T["dnz"],
                                       *T["approx"]),
         each(lambda lo, h, b: wide(h, lo) % b, "lo", "hib", "dnz")),
        ("Accumulator", "w",
         lambda T: tb.Accumulator(W, (T["n"],), device=dev).add(T["x"]).add(
             T["y"]).sub(T["z"]).resolve(),
         each(lambda a, b, c: (a + b - c) & top, "x", "y", "z")),
    ]
    return cases


def bigint_tensors(arrays, dev) -> dict:
    """The operands on the card, with the Barrett approximation of the
    nonzero divisors (its own op is checked separately)."""
    from ntt_tpu_torch import bigint as tb
    T = {k: torch.from_numpy(a).to(dev) for k, a in arrays.items()}
    T["n"] = T["power_cols"] = arrays["x"].shape[1]
    T["approx"] = tb.barrett_approximation(T["dnz"])
    return T


def bigint_ints(arrays, idx) -> dict:
    """The operands' Python ints at the columns ``idx`` (None: all)."""
    return {k: (a.tolist() if idx is None else a[idx].tolist())
            if a.ndim == 1 else col_ints(a if idx is None else a[:, idx])
            for k, a in arrays.items()}


def flat_outputs(out) -> list:
    """An op's outputs (a tensor or nested tuples) as a flat list."""
    if isinstance(out, tuple):
        return [o for part in out for o in flat_outputs(part)]
    return [out]


def bigint_same(what, out, kinds, want, idx, dev) -> None:
    """Every output on the card, of its kind's dtype, and equal at the
    columns ``idx`` (None: all) to the Python-int result."""
    outs = flat_outputs(out)
    dtypes = {"w": torch.uint32, "u": torch.uint32, "i": torch.int32,
              "b": torch.bool}
    want = (want,) if len(kinds) == 1 else want
    if len(outs) != len(kinds):
        raise AssertionError(f"bigint {what}: {len(outs)} outputs")
    for k, (o, kind, w) in enumerate(zip(outs, kinds, want)):
        if o.device != dev or o.dtype != dtypes[kind]:
            raise AssertionError(f"bigint {what}: output {k} {o.dtype} on "
                                 f"{o.device}")
        o = o.cpu().numpy()
        if idx is not None:
            o = o[:, idx] if kind == "w" else o[idx]
        got = col_ints(o) if kind == "w" else o.tolist()
        if got != list(w):
            bad = sum(g != v for g, v in zip(got, w))
            raise AssertionError(f"bigint {what}: output {k}: {bad} of "
                                 f"{len(got)} columns differ from Python "
                                 "ints")


def bigint_check_width(W, n, rng, dev) -> int:
    """Every op at width W on n columns (modular_power at W = 8 on the
    first BIGINT_POWER_CHECK_COLS), each output held in full against
    Python ints; returns the calls made."""
    arrays = bigint_inputs(W, n, rng)
    T, v = bigint_tensors(arrays, dev), bigint_ints(arrays, None)
    if W == 8:
        T["power_cols"] = v["power_cols"] = min(n, BIGINT_POWER_CHECK_COLS)
    cases = bigint_cases(W, dev)
    for name, kinds, fn, want in cases:
        bigint_same(f"{name} W={W}", fn(T), kinds, want(v), None, dev)
    from ntt_tpu_torch import bigint as tb
    public = {k for k in dir(tb) if not k.startswith("_")
              and getattr(getattr(tb, k), "__module__", None) == tb.__name__}
    missed = public - {c[0] for c in cases}
    if missed or len(public) != 68:
        raise AssertionError(f"bigint: {len(public)} public names, not run: "
                             f"{sorted(missed)}")
    return len(cases)


def device_launches(fn, dev) -> tuple:
    """(the device kernels one call of ``fn`` launches, whether the trace
    holds the whole call), by ``torch.profiler`` (device activity only,
    counted from the raw trace events: the per-op summary costs about 0.2
    ms an event to build). The tracer can drop kernels at a window's
    edges, so 256 float multiplies before the call and 256 float adds
    after it (the ops here run no float kernel) pad the window and are
    left out of the count; the call is whole where some of both show. A
    trace with no device kernel at all, not even the 512 pads, is a tracer
    that recorded nothing: the call is traced again, up to three times in
    all, and fails if no trace shows a kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    pad = torch.ones(1, device=dev)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(256):
                pad.mul_(1.0)
            fn()
            for _ in range(256):
                pad.add_(0.0)
            torch.cuda.synchronize()
        names = [e.name() for e in prof.profiler.kineto_results.events()
                 if e.device_type() == DeviceType.CUDA
                 and not e.name().startswith(("Memcpy", "Memset"))]
        if names:
            break
        print("device_launches: the trace holds no device kernel, not "
              "even the pads; tracing the call again", flush=True)
    else:
        raise AssertionError("torch.profiler traced no device kernel")
    lead = sum("MulFunctor<float>" in n for n in names)
    trail = sum("float" in n for n in names) - lead
    return len(names) - lead - trail, lead > 0 and trail > 0


def bigint_times(rng, dev) -> tuple:
    """Each op at W = 8 on BIGINT_TIMED_COLS columns (BIGINT_TIMED_LESS for
    the ops named there): one warm call traced for its launches, then the
    median of three by CUDA events; the last result held against Python
    ints on BIGINT_SAMPLE columns (the special ones among them). Returns
    (op -> times, the ops whose trace lost kernels at an edge)."""
    W = 8
    sizes = sorted({BIGINT_TIMED_COLS, *BIGINT_TIMED_LESS.values()})
    times, cut = {}, []
    for n in sizes:
        arrays = bigint_inputs(W, n, rng)
        idx = np.unique(np.concatenate([
            np.arange(20), rng.choice(n, BIGINT_SAMPLE - 20,
                                      replace=False)]))
        T, v = bigint_tensors(arrays, dev), bigint_ints(arrays, idx)
        seen = set()
        for name, kinds, fn, want in bigint_cases(W, dev):
            if name in seen or BIGINT_TIMED_LESS.get(name,
                                                     BIGINT_TIMED_COLS) != n:
                continue
            seen.add(name)
            # the warm call, traced for its launches
            t_traced = time.time()
            launches, whole = device_launches(lambda: fn(T), dev)
            t_traced = time.time() - t_traced
            ms = []
            for _ in range(3):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(T)
                end.record()
                end.synchronize()
                ms.append(start.elapsed_time(end))
            bigint_same(f"{name} W={W} n={n}", out, kinds, want(v), idx,
                        dev)
            del out
            times[name] = {"ms": statistics.median(ms),
                           "launches": launches, "elements": n, "W": W}
            per = (f"{times[name]['ms'] * 1e3 / launches:.2f} us a launch"
                   if launches else "no launch")
            if not whole:
                cut.append(name)
                per += ", the trace cut into the call"
            print(f"bigint {name}: {times[name]['ms']:.4f} ms at W={W}, "
                  f"n={n}, {launches} launches, {per} (traced call "
                  f"{t_traced:.1f} s)", flush=True)
        del T
        torch.cuda.empty_cache()
    return times, cut


def time_bigint(rng, dev) -> None:
    """The bigint phase's timings (``bigint_times``), made while no host
    thread computes a golden result; prints the ``bigint`` JSON line."""
    t0 = time.time()
    times, cut = bigint_times(rng, dev)
    print(json.dumps({"bigint": times}))
    print(f"bigint timings: {time.time() - t0:.1f} s; traces cut at an "
          f"edge: {len(cut)} {cut}", flush=True)


def check_bigint(rng, dev) -> None:
    """The bigint phase's checks: every op of ``ntt_tpu_torch.bigint`` and
    ``limbs.eq`` on the card at W = 2 and 8 on BIGINT_CHECK_COLS columns
    against Python ints (sentinels included)."""
    t0 = time.time()
    for W in (2, 8):
        calls = bigint_check_width(W, BIGINT_CHECK_COLS, rng, dev)
        print(f"bigint W={W}: {calls} calls on {BIGINT_CHECK_COLS} columns "
              f"equal to Python ints ({time.time() - t0:.1f} s)", flush=True)


#: kernel -> (source, the TPU kernel it replaces)
KERNELS = {
    "base_ntt_mxu": ("ntt_tpu_torch/csrc/mxu_level.cu",
                     "ntt_tpu/kernels/mxu_ntt.py:128"),
    "fused_level_stack": ("ntt_tpu_torch/csrc/mxu_level.cu",
                          "ntt_tpu/kernels/mxu_level.py:410"),
    "fused_subntt": ("ntt_tpu_torch/csrc/mxu_level.cu",
                     "ntt_tpu/kernels/mxu_level.py:144"),
    "fused_subntt_multi": ("ntt_tpu_torch/csrc/mxu_sub.cu",
                           "ntt_tpu/kernels/mxu_level.py:144"),
    "fused_subntt_wide": ("ntt_tpu_torch/csrc/mxu_sub.cu",
                          "ntt_tpu/kernels/mxu_level.py:144"),
    "fused_level": ("ntt_tpu_torch/csrc/mxu_level.cu",
                    "ntt_tpu/kernels/mxu_level.py:67"),
    "stage_ntt": ("ntt_tpu_torch/csrc/vmem_ntt.cu",
                  "ntt_tpu/kernels/vmem_ntt.py:87"),
    "fused_stage_level": ("ntt_tpu_torch/csrc/vmem_ntt.cu",
                          "ntt_tpu/kernels/vmem_ntt.py:93"),
    "fused_level_probe": ("ntt_tpu_torch/csrc/mxu_level.cu",
                          "ntt_tpu/kernels/mxu_level.py:562"),
    "a2a_transpose": ("ntt_tpu_torch/csrc/exchange.cu",
                      "ntt_tpu/kernels/exchange.py:39"),
}

#: the run whose launches each kernel's line counts
MAIN_PATH = {
    "fused_subntt_multi": "goldilocks 2^18 forward",
    "fused_subntt_wide": "goldilocks 2^24 forward",
    "fused_level": "bls12-381-fr 2^18 forward, algorithm mxu_fused",
    "stage_ntt": "bls12-381-fr 2^18 forward, algorithm pallas",
    "fused_stage_level": "bls12-381-fr 2^18 forward, algorithm pallas_fused",
    "fused_level_probe": "the five probe stages at the bls12-381-fr 2^18 "
                         "level shape [8,32,8192]",
    "a2a_transpose": "bls12-381-fr 2^22 dist D=4 exchange=pallas",
}
INT_MM_NOTE = ("torch._int_mm on the same int8 digit operands (the matmul "
               "part only; a stack level times one entry over all columns, "
               "a multi-level call its two matmuls)")
NO_LIBRARY_NOTE = "none: no single PyTorch call computes a butterfly ladder"
LIBRARY_NOTES = {
    "a2a_transpose": "permute(...).contiguous() of the four shards stacked "
                     "on one card (the whole exchange; a launch's share is "
                     "a quarter)"}


def cross_cards_only(rng, dev, card) -> int:
    """``--cross-cards``: the one-card BLS12-381 Fr 2^22 dist forward, then
    the same on distinct cards against it and the golden NTT; no result
    line."""
    from ntt_tpu_torch import BLS12_381_FR as f
    from ntt_tpu_torch import limbs
    from ntt_tpu_torch.parallel import make_dist_ntt, make_mesh, shard_for_ntt

    n = 1 << 22
    xs = random_words(f, (n,), rng)
    mesh = make_mesh([dev] * DIST_D)
    run = make_dist_ntt(f, n, mesh, algorithm="mxu_sub", exchange="pallas")
    y = run(shard_for_ntt(limbs.to_mont(torch.from_numpy(xs).to(dev), f), f,
                          mesh))
    path_ms = {}
    cross_cards(f, n, "mxu_sub", xs, y, path_ms, rng)
    print(json.dumps({"path_ms": path_ms}))
    print(f"card: {card}")
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    quick = "--quick" in sys.argv[1:]
    passes_only = "--passes" in sys.argv[1:]
    persist_only = "--persist" in sys.argv[1:]
    cross_only = "--cross-cards" in sys.argv[1:]
    t_start = time.time()
    from ntt_tpu_torch import (BLS12_381_FR, BN254_FR, GOLDILOCKS, SMALL,
                               get_field)
    from ntt_tpu_torch.api import get_runner
    from ntt_tpu_torch.kernels import _build

    dev = torch.device("cuda", torch.cuda.current_device())
    card = card_line()
    print(f"card: {card}")
    print(f"device: {torch.cuda.get_device_name(0)}  torch {torch.__version__}"
          f"  cuda {torch.version.cuda}", flush=True)

    t0 = time.time()
    logs = _build.build_all()
    print(f"build: {time.time() - t0:.1f} s ({', '.join(_build.LIBRARIES)})")
    for name, log in logs.items():
        for line in log.splitlines():
            if ("registers" in line or "spill" in line or "warning" in line
                    or "wgmma" in line):
                print(f"  ptxas {name}: {line.strip()}")
    check_sass()

    rng = np.random.default_rng(SEED)
    if cross_only:
        return cross_cards_only(rng, dev, card)
    for f in (BLS12_381_FR, BN254_FR):
        check_persist(f, dev, big=False)
    if persist_only:
        rows = check_persist(BLS12_381_FR, dev, big=True)
        print(f"card: {card}")
        print(json.dumps({"persist": rows}))
        return 0
    small = [(name, 10) for name in ("bls12-381-fr", "bn254-fr",
                                     "goldilocks", "small-proth")]
    check_passes(dev, small, timed=False)
    print(f"small shapes: {8 * len(small)} pass kernel calls word-equal to "
          "their plain versions", flush=True)
    if passes_only:
        rows = check_passes(dev, PASS_SHAPES)
        print(f"card: {card}")
        print(json.dumps({"passes": rows}))
        return 0
    print(f"small shapes: {check_small_exchange(rng, [dev])} K8 calls on "
          "one card word-equal to the plain version", flush=True)
    for f in (SMALL, GOLDILOCKS):
        print(f"small shapes {f.name}: "
              f"{check_small_multi(f, (64, 128, 256, 512), rng, dev)} "
              "multi-level kernel calls word-equal to the plain version",
              flush=True)
        t0 = time.time()
        print(f"small shapes {f.name}: {check_small_wide(f, rng, dev)} "
              "wide multi-level kernel calls word-equal to the plain version "
              f"({time.time() - t0:.1f} s)", flush=True)
    print(f"small shapes {BLS12_381_FR.name}: "
          f"{check_small_multi(BLS12_381_FR, (64, 128, 256, 512), rng, dev)} "
          "multi-level kernel calls word-equal to the plain version",
          flush=True)
    for f in (SMALL, GOLDILOCKS, BLS12_381_FR):
        t0 = time.time()
        print(f"small shapes {f.name}: {check_small_1024(f, rng, dev)} "
              "m = 1024 multi-level kernel calls word-equal to the plain "
              f"version ({time.time() - t0:.1f} s)", flush=True)
    for f in (BLS12_381_FR, BN254_FR, GOLDILOCKS, SMALL):
        t0 = time.time()
        print(f"small shapes {f.name}: {check_small_transposed(f, rng, dev)} "
              "transposed-store calls of K2 and K3 word-equal to the plain "
              f"versions ({time.time() - t0:.1f} s)", flush=True)
    for f in (BLS12_381_FR, BN254_FR, GOLDILOCKS, SMALL):
        print(f"small shapes {f.name}: {check_small_shapes(f, rng, dev)} "
              "single-level kernel calls word-equal to their plain versions",
              flush=True)
    for f in (BLS12_381_FR, BN254_FR, GOLDILOCKS, SMALL):
        print(f"small shapes {f.name}: {check_small_level(f, rng, dev)} "
              "fused_level and probe calls, "
              f"{check_small_stages(f, rng, dev)} stage-kernel calls "
              "word-equal to their plain versions", flush=True)
    if quick:
        check_exchange(rng, dev, {})
        print(f"quick: kernel checks passed in {time.time() - t_start:.1f} s")
        return 0
    # the bigint timings read the host's cost to issue a launch: before the
    # golden results above 2^24, which take minutes on host threads and
    # then run under the bigint checks and the kernel checks
    time_bigint(rng, dev)
    from concurrent.futures import ThreadPoolExecutor
    pool = ThreadPoolExecutor(max_workers=6)
    huge_x = huge_inputs(rng)
    huge_want = start_huge_goldens(pool, huge_x)
    narrow_huge = start_narrow_goldens(pool, rng)
    check_bigint(rng, dev)
    print(f"seconds so far: {time.time() - t_start:.1f}", flush=True)

    t0 = time.time()
    run, aux = get_runner(BLS12_381_FR, 1 << 18, device=dev)
    print(f"tables: bls12-381-fr 2^18 built and resident in "
          f"{time.time() - t0:.1f} s", flush=True)
    results = {}
    check_kernels(BLS12_381_FR, aux, rng, dev, results)
    check_persist(BLS12_381_FR, dev, big=True)
    check_periodic_t3(rng, dev, results)
    check_base_m2(rng, dev, results)
    check_table_generators(dev)
    check_passes(dev, PASS_SHAPES)
    check_multi_level(rng, dev, results)
    time_transposed(rng, dev, card)
    check_narrow_short_bases(dev, results)
    check_ladder_kernels(rng, dev, results)
    check_base64_kernels(rng, dev, results)
    check_exchange(rng, dev, results)
    probe_line(results)
    print(f"seconds so far: {time.time() - t_start:.1f}", flush=True)

    path_ms = {}
    counts = wide_paths(rng, dev, run, aux, path_ms)
    print(f"seconds so far: {time.time() - t_start:.1f}", flush=True)
    wide_large_paths(rng, dev, path_ms)
    print(f"seconds so far: {time.time() - t_start:.1f}", flush=True)
    table_build_times(dev)
    seen = {}
    huge_paths(dev, path_ms, huge_x, huge_want, seen)
    huge_sub_and_lde(dev, path_ms, huge_x, huge_want, seen)
    check_path_launches(seen, dev)
    print(f"seconds so far: {time.time() - t_start:.1f}", flush=True)
    seen = {}
    giant_paths(dev, path_ms, huge_x, huge_want, seen)
    pool.shutdown()
    del huge_x, huge_want
    # the knob phase's longest golden result, on a host thread under the
    # narrow paths (not beside the 2^27 one, which the giant paths wait for)
    pool = ThreadPoolExecutor(max_workers=1)
    kf = get_field(KNOB_EARLY_GOLDEN[0])
    kx = random_words(kf, (1 << KNOB_EARLY_GOLDEN[1],), rng)
    knob_early = {KNOB_EARLY_GOLDEN: (kx, pool.submit(golden_ntt, kf, kx))}
    check_path_launches(seen, dev, timed=True)
    del seen
    print(f"seconds so far: {time.time() - t_start:.1f}", flush=True)
    counts.update(narrow_paths(rng, dev, path_ms, narrow_huge))
    del narrow_huge
    print(f"seconds so far: {time.time() - t_start:.1f}", flush=True)
    # the multi-device phase's golden results, on host threads under the
    # knob, ladder and probe phases (one after another they took most of
    # its time)
    dist_pool = ThreadPoolExecutor(max_workers=3)
    dist_goldens = start_dist_goldens(dist_pool, rng)
    knob_paths(rng, dev, path_ms, card, knob_early)
    pool.shutdown()
    del knob_early
    print(f"seconds so far: {time.time() - t_start:.1f}", flush=True)
    counts.update(ladder_paths(rng, dev, path_ms))
    counts.update(probe_path(rng, dev))
    print(f"seconds so far: {time.time() - t_start:.1f}", flush=True)
    counts["a2a_transpose"] = dist_paths(rng, dev, path_ms,
                                         dist_goldens)["a2a_transpose"]
    dist_pool.shutdown()
    del dist_goldens
    print(f"seconds so far: {time.time() - t_start:.1f}", flush=True)
    breakdown(GOLDILOCKS, 1 << 18, rng, dev)
    breakdown(BLS12_381_FR, 1 << 18, rng, dev)
    for alg in ("mxu_fused", "pallas_fused", "pallas"):
        breakdown(BLS12_381_FR, 1 << 18, rng, dev, algorithm=alg)
    print(f"seconds so far: {time.time() - t_start:.1f}", flush=True)
    tools_phase(card)
    print(f"seconds so far: {time.time() - t_start:.1f}", flush=True)
    for name in KERNELS:
        if counts.get(name, 0) < 1:
            raise AssertionError(f"{name} was not launched on its main path")

    kernels = []
    for name, (src, replaces) in KERNELS.items():
        path = results[name]["path"]
        if len(path) != counts[name]:
            raise AssertionError(
                f"{name}: {counts[name]} launches on its main path, "
                f"{len(path)} of them timed")
        # the bound of the path: each launch's own bound, summed; bound_by
        # names the kind that holds the larger share of it (bound_split)
        split = {"bytes": 0.0, "operations": 0.0}
        for c in path:
            split[c["bound_by"]] += c["bound_ms"]
        b_ms = split["bytes"] + split["operations"]
        b_by = max(split, key=split.get)
        libs = [c["library_ms"] for c in path if c["library_ms"] is not None]
        device = {}
        if all("device_ms" in c for c in path):
            # device time of the kernel's launches, and of the library
            # call where the launch has one
            vals = [c["device_ms"] for c in path]
            lib_vals = [c["library_device_ms"] for c in path
                        if c["library_ms"] is not None]
            device = {"device_ms": None if None in vals else sum(vals),
                      "library_device_ms": None if not lib_vals
                      or None in lib_vals else sum(lib_vals)}
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": max(c["max_abs_err"]
                               for c in results[name]["calls"]),
            "ms": sum(c["ms"] for c in path),
            "plain_ms": sum(c["plain_ms"] for c in path),
            "bound_ms": b_ms, "bound_by": b_by, "bound_split": split,
            "library_ms": sum(libs) if libs else None, **device,
            "library_call": LIBRARY_NOTES.get(
                name, INT_MM_NOTE if libs else NO_LIBRARY_NOTE),
            "main_path": MAIN_PATH.get(name, "bls12-381-fr 2^18 forward"),
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

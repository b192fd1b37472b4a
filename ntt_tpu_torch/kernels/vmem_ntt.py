"""Kernels K5 and K6: all butterfly stages of a sub-NTT, in register passes
(port of ``ntt_tpu.kernels.vmem_ntt``).

- ``stage_ntt`` (K5): natural-order m-point NTT along axis 1 of
  uint32[W, m, B], Montgomery form in and out: the bit-reversal and all
  log2 m radix-2 decimation-in-time stages (``mont_mul`` by the stage
  twiddle, ``add_mod``, ``sub_mod``) in one launch.
- ``fused_stage_level`` (K6): the same, then an optional product with a
  full-resolution twiddle T3 [W, m, B] and an optional transposed store to
  [W, B, m]: one four-step level on the butterfly path.

The stage twiddles are read from the master table ω_m^0 .. ω_m^{m/2-1}
(``core.twiddle_master``) at stride (m/2)/s; the JAX kernel's per-stage
expanded tables are a TPU layout rule and have no counterpart here. A
thread of the CUDA kernel (``csrc/vmem_ntt.cu``) owns R elements of one
column and runs log2 R stages on them in registers; the column's threads
trade elements through shared memory between passes (:func:`passes`), and
the bit reversal is folded into the rows pass 0 reads. The launch plan
(:func:`stage_plan`) is computed here and checked by the C launcher. On a
CUDA tensor each wrapper launches the kernel; on a CPU tensor it runs its
plain PyTorch version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import limbs
from ..fields import Field
from ..tracing import span
from ..transforms.core import ntt_along_axis, twiddle_master_on
from . import _build

#: the largest transform length the kernels take: a column of W·m words
#: must fit a block's shared-memory tile
MAX_M = 256
#: bytes of one column (W·m words) at the largest m the transforms give the
#: kernels: it fixes their decomposition (:func:`max_m`), as in the JAX
#: package
COLUMN_BYTES = 2048


def max_m(field: Field) -> int:
    """The largest m whose column of W·m words stays within COLUMN_BYTES:
    64 for the 256-bit fields, 256 for the narrow ones (capped at MAX_M)."""
    return min(MAX_M, COLUMN_BYTES // (4 * field.n_words))


#: elements a thread owns at most, by field width: 4 of 8 words (32
#: registers of data), 16 of one or two words (16 or 32)
R_MAX = {8: 4, 2: 16, 1: 16}
#: dynamic shared memory a block may use, and an SM holds, on an H100
SMEM_MAX = 227 * 1024
SMEM_SM = 228 * 1024
#: the SMs of an H100 SXM, for plans made without a card
H100_SMS = 132


class StagePlan(NamedTuple):
    """Launch plan of a K5 / K6 call on uint32[W, m, B]: a thread owns ``r``
    = 2^``k`` elements of a column and runs ``passes`` register passes;
    ``col_threads`` = m / r threads a column, ``bt`` columns a tile,
    ``threads`` = col_threads * bt a block, ``tiles`` column tiles looped
    over by ``grid`` blocks; the block's shared memory holds the master
    twiddles (``tw_words``, element-major) and the exchange tile
    [W][m][bt + 1] (``smem_bytes`` in all)."""
    r: int
    k: int
    passes: int
    col_threads: int
    bt: int
    threads: int
    tiles: int
    grid: int
    tw_words: int
    smem_bytes: int


def max_threads(W: int, r: int) -> int:
    """Threads a block may have (the kernels' ``__launch_bounds__``): 256
    where a thread holds 32 words or more, else 512."""
    return 256 if W * r >= 32 else 512


@functools.cache
def stage_plan(W: int, m: int, B: int, sms: int = H100_SMS) -> StagePlan:
    """The plan of a K5 / K6 launch on uint32[W, m, B] on a card of ``sms``
    SMs: r = min(R_MAX, m); bt as wide as the block's threads allow (at
    most 256 columns), halved down to 32 while there are fewer than two
    tiles an SM; a grid of at most the blocks the card holds at once."""
    if W not in R_MAX or m & (m - 1) or not 2 <= m <= MAX_M or B < 1:
        raise ValueError(f"no stage plan for W = {W}, m = {m}, B = {B}")
    r = min(R_MAX[W], m)
    k = r.bit_length() - 1
    log_m = m.bit_length() - 1
    col_threads = m // r
    bt = min(256, max_threads(W, r) // col_threads)
    while bt > 32 and -(-B // bt) < 2 * sms:    # tiles for every SM
        bt //= 2
    threads = col_threads * bt
    tiles = -(-B // bt)
    tw_words = -(-W * (m // 2) // 4) * 4
    smem = 4 * (tw_words + W * m * (bt + 1))
    if smem > SMEM_MAX:
        raise ValueError(f"W = {W}, m = {m}: {smem} shared bytes exceed "
                         "the block")
    per_sm = max(1, min(2048 // threads, SMEM_SM // (smem + 1024)))
    return StagePlan(r, k, -(-log_m // k), col_threads, bt, threads, tiles,
                     min(tiles, sms * per_sm), tw_words, smem)


def passes(m: int, r: int) -> list:
    """The register passes of an m-point ladder with r elements a thread,
    as (s0, u0): the pass's elements differ in bits [s0, s0 + log2 r) of
    the bit-reversed row index p, and it runs their local stages u0 ..
    log2 r - 1 (global half-size 2^(s0 + u)). Every pass but the last owns
    fresh bits; the last is shifted down to end at bit log2 m and skips
    the stages the pass before it ran."""
    L, K = m.bit_length() - 1, r.bit_length() - 1
    n = -(-L // K)
    out = []
    for P in range(n):
        s0 = K * P if P < n - 1 else L - K
        out.append((s0, K * P - s0))
    return out


def pass_base(t: int, s0: int, k: int) -> int:
    """Row p of element 0 of thread t (of a column) in a pass at bit s0:
    t's low s0 bits stay, its other bits move above the pass's k bits."""
    return (t & ((1 << s0) - 1)) | ((t >> s0) << (s0 + k))


def thread_rank(tid: int, col_threads: int, bt: int) -> tuple:
    """(t, bl) of thread ``tid`` of a block as the kernel maps them: thread
    t of column bl of the tile. A warp holds 32 columns of one t where bt
    >= 32, else 32 / bt values of t that differ only in their bits from
    log2(warps) up, so that they share the low bits the twiddle index of
    a pass at s0 <= log2(warps) reads."""
    if bt >= 32:
        return tid // bt, tid % bt
    lane = tid & 31
    return (tid >> 5) + lane // bt * (col_threads * bt // 32), lane % bt


@functools.cache
def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def plan_args(W: int, m: int, B: int, device) -> tuple:
    """The plan of :func:`stage_plan` as the C entry points take it."""
    plan = stage_plan(W, m, B, _sms(device))
    return (plan.r, plan.bt, plan.threads, plan.grid, plan.smem_bytes)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("vmem_ntt")
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    plan = [i] * 5
    lib.vmem_stage_ntt.argtypes = [
        vp, vp, vp, i, ll, *plan, *_build.FIELD_ARGTYPES, vp]
    lib.vmem_stage_ntt.restype = ctypes.c_int
    lib.vmem_fused_stage_level.argtypes = [
        vp, vp, vp, vp, i, i, ll, *plan, *_build.FIELD_ARGTYPES, vp]
    lib.vmem_fused_stage_level.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# K5: the butterfly ladder alone
# ---------------------------------------------------------------------------

def stage_ntt_plain(x, field: Field, inverse: bool = False):
    """Plain PyTorch version of K5: ``core.ntt_along_axis``."""
    return ntt_along_axis(x, field, inverse=inverse)


def stage_ntt(x, field: Field, inverse: bool = False):
    """Natural-order NTT along axis 1 of uint32[W, m, B] (Montgomery form
    in and out, no 1/n scale), m a power of two up to 256, all stages in
    one launch."""
    W, m, B = x.shape
    if m == 1:
        return x
    if x.device.type == "cpu":
        return stage_ntt_plain(x, field, inverse)
    with span("ntt.launch.stage_ntt"):
        _build.check_level(x, field, MAX_M)
        tw = twiddle_master_on(field, m, inverse, x.device)
        out = torch.empty_like(x)
        rc = _lib().vmem_stage_ntt(
            _build.ptr(x), _build.ptr(tw), _build.ptr(out), m, B,
            *plan_args(W, m, B, x.device), *_build.field_args(field),
            _build.stream(x))
        _build.check(rc, "stage_ntt")
        _build.launches["stage_ntt"] += 1
        return out


#: K5 under the JAX package's entry name (``ntt_tpu.kernels``), the same
#: parameters but its TPU batch tile
ntt_along_axis_pallas = stage_ntt


# ---------------------------------------------------------------------------
# K6: the ladder, the decomposition twiddle and the transposed store
# ---------------------------------------------------------------------------

def fused_stage_level_plain(x, field: Field, inverse: bool = False, T3=None,
                            transpose_out: bool = True):
    """Plain PyTorch version of K6."""
    y = ntt_along_axis(x, field, inverse=inverse)
    if T3 is not None:
        y = limbs.mont_mul(y, T3, field)
    return y.transpose(1, 2).contiguous() if transpose_out else y


def fused_stage_level(x, field: Field, inverse: bool = False, T3=None,
                      transpose_out: bool = True):
    """One four-step level on uint32[W, m, B] with the butterfly ladder as
    its base: m-point NTT along axis 1, then the optional full-resolution
    twiddle ``T3`` [W, m, B], stored as [W, B, m] when ``transpose_out``
    (else [W, m, B])."""
    W, m, B = x.shape
    if T3 is not None and tuple(T3.shape) != (W, m, B):
        raise ValueError(f"T3 must be {(W, m, B)}, got {tuple(T3.shape)}")
    if m == 1:
        if T3 is not None:
            x = limbs.mont_mul(x, T3, field)
        return x.transpose(1, 2).contiguous() if transpose_out else x
    if x.device.type == "cpu":
        return fused_stage_level_plain(x, field, inverse, T3, transpose_out)
    with span("ntt.launch.fused_stage_level"):
        _build.check_level(x, field, MAX_M)
        if T3 is not None:
            _build.check_operand(T3, "T3", torch.uint32, (W, m, B), x.device)
        tw = twiddle_master_on(field, m, inverse, x.device)
        out = torch.empty((W, B, m) if transpose_out else (W, m, B),
                          dtype=torch.uint32, device=x.device)
        rc = _lib().vmem_fused_stage_level(
            _build.ptr(x), _build.ptr(tw), _build.ptr(T3), _build.ptr(out),
            int(transpose_out), m, B, *plan_args(W, m, B, x.device),
            *_build.field_args(field), _build.stream(x))
        _build.check(rc, "fused_stage_level")
        _build.launches["fused_stage_level"] += 1
        return out

"""Kernels K2, K3, K4 and K7: one four-step level with its decomposition
twiddle (port of ``ntt_tpu.kernels.mxu_level``), and the C library they
share with K1 (``kernels/mxu_ntt.py``).

- ``fused_level_stack`` (K2): the twiddle is folded into a stack of conv
  matrices As[NT, E*m, D*m]; batch column b uses ``As[b // rep]``; an
  optional residual twiddle T3 multiplies the output, at batch resolution
  [W, m, B] or periodic [W, m, s0] (column b reads column b mod s0; s0 a
  power of two dividing B).
- ``fused_subntt`` (K3): an m-point sub-NTT, then the decomposition
  twiddle by a Montgomery product from T3 [W, m, B] (rep == 1) or from the
  i2-resolution table T3 [W, B // rep, m] (rep > 1). Single-level (one
  conv matrix) up to 32 points, and at 64 where the caller's plan has the
  64-point matrix (``NTT_MXU_BASE_LOG=6``; :func:`single_level`);
  multi-level for m = 64 .. 1024 otherwise: the peel-32 recursion with its
  two inner matmul levels and the inner twiddle ω_m^{k1·i2} between them,
  all in one kernel; on the narrow fields, above one wave of its blocks,
  in its wide form where its block holds the level (:func:`sub_wide`:
  persistent blocks with both matrices resident, level B in one pass, both
  epilogues from registers).

K2 and K3 store their output as [W, B, m] when ``transpose_out``, as the
JAX package's entries do (no path of either package asks for it).

- ``fused_level`` (K4): one conv matrix, an optional full-resolution
  twiddle T3 [W, m, B], and the store transposed to [W, B, m] on request:
  the level of the flat-peel transform ``mxu_fused``.
- ``fused_level_probe`` (K7): K4's level (without the transposed store)
  cut off after ``stream``, ``digits``, ``matmul``, ``reduce`` or ``tw``,
  to attribute its time to its stages.

On a CUDA tensor each launches its hand-written kernel
(``csrc/mxu_level.cu``, ``csrc/mxu_sub.cu``); on a CPU tensor it runs its
plain PyTorch version. Every kernel contracts on the int8 tensor cores
(``csrc/mxu_core.cuh``, ``tc::contract``; K1's short form its own
block); the launch plans (:func:`tc_plan` for the one-level kernels,
:func:`base_plan` for K1, which takes its short form where
:func:`short_form`, :func:`sub_plan` for the multi-level K3, whose block
runs both levels on its own row chunk and columns, and
:func:`sub_wide_plan` for its wide form) are computed here and checked by
the C launchers.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import digits, limbs
from ..fields import Field
from ..tracing import span
from ..transforms.core import host_power_matrix
from . import _build

#: the longest transform the single-level kernels (K1, K2, K3 single, K4,
#: K7) compute as one conv matrix: above 32 points they stream the digit
#: tile over the contraction depth in passes of 32 rows
#: (``csrc/mxu_core.cuh``, ``tc::contract``)
LEVEL_MAX_M = 64
#: the peel of the multi-level sub-NTT (its level A) and its largest
#: transform length; the peel stays 32 under every NTT_MXU_BASE_LOG
SUB_PEEL = 32
MAX_SUB = 1024


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("mxu_level")
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    plan = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ll, ctypes.c_int]
    lib.mxu_fused_level_stack.argtypes = [
        vp, vp, ll, vp, ll, vp, ctypes.c_int, ctypes.c_int, ll,
        *_build.FIELD_ARGTYPES, *plan, vp]
    lib.mxu_fused_level_stack.restype = ctypes.c_int
    lib.mxu_fused_subntt.argtypes = [
        vp, vp, vp, ll, vp, ctypes.c_int, ctypes.c_int, ll,
        *_build.FIELD_ARGTYPES, *plan, vp]
    lib.mxu_fused_subntt.restype = ctypes.c_int
    lib.mxu_base_ntt.argtypes = [vp, vp, vp, ctypes.c_int, ll,
                                 *_build.FIELD_ARGTYPES, *plan, vp]
    lib.mxu_base_ntt.restype = ctypes.c_int
    lib.mxu_fused_level.argtypes = [
        vp, vp, vp, vp, ctypes.c_int, ctypes.c_int, ll,
        *_build.FIELD_ARGTYPES, *plan, vp]
    lib.mxu_fused_level.restype = ctypes.c_int
    lib.mxu_fused_level_probe.argtypes = [
        vp, vp, vp, vp, ctypes.c_int, ctypes.c_int, ll,
        *_build.FIELD_ARGTYPES, *plan, vp]
    lib.mxu_fused_level_probe.restype = ctypes.c_int
    return lib


@functools.cache
def _lib_sub() -> ctypes.CDLL:
    lib = _build.load("mxu_sub")
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.mxu_fused_subntt_multi.argtypes = [
        vp, vp, vp, vp, vp, ll, vp, ctypes.c_int, ctypes.c_int, ll,
        *_build.FIELD_ARGTYPES, *[ctypes.c_int] * 7, ll, ctypes.c_int, vp]
    lib.mxu_fused_subntt_multi.restype = ctypes.c_int
    lib.mxu_fused_subntt_wide.argtypes = [
        vp, vp, vp, vp, vp, ll, vp, ctypes.c_int, ctypes.c_int, ll,
        *_build.FIELD_ARGTYPES, *[ctypes.c_int] * 4, ll, ll, ctypes.c_int, vp]
    lib.mxu_fused_subntt_wide.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# The launch plans of the tensor-core kernels: csrc/mxu_core.cuh, tc::
# ---------------------------------------------------------------------------

#: batch columns a block owns (two wgmma M of 64); GEMM rows of a block,
#: padded (two wgmma N of 160); the contraction depth is padded to
#: TC_BK, one wgmma step and one stage of the conv-matrix rows; TC_STAGES
#: ring stages where TMA feeds them (D*m % 16 == 0), else the whole chunk;
#: the Z tile's rows are TC_COLS + 4 words; TC_ALIGN bytes of slack align
#: the shared base to the 256-byte swizzle atom
TC_COLS = 128
TC_ROWS_PAD = 320
TC_BK = 32
TC_STAGES = 6
TC_Z_STRIDE = TC_COLS + 4
TC_ALIGN = 256
#: dynamic shared memory a block may use on an H100
TC_MAX_SMEM = 232448
#: output rows a block owns (a row chunk), by field width: about 300 GEMM
#: rows (E * kt) for every width
TC_KT = {8: 8, 2: 16, 1: 32}
#: K1's short form (``base_ntt_mxu_short_kernel``), taken where one wgmma N
#: half holds every GEMM row of the level, E * m <= TC_SHORT_ROWS: a block
#: of two warpgroups, each on 64 columns of a TC_COLS-column tile, stages
#: the conv matrix once and walks a span of tiles; TC_SHORT_BLOCKS blocks
#: share an SM, one wave of them on the card's ``sms`` SMs (TC_SMS on an
#: H100 SXM)
TC_SHORT_ROWS = 160
TC_SHORT_BLOCKS = 2
TC_SMS = 132


def tc_passes(m: int) -> int:
    """Passes of the digit tile over the contraction depth
    (``tc::passes``): one up to m = TC_BK rows, m / TC_BK above, each
    holding TC_BK rows of the operand."""
    return max(1, m // TC_BK)


class TcPlan(NamedTuple):
    """Launch plan of one tensor-core level: kt output rows a chunk, the
    contraction depth and GEMM rows padded for the MMA, ``chunks`` row
    chunks x ``col_tiles`` column tiles of TC_COLS, ``blocks`` blocks that
    each cover ``span`` column tiles (the last one fewer), and the block's
    dynamic shared bytes."""
    kt: int
    k_pad: int
    m_pad: int
    chunks: int
    col_tiles: int
    blocks: int
    smem_bytes: int
    span: int = 1


def _contract_bytes(D: int, E: int, m: int, kt: int, k_pad: int) -> int:
    """Shared bytes of one contraction (``tc::contract_bytes``): the
    conv-matrix stages (a TMA ring where D*m % 16 == 0, else the whole
    chunk), the digit tile of one pass (:func:`tc_passes`), or the Z tile
    that aliases both."""
    rows = -(-E * kt // 8) * 8
    stages = TC_STAGES if D * m % 16 == 0 else k_pad // TC_BK
    main_loop = (stages * rows * TC_BK
                 + max(TC_COLS * (k_pad // tc_passes(m)),
                       (TC_ROWS_PAD - rows) * TC_BK))
    return max(main_loop, E * kt * TC_Z_STRIDE * 4)


@functools.cache
def tc_plan(field: Field, m: int, B: int) -> TcPlan:
    """The plan of a K1 / K2 / K3 (single-level) / K4 / K7 launch on
    uint32[W, m, B] of ``field``, m up to LEVEL_MAX_M."""
    W = field.n_words
    if (W not in TC_KT or m & (m - 1) or not 2 <= m <= LEVEL_MAX_M
            or B < 1):
        raise ValueError(f"no tensor-core plan for W = {W}, m = {m}, "
                         f"B = {B}")
    D, E = digits.n_digits(field), digits.out_planes(field)
    kt = min(m, TC_KT[W])
    k_pad = -(-D * m // TC_BK) * TC_BK
    chunks, col_tiles = m // kt, -(-B // TC_COLS)
    epilogue = E * kt * TC_Z_STRIDE * 4 + W * TC_COLS * (kt | 1) * 4
    plan = TcPlan(kt, k_pad, TC_ROWS_PAD, chunks, col_tiles,
                  chunks * col_tiles,
                  TC_ALIGN + max(_contract_bytes(D, E, m, kt, k_pad),
                                 epilogue))
    if E * kt > TC_ROWS_PAD or plan.smem_bytes > TC_MAX_SMEM:
        raise ValueError(f"W = {W}, m = {m}: plan {plan} exceeds the block")
    return plan


@functools.cache
def plan_args(field: Field, m: int, B: int) -> tuple:
    """The plan of :func:`tc_plan` as the C entry points take it."""
    plan = tc_plan(field, m, B)
    return (plan.kt, plan.k_pad, plan.m_pad, plan.blocks, plan.smem_bytes)


def short_form(field: Field, m: int) -> bool:
    """Whether K1 takes its short form at m: every GEMM row of the level,
    E * m, within one wgmma N half (W = 8 at m <= 4, W = 2 at m <= 8,
    W = 1 at m <= 16)."""
    return digits.out_planes(field) * m <= TC_SHORT_ROWS


@functools.cache
def base_plan(field: Field, m: int, B: int, sms: int = TC_SMS) -> TcPlan:
    """The plan of a K1 launch on uint32[W, m, B]: the short form where
    :func:`short_form` (one chunk of m rows, the GEMM rows padded to one N
    half, TC_COLS-column tiles, at most TC_SHORT_BLOCKS * ``sms``
    blocks, each walking ``span`` = ceil(tiles / (TC_SHORT_BLOCKS * sms))
    tiles, so that no block is empty; the shared bytes of the matrix and
    of the digit tile or the Z tile that aliases it), else
    :func:`tc_plan`'s."""
    plan = tc_plan(field, m, B)
    if not short_form(field, m):
        return plan
    W, E = field.n_words, digits.out_planes(field)
    tiles = -(-B // TC_COLS)
    span = -(-tiles // (TC_SHORT_BLOCKS * sms))
    smem = (TC_ALIGN + TC_SHORT_ROWS * plan.k_pad
            + max(TC_COLS * plan.k_pad, E * m * TC_Z_STRIDE * 4))
    plan = TcPlan(m, plan.k_pad, TC_SHORT_ROWS, 1, tiles, -(-tiles // span),
                  smem, span)
    if TC_SHORT_BLOCKS * smem > TC_MAX_SMEM:
        raise ValueError(f"W = {W}, m = {m}: plan {plan} exceeds the SM")
    return plan


@functools.cache
def base_plan_args(field: Field, m: int, B: int, sms: int = TC_SMS) -> tuple:
    """The plan of :func:`base_plan` as ``mxu_base_ntt`` takes it."""
    plan = base_plan(field, m, B, sms)
    return (plan.kt, plan.k_pad, plan.m_pad, plan.blocks, plan.smem_bytes)


#: rows k1 a block of the multi-level K3 owns (level A's row chunk), by
#: field width: E * kt within the block's 320 GEMM rows, and 4 at W = 8 so
#: that level A's contraction and the shared tile Y fit in one block
SUB_KT = {8: 4, 2: 16, 1: 32}


class SubPlan(NamedTuple):
    """Launch plan of the multi-level K3 on uint32[W, m, B], m2 = m / 32
    (SUB_PEEL):
    a block owns ``kt`` rows k1 and ``bt`` = 128 / m2 batch columns (level
    A: one contraction over the 128 virtual columns (i2, b)); level B runs
    one contraction for each 128 of the kt * bt virtual columns (k1, b) and
    each ``kt2`` rows k2. Padded depths of A1 (``ka_pad``) and A2
    (``kb_pad``), padded GEMM rows, the grid (``chunks`` row chunks x
    ``col_tiles`` column tiles), the shared tile Y (row stride ``ys``
    words, at byte ``y_off``) and the block's dynamic shared bytes. The
    plan owns Y's layout; the launcher only checks that it is safe."""
    kt: int
    kt2: int
    bt: int
    ka_pad: int
    kb_pad: int
    m_pad: int
    chunks: int
    col_tiles: int
    blocks: int
    ys: int
    y_off: int
    smem_bytes: int


@functools.cache
def sub_plan(field: Field, m: int, B: int) -> SubPlan:
    """The plan of a multi-level K3 launch on uint32[W, m, B] of ``field``
    (``mxu_sub.cu``, ``launch_sub``)."""
    W = field.n_words
    if W not in SUB_KT or m & (m - 1) or not 2 * SUB_PEEL <= m <= MAX_SUB \
            or B < 1:
        raise ValueError(f"no multi-level plan for W = {W}, m = {m}, "
                         f"B = {B}")
    D, E = digits.n_digits(field), digits.out_planes(field)
    m2 = m // SUB_PEEL
    kt, kt2, bt = SUB_KT[W], min(m2, TC_KT[W]), TC_COLS // m2
    ka_pad = -(-D * SUB_PEEL // TC_BK) * TC_BK
    kb_pad = -(-D * m2 // TC_BK) * TC_BK
    # Y's rows i2 are kt * bt words apart, bt more where a warp's 32 level-A
    # results span several i2 (bt < 32), so that their stores fall in
    # distinct banks; Y follows the larger of the two contractions' bytes
    ys = kt * bt + (bt if bt < 32 else 0)
    y_off = max(_contract_bytes(D, E, SUB_PEEL, kt, ka_pad),
                _contract_bytes(D, E, m2, kt2, kb_pad))
    chunks, col_tiles = SUB_PEEL // kt, -(-B // bt)
    plan = SubPlan(kt, kt2, bt, ka_pad, kb_pad, TC_ROWS_PAD, chunks,
                   col_tiles, chunks * col_tiles, ys, y_off,
                   TC_ALIGN + y_off + W * m2 * ys * 4)
    if max(E * kt, E * kt2) > TC_ROWS_PAD or plan.smem_bytes > TC_MAX_SMEM:
        raise ValueError(f"W = {W}, m = {m}: plan {plan} exceeds the block")
    return plan


@functools.cache
def sub_plan_args(field: Field, m: int, B: int) -> tuple:
    """The plan of :func:`sub_plan` as the C entry point takes it."""
    p = sub_plan(field, m, B)
    return (p.kt, p.kt2, p.ka_pad, p.kb_pad, p.m_pad, p.ys, p.y_off,
            p.blocks, p.smem_bytes)


#: field widths the wide form of the multi-level K3 is built for: the
#: narrow fields (W = 8 keeps the present form)
SUB_WIDE_WORDS = (1, 2)
#: words between the rows kk of the wide form's level-A result tile Y
SUB_WIDE_YS = TC_COLS + 4


class SubWidePlan(NamedTuple):
    """Launch plan of the wide form of the multi-level K3
    (``fused_subntt_wide_kernel``) on uint32[W, m, B], m2 = m / 32: each
    wgmma N half holds ``slots`` output rows (groups of 8, the E planes of
    slot s at GEMM rows e * 8 + s, ``group_rows`` apart); a block owns
    ``kt`` = 2 * slots rows k1 (``chunks`` row chunks) and walks ``span``
    column tiles of ``bt`` = 128 / m2 batch columns, both matrices resident
    in shared memory. Level B stacks ``lb`` / m2 vectors in one GEMM
    column of ``lb`` rows (A2 block-diagonal). Depths padded to 32
    (``ka_pad``, ``kb_pad``); ``blocks`` = chunks x ceil(col_tiles / span),
    one wave on the card's SMs, none empty; the block's dynamic shared
    bytes (the two matrices, the digit tile, level A's result tile Y and
    the tile's twiddle)."""
    slots: int
    group_rows: int
    kt: int
    chunks: int
    bt: int
    lb: int
    ka_pad: int
    kb_pad: int
    col_tiles: int
    span: int
    blocks: int
    smem_bytes: int


@functools.cache
def _wide_geometry(field: Field, m: int) -> tuple:
    """The wide form's slot geometry and shared bytes on uint32[W, m, B]
    (they do not depend on B): group_rows, slots, kt, lb, ka_pad, kb_pad and
    the block's dynamic shared bytes (the two matrices, the digit tile,
    level A's result tile Y and the tile's twiddle)."""
    W = field.n_words
    D, E = digits.n_digits(field), digits.out_planes(field)
    group_rows = -(-8 * E // 16) * 16
    slots = 8 * (TC_SHORT_ROWS // group_rows)
    kt, lb = 2 * slots, max(slots, m // SUB_PEEL)
    ka_pad, kb_pad = D * SUB_PEEL, -(-D * lb // TC_BK) * TC_BK
    rows = TC_SHORT_ROWS * TC_BK    # bytes of one step of one row unit
    smem = (TC_ALIGN + ka_pad // TC_BK * 2 * rows
            + kb_pad // TC_BK * (lb // slots) * rows
            + max(TC_COLS * ka_pad, kt * TC_COLS // lb * kb_pad)
            + W * kt * (SUB_WIDE_YS + TC_COLS) * 4)
    return group_rows, slots, kt, lb, ka_pad, kb_pad, smem


def sub_wide_holds(field: Field, m: int) -> bool:
    """Whether the wide form is built for the field (SUB_WIDE_WORDS) and
    its block holds an m-point level: not W = 2 at m = 1024, whose
    block-diagonal A2 alone exceeds it."""
    return (field.n_words in SUB_WIDE_WORDS
            and _wide_geometry(field, m)[-1] <= TC_MAX_SMEM)


def sub_wide(field: Field, m: int, B: int, sms: int = TC_SMS) -> bool:
    """Whether a multi-level K3 launch takes the wide form: where
    :func:`sub_wide_holds`, above one wave of the present form's blocks
    (:func:`sub_plan`) on the card's ``sms`` SMs. Else the present form
    takes it."""
    return (sub_wide_holds(field, m)
            and sub_plan(field, m, B).blocks > sms)


@functools.cache
def sub_wide_plan(field: Field, m: int, B: int, sms: int = TC_SMS
                  ) -> SubWidePlan:
    """The plan of a wide-form launch on uint32[W, m, B] for a card of
    ``sms`` SMs (``mxu_sub.cu``, ``launch_wide``, which checks it): one
    block an SM, the chunks of one span of tiles in neighbouring blocks."""
    W = field.n_words
    if (W not in SUB_WIDE_WORDS or m & (m - 1)
            or not 2 * SUB_PEEL <= m <= MAX_SUB or B < 1 or sms < 1):
        raise ValueError(f"no wide multi-level plan for W = {W}, m = {m}, "
                         f"B = {B}")
    group_rows, slots, kt, lb, ka_pad, kb_pad, smem = _wide_geometry(field, m)
    chunks, bt = SUB_PEEL // kt, TC_COLS // (m // SUB_PEEL)
    tiles = -(-B // bt)
    span = -(-tiles // max(1, sms // chunks))
    plan = SubWidePlan(slots, group_rows, kt, chunks, bt, lb, ka_pad, kb_pad,
                       tiles, span, chunks * -(-tiles // span), smem)
    if ka_pad % TC_BK or smem > TC_MAX_SMEM:
        raise ValueError(f"W = {W}, m = {m}: plan {plan} exceeds the block")
    return plan


@functools.cache
def sub_wide_args(field: Field, m: int, B: int, sms: int = TC_SMS) -> tuple:
    """The plan of :func:`sub_wide_plan` as the C entry point takes it."""
    p = sub_wide_plan(field, m, B, sms)
    return (p.kt, p.lb, p.ka_pad, p.kb_pad, p.span, p.blocks, p.smem_bytes)


def _zmax_bits(field: Field, m: int) -> int:
    return (m * digits.n_digits(field) * digits.DIGIT_MASK ** 2).bit_length()


def _fold_mul_matrix(field: Field, device):
    return torch.from_numpy(digits.fold_mul_matrix(field)).to(device)


def _twiddle_product(y, T3, field: Field, F2=None):
    """y · T3 as the level kernels' plain versions take it: the fold
    product for wide fields, ``limbs.mont_mul`` for narrow ones."""
    if not digits.fold_active(field):
        return limbs.mont_mul(y, T3, field)
    if F2 is None:
        F2 = _fold_mul_matrix(field, y.device)
    return digits.mont_mul_fold(y, T3, field, F2)


# ---------------------------------------------------------------------------
# K2: the twiddle folded into a conv-matrix stack
# ---------------------------------------------------------------------------

def t3_period(T3, W: int, m: int, B: int) -> int:
    """The period s0 of K2's residual T3: B for [W, m, B], s0 for a
    periodic [W, m, s0] with s0 a power of two dividing B. ValueError for
    any other shape."""
    shape = tuple(T3.shape)
    s0 = shape[2] if len(shape) == 3 else 0
    if (shape[:2] != (W, m) or s0 < 1 or B % s0
            or (s0 != B and s0 & (s0 - 1))):
        raise ValueError(
            f"T3 must be uint32[{W}, {m}, {B}] or periodic [{W}, {m}, s0] "
            f"with s0 a power of two dividing {B}; got {shape}")
    return s0


def _store(y, transpose_out: bool):
    """y [W, m, B], or as [W, B, m] when ``transpose_out``."""
    if not transpose_out:
        return y
    with span("ntt.copy"):
        return y.transpose(1, 2).contiguous()


def _output(x3, transpose_out: bool):
    """The kernels' output tensor: [W, m, B], or [W, B, m] when
    ``transpose_out``."""
    W, m, B = x3.shape
    return torch.empty((W, B, m) if transpose_out else (W, m, B),
                       dtype=torch.uint32, device=x3.device)


def fused_level_stack_plain(x3, field: Field, As, rep: int, F=None,
                            T3=None, transpose_out: bool = False):
    """Plain PyTorch version of K2. A periodic T3 is expanded to batch
    resolution by indexing."""
    W, m, B = x3.shape
    D = digits.n_digits(field)
    d = digits.extract_digits(x3, field).reshape(D * m, B)
    Z = torch.empty((digits.out_planes(field) * m, B), dtype=torch.int64,
                    device=x3.device)
    for s in range(As.shape[0]):
        cols = slice(s * rep, (s + 1) * rep)
        Z[:, cols] = digits.matmul_exact(As[s], d[:, cols])
    y = digits.recompose_reduce(Z.reshape(-1, m, B), field,
                                _zmax_bits(field, m), fold_mat=F)
    if T3 is not None:
        s0 = t3_period(T3, W, m, B)
        if s0 != B:     # (CUDA indexes no uint32 tensor: as int32 bits)
            cols = torch.arange(B, device=T3.device) % s0
            T3 = T3.view(torch.int32)[:, :, cols].view(torch.uint32)
        y = _twiddle_product(y, T3, field)
    return _store(y, transpose_out)


def fused_level_stack(x3, field: Field, As, rep: int, F=None, T3=None,
                      transpose_out: bool = False):
    """m-point level on uint32[W, m, B] with the decomposition twiddle
    folded into the conv-matrix stack ``As`` (int8[NT, D*m, D*m],
    NT * rep == B). ``T3``: optional residual twiddle, uint32[W, m, B] or
    periodic [W, m, s0] (:func:`t3_period`), which the kernel reads
    compact. ``F``: the fold matrix, which only the plain version reads.
    Stored as [W, B, m] when ``transpose_out`` (else [W, m, B])."""
    W, m, B = x3.shape
    NT = As.shape[0]
    if NT * rep != B:
        raise ValueError(f"stack of {NT} entries x rep {rep} != B = {B}")
    period = B if T3 is None else t3_period(T3, W, m, B)
    if x3.device.type == "cpu":
        return fused_level_stack_plain(x3, field, As, rep, F, T3,
                                       transpose_out)
    with span("ntt.launch.fused_level_stack"):
        _build.check_level(x3, field, LEVEL_MAX_M)
        D, E = digits.n_digits(field), digits.out_planes(field)
        _build.check_operand(As, "As", torch.int8, (NT, E * m, D * m),
                             x3.device)
        if T3 is not None:
            _build.check_operand(T3, "T3", torch.uint32, (W, m, period),
                                 x3.device)
        out = _output(x3, transpose_out)
        rc = _lib().mxu_fused_level_stack(
            _build.ptr(x3), _build.ptr(As), rep, _build.ptr(T3), period,
            _build.ptr(out), int(transpose_out), m, B,
            *_build.field_args(field), *plan_args(field, m, B),
            _build.stream(x3))
        _build.check(rc, "fused_level_stack")
        _build.launches["fused_level_stack"] += 1
        return out


# ---------------------------------------------------------------------------
# K3: sub-NTT (single- or multi-level) then the decomposition twiddle
# ---------------------------------------------------------------------------

def _expand_twiddle(T3, rep: int, B: int):
    """The twiddle at batch resolution [W, m, B]: T3 itself for rep == 1,
    else the i2-resolution table [W, B // rep, m] repeated over rep."""
    if rep == 1:
        return T3
    W, n2, m = T3.shape
    return T3.transpose(1, 2)[:, :, :, None].expand(W, m, n2, rep).reshape(
        W, m, B)


_inner_cache: dict = {}


def inner_twiddle(field: Field, m: int, inverse: bool, device):
    """The inner twiddle ω_m^{k1·i2} of a multi-level m-point sub-NTT
    (the inverse root when ``inverse``): Montgomery uint32[W, 32, m // 32],
    built on the host once per (field, m, direction) and kept on
    ``device``."""
    key = (field.name, m, inverse, str(device))
    got = _inner_cache.get(key)
    if got is None:
        root = field.root_of_unity(m)
        if inverse:
            root = field.inv_root_of_unity(m)
        got = _inner_cache[key] = torch.from_numpy(
            host_power_matrix(field, root, SUB_PEEL, m // SUB_PEEL)).to(device)
    return got


def single_level(m: int, mats) -> bool:
    """Whether K3 runs an m-point sub-NTT as one conv matrix: always up
    to SUB_PEEL points, at 64 where ``mats`` holds the 64-point matrix (a
    plan built under NTT_MXU_BASE_LOG=6), never above. Else the peel-32
    recursion of the multi-level kernel."""
    return m <= SUB_PEEL or (m <= LEVEL_MAX_M and m in mats)


def _subntt_plain(x3, field: Field, mats, inverse: bool):
    """The m-point sub-NTT alone: one matrix where :func:`single_level`,
    else the peel-32 recursion (32-point transforms over i1, the inner
    twiddle, transpose, (m/32)-point transforms over i2; output row
    k2*32 + k1)."""
    W, m, B = x3.shape
    if single_level(m, mats):
        return digits.apply_matrix(mats[m], x3, field, m,
                                   _zmax_bits(field, m),
                                   fold_mat=mats.get(-m))
    P = SUB_PEEL
    m2 = m // P
    y = digits.apply_matrix(mats[P], x3.reshape(W, P, m2, B), field,
                            P, _zmax_bits(field, P), fold_mat=mats.get(-P))
    Tin = inner_twiddle(field, m, inverse, x3.device)
    y = limbs.mont_mul(y, Tin[:, :, :, None], field)
    y = digits.apply_matrix(mats[m2], y.transpose(1, 2).contiguous(), field,
                            m2, _zmax_bits(field, m2),
                            fold_mat=mats.get(-m2))
    return y.reshape(W, m, B)


def fused_subntt_plain(x3, field: Field, inverse: bool, mats, T3=None,
                       transpose_out: bool = False, rep: int = 1):
    """Plain PyTorch version of K3, single- and multi-level."""
    B = x3.shape[2]
    y = _subntt_plain(x3, field, mats, inverse)
    if T3 is not None:
        y = _twiddle_product(y, _expand_twiddle(T3, rep, B), field,
                             mats.get(-1))
    return _store(y, transpose_out)


def fused_subntt(x3, field: Field, inverse: bool, mats, T3=None,
                 transpose_out: bool = False, rep: int = 1):
    """m-point sub-NTT along axis 1 of uint32[W, m, B] (m a power of two
    up to 1024), then the optional decomposition twiddle ``T3``: [W, m, B]
    for rep == 1, the i2-resolution table [W, B // rep, m] for rep > 1;
    stored as [W, B, m] when ``transpose_out`` (else [W, m, B]).
    ``mats``: {size: conv matrix, -size: fold matrix, -1: twiddle fold
    matrix} built for the direction ``inverse``; the kernels read only the
    conv matrices: of m itself where :func:`single_level` (m <= 32, or 64
    with its matrix in ``mats``), else of 32 and m // 32 (the multi-level
    kernel, in its wide form where :func:`sub_wide` for the card's SMs),
    whose inner twiddle is of the direction ``inverse``."""
    W, m, B = x3.shape
    if m == 1:
        return _store(x3, transpose_out)
    if T3 is not None:
        want = (W, m, B) if rep == 1 else (W, B // rep, m)
        if B % rep or tuple(T3.shape) != want:
            raise ValueError(f"rep {rep}: T3 must be {want}, "
                             f"got {tuple(T3.shape)}")
    if x3.device.type == "cpu":
        return fused_subntt_plain(x3, field, inverse, mats, T3,
                                  transpose_out, rep)
    with span("ntt.launch.fused_subntt"):
        _build.check_level(x3, field, MAX_SUB)
        D, E = digits.n_digits(field), digits.out_planes(field)
        if T3 is not None:
            _build.check_operand(T3, "T3", torch.uint32, T3.shape, x3.device)
        out = _output(x3, transpose_out)
        if single_level(m, mats):
            A = mats[m]
            _build.check_operand(A, "A", torch.int8, (E * m, D * m), x3.device)
            rc = _lib().mxu_fused_subntt(
                _build.ptr(x3), _build.ptr(A), _build.ptr(T3), rep,
                _build.ptr(out), int(transpose_out), m, B,
                *_build.field_args(field), *plan_args(field, m, B),
                _build.stream(x3))
            _build.check(rc, "fused_subntt")
            _build.launches["fused_subntt"] += 1
            return out
        m2 = m // SUB_PEEL
        A1, A2 = mats[SUB_PEEL], mats[m2]
        _build.check_operand(A1, "A[32]", torch.int8,
                             (E * SUB_PEEL, D * SUB_PEEL), x3.device)
        _build.check_operand(A2, f"A[{m2}]", torch.int8, (E * m2, D * m2),
                             x3.device)
        Tin = inner_twiddle(field, m, inverse, x3.device)
        sms = _build.sm_count(x3.device)
        if sub_wide(field, m, B, sms):
            rc = _lib_sub().mxu_fused_subntt_wide(
                _build.ptr(x3), _build.ptr(A1), _build.ptr(A2),
                _build.ptr(Tin), _build.ptr(T3), rep, _build.ptr(out),
                int(transpose_out), m, B,
                *_build.field_args(field), *sub_wide_args(field, m, B, sms),
                _build.stream(x3))
            _build.check(rc, "fused_subntt_wide")
            _build.launches["fused_subntt_wide"] += 1
            return out
        rc = _lib_sub().mxu_fused_subntt_multi(
            _build.ptr(x3), _build.ptr(A1), _build.ptr(A2), _build.ptr(Tin),
            _build.ptr(T3), rep, _build.ptr(out), int(transpose_out), m, B,
            *_build.field_args(field), *sub_plan_args(field, m, B),
            _build.stream(x3))
        _build.check(rc, "fused_subntt_multi")
        _build.launches["fused_subntt_multi"] += 1
        return out


# ---------------------------------------------------------------------------
# K4: one level with a full-resolution twiddle and a transposed store
# ---------------------------------------------------------------------------

def fused_level_plain(x3, field: Field, A, T3=None,
                      transpose_out: bool = True, F=None, F2=None):
    """Plain PyTorch version of K4."""
    m = x3.shape[1]
    y = digits.apply_matrix(A, x3, field, m, _zmax_bits(field, m), fold_mat=F)
    if T3 is not None:
        y = _twiddle_product(y, T3, field, F2)
    return _store(y, transpose_out)


def _check_level_operands(x3, field: Field, A, T3) -> None:
    W, m, B = x3.shape
    _build.check_level(x3, field, LEVEL_MAX_M)
    D, E = digits.n_digits(field), digits.out_planes(field)
    _build.check_operand(A, "A", torch.int8, (E * m, D * m), x3.device)
    if T3 is not None:
        _build.check_operand(T3, "T3", torch.uint32, (W, m, B), x3.device)


def fused_level(x3, field: Field, A, T3=None, transpose_out: bool = True,
                F=None, F2=None):
    """One four-step level on uint32[W, m, B] (m a power of two up to 64):
    the m-point transform as one digit matmul against the conv matrix
    ``A``, the optional full-resolution twiddle ``T3`` [W, m, B], stored as
    [W, B, m] when ``transpose_out`` (else [W, m, B]). ``F``, ``F2``: the
    fold matrices, which only the plain version reads."""
    W, m, B = x3.shape
    if x3.device.type == "cpu":
        return fused_level_plain(x3, field, A, T3, transpose_out, F, F2)
    with span("ntt.launch.fused_level"):
        _check_level_operands(x3, field, A, T3)
        out = _output(x3, transpose_out)
        rc = _lib().mxu_fused_level(
            _build.ptr(x3), _build.ptr(A), _build.ptr(T3), _build.ptr(out),
            int(transpose_out), m, B, *_build.field_args(field),
            *plan_args(field, m, B), _build.stream(x3))
        _build.check(rc, "fused_level")
        _build.launches["fused_level"] += 1
        return out


# ---------------------------------------------------------------------------
# K7: K4's level cut off after a stage
# ---------------------------------------------------------------------------

#: the stages of the fused-level probe, in pipeline order
PROBE_STAGES = ("stream", "digits", "matmul", "reduce", "tw")


def fused_level_probe_plain(x3, field: Field, A, stage: str, T3=None):
    """Plain PyTorch version of K7."""
    W, m, B = x3.shape
    if stage == "stream":
        return x3.clone()
    D, E = digits.n_digits(field), digits.out_planes(field)
    d = digits.extract_digits(x3, field)                    # [D, m, B]
    if stage == "digits":
        acc = d.to(torch.int64).sum(dim=0)
        return acc[None].expand(W, m, B).to(torch.uint32).contiguous()
    Z = digits.matmul_exact(A, d.reshape(D * m, B)).reshape(E, m, B)
    if stage == "matmul":
        return (Z[:W] & 0xFFFFFFFF).to(torch.uint32)
    y = digits.recompose_reduce(Z, field, _zmax_bits(field, m))
    if stage == "tw":
        y = _twiddle_product(y, T3, field)
    return y


def fused_level_probe(x3, field: Field, A, stage: str, T3=None):
    """The fused level (K4 without the transposed store; K3 at rep 1) cut
    off after ``stage``, for attributing its time: uint32[W, m, B] holding
    x itself (``stream``), the sum of each element's digits on every word
    plane (``digits``), the first W accumulator planes cast to uint32
    (``matmul``), the reduced transform (``reduce``) or its product with
    ``T3`` (``tw``, which is :func:`fused_level` with T3 and no
    transpose). The kernel runs the tensor-core level's launch plan
    (:func:`tc_plan`)."""
    if stage not in PROBE_STAGES:
        raise ValueError(f"stage must be one of {PROBE_STAGES}, got {stage!r}")
    if (stage == "tw") != (T3 is not None):
        raise ValueError("T3 goes with stage 'tw' and only with it")
    W, m, B = x3.shape
    if x3.device.type == "cpu":
        return fused_level_probe_plain(x3, field, A, stage, T3)
    with span("ntt.launch.fused_level_probe"):
        _check_level_operands(x3, field, A, T3)
        out = torch.empty_like(x3)
        rc = _lib().mxu_fused_level_probe(
            _build.ptr(x3), _build.ptr(A), _build.ptr(T3), _build.ptr(out),
            PROBE_STAGES.index(stage), m, B, *_build.field_args(field),
            *plan_args(field, m, B), _build.stream(x3))
        _build.check(rc, "fused_level_probe")
        _build.launches["fused_level_probe"] += 1
        return out

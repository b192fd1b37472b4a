"""Digit-matmul NTT: ``mxu_chunked``, ``mxu_sub`` (the two ``auto`` paths),
``mxu``, ``mxu_pallas`` and ``mxu_fused`` — the port of
``ntt_tpu.transforms.mxu``, forward, inverse and coset.

The four-step recursion peels BASE = 32 columns per level (64 under
NTT_MXU_BASE_LOG=6). A level's BASE-point column transforms are ONE int8
digit matmul against a conv matrix (:mod:`ntt_tpu_torch.digits`), with the
decomposition twiddle either folded into a stack of conv matrices
(:class:`~.fourstep.TwMatStack`) or applied by a Montgomery product inside
the same kernel. The last base transform (m <= BASE) is one more matmul.
``mxu_sub`` peels SUBBASE = 512 columns per
level instead, and a whole 512-point sub-NTT (two inner matmul levels) is
one kernel. ``mxu`` and ``mxu_pallas`` run the plain recursion (base
transform, separate twiddle product, transpose) with the digit matmul as a
PyTorch product or as kernel K1; ``mxu_fused`` is the flat peel loop with one
``fused_level`` launch per level. The knobs of the JAX package's
``transforms/mxu.py`` are read here from the environment once, at import,
under the same names and defaults (``ntt_tpu_torch.config`` lists them):
NTT_MXU_BASE_LOG=5, NTT_TW_MATFOLD=1, NTT_TW_STACK_MAX_NT=128,
NTT_TW_MERGED_MAX=2^24, NTT_TW_RESID=auto, NTT_FUSE_TW=1,
NTT_MXU_SUBBASE_LOG=9, NTT_MXU_SUB256_LOG=0.

The constructors here return the aux tables in their numpy form (see
``api.aux_from_numpy``), byte-equal to the JAX package's; given a device,
the tables above ``core.HOST_TW_LIMIT`` entries come as tensors generated
there, with the same words.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import digits, limbs
from ..fields import Field
from ..kernels import mxu_level
from ..kernels.mxu_level import fused_level, fused_level_stack, fused_subntt
from ..kernels.mxu_ntt import base_ntt_mxu
from ..tracing import span
from .core import (host_power_matrix, host_powers_fast, power_table,
                   scale_columns)
from .fourstep import (TwMatStack, TwStackResid, check_unbatched,
                       ntt_axis_fourstep, undo_peel_order)
from .fourstep import twiddle_requests as _fourstep_requests

#: log2 of the peel and base-transform size of the single-level drivers
BASE_LOG = int(os.environ.get("NTT_MXU_BASE_LOG", "5"))
BASE = 1 << BASE_LOG

#: the decomposition twiddles folded into conv-matrix stacks and one merged
#: table (256-bit fields, peel-BASE drivers; :func:`matfold_tw_tables`)
TW_MATFOLD = os.environ.get("NTT_TW_MATFOLD", "1") == "1"
#: largest per-level matrix stack the twiddle fold may build
TW_STACK_MAX_NT = int(os.environ.get("NTT_TW_STACK_MAX_NT", "128"))
#: largest n whose merged level-1 table (TwBatch, n entries) is built;
#: above it level 0 takes the periodic residual (TwStackResid)
TW_MERGED_MAX = int(os.environ.get("NTT_TW_MERGED_MAX", str(1 << 24)))
#: the periodic residual at level 0: "auto" above TW_MERGED_MAX only, "1"
#: at every size where level 0 folds, "0" never
TW_RESID = os.environ.get("NTT_TW_RESID", "auto")
#: the top level's twiddle applied inside the level kernels (``mxu_chunked``);
#: 0 runs each level's base transform, then the twiddle as a plain product
FUSE_TW = os.environ.get("NTT_FUSE_TW", "1") == "1"

_matrix_cache: dict = {}


def _root(field: Field, m: int, inverse: bool) -> int:
    return field.inv_root_of_unity(m) if inverse else field.root_of_unity(m)


def _dft_entries(field: Field, m: int, inverse: bool,
                 col_shift: int | None = None) -> list:
    """M̃[k][i] = ω_m^{ik} (· col_shift^i) · R · 2^16 mod p."""
    p = field.p
    w = _root(field, m, inverse)
    scale = digits.matrix_prescale(field)
    wp = [pow(w, j, p) for j in range(m)]
    if col_shift is None:
        return [[wp[(i * k) % m] * scale % p for i in range(m)]
                for k in range(m)]
    cp = [pow(col_shift % p, i, p) for i in range(m)]
    return [[wp[(i * k) % m] * cp[i] % p * scale % p for i in range(m)]
            for k in range(m)]


def _base_matrix(field: Field, m: int, inverse: bool = False) -> np.ndarray:
    """Digit conv matrix of the m-point DFT (the inverse roots when
    ``inverse``), entries ω_m^{ik} * R * 2^16 mod p."""
    got = _matrix_cache.get((field.name, m, inverse))
    if got is None:
        got = _matrix_cache[(field.name, m, inverse)] = digits.conv_matrix(
            _dft_entries(field, m, inverse), field)
    return got


def coset_base_matrix(field: Field, m: int, inverse: bool,
                      col_shift: int) -> np.ndarray:
    """Conv matrix of the m-point DFT with the coset column scaling
    ``col_shift^i`` absorbed into the input side: entries
    ω_m^{ik} · col_shift^i · R · 2^16 mod p. A diagonal on the contraction
    index folds into the matrix exactly, so a coset NTT's first level costs
    the same matmul as the plain one."""
    return digits.conv_matrix(_dft_entries(field, m, inverse, col_shift),
                              field)


def twiddle_matrix_stack(field: Field, m: int, inverse: bool, tvals,
                         col_shift: int | None = None) -> np.ndarray:
    """Stack of conv matrices ``diag(t_s) @ DFT_m`` (optionally
    ``@ diag(col_shift^i)`` on the input side): int8[NT, E*m, D*m],
    ``tvals[s][k]`` the plain twiddle value multiplying output row k of
    stack entry s."""
    p = field.p
    base = _dft_entries(field, m, inverse, col_shift)
    mats = []
    for ts in tvals:
        entries = [[base[k][i] * ts[k] % p for i in range(m)]
                   for k in range(m)]
        mats.append(digits.conv_matrix(entries, field))
    return np.stack(mats, axis=0)


def _scale_cols(T, v: np.ndarray, field: Field):
    """T[W, r, c] times the host row vector v[W, c] (Montgomery product) in
    row chunks: on the host for a numpy T, on T's device for a tensor."""
    vt = torch.from_numpy(np.ascontiguousarray(v))
    if isinstance(T, np.ndarray):
        return scale_columns(torch.from_numpy(T), vt, field,
                             chunk=1 << 16).numpy()
    return scale_columns(T, vt.to(T.device), field)


def matfold_plan(field: Field, n: int):
    """The form each level's table takes under the matrix fold, without
    building any: a list of (kind, (m, n1, n2)) in twiddle-request order,
    or None when nothing folds.
    Kinds: ``"stack"`` (a conv-matrix stack: level 0 up to TW_MERGED_MAX,
    or a deep level folded whole), ``"resid"`` (level 0's stack with the
    periodic residual: above TW_MERGED_MAX under TW_RESID=auto, at every
    size under TW_RESID=1), ``"batch"`` (the merged level-1 table, n
    entries), ``"deep"`` (a deep level's plain table) and ``"plain"`` (the
    top level's plain table)."""
    requests = _fourstep_requests(n, BASE)
    if not requests:
        return None
    D = digits.n_digits(field)
    E = digits.out_planes(field)
    s0 = requests[0][2] // BASE
    geom0 = len(requests) >= 2 and s0 >= 128 and requests[0][0] == n
    resid0 = geom0 and (TW_RESID == "1" or
                        (TW_RESID == "auto" and n > TW_MERGED_MAX))
    fold0 = geom0 and not resid0 and n <= TW_MERGED_MAX
    kinds = []
    for l, (m_l, _, n2_l) in enumerate(requests):
        R_l = n // m_l
        if l == 0 and (fold0 or resid0):
            kinds.append("stack" if fold0 else "resid")
        elif l == 1 and fold0:
            kinds.append("batch")
        elif (l >= 2 and n2_l <= TW_STACK_MAX_NT and R_l % 128 == 0
              and n2_l * E * BASE * D * BASE <= 4 * n * field.n_words * 4):
            kinds.append("stack")
        else:
            kinds.append("plain" if m_l == n else "deep")
    if not fold0 and not resid0 and "stack" not in kinds:
        return None
    return list(zip(kinds, requests))


def matfold_tw_tables(field: Field, n: int, inverse: bool = False,
                      coset_shift: int | None = None, device=None):
    """Twiddle tables with the decomposition twiddles folded into
    conv-matrix stacks where :func:`matfold_plan` says so, or None when
    nothing folds. The tables are in numpy form, built on the host; with a
    ``device``, those above HOST_TW_LIMIT entries are tensors generated
    there (the same words). ``coset_shift`` (forward only) folds the coset
    premultiply c^i in exactly: c^{i1*n2_0} as the level-0 stack's
    input-side diagonal, c^{a*s0} as a per-stack-entry scalar, c^b into the
    merged level-1 table or the residual, so the coset costs no extra pass:

    - level 0 (when level 1 exists and s0 = n2_0/BASE >= 128): a BASE-entry
      stack over the high digit a of i2 = a*s0 + b. Up to TW_MERGED_MAX
      the residual w^{k*b} is deferred into level 1, which then takes ONE
      merged batch-resolution table M[k1, b, k0] = w_n^{(BASE*k1 + k0)*b};
      above it (or at every size under TW_RESID=1) the residual stays at
      level 0 as the compact periodic table
      Tres[W, BASE, s0] (``"resid"``), which the level kernel reads at
      column b mod s0, and level 1 keeps its plain table: no table has n
      entries;
    - deeper levels fold entirely into an n2-entry stack when n2 <=
      TW_STACK_MAX_NT and the stack stays below four data sizes."""
    plan = matfold_plan(field, n)
    if plan is None:
        return None
    p = field.p
    shift = None if coset_shift is None else coset_shift % p
    s0 = plan[0][1][2] // BASE
    out = []
    for l, (kind, (m_l, n1, n2_l)) in enumerate(plan):
        w = _root(field, m_l, inverse)
        if l == 0 and kind in ("stack", "resid"):
            lam = [1] * BASE if shift is None else [
                pow(shift, a * s0, p) for a in range(BASE)]
            tvals = [[pow(w, (k * a * s0) % m_l, p) * lam[a] % p
                      for k in range(BASE)] for a in range(BASE)]
            col = None if shift is None else pow(shift, m_l // BASE, p)
            As = twiddle_matrix_stack(field, BASE, inverse, tvals,
                                      col_shift=col)
            entry = {"kind": kind, "rep": s0, "As": As}
            if kind == "resid":
                Tres = power_table(field, w, BASE, s0, device)
                if shift is not None:
                    Tres = _scale_cols(
                        Tres, host_powers_fast(field, shift, s0), field)
                entry["Tres"] = Tres
            out.append(entry)
        elif kind == "batch":
            BB = BASE * BASE
            M = power_table(field, _root(field, n, inverse), BB, n2_l,
                             device)
            if shift is not None:
                M = _scale_cols(M, host_powers_fast(field, shift, n2_l),
                                field)
            M = M.reshape(field.n_words, BASE, BASE, n2_l)
            M = (np.ascontiguousarray(M.transpose(0, 1, 3, 2))
                 if isinstance(M, np.ndarray)
                 else M.permute(0, 1, 3, 2).contiguous())  # [W, k1, b, k0]
            out.append({"kind": "batch", "T4": M})
        elif kind == "stack":
            tvals = [[pow(w, (k * s) % m_l, p) for k in range(BASE)]
                     for s in range(n2_l)]
            out.append({"kind": "stack", "rep": n // m_l,
                        "As": twiddle_matrix_stack(field, BASE, inverse,
                                                   tvals)})
        else:
            out.append(plain_table(field, n, inverse, m_l, n1, n2_l, device))
    return out


def plain_table(field: Field, n: int, inverse: bool, m: int, n1: int,
                n2: int, device=None):
    """The plain decomposition twiddle ω_m^{k1·i2} of one level (numpy, or
    generated on ``device`` above HOST_TW_LIMIT entries): the table
    [W, n1, n2] itself at the top level (m == n), and
    ``{"kind": "deep", "T": table}`` below it, which ``aux_from_numpy``
    lays out once in the i2-resolution form [W, n2, n1] that a deep level
    hands to its kernel."""
    T = power_table(field, _root(field, m, inverse), n1, n2, device)
    return T if m == n else {"kind": "deep", "T": T}


def _zmax_bits(field: Field, m: int) -> int:
    """Exact bound on one accumulator entry: <= m * D * (2^7-1)^2."""
    return (m * digits.n_digits(field) * digits.DIGIT_MASK ** 2).bit_length()


def _fold_matrix(field: Field, m: int):
    """Montgomery fold matrix of the m-point conv-matmul reduction, or
    None for a narrow field (no fold)."""
    if not digits.fold_active(field):
        return None
    zb = _zmax_bits(field, m)
    J, hbits = digits.halves_info(digits.out_planes(field), zb)
    return digits.fold_reduce_matrix(field, J, hbits, zb)


def base_sizes(n: int) -> set:
    """Distinct base-transform sizes the peel-BASE recursion hits."""
    if n <= BASE:
        return {n}
    return base_sizes(BASE) | base_sizes(n // BASE)


def _mats_for(field: Field, sizes, inverse: bool) -> dict:
    sizes = [m for m in sizes if m > 1]
    out = {m: _base_matrix(field, m, inverse) for m in sizes}
    if digits.fold_active(field):
        out.update({-m: _fold_matrix(field, m) for m in sizes})
        out[-1] = digits.fold_mul_matrix(field)
    return out


def base_mats(field: Field, n: int, inverse: bool = False) -> dict:
    """{m: conv matrix, -m: its fold matrix} for every base size m > 1,
    plus the twiddle-product fold matrix keyed -1 (numpy; the fold
    matrices only for wide fields)."""
    return _mats_for(field, base_sizes(n), inverse)


#: log2 of the peel of the multi-level sub-NTT transform on the narrow
#: fields: a whole SUBBASE-point transform runs in one kernel, so
#: n = SUBBASE^2 needs two passes over the data
SUBBASE_LOG = int(os.environ.get("NTT_MXU_SUBBASE_LOG", "9"))
SUBBASE = 1 << SUBBASE_LOG
#: log2 of the multi-level peel of the 256-bit fields (0: the single-level
#: BASE, the default)
SUB256_LOG = int(os.environ.get("NTT_MXU_SUB256_LOG", "0"))

_subbase_cache: dict = {}


def single_level_max() -> int:
    """The longest sub-NTT the kernels run as one conv matrix under the
    current BASE: BASE itself, at most ``mxu_level.LEVEL_MAX_M`` (64), and
    never below ``mxu_level.SUB_PEEL`` (32), since the multi-level kernel
    starts at twice its peel. Longer ones run the multi-level kernel, which
    peels SUB_PEEL points whatever BASE is."""
    return max(mxu_level.SUB_PEEL, min(BASE, mxu_level.LEVEL_MAX_M))


def _card_fits(field: Field, s: int) -> bool:
    """Whether the port's kernels take an s-point sub-NTT in one launch:
    one conv matrix up to :func:`single_level_max` points, the multi-level
    kernel up to ``mxu_level.MAX_SUB`` points when its plan fits a
    block."""
    if s <= single_level_max():
        return True
    if s > mxu_level.MAX_SUB:
        return False
    try:
        mxu_level.sub_plan(field, s, mxu_level.TC_COLS)
    except ValueError:
        return False
    return True


#: the JAX package's TPU build settings that its peel rule reads, at their
#: defaults (their knobs, NTT_MXU_BT = 256 and NTT_VMEM_LIMIT_MB = 64, have
#: no counterpart here): the scoped-VMEM budget of its kernels and that of
#: its 256-bit multi-level kernels (the 64 MB limit less 8 MB). The rule
#: takes a peel whose kernel keeps a tile of REF_MIN_TILE columns (the
#: TPU's 128 lanes) within the budget: its tile search halves 256 until
#: the working set fits, so it reaches 128 exactly where 128 columns fit
REF_VMEM_BUDGET = 14 << 20
REF_VMEM_BUDGET_WIDE = (64 - 8) << 20
REF_MIN_TILE = 128


def reference_peel_fits(field: Field, s: int) -> bool:
    """Whether the JAX package takes s points as the multi-level peel of
    ``mxu_sub`` (``ntt_tpu/kernels/mxu_ntt.py`` ``vmem_batch_tile`` at a
    wide batch with a twiddle, its multi-level working set, against
    REF_MIN_TILE): the conv matrices of the inner base sizes, and per batch
    column the int32 Z planes, the digits and the double-buffered input,
    output and twiddle words, four times that for a 256-bit peel above
    BASE (its CIOS temporaries), against its budget. The arithmetic of the
    reference's peel, copied; not the card's (:func:`_card_fits`)."""
    D, E, W = digits.n_digits(field), digits.out_planes(field), field.n_words
    mat = sum(E * sz * D * sz for sz in base_sizes(s) if sz > 1)
    per_col = E * s * 4 + D * s + 3 * 2 * W * s * 4
    budget = REF_VMEM_BUDGET
    if field.n_halves > 8 and s > BASE:
        per_col *= 4
        budget = REF_VMEM_BUDGET_WIDE
    return mat + REF_MIN_TILE * per_col <= budget


def effective_subbase(field: Field) -> int:
    """The peel size of ``mxu_sub``, the JAX package's: SUBBASE on the
    narrow fields, the single-level BASE on the 256-bit ones unless
    NTT_MXU_SUB256_LOG asks for a multi-level peel; halved while the
    reference's kernel would not take it (:func:`reference_peel_fits`).
    ValueError where the card's kernels do not take that peel
    (:func:`_card_fits`: the multi-level kernel takes m up to 1024 where
    its plan fits a block): the port never peels smaller than the
    reference."""
    key = (field.name, BASE, SUBBASE, SUB256_LOG)
    got = _subbase_cache.get(key)
    if got is None:
        if field.n_halves <= 8:
            s = SUBBASE
        else:
            s = max(BASE, 1 << SUB256_LOG) if SUB256_LOG else BASE
        while s > BASE and not reference_peel_fits(field, s):
            s //= 2
        if not _card_fits(field, s):
            raise ValueError(
                f"{field.name}: mxu_sub peels {s} points (NTT_MXU_SUBBASE_LOG"
                f"={SUBBASE_LOG}, NTT_MXU_SUB256_LOG={SUB256_LOG}), which no "
                f"kernel of the port takes in one launch (multi-level up to "
                f"m = {mxu_level.MAX_SUB} where its plan fits a block)")
        got = _subbase_cache[key] = s
    return got


def sub_base_sizes(n: int, sub: int) -> set:
    """Every kernel transform length the sub-peel recursion hits,
    expanded to the inner matmul base sizes."""
    inner = set()
    for s in _outer_sizes(n, sub):
        inner |= base_sizes(s)
    return inner


def _outer_sizes(n: int, sub: int) -> set:
    outer = set()
    m = n
    while m > sub:
        outer.add(sub)
        m //= sub
    outer.add(m)
    return outer


def kernel_sizes(sizes) -> set:
    """The conv-matrix sizes the kernels read for sub-NTTs of the lengths
    ``sizes``: m itself up to :func:`single_level_max` points (one matrix:
    32, or 64 under NTT_MXU_BASE_LOG=6), else the multi-level kernel's 32
    and m / 32 (its inner peel is 32 whatever BASE is). ``fused_subntt``
    takes the single-level kernel exactly where the m-point matrix is
    there (``mxu_level.single_level``)."""
    one, peel = single_level_max(), mxu_level.SUB_PEEL
    out = set()
    for s in sizes:
        out |= {s} if s <= one else {peel, s // peel}
    return out


def sub_mats(field: Field, n: int, inverse: bool = False) -> dict:
    """The mats dict of the multi-level sub-NTT transform (numpy): the
    sizes its kernels read (:func:`kernel_sizes`), which are
    :func:`sub_base_sizes` at the default BASE."""
    return _mats_for(field, kernel_sizes(
        _outer_sizes(n, effective_subbase(field))), inverse)


def _drive(x, field: Field, inverse: bool, tws, mats, pre_col, first_mats,
           base_max: int, base_kernel, fuse: bool = True):
    """The four-step over ``base_max``-point columns: every level is the
    stack kernel (:func:`fused_level_stack`) or the sub-NTT-with-twiddle
    kernel (:func:`fused_subntt`), the last base is
    ``base_kernel(c3 [W, m, B], md)``; without ``fuse`` every level is the
    generic one (its base transform by ``base_kernel``, then the twiddle
    product). ``first_mats`` overrides conv matrices for the top level only
    (the coset fusion, :func:`coset_base_matrix`)."""

    def make(md):
        def base(c, f, inv):
            W, m = c.shape[0], c.shape[1]
            return base_kernel(c.reshape(W, m, -1), md).reshape(c.shape)

        def tw_base(c3, t3, rep=1):
            if isinstance(t3, TwStackResid):
                return fused_level_stack(c3, field, t3.As, t3.rep,
                                         md.get(-c3.shape[1]), T3=t3.Tres)
            if isinstance(t3, TwMatStack):
                return fused_level_stack(c3, field, t3.As, t3.rep,
                                         md.get(-c3.shape[1]))
            return fused_subntt(c3, field, inverse, md, t3, rep=rep)
        return base, (tw_base if fuse else None)

    base, tw_base = make(mats)
    first_base = first_tw = None
    if first_mats is not None:
        first_base, first_tw = make({**mats, **first_mats})
    return ntt_axis_fourstep(x, field, inverse, base, base_max, tws,
                             pre_col=pre_col, tw_base_fn=tw_base,
                             first_base_fn=first_base,
                             first_tw_base_fn=first_tw)


def ntt_mxu_chunked(x, field: Field, inverse: bool = False, tws=None,
                    mats=None, pre_col=None, first_mats=None, *,
                    base_max: int | None = None, fuse: bool | None = None):
    """NTT along axis 1 of uint32[W, n, *batch] (Montgomery form in and
    out, no 1/n scale) by the peel-``base_max`` four-step; the last base
    runs :func:`base_ntt_mxu`. ``tws``: iterator over the level tables;
    ``mats``: the :func:`base_mats` dict, as device tensors (built for
    ``inverse``). Without ``fuse`` every level is generic: the base
    kernel, then the twiddle as a plain Montgomery product. ``base_max``
    and ``fuse`` are the plan the tables were built for (``api.get_runner``
    passes them); None reads BASE and FUSE_TW."""
    def base(c3, md):
        m = c3.shape[1]
        return base_ntt_mxu(c3, field, md.get(m), md.get(-m))
    return _drive(x, field, inverse, tws, mats, pre_col, first_mats,
                  base_max or BASE, base,
                  fuse=FUSE_TW if fuse is None else fuse)


def ntt_mxu_sub(x, field: Field, inverse: bool = False, tws=None,
                mats=None, pre_col=None, first_mats=None, *,
                base_max: int | None = None):
    """NTT along axis 1 of uint32[W, n, *batch] (Montgomery form in and
    out, no 1/n scale) by the four-step with ``base_max``-point
    single-kernel sub-NTTs (the plan's peel; None: :func:`effective_subbase`):
    every level and the last base is one launch of :func:`fused_subntt`
    (its multi-level kernel above :func:`single_level_max` points), so
    n = 2^18 is two passes over the data. ``mats``: the :func:`sub_mats`
    dict as device tensors."""
    def base(c3, md):
        return fused_subntt(c3, field, inverse, md)
    return _drive(x, field, inverse, tws, mats, pre_col, first_mats,
                  base_max or effective_subbase(field), base)


# ---------------------------------------------------------------------------
# mxu, mxu_pallas: the plain recursion over digit-matmul base transforms
# ---------------------------------------------------------------------------

def twiddle_requests(m: int) -> list:
    """(m, n1, n2) decomposition-twiddle tables of the peel-BASE recursion,
    in consumption order."""
    return _fourstep_requests(m, BASE)


def _base_ntt(x, field: Field, inverse: bool, mats=None):
    """m <= BASE point NTT along axis 1 as one digit matmul, in plain
    PyTorch (any batch rank); ``mats`` built for ``inverse``."""
    m = x.shape[1]
    if m == 1:
        return x
    return digits.apply_matrix(mats[m], x, field, m, _zmax_bits(field, m),
                               fold_mat=mats.get(-m))


def _base_ntt_kernel(x, field: Field, inverse: bool, mats=None):
    """The same through kernel K1, the batch flattened to one axis."""
    W, m = x.shape[0], x.shape[1]
    if m == 1:
        return x
    return base_ntt_mxu(x.reshape(W, m, -1), field, mats[m],
                        mats.get(-m)).reshape(x.shape)


def ntt_axis_mxu(x, field: Field, inverse: bool = False, tws=None,
                 base_fn=None, mats=None, *, base_max: int | None = None):
    """Natural-order NTT along axis 1 of uint32[W, m, *batch] (Montgomery
    form in and out, no 1/n scale): base transforms over ``base_max``
    columns (the plan's peel; None: BASE), the decomposition twiddle as a
    separate product, transpose, recurse. ``tws``: iterator over the plain
    tables [W, base_max, m / base_max] of :func:`twiddle_requests`;
    ``mats``: the :func:`base_mats` dict, built for ``inverse``;
    ``base_fn``: :func:`_base_ntt` unless given."""
    base = base_fn or _base_ntt
    peel = base_max or BASE
    W, m = x.shape[0], x.shape[1]
    rest = tuple(x.shape[2:])
    if m <= peel:
        return base(x, field, inverse, mats)
    n1, n2 = peel, m // peel
    y = base(x.reshape((W, n1, n2) + rest), field, inverse, mats)  # over i1
    T = next(tws)                                             # ω_m^{k1·i2}
    y = limbs.mont_mul(y, T.reshape(tuple(T.shape) + (1,) * len(rest)),
                       field)
    with span("ntt.copy"):
        y = y.transpose(1, 2).contiguous()               # [W, i2, k1, *rest]
    y = ntt_axis_mxu(y, field, inverse, tws, base_fn, mats,
                     base_max=peel)                           # over i2
    return y.reshape((W, m) + rest)                           # X[k2*n1 + k1]


def ntt_mxu(x, field: Field, tws, mats, *, base_max: int | None = None):
    """The digit-matmul transform with its matmuls in plain PyTorch (the
    tables carry the direction)."""
    return ntt_axis_mxu(x, field, tws=tws, mats=mats, base_max=base_max)


def ntt_mxu_pallas(x, field: Field, tws, mats, *,
                   base_max: int | None = None):
    """The digit-matmul transform with kernel K1 as its base transform."""
    return ntt_axis_mxu(x, field, tws=tws, base_fn=_base_ntt_kernel,
                        mats=mats, base_max=base_max)


# ---------------------------------------------------------------------------
# mxu_fused: one fused_level launch per level
# ---------------------------------------------------------------------------

def expanded_twiddles(field: Field, n: int, inverse: bool = False,
                      base: int = BASE) -> list:
    """Full-resolution per-level twiddles of the flat-peel transforms (numpy):
    level l's table [W, base, I2_l] repeated across the already processed
    suffix S_l, so that every level's twiddle is batch-shaped
    [W, base, n / base]."""
    out = []
    S = 1
    remaining = n
    W = field.n_words
    while remaining > base:
        I2 = remaining // base
        T = host_power_matrix(field, _root(field, remaining, inverse), base,
                              I2)
        Te = np.broadcast_to(T[:, :, :, None], T.shape + (S,))
        out.append(np.ascontiguousarray(Te).reshape(W, base, I2 * S))
        remaining //= base
        S *= base
    return out


def ntt_mxu_fused(x, field: Field, tws, mats, *,
                  base_max: int | None = None):
    """The fully fused digit-matmul transform of unbatched uint32[W, n]:
    one :func:`fused_level` launch per level (digits, matmul, reduction,
    twiddle, transposed store). Carving the next ``base_max``-point axis
    (the plan's peel; None: BASE) off the front of the flattened remainder
    is a reshape after the transposed store. ``tws``: iterator over
    :func:`expanded_twiddles`; ``mats``: the :func:`base_mats` dict."""
    check_unbatched(x)
    peel = base_max or BASE
    W, n = x.shape
    remaining = n
    cur = x.reshape(W, min(peel, n), -1)
    levels = 0
    while remaining > peel:
        cur = fused_level(cur, field, mats[peel], next(tws),
                          transpose_out=True, F=mats.get(-peel),
                          F2=mats.get(-1))
        remaining //= peel
        levels += 1
        cur = cur.reshape(W, min(peel, remaining), -1)
    if remaining > 1:
        cur = fused_level(cur, field, mats[remaining], None,
                          transpose_out=False, F=mats.get(-remaining))
    return undo_peel_order(cur, remaining, peel, levels)

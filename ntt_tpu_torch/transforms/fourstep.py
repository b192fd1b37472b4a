"""Four-step (self-sorting) NTT recursion and its butterfly-ladder transforms
(``fourstep``, ``fourstep_st``, ``pallas``, ``pallas_fused``) — the port of
``ntt_tpu.transforms.fourstep``.

With n = n1*n2, i = i1*n2 + i2, k = k2*n1 + k1 and ω the n-th root:

    X[k2*n1 + k1] = Σ_{i2} ω_{n2}^{i2 k2} · ω^{i2 k1} · Σ_{i1} x[i1*n2+i2] ω_{n1}^{i1 k1}

so each level runs column NTTs of length n1, applies the decomposition
twiddle ω^{k1·i2} (inside the same kernel where the transform has one),
transposes, and recurses on rows of length n2. The JAX package chunks each
level to fit TPU VMEM; chunking changes no value, so a level here is one
pass over the whole level and the transpose is a PyTorch copy.
"""

from __future__ import annotations

from .. import limbs
from ..fields import Field
from ..kernels import vmem_ntt
from ..tracing import span
from .core import ntt_along_axis, ntt_along_axis_stockham, split_log

#: largest sub-transform the ladder transforms run as one base transform;
#: larger sizes peel BASE_MAX columns per level
BASE_MAX = 512


class TwMatStack:
    """A decomposition twiddle folded into a conv-matrix STACK: ``As``
    int8[NT, E*m, D*m]; batch column b of the level uses ``As[b // rep]``
    (the twiddle rides the matmul, zero per-element twiddle work)."""

    def __init__(self, As, rep: int):
        self.As = As
        self.rep = rep


class TwStackResid:
    """Level 0's matrix fold above ``mxu.TW_MERGED_MAX``, where the merged
    level-1 table would have n entries: the stack ``As`` (as in
    :class:`TwMatStack`, entry a covering ``rep`` = s0 batch columns)
    carries the slow factor w^{k·a·s0}, and the fast residual w^{k·b}
    (b = i2 mod s0) is the compact periodic table ``Tres`` uint32[W, n1,
    s0], which the level kernel multiplies in at column b mod s0: n1·s0
    resident entries instead of n. A top-level-only form."""

    def __init__(self, As, rep: int, Tres):
        self.As = As
        self.rep = rep
        self.Tres = Tres


class TwBatch:
    """A decomposition twiddle merged to full batch resolution: ``T4``
    uint32[W, n1, n2, R] Montgomery form — the level's own twiddle times
    the residual deferred from the level-0 matrix fold."""

    def __init__(self, T4):
        self.T4 = T4


class TwDeep:
    """A plain decomposition twiddle of a deep level (suffix R > 1), kept in
    the i2-resolution layout the kernels read: ``Tt`` uint32[W, n2, n1],
    each row covering R consecutive batch columns. Laid out once, when the
    aux tables are put on the device."""

    def __init__(self, Tt):
        self.Tt = Tt


def _split(m: int, base_max: int):
    """Peel base_max columns (the JAX package's default split; the port
    does not take its residency-aware split, NTT_RESIDENT_SPLIT:
    ``config.warn_plan_only_knobs``)."""
    return base_max, m // base_max


def twiddle_requests(m: int, base_max: int = BASE_MAX) -> list:
    """The (m, n1, n2) decomposition-twiddle tables the recursion
    consumes, in consumption order."""
    if m <= base_max:
        return []
    n1, n2 = _split(m, base_max)
    return (twiddle_requests(n1, base_max) + [(m, n1, n2)]
            + twiddle_requests(n2, base_max))


def ntt_axis_fourstep(x, field: Field, inverse: bool, base_fn,
                      base_max: int = BASE_MAX, tws=None, pre_col=None,
                      tw_base_fn=None, first_base_fn=None,
                      first_tw_base_fn=None):
    """Four-step NTT along axis 1 of uint32[W, m, *batch]: the JAX
    package's recursion on the n2 half, run as a loop, so that each
    level's input is released once the level has read it (at 2^26 on the
    256-bit fields every buffer is 2 GiB).

    ``base_fn(x, field, inverse)``: the base transform for m <= base_max
    (any batch rank); ``tw_base_fn(c3 [W, n1, B], t3, rep)``: a level's
    column transform with its decomposition twiddle applied in the same
    kernel, or None for the generic level (base transform, then the
    twiddle as a separate Montgomery product); ``tws``: an iterator over
    the level tables in :func:`twiddle_requests` order.

    ``pre_col``: optional [W, n1] Montgomery column vector multiplied into
    the data before the top level's column transforms (the c^{i1·n2}
    factor of a fused coset premultiply; its c^{i2} partner is folded into
    the top twiddle table when the runner is built).
    ``first_base_fn`` / ``first_tw_base_fn``: replacements for base_fn /
    tw_base_fn at the top level only (base transforms whose conv matrix has
    the coset column absorbed)."""
    shape = x.shape
    W, m = shape[0], shape[1]
    rest = tuple(shape[2:])
    if m <= base_max and pre_col is not None:
        x = limbs.mont_mul(
            x, pre_col.reshape((W, m) + (1,) * len(rest)), field)
    base = first_base_fn or base_fn
    while m > base_max:
        n1, n2 = _split(m, base_max)
        with span("ntt.level"):                  # -> [W, i2, k1, *rest]
            x = _fused_level(x.reshape((W, n1, n2) + rest), next(tws), field,
                             inverse, base, pre_col,
                             first_tw_base_fn or tw_base_fn)
        base, first_tw_base_fn, pre_col = base_fn, None, None
        m, rest = n2, (n1,) + rest
    with span("ntt.base"):
        return base(x, field, inverse).reshape(shape)    # X[k2*n1 + k1]


def _fused_level(x4, T, field: Field, inverse: bool, base_fn, pre_col=None,
                 tw_base_fn=None):
    """One four-step level: x4 [W, n1, n2, *rest] -> [W, n2, n1, *rest].

    ``T`` is a :class:`TwMatStack` (twiddle folded into the matrices), a
    :class:`TwStackResid` (level 0's stack with its periodic residual,
    handed to the kernel compact), a :class:`TwBatch` (merged
    batch-resolution table), a :class:`TwDeep` (deep level, R > 1: the
    i2-resolution table, each row covering rep = R consecutive batch
    columns) or a plain table uint32[W, n1, n2] (batch-resolution at the
    top level, R == 1; a batched input makes the top level deep too, and
    its table is then re-laid per call).

    With ``pre_col``, or without a ``tw_base_fn``, the level runs unfused
    (the generic level): pre-multiply, column transforms without twiddle,
    then the twiddle as a separate Montgomery product."""
    W, n1, n2 = x4.shape[0], x4.shape[1], x4.shape[2]
    rest = tuple(x4.shape[3:])
    R = 1
    for r in rest:
        R *= r
    if pre_col is not None or tw_base_fn is None:
        assert not isinstance(T, (TwMatStack, TwStackResid, TwBatch, TwDeep))
        c = x4.reshape(W, n1, n2, R)
        if pre_col is not None:
            c = limbs.mont_mul(c, pre_col[:, :, None, None], field)
        y = base_fn(c, field, inverse)
        y = limbs.mont_mul(y, T[:, :, :, None], field)
        with span("ntt.copy"):
            y = y.transpose(1, 2).contiguous()
        return y.reshape((W, n2, n1) + rest)
    c3 = x4.reshape(W, n1, n2 * R)          # flat batch: i2 major, r minor
    if isinstance(T, TwStackResid):
        assert R == 1 and T.rep == T.Tres.shape[2], (R, T.rep, T.Tres.shape)
        assert T.rep * T.As.shape[0] == n2, (T.rep, T.As.shape, n2)
        y3 = tw_base_fn(c3, T, rep=T.rep)
    elif isinstance(T, TwMatStack):
        assert T.rep % R == 0 and T.rep * T.As.shape[0] == n2 * R, \
            (T.rep, T.As.shape, n2, R)
        y3 = tw_base_fn(c3, T, rep=T.rep)
    elif isinstance(T, TwBatch):
        assert tuple(T.T4.shape) == (W, n1, n2, R), (T.T4.shape, x4.shape)
        y3 = tw_base_fn(c3, T.T4.reshape(W, n1, n2 * R), rep=1)
    elif isinstance(T, TwDeep):
        assert R > 1 and tuple(T.Tt.shape) == (W, n2, n1), (T.Tt.shape, R)
        y3 = tw_base_fn(c3, T.Tt, rep=R)
    elif R > 1:
        with span("ntt.copy"):
            Tt = T.transpose(1, 2).contiguous()
        y3 = tw_base_fn(c3, Tt, rep=R)
    else:
        y3 = tw_base_fn(c3, T, rep=1)
    with span("ntt.copy"):
        y = y3.reshape(W, n1, n2, R).transpose(1, 2).contiguous()
    return y.reshape((W, n2, n1) + rest)


# ---------------------------------------------------------------------------
# The butterfly-ladder transforms
# ---------------------------------------------------------------------------

def _base_ladder(x, field: Field, inverse: bool):
    return ntt_along_axis(x, field, inverse=inverse)


def _base_stockham(x, field: Field, inverse: bool):
    return ntt_along_axis_stockham(x, field, inverse=inverse)


def _base_pallas(x, field: Field, inverse: bool):
    W, m = x.shape[0], x.shape[1]
    return vmem_ntt.stage_ntt(x.reshape(W, m, -1), field, inverse).reshape(
        x.shape)


def ntt_fourstep(x, field: Field, inverse: bool = False, tws=None,
                 pre_col=None):
    """x: uint32[W, n, *batch] Montgomery form: the four-step with the
    bit-reversed radix-2 ladder (:func:`core.ntt_along_axis`) as its base
    transform and generic levels."""
    if split_log(x.shape[1])[1] == 1:
        return ntt_along_axis(x, field, inverse=inverse)
    return ntt_axis_fourstep(x, field, inverse, _base_ladder, BASE_MAX, tws,
                             pre_col=pre_col)


def ntt_fourstep_stockham(x, field: Field, inverse: bool = False, tws=None,
                          pre_col=None):
    """The four-step with the Stockham self-sorting ladder as its base
    transform: no gather or bit-reversal pass anywhere."""
    if split_log(x.shape[1])[1] == 1:
        return _base_stockham(x, field, inverse)
    return ntt_axis_fourstep(x, field, inverse, _base_stockham, BASE_MAX,
                             tws, pre_col=pre_col)


def pallas_base_max(field: Field) -> int:
    """The base size of the ``pallas`` transform: the largest m whose column
    fits the stage kernel's shared-memory tile at 32 columns a block (64
    for the 256-bit fields, 256 for the narrow ones)."""
    return vmem_ntt.max_m(field)


def fused_m(field: Field) -> int:
    """The level size of the ``pallas_fused`` transform: 64 for the 256-bit
    fields, 128 for the narrow ones."""
    return min(128, vmem_ntt.max_m(field))


def ntt_fourstep_pallas(x, field: Field, inverse: bool = False, tws=None,
                        pre_col=None):
    """The four-step with the shared-memory stage kernel
    (:func:`~ntt_tpu_torch.kernels.vmem_ntt.stage_ntt`) as its base
    transform and generic levels."""
    if x.shape[1] <= 2:
        return ntt_along_axis(x, field, inverse=inverse)
    return ntt_axis_fourstep(x, field, inverse, _base_pallas,
                             pallas_base_max(field), tws, pre_col=pre_col)


def check_unbatched(x) -> None:
    """The flat-peel transforms take uint32[W, n] only, as in the JAX package
    (an assertion there)."""
    if x.dim() != 2:
        raise AssertionError(
            "fused flat-peel transforms take unbatched uint32[W, n]")


def undo_peel_order(y, remaining: int, base: int, levels: int):
    """The flat-peel transforms' last relayout. The per-level transposed
    stores append each level's output digit after the older suffix, which
    leaves flat order (k_L, k_1, ..., k_{L-1}); the four-step convention is
    (k_L, k_{L-1}, ..., k_1), so the suffix digits are reversed."""
    W = y.shape[0]
    if levels > 1:
        y = y.reshape((W, remaining) + (base,) * levels)
        order = (0, 1) + tuple(range(levels + 1, 1, -1))
        with span("ntt.copy"):
            y = y.permute(order).contiguous()
    return y.reshape(W, -1)


def ntt_fourstep_pallas_fused(x, field: Field, inverse: bool = False,
                              tws=None):
    """The fully fused ladder: one
    :func:`~ntt_tpu_torch.kernels.vmem_ntt.fused_stage_level` launch per
    four-step level (all stages, the decomposition twiddle, the transposed
    store). ``tws``: iterator over ``mxu.expanded_twiddles`` built with
    base = :func:`fused_m`. Flat peel loop as in ``mxu.ntt_mxu_fused``."""
    check_unbatched(x)
    W, n = x.shape
    if n <= 2:
        return ntt_along_axis(x, field, inverse=inverse)
    mf = fused_m(field)
    remaining = n
    cur = x.reshape(W, min(mf, n), -1)
    levels = 0
    while remaining > mf:
        cur = vmem_ntt.fused_stage_level(cur, field, inverse, next(tws),
                                         transpose_out=True)
        remaining //= mf
        levels += 1
        cur = cur.reshape(W, min(mf, remaining), -1)
    y = vmem_ntt.fused_stage_level(cur, field, inverse, None,
                                   transpose_out=False)
    return undo_peel_order(y, remaining, mf, levels)

"""Four-step (self-sorting) NTT recursion — the port of the parts of
``ntt_tpu.transforms.fourstep`` that the ``mxu_chunked`` and ``mxu_sub``
paths take.

With n = n1*n2, i = i1*n2 + i2, k = k2*n1 + k1 and ω the n-th root:

    X[k2*n1 + k1] = Σ_{i2} ω_{n2}^{i2 k2} · ω^{i2 k1} · Σ_{i1} x[i1*n2+i2] ω_{n1}^{i1 k1}

so each level runs column NTTs of length n1 with the decomposition twiddle
ω^{k1·i2} applied inside the same kernel, transposes, and recurses on rows
of length n2. The JAX package chunks each level to fit TPU VMEM; chunking
changes no value, so a level here is one kernel launch over the whole level
and the transpose is a PyTorch copy between launches.
"""

from __future__ import annotations

from .. import limbs
from ..fields import Field


class TwMatStack:
    """A decomposition twiddle folded into a conv-matrix STACK: ``As``
    int8[NT, E*m, D*m]; batch column b of the level uses ``As[b // rep]``
    (the twiddle rides the matmul, zero per-element twiddle work)."""

    def __init__(self, As, rep: int):
        self.As = As
        self.rep = rep


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
    """Peel base_max columns (the JAX package's default split)."""
    return base_max, m // base_max


def twiddle_requests(m: int, base_max: int) -> list:
    """The (m, n1, n2) decomposition-twiddle tables the recursion
    consumes, in consumption order."""
    if m <= base_max:
        return []
    n1, n2 = _split(m, base_max)
    return (twiddle_requests(n1, base_max) + [(m, n1, n2)]
            + twiddle_requests(n2, base_max))


def ntt_axis_fourstep(x, field: Field, base_fn, base_max: int, tws,
                      tw_base_fn, pre_col=None, first_base_fn=None,
                      first_tw_base_fn=None):
    """Recursive four-step NTT along axis 1 of uint32[W, m, *batch].

    ``base_fn(x, field)``: the base transform for m <= base_max;
    ``tw_base_fn(c3 [W, n1, B], t3, rep)``: a level's column transform with
    its decomposition twiddle applied in the same kernel; ``tws``: an
    iterator over the level tables in :func:`twiddle_requests` order.

    ``pre_col``: optional [W, n1] Montgomery column vector multiplied into
    the data before the top level's column transforms (the c^{i1·n2}
    factor of a fused coset premultiply; its c^{i2} partner is folded into
    the top twiddle table when the runner is built).
    ``first_base_fn`` / ``first_tw_base_fn``: replacements for base_fn /
    tw_base_fn at the top level only (base transforms whose conv matrix has
    the coset column absorbed)."""
    W, m = x.shape[0], x.shape[1]
    rest = tuple(x.shape[2:])
    if m <= base_max:
        if pre_col is not None:
            x = limbs.mont_mul(
                x, pre_col.reshape((W, m) + (1,) * len(rest)), field)
        return (first_base_fn or base_fn)(x, field)
    n1, n2 = _split(m, base_max)
    A = x.reshape((W, n1, n2) + rest)
    Ct = _fused_level(A, next(tws), field, first_base_fn or base_fn,
                      first_tw_base_fn or tw_base_fn, pre_col)  # [W,i2,k1,..]
    D = ntt_axis_fourstep(Ct, field, base_fn, base_max, tws, tw_base_fn)
    return D.reshape((W, m) + rest)                          # X[k2*n1+k1]


def _fused_level(x4, T, field: Field, base_fn, tw_base_fn, pre_col=None):
    """One four-step level: x4 [W, n1, n2, *rest] -> [W, n2, n1, *rest].

    ``T`` is a :class:`TwMatStack` (twiddle folded into the matrices), a
    :class:`TwBatch` (merged batch-resolution table), a :class:`TwDeep`
    (deep level, R > 1: the i2-resolution table, each row covering rep = R
    consecutive batch columns) or a plain table uint32[W, n1, n2]:
    batch-resolution at the top level (R == 1); a batched input makes the
    top level deep too, and its table is then re-laid per call.

    With ``pre_col`` the level runs unfused: pre-multiply, column
    transforms without twiddle, then the twiddle as a separate Montgomery
    product."""
    W, n1, n2 = x4.shape[0], x4.shape[1], x4.shape[2]
    rest = tuple(x4.shape[3:])
    R = 1
    for r in rest:
        R *= r
    if pre_col is not None:
        assert not isinstance(T, (TwMatStack, TwBatch, TwDeep))
        c = limbs.mont_mul(x4.reshape(W, n1, n2, R),
                           pre_col[:, :, None, None], field)
        y = base_fn(c, field)
        y = limbs.mont_mul(y, T[:, :, :, None], field)
        return y.transpose(1, 2).contiguous().reshape((W, n2, n1) + rest)
    c3 = x4.reshape(W, n1, n2 * R)          # flat batch: i2 major, r minor
    if isinstance(T, TwMatStack):
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
        y3 = tw_base_fn(c3, T.transpose(1, 2).contiguous(), rep=R)
    else:
        y3 = tw_base_fn(c3, T, rep=1)
    y = y3.reshape(W, n1, n2, R).transpose(1, 2).contiguous()
    return y.reshape((W, n2, n1) + rest)

"""Four-step (self-sorting) NTT recursion — the port of the parts of
``ntt_tpu.transforms.fourstep`` that the ``mxu_chunked`` path takes.

With n = n1*n2, i = i1*n2 + i2, k = k2*n1 + k1 and ω the n-th root:

    X[k2*n1 + k1] = Σ_{i2} ω_{n2}^{i2 k2} · ω^{i2 k1} · Σ_{i1} x[i1*n2+i2] ω_{n1}^{i1 k1}

so each level runs column NTTs of length n1 with the decomposition twiddle
ω^{k1·i2} applied inside the same kernel, transposes, and recurses on rows
of length n2. The JAX package chunks each level to fit TPU VMEM; chunking
changes no value, so a level here is one kernel launch over the whole level
and the transpose is a PyTorch copy between launches.
"""

from __future__ import annotations

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
                      tw_base_fn):
    """Recursive four-step NTT along axis 1 of uint32[W, m, *batch].

    ``base_fn(x, field)``: the base transform for m <= base_max;
    ``tw_base_fn(c3 [W, n1, B], t3, rep)``: a level's column transform with
    its decomposition twiddle applied in the same kernel; ``tws``: an
    iterator over the level tables in :func:`twiddle_requests` order."""
    W, m = x.shape[0], x.shape[1]
    rest = tuple(x.shape[2:])
    if m <= base_max:
        return base_fn(x, field)
    n1, n2 = _split(m, base_max)
    A = x.reshape((W, n1, n2) + rest)
    Ct = _fused_level(A, next(tws), tw_base_fn)              # [W,i2,k1,..]
    D = ntt_axis_fourstep(Ct, field, base_fn, base_max, tws, tw_base_fn)
    return D.reshape((W, m) + rest)                          # X[k2*n1+k1]


def _fused_level(x4, T, tw_base_fn):
    """One four-step level: x4 [W, n1, n2, *rest] -> [W, n2, n1, *rest].

    ``T`` is a :class:`TwMatStack` (twiddle folded into the matrices), a
    :class:`TwBatch` (merged batch-resolution table) or a plain table
    uint32[W, n1, n2]: batch-resolution at the top level (R == 1), and at
    deep levels (R > 1) handed to the kernel in i2-resolution layout
    [W, n2, n1], each row covering rep = R consecutive batch columns."""
    W, n1, n2 = x4.shape[0], x4.shape[1], x4.shape[2]
    rest = tuple(x4.shape[3:])
    R = 1
    for r in rest:
        R *= r
    c3 = x4.reshape(W, n1, n2 * R)          # flat batch: i2 major, r minor
    if isinstance(T, TwMatStack):
        assert T.rep % R == 0 and T.rep * T.As.shape[0] == n2 * R, \
            (T.rep, T.As.shape, n2, R)
        y3 = tw_base_fn(c3, T, rep=T.rep)
    elif isinstance(T, TwBatch):
        assert tuple(T.T4.shape) == (W, n1, n2, R), (T.T4.shape, x4.shape)
        y3 = tw_base_fn(c3, T.T4.reshape(W, n1, n2 * R), rep=1)
    elif R > 1:
        y3 = tw_base_fn(c3, T.transpose(1, 2).contiguous(), rep=R)
    else:
        y3 = tw_base_fn(c3, T, rep=1)
    y = y3.reshape(W, n1, n2, R).transpose(1, 2).contiguous()
    return y.reshape((W, n2, n1) + rest)

"""Digit-matmul NTT (``mxu_chunked``) — the port of the parts of
``ntt_tpu.transforms.mxu`` that the 256-bit forward main path takes.

The four-step recursion peels BASE = 32 columns per level. A level's
32-point column transforms are ONE int8 digit matmul against a conv matrix
(:mod:`ntt_tpu_torch.digits`), with the decomposition twiddle either folded
into a stack of conv matrices (:class:`~.fourstep.TwMatStack`) or applied by
a Montgomery product inside the same kernel. The last base transform
(m <= 32) is one more matmul. The JAX package's knobs are hard-wired to
their defaults: NTT_MXU_BASE_LOG=5, NTT_TW_MATFOLD=1, NTT_FUSE_TW=1,
NTT_RESIDENT_SPLIT=0.

The host-side constructors here return the aux tables in their numpy
form (see ``api.aux_from_numpy``), byte-equal to the JAX package's.
"""

from __future__ import annotations

import numpy as np

from .. import digits
from ..fields import Field
from ..kernels.mxu_level import fused_level_stack, fused_subntt
from ..kernels.mxu_ntt import base_ntt_mxu
from .core import host_power_matrix
from .fourstep import TwMatStack, ntt_axis_fourstep, twiddle_requests

BASE_LOG = 5
BASE = 1 << BASE_LOG

#: largest per-level matrix stack the twiddle fold may build
TW_STACK_MAX_NT = 128
#: largest n whose merged level-1 table (TwBatch) is built; above it the
#: JAX package switches level 0 to the periodic residual (TwStackResid),
#: which this port does not have yet
TW_MERGED_MAX = 1 << 24

_matrix_cache: dict = {}


def _base_matrix(field: Field, m: int) -> np.ndarray:
    """Digit conv matrix of the forward m-point DFT, entries
    ω_m^{ik} * R * 2^16 mod p."""
    got = _matrix_cache.get((field.name, m))
    if got is None:
        p = field.p
        w = field.root_of_unity(m)
        scale = digits.matrix_prescale(field)
        wp = [pow(w, j, p) for j in range(m)]
        entries = [[wp[(i * k) % m] * scale % p for i in range(m)]
                   for k in range(m)]
        got = _matrix_cache[(field.name, m)] = digits.conv_matrix(
            entries, field)
    return got


def twiddle_matrix_stack(field: Field, m: int, tvals) -> np.ndarray:
    """Stack of conv matrices ``diag(t_s) @ DFT_m``: int8[NT, E*m, D*m],
    ``tvals[s][k]`` the plain twiddle value multiplying output row k of
    stack entry s."""
    p = field.p
    w = field.root_of_unity(m)
    scale = digits.matrix_prescale(field)
    wp = [pow(w, j, p) for j in range(m)]
    base = [[wp[(i * k) % m] * scale % p for i in range(m)]
            for k in range(m)]
    mats = []
    for ts in tvals:
        entries = [[base[k][i] * ts[k] % p for i in range(m)]
                   for k in range(m)]
        mats.append(digits.conv_matrix(entries, field))
    return np.stack(mats, axis=0)


def matfold_tw_tables(field: Field, n: int):
    """Twiddle tables (numpy form) with the decomposition twiddles folded
    into conv-matrix stacks where the geometry allows, or None when
    nothing folds:

    - level 0 (when level 1 exists and s0 = n2_0/BASE >= 128): a BASE-entry
      stack over the high digit a of i2 = a*s0 + b; the residual w^{k*b}
      is deferred into level 1;
    - level 1 then takes ONE merged batch-resolution table
      M[k1, b, k0] = w_n^{(BASE*k1 + k0)*b};
    - deeper levels fold entirely into an n2-entry stack when n2 <=
      TW_STACK_MAX_NT and the stack stays below four data sizes."""
    requests = twiddle_requests(n, BASE)
    if not requests:
        return None
    if n > TW_MERGED_MAX:
        raise NotImplementedError(
            f"n = 2^{n.bit_length() - 1} > 2^24 needs the periodic-residual "
            "level 0 (TwStackResid), not ported yet (ROADMAP.md, Queue 1 "
            "item 3)")
    p = field.p
    D = digits.n_digits(field)
    E = digits.out_planes(field)
    s0 = requests[0][2] // BASE
    fold0 = len(requests) >= 2 and s0 >= 128
    deep_fold = [False] * len(requests)
    for l in range(2, len(requests)):
        m_l, _, n2_l = requests[l]
        R_l = n // m_l
        if (n2_l <= TW_STACK_MAX_NT and R_l % 128 == 0
                and n2_l * E * BASE * D * BASE <= 4 * n * field.n_words * 4):
            deep_fold[l] = True
    if not fold0 and not any(deep_fold):
        return None

    out = []
    for l, (m_l, n1, n2_l) in enumerate(requests):
        w = field.root_of_unity(m_l)
        if l == 0 and fold0:
            tvals = [[pow(w, (k * a * s0) % m_l, p) for k in range(BASE)]
                     for a in range(BASE)]
            out.append({"kind": "stack", "rep": s0,
                        "As": twiddle_matrix_stack(field, BASE, tvals)})
        elif l == 1 and fold0:
            BB = BASE * BASE
            M = host_power_matrix(field, field.root_of_unity(n), BB, n2_l)
            M = M.reshape(field.n_words, BASE, BASE, n2_l).transpose(
                0, 1, 3, 2)                                # [W, k1, b, k0]
            out.append({"kind": "batch", "T4": np.ascontiguousarray(M)})
        elif deep_fold[l]:
            tvals = [[pow(w, (k * s) % m_l, p) for k in range(BASE)]
                     for s in range(n2_l)]
            out.append({"kind": "stack", "rep": n // m_l,
                        "As": twiddle_matrix_stack(field, BASE, tvals)})
        else:
            out.append(host_power_matrix(field, w, n1, n2_l))
    return out


def _zmax_bits(field: Field, m: int) -> int:
    """Exact bound on one accumulator entry: <= m * D * (2^7-1)^2."""
    return (m * digits.n_digits(field) * digits.DIGIT_MASK ** 2).bit_length()


def _fold_matrix(field: Field, m: int) -> np.ndarray:
    """Montgomery fold matrix of the m-point conv-matmul reduction."""
    zb = _zmax_bits(field, m)
    J, hbits = digits.halves_info(digits.out_planes(field), zb)
    return digits.fold_reduce_matrix(field, J, hbits, zb)


def base_sizes(n: int) -> set:
    """Distinct base-transform sizes the peel-BASE recursion hits."""
    if n <= BASE:
        return {n}
    return base_sizes(BASE) | base_sizes(n // BASE)


def base_mats(field: Field, n: int) -> dict:
    """{m: conv matrix, -m: its fold matrix} for every base size m > 1,
    plus the twiddle-product fold matrix keyed -1 (numpy)."""
    sizes = [m for m in base_sizes(n) if m > 1]
    out = {m: _base_matrix(field, m) for m in sizes}
    out.update({-m: _fold_matrix(field, m) for m in sizes})
    out[-1] = digits.fold_mul_matrix(field)
    return out


def ntt_mxu_chunked(x, field: Field, tws, mats):
    """Forward NTT along axis 1 of uint32[W, n, *batch] (Montgomery form in
    and out): the peel-BASE four-step whose levels run the stack kernel
    (:func:`fused_level_stack`) or the sub-NTT-with-twiddle kernel
    (:func:`fused_subntt`), and whose last base runs
    :func:`base_ntt_mxu`. ``tws``: iterator over the level tables;
    ``mats``: the :func:`base_mats` dict, as device tensors."""

    def base(c, f):
        W, m = c.shape[0], c.shape[1]
        y = base_ntt_mxu(c.reshape(W, m, -1), f, mats.get(m), mats.get(-m))
        return y.reshape(c.shape)

    def tw_base(c3, t3, rep=1):
        mm = c3.shape[1]
        if isinstance(t3, TwMatStack):
            return fused_level_stack(c3, field, t3.As, t3.rep, mats[-mm])
        return fused_subntt(c3, field, {k: mats[k] for k in (mm, -mm, -1)},
                            t3, rep=rep)

    return ntt_axis_fourstep(x, field, base, BASE, tws, tw_base)

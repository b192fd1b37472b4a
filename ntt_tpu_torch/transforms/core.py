"""Twiddle tables and the radix-2 butterfly ladders (the port's part of
``ntt_tpu.transforms.core``).

A twiddle table of up to :data:`HOST_TW_LIMIT` entries is built on the host
with the native hostlib and moved to the device once; a larger one is
generated on the device that will hold it (:func:`power_matrix_chunked`,
:func:`geometric_outer_chunked`), in row chunks that bound the plain
Montgomery product's temporaries, as ``ntt_tpu/api.py`` does above its
``_HOST_TW_LIMIT``. Both forms give the same words.

The ladders (:func:`ntt_along_axis`, :func:`ntt_along_axis_stockham`) are
plain PyTorch on the caller's device, one pass over the data per stage: in
the JAX package they are XLA graphs, not kernels. They work on
Montgomery-form word planes ``uint32[W, m, *batch]`` along axis 1.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import hostlib, limbs
from ..fields import Field


def host_powers(field: Field, base: int, count: int) -> np.ndarray:
    """Montgomery-form powers base^0..base^{count-1} as np.uint32[W, count]
    with Python ints (use only for small count)."""
    p = field.p
    vals = []
    cur = 1
    for _ in range(count):
        vals.append(field.to_mont_int(cur))
        cur = cur * base % p
    return np.asarray(
        [[field.int_to_words(v)[k] for v in vals]
         for k in range(field.n_words)], dtype=np.uint32)


def host_powers_fast(field: Field, base: int, count: int) -> np.ndarray:
    """Montgomery-form powers base^0..base^{count-1} as np.uint32[W, count]
    through the native hostlib."""
    return hostlib.powers_np(base, count, field, mont_form=True)


def host_power_matrix(field: Field, base: int, n1: int,
                      n2: int) -> np.ndarray:
    """Montgomery-form T[i, j] = base^{i*j} as np.uint32[W, n1, n2] — the
    four-step decomposition twiddle."""
    count = (n1 - 1) * (n2 - 1) + 1
    pw = host_powers_fast(field, base, count)
    idx = np.outer(np.arange(n1, dtype=np.int64),
                   np.arange(n2, dtype=np.int64))
    return np.ascontiguousarray(pw[:, idx])


def power_matrix(field: Field, base: int, n1: int, n2: int,
                 device) -> torch.Tensor:
    """:func:`host_power_matrix` as a tensor on ``device``: T[i, j] =
    base^{i*j}, uint32[W, n1, n2] in Montgomery form. The JAX package
    generates the same words on its device by log-doubling."""
    return torch.from_numpy(host_power_matrix(field, base, n1, n2)).to(device)


# ---------------------------------------------------------------------------
# Device-side generation of the data-sized tables
# ---------------------------------------------------------------------------

#: tables of more entries than this are generated on their device
HOST_TW_LIMIT = 1 << 18
#: entries a row chunk of the generators and of :func:`scale_columns`
#: holds: a plain Montgomery product keeps about 0.6 KB of int64
#: temporaries an element at W = 8, so a chunk costs at most about 2.5 GB;
#: each chunk is some 4000 small launches (a doubling step is a plain
#: product), so fewer, larger chunks build faster
TABLE_CHUNK = 1 << 22


def _rows_per_chunk(n1: int, n2: int, chunk: int) -> int:
    return max(1, min(n1, chunk // max(n2, 1)))


def power_matrix_chunked(field: Field, base: int, n1: int, n2: int, device,
                         chunk: int = TABLE_CHUNK) -> torch.Tensor:
    """T[i, j] = base^{i*j} as Montgomery uint32[W, n1, n2], generated on
    ``device`` row chunk by row chunk: each chunk's rows start at 1 and
    double along j (T[:, k + j] = T[:, j] * (base^i)^k, then square),
    log2(n2) plain products over at most ``chunk`` entries each. Only the
    column base^i (n1 entries) comes from the host."""
    W = field.n_words
    col = torch.from_numpy(host_powers_fast(field, base, n1)).to(device)
    one = torch.tensor(field.int_to_words(field.R), dtype=torch.int64,
                       device=device).to(torch.uint32)
    out = torch.empty((W, n1, n2), dtype=torch.uint32, device=device)
    rows = _rows_per_chunk(n1, n2, chunk)
    for r0 in range(0, n1, rows):
        T = out[:, r0:r0 + rows]
        wk = col[:, r0:r0 + rows, None]
        T[:, :, 0] = one[:, None]
        k = 1
        while k < n2:
            grow = min(k, n2 - k)
            T[:, :, k:k + grow] = limbs.mont_mul(T[:, :, :grow], wk, field)
            if 2 * k < n2:
                wk = limbs.mont_sqr(wk, field)
            k *= 2
    return out


def geometric_outer(field: Field, base: int, n1: int, n2: int, device,
                    chunk: int = TABLE_CHUNK) -> torch.Tensor:
    """base^0 .. base^{n1*n2-1} as Montgomery uint32[W, n1, n2] on
    ``device``, by the rank-1 product base^{i1*n2+i2} = (base^{n2})^{i1} *
    base^{i2} of two host vectors, at most ``chunk`` entries a product."""
    row = torch.from_numpy(host_powers_fast(field, base, n2)).to(device)
    col = torch.from_numpy(host_powers_fast(
        field, pow(base, n2, field.p), n1)).to(device)
    out = torch.empty((field.n_words, n1, n2), dtype=torch.uint32,
                      device=device)
    rows = _rows_per_chunk(n1, n2, chunk)
    for r0 in range(0, n1, rows):
        out[:, r0:r0 + rows] = limbs.mont_mul(
            col[:, r0:r0 + rows, None], row[:, None, :], field)
    return out


def geometric_outer_chunked(field: Field, base: int, n: int, device,
                            chunk: int = TABLE_CHUNK) -> torch.Tensor:
    """base^0 .. base^{n-1} as Montgomery uint32[W, n] on ``device``:
    :func:`geometric_outer` over n = n1 * n2 (:func:`split_log`)."""
    return geometric_outer(field, base, *split_log(n), device,
                           chunk).reshape(field.n_words, n)


def power_table(field: Field, base: int, n1: int, n2: int, device=None):
    """T[i, j] = base^{i*j} [W, n1, n2]: built on the host (numpy) up to
    :data:`HOST_TW_LIMIT` entries or without a ``device``, above it
    generated on ``device`` (:func:`power_matrix_chunked`)."""
    if device is None or n1 * n2 <= HOST_TW_LIMIT:
        return host_power_matrix(field, base, n1, n2)
    return power_matrix_chunked(field, base, n1, n2, device)


def scale_columns(T: torch.Tensor, v: torch.Tensor, field: Field,
                  chunk: int = TABLE_CHUNK) -> torch.Tensor:
    """T[W, r, c] times the row vector v[W, c] (Montgomery product), in row
    chunks of at most ``chunk`` entries, into a new tensor."""
    out = torch.empty_like(T)
    rows = _rows_per_chunk(T.shape[1], T.shape[2], chunk)
    vt = v[:, None, :]
    for r0 in range(0, T.shape[1], rows):
        out[:, r0:r0 + rows] = limbs.mont_mul(T[:, r0:r0 + rows], vt, field)
    return out


# ---------------------------------------------------------------------------
# Twiddle masters and the butterfly ladders
# ---------------------------------------------------------------------------

_master_cache: dict = {}


def twiddle_master(field: Field, m: int, inverse: bool = False) -> np.ndarray:
    """Powers ω_m^0 .. ω_m^{m/2-1} (the inverse root when ``inverse``) in
    Montgomery form, np.uint32[W, max(m/2, 1)]. Cached per (field, m,
    direction)."""
    key = (field.name, m, inverse)
    got = _master_cache.get(key)
    if got is None:
        w = field.inv_root_of_unity(m) if inverse else field.root_of_unity(m)
        got = _master_cache[key] = host_powers_fast(field, w, max(m // 2, 1))
    return got


_master_on_cache: dict = {}


def twiddle_master_on(field: Field, m: int, inverse: bool,
                      device) -> torch.Tensor:
    """:func:`twiddle_master` as a tensor on ``device``, kept there."""
    key = (field.name, m, inverse, str(device))
    got = _master_on_cache.get(key)
    if got is None:
        got = _master_on_cache[key] = torch.from_numpy(
            twiddle_master(field, m, inverse)).to(device)
    return got


def bit_reverse_table(n: int) -> np.ndarray:
    """The bit-reversal permutation of 0 .. n-1 (n a power of two)."""
    bits = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def bit_reverse_axis1(x):
    """Bit-reverse permute along axis 1."""
    rev = torch.from_numpy(bit_reverse_table(x.shape[1])).to(x.device)
    return torch.index_select(x, 1, rev)


def dit_stage(x, s: int, tw, field: Field):
    """One radix-2 decimation-in-time butterfly stage at stride ``s`` along
    axis 1 of uint32[W, m, *batch]: pairs (start + j, start + j + s) within
    groups of 2s. ``tw``: uint32[W, s] (Montgomery form, ω_{2s}^j), or None
    for the first stage, whose twiddles are all 1."""
    W, m = x.shape[0], x.shape[1]
    rest = tuple(x.shape[2:])
    xr = x.reshape((W, m // (2 * s), 2, s) + rest)
    a, b = xr[:, :, 0], xr[:, :, 1]
    if tw is not None:
        b = limbs.mont_mul(b, tw.reshape((W, 1, s) + (1,) * len(rest)), field)
    lo = limbs.add_mod(a, b, field)
    hi = limbs.sub_mod(a, b, field)
    return torch.stack([lo, hi], dim=2).reshape(x.shape)


def ntt_along_axis(x, field: Field, inverse: bool = False):
    """Natural-order NTT along axis 1 of uint32[W, m, *batch] (Montgomery
    form in and out, no 1/n scale): bit-reversal, then log2 m radix-2
    stages; stage s reads the master table at stride (m/2)/s."""
    m = x.shape[1]
    if m == 1:
        return x
    master = twiddle_master_on(field, m, inverse, x.device)        # [W, m/2]
    x = bit_reverse_axis1(x)
    s = 1
    while s < m:
        step = (m // 2) // s
        tw = None if s == 1 else master[:, ::step][:, :s]
        x = dit_stage(x, s, tw, field)
        s <<= 1
    return x


def ntt_along_axis_stockham(x, field: Field, inverse: bool = False):
    """Self-sorting NTT along axis 1 (natural order in and out, Montgomery
    form, no 1/n scale) with no bit-reversal anywhere: the radix-2
    four-step applied recursively, each level's transpose a reshape. Per
    level (m = 2h, ω the m-th root):
    X[k2·2 + k1] = NTT_h over i2 of [ω^{k1·i2} · (x[i2] ± x[h + i2])]."""
    W, m = x.shape[0], x.shape[1]
    rest = tuple(x.shape[2:])
    if m == 1:
        return x
    h = m // 2
    xf = x.reshape(W, 2, h, -1)
    a, b = xf[:, 0], xf[:, 1]
    lo = limbs.add_mod(a, b, field)
    hi = limbs.sub_mod(a, b, field)
    if m > 2:       # the m = 2 level's twiddle is identically 1
        tw = twiddle_master_on(field, m, inverse, x.device)        # ω_m^{i2}
        hi = limbs.mont_mul(hi, tw[:, :, None], field)
    y = torch.stack([lo, hi], dim=2).reshape(W, h, -1)      # [W, i2, (k1, B)]
    z = ntt_along_axis_stockham(y, field, inverse)          # over i2 -> k2
    return z.reshape((W, m) + rest)                         # X[k2*2 + k1]


def split_log(n: int) -> tuple:
    """The four-step split n = n1 * n2 with n1 >= n2."""
    log_n = n.bit_length() - 1
    l2 = log_n // 2
    return 1 << (log_n - l2), 1 << l2

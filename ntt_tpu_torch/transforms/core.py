"""Host-side twiddle tables and the radix-2 butterfly ladders (the port's
part of ``ntt_tpu.transforms.core``).

Every twiddle table is built on the host with the native hostlib and moved
to the device once, for every n up to 2^24. The values equal the JAX
package's, which builds the tables above 2^18 on its device instead
(``ntt_tpu/api.py``, ``_HOST_TW_LIMIT``; ``power_matrix`` on the
distributed path).

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

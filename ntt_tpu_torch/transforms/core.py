"""Host-side twiddle tables (the port's part of ``ntt_tpu.transforms.core``).

Every decomposition-twiddle table of this slice is built on the host with
the native hostlib and moved to the device once, for every n up to 2^24.
The values equal the JAX package's, which builds the tables above 2^18 on
its device instead (``ntt_tpu/api.py``, ``_HOST_TW_LIMIT``).
"""

from __future__ import annotations

import numpy as np

from .. import hostlib
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

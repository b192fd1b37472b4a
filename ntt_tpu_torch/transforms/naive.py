"""Naive per-stage NTT over the flat coefficient vector: bit-reversal up
front, then one full pass over the data per radix-2 stage (the port of
``ntt_tpu.transforms.naive``). The correctness anchor of the algorithm
ladder. Natural order and Montgomery form in and out."""

from __future__ import annotations

from ..fields import Field
from .core import ntt_along_axis


def ntt_naive(x, field: Field, inverse: bool = False):
    """x: uint32[W, n, *batch] Montgomery form. Returns the forward (or
    inverse, unscaled) transform in natural order."""
    return ntt_along_axis(x, field, inverse=inverse)

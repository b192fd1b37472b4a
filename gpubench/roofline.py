"""The transform's work, counted without regard to how it is implemented.

The work model is ``BASELINE.md``'s: a radix-2 transform of n points makes
(n/2)·log2 n butterflies, each with one modular product, costed as
2·d² + 4·d int8 multiply-accumulates for an element of d bytes (the
schoolbook digit product and its Montgomery reduction on 8-bit digits), and
reads and writes the data once, 2·n·d bytes. The least time is the larger
of the operations (two a MAC) at the int8 tensor rate and the bytes at the
memory rate, from NVIDIA's H100 SXM data sheet (dense rates, 700 W). A
faster kernel changes the time this is divided by, never the work.
"""

from __future__ import annotations

#: dense int8 tensor-core operations a second, H100 SXM
INT8_OPS_PER_S = 1.979e15
#: HBM3 bytes a second, H100 SXM
HBM_BYTES_PER_S = 3.35e12


def butterflies(n: int) -> int:
    return (n // 2) * (n.bit_length() - 1)


def macs_per_butterfly(elem_bytes: int) -> int:
    return 2 * elem_bytes * elem_bytes + 4 * elem_bytes


def transform_ops(n: int, elem_bytes: int) -> int:
    """int8 operations (a multiply-accumulate is two) of one transform."""
    return 2 * butterflies(n) * macs_per_butterfly(elem_bytes)


def transform_bytes(n: int, elem_bytes: int) -> int:
    """Bytes one transform reads and writes: the data in once and out once."""
    return 2 * n * elem_bytes


def least_time(n: int, elem_bytes: int) -> tuple:
    """(seconds, "operations" or "bytes"): the least time of one n-point
    transform over d-byte elements, and which of the two bounds it."""
    t_ops = transform_ops(n, elem_bytes) / INT8_OPS_PER_S
    t_bytes = transform_bytes(n, elem_bytes) / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")

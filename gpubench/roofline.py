"""The transform's work, counted without regard to how it is implemented.

The work model is ``BASELINE.md``'s: a radix-2 transform of n points makes
(n/2)·log2 n butterflies, each with one modular product, costed as
2·d² + 4·d int8 multiply-accumulates for an element of d bytes (the
schoolbook digit product and its Montgomery reduction on 8-bit digits), and
reads and writes the data once, 2·n·d bytes. The least time is the larger
of the operations (two a MAC) at the int8 tensor rate and the bytes at the
memory rate, from NVIDIA's H100 SXM data sheet (dense rates, 700 W). A
faster kernel changes the time this is divided by, never the work.

Over D cards the operations and the bytes spread over D cards' rates, and
the cards exchange data over NVLink: see :func:`exchange_bytes`.
"""

from __future__ import annotations

#: dense int8 tensor-core operations a second, H100 SXM
INT8_OPS_PER_S = 1.979e15
#: HBM3 bytes a second, H100 SXM
HBM_BYTES_PER_S = 3.35e12
#: NVLink bytes a second into one card (each way), H100 SXM
NVLINK_BYTES_PER_S = 450e9


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


def exchange_bytes(n: int, elem_bytes: int, chips: int) -> float:
    """Bytes each of ``chips`` cards receives from the others in one
    transform whose input and output each lie in equal shards, one a card:
    (D−1)/D² · n · d.

    Why no layout needs less: in the four-step layouts (input A[i1, i2]
    split by columns i2, output X[k2·n1 + k1] split by k1), the outputs of
    one card depend on the inputs of another through the block of the DFT
    matrix between them, ω^{(i1·n2 + i2)(k2·n1 + k1)} over one card's k1
    and the other's i2, which has rank n/D² (it factors through the
    n1/D × n2/D products ω^{i2·k1} and full-rank transforms on either
    side). A card cannot compute its outputs from less than that rank's
    worth of elements of each other card, so it receives at least
    (D−1)·n/D² elements."""
    return (chips - 1) * n * elem_bytes / chips ** 2


def least_time(n: int, elem_bytes: int, chips: int = 1) -> tuple:
    """(seconds, "operations", "bytes" or "exchange"): the least time of
    one n-point transform over d-byte elements on ``chips`` cards, and
    which bound sets it. On one card there is no exchange, and the time is
    the larger of the operations and the bytes."""
    t_ops = transform_ops(n, elem_bytes) / (chips * INT8_OPS_PER_S)
    t_bytes = transform_bytes(n, elem_bytes) / (chips * HBM_BYTES_PER_S)
    t, by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    t_x = exchange_bytes(n, elem_bytes, chips) / NVLINK_BYTES_PER_S
    return (t_x, "exchange") if t_x > t else (t, by)

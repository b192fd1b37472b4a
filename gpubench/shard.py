"""How a vector lies over the cards of a cell: the layouts that a sharded
operation (``gpubench/ops/<op>.py`` with ``SHARDED = True``) declares for
its input and its output.

A vector of n elements over D cards is a list of D tensors, one a card, each
of the same local shape uint32[W, ...]. A :class:`Layout` says which global
index each local element holds: ``index(d, pos)`` for card d's flat local
positions ``pos`` (over the axes after W, in row-major order), and its
inverse ``locate(g)``, the (card, position) of global indices ``g``. Both
act on int64 tensors, elementwise. An operation builds its layouts from
(W, n, D) alone.
"""

from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass(frozen=True)
class Layout:
    shape: tuple            # each card's local shape, W first
    index: Callable         # (card, positions) -> global indices
    locate: Callable        # global indices -> (cards, positions)


def columns(W: int, rows: int, cols: int, D: int) -> Layout:
    """A [rows, cols] matrix, element [i, j] holding global index
    i·cols + j, split by columns: card d holds columns d·cols/D ..
    (d+1)·cols/D − 1 as uint32[W, rows, cols/D]."""
    loc = cols // D

    def index(d, pos):
        return (pos // loc) * cols + d * loc + pos % loc

    def locate(g):
        j = g % cols
        return j // loc, (g // cols) * loc + j % loc

    return Layout((W, rows, loc), index, locate)

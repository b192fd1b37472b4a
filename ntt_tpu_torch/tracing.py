"""The program's spans, on the PyTorch profiler's clock.

``span(name)`` marks a stretch of host work at a layer boundary (the API,
the runner build, a four-step level, a layout copy, an elementwise pass, a
kernel launch) as ``torch.profiler.record_function(name)`` while a PyTorch
profiler is recording, so that the span lands in the profiler's trace beside
the device operations it launched. With no profiler running it returns one
shared no-op context: the cost is one flag check. The profiler keeps the
spans and writes them out when its owner exports the trace; nothing here
records or writes anything of its own.

Every name starts with ``ntt.``: ``ntt.api``, ``ntt.runner.build``,
``ntt.level``, ``ntt.base``, ``ntt.copy``, ``ntt.pass.<pass>``,
``ntt.dist.local``, ``ntt.dist.twiddle``, ``ntt.dist.exchange`` and
``ntt.launch.<wrapper>``. The distributed entries (``dist_ntt``,
``dist_intt``, ``dist_lde``) open ``ntt.api`` too, and ``ntt.runner.build``
on a miss of their runner cache; inside, each shard's local transforms
(steps 1 and 4), its step-2 product and the exchange (step 3) are the
``ntt.dist.*`` spans, the local transpose an ``ntt.copy``.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records ``name`` while a profiler is recording."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF

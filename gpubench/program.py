"""The system under test: ``ntt_tpu_torch``'s public calls, through which the
operations of ``gpubench/ops/`` reach the program. This and those modules'
``program`` functions are the only code of the benchmark that touches the
program; the reference imports nothing of it.

Transforms keep the program's tables resident (its runner cache), as a
prover does; the elementwise operations are ``limbs``' passes (one launch
of the pass kernels each on the card). Over several cards the program is
``ntt_tpu_torch.parallel``'s distributed four-step on a mesh of the cell's
cards, one shard a card, its options taken from the configuration.
"""

from __future__ import annotations

import contextlib
import importlib
import time

import torch

from .workload import load_op


class Program:
    """``ntt_tpu_torch`` on one field and coset shift, its transforms'
    words in Montgomery form with ``mont_io``. ``device``: one device, or
    the list of a cell's cards (a mesh of one shard a card, ``self.mesh``;
    a card may repeat). ``options``: the configuration, whose keys the
    sharded operations read (``local``, ``exchange``)."""

    def __init__(self, field: str, shift: int, device, mont_io: bool = True,
                 options: dict | None = None):
        from ntt_tpu_torch import api, limbs
        from ntt_tpu_torch.fields import get_field
        from ntt_tpu_torch.kernels import _build

        self.api, self.limbs, self._build = api, limbs, _build
        self.field = get_field(field)
        self.options = {} if options is None else options
        self.dist = self.mesh = None
        if isinstance(device, (list, tuple)):
            # the module: the package's name ``dist_ntt`` is its function
            self.dist = importlib.import_module(
                "ntt_tpu_torch.parallel.dist_ntt")
            self.mesh = self.dist.make_mesh(list(device))
            device = device[0]
        self.shift, self.device = shift, torch.device(device)
        #: the keywords every transform call takes
        self.io = {"mont_io": mont_io, "device": self.device}
        self._consts: dict = {}

    def call(self, op: str, *xs):
        """Operation ``op`` (``gpubench/ops/<op>.py``) on the program."""
        return load_op(op).program(self, *xs)

    def scale(self, x, c: int):
        """x·c mod p, one Montgomery product by c's Montgomery form (kept on
        the card after its first use)."""
        key = (c, x.dim())
        if key not in self._consts:
            f = self.field
            words = f.int_to_words(f.to_mont_int(c))
            self._consts[key] = torch.tensor(words, dtype=torch.int64).to(
                torch.uint32).reshape((-1,) + (1,) * (x.dim() - 1)).to(
                    self.device)
        return self.limbs.mont_mul(x, self._consts[key], self.field)

    # -- what the benchmark reads -----------------------------------------

    def launches(self) -> int:
        """The port's kernel launches so far, on every card (its wrappers'
        counter, one for the process)."""
        return sum(self._build.launches.values())

    @contextlib.contextmanager
    def timing_tables(self, sink: list):
        """Appends to ``sink`` the seconds of each ``api.get_runner`` call
        (the tables' build and upload) made inside the block, and over
        several cards of each call of the distributed runner cache
        (``dist_ntt._get``, which builds every card's tables)."""
        owners = [(self.api, "get_runner")]
        if self.dist is not None:
            owners.append((self.dist, "_get"))
        inner = [getattr(m, name) for m, name in owners]

        def timer(fn):
            def timed(*args, **kw):
                t = time.perf_counter()
                try:
                    return fn(*args, **kw)
                finally:
                    sink.append(time.perf_counter() - t)
            return timed

        for (m, name), fn in zip(owners, inner):
            setattr(m, name, timer(fn))
        try:
            yield
        finally:
            for (m, name), fn in zip(owners, inner):
                setattr(m, name, fn)

    def release(self) -> None:
        """Drops the program's resident tables (its runner caches)."""
        self.api._runner_cache.clear()
        if self.dist is not None:
            self.dist._dist_cache.clear()

"""The system under test: ``ntt_tpu_torch``'s public calls, through which the
operations of ``gpubench/ops/`` reach the program. This and those modules'
``program`` functions are the only code of the benchmark that touches the
program; the reference imports nothing of it.

Transforms keep the program's tables resident (its runner cache), as a
prover does; the elementwise operations are ``limbs``' plain passes.
"""

from __future__ import annotations

import contextlib
import time

import torch

from .workload import load_op


class Program:
    """``ntt_tpu_torch`` on one field and coset shift, its transforms'
    words in Montgomery form with ``mont_io``."""

    def __init__(self, field: str, shift: int, device, mont_io: bool = True):
        from ntt_tpu_torch import api, limbs
        from ntt_tpu_torch.fields import get_field
        from ntt_tpu_torch.kernels import _build

        self.api, self.limbs, self._build = api, limbs, _build
        self.field = get_field(field)
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
        """The port's kernel launches so far (its wrappers' counter)."""
        return sum(self._build.launches.values())

    @contextlib.contextmanager
    def timing_tables(self, sink: list):
        """Appends to ``sink`` the seconds of each ``api.get_runner`` call
        (the tables' build and upload) made inside the block."""
        api, inner = self.api, self.api.get_runner

        def timed(*args, **kw):
            t = time.perf_counter()
            try:
                return inner(*args, **kw)
            finally:
                sink.append(time.perf_counter() - t)

        api.get_runner = timed
        try:
            yield
        finally:
            api.get_runner = inner

    def release(self) -> None:
        """Drops the program's resident tables (its runner cache)."""
        self.api._runner_cache.clear()

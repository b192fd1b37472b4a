"""The one general generator: reads a traffic file and makes its work.

A traffic mix is a JSON file ``gpubench/traffic/<mix>.json``:

- ``inputs``: the names of the vectors one unit of work takes, each a fresh
  uint32[W, n] of canonical random words (uint32[W, n, batch] with
  ``batch`` above 1);
- ``batch`` (default 1): the vectors' trailing batch axis, the columns a
  call transforms at once;
- ``pool_slots``: how many such vectors the seeded pool holds; unit i takes
  the slots (k·i + j) mod pool_slots for its k inputs;
- ``steps``: the unit, a list of ``{"op", "args", "out"}``, each run by the
  system under test (or, in the check, by the plain reference) on the named
  vectors. Each operation is found by name: ``gpubench/ops/<op>.py``, a
  module with ``ARGS`` (its number of vector arguments), ``points(x)`` (the
  transform points it completes on its first argument ``x``, 0 for a pass),
  ``program(prog, *xs)`` (the call into the program, through
  :class:`gpubench.program.Program`) and ``reference(ref, *xs)`` (the same
  over :class:`gpubench.reference.ops.Reference`'s plain primitives);
- ``output``: the name of the vector a unit produces, the one the check
  compares;
- ``mont_io`` (default true): the transforms take and return
  Montgomery-form words, as a prover keeps its data; false: standard form,
  the program converting in and out. The reference's words are the same
  either way: the transforms are linear over the field;
- ``sync_every`` (default 1): one client in a closed loop, dispatching this
  many units and then waiting for the card; each unit's time runs from its
  call until that wait returns;
- ``check_units``: how many completed units, drawn from the seed, the check
  compares with the reference after the window;

In a cell of several cards a vector is a list of per-card tensors, and the
unit is one step of a sharded operation: one that declares ``SHARDED =
True`` and the layouts of its input and output (``gpubench/shard.py``). The
pool's vectors are then made card by card (:func:`make_shard`).

A new mix is a new file, and a new operation one more module beside the
others; no code changes.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import importlib.util
import json
import math
import os

import torch

PKG = os.path.dirname(os.path.abspath(__file__))
TRAFFIC_DIR = os.path.join(PKG, "traffic")
OPS_DIR = os.path.join(PKG, "ops")


@functools.lru_cache(maxsize=None)
def load_op(name: str, directory: str = OPS_DIR):
    """The module of operation ``name`` (``<directory>/<name>.py``)."""
    path = os.path.join(directory, f"{name}.py")
    if not os.path.isfile(path):
        raise ValueError(f"no operation {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"gpubench_op_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass(frozen=True)
class Traffic:
    name: str
    inputs: tuple
    pool_slots: int
    steps: tuple
    output: str
    check_units: int
    batch: int = 1
    mont_io: bool = True
    sync_every: int = 1

    @classmethod
    def load(cls, name: str, directory: str | None = None) -> "Traffic":
        directory = TRAFFIC_DIR if directory is None else directory
        with open(os.path.join(directory, f"{name}.json")) as f:
            d = json.load(f)
        t = cls(name=name, inputs=tuple(d["inputs"]),
                pool_slots=int(d["pool_slots"]),
                steps=tuple((s["op"], tuple(s["args"]), s["out"])
                            for s in d["steps"]),
                output=d["output"], check_units=int(d["check_units"]),
                batch=int(d.get("batch", 1)),
                mont_io=bool(d.get("mont_io", True)),
                sync_every=int(d.get("sync_every", 1)))
        t.validate()
        return t

    def validate(self) -> None:
        if (self.pool_slots < len(self.inputs) or self.check_units < 1
                or self.batch < 1 or self.sync_every < 1):
            raise ValueError(f"{self.name}: pool_slots must hold one unit's "
                             "inputs, and check_units, batch and sync_every "
                             "be at least 1")
        known = set(self.inputs)
        for op, args, out in self.steps:
            if load_op(op).ARGS != len(args):
                raise ValueError(f"{self.name}: {op} takes "
                                 f"{load_op(op).ARGS} vectors, not {args}")
            missing = [a for a in args if a not in known]
            if missing:
                raise ValueError(f"{self.name}: {op} reads {missing} before "
                                 "any step writes it")
            known.add(out)
        if self.output not in known:
            raise ValueError(f"{self.name}: no step writes {self.output}")

    def unit_slots(self, i: int) -> list:
        k = len(self.inputs)
        return [(k * i + j) % self.pool_slots for j in range(k)]

    def shape(self, words: int, n: int) -> tuple:
        return (words, n) if self.batch == 1 else (words, n, self.batch)


def slot_seed(seed: int, slot: int) -> int:
    """A 63-bit generator seed for one pool slot of a run's seed."""
    h = hashlib.blake2b(f"{seed}:{slot}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") >> 1


def make_vector(p: int, shape: tuple, seed: int, slot: int,
                device) -> torch.Tensor:
    """Canonical random words uint32[W, ...], made on ``device`` from the
    seed: the top word stays below p's, so every value is below p."""
    words, rest = shape[0], tuple(shape[1:])
    g = torch.Generator(device=device)
    g.manual_seed(slot_seed(seed, slot))
    x = torch.randint(0, 1 << 32, (words,) + rest, dtype=torch.int64,
                      generator=g, device=device)
    x[words - 1] = torch.randint(0, p >> (32 * (words - 1)), rest,
                                 dtype=torch.int64, generator=g,
                                 device=device)
    return x.to(torch.uint32)


def shard_seed(seed: int, slot: int, card: int) -> int:
    """A 63-bit generator seed for one card's block of one pool slot."""
    h = hashlib.blake2b(f"{seed}:{slot}:{card}".encode(),
                        digest_size=8).digest()
    return int.from_bytes(h, "little") >> 1


#: columns a chunk of :func:`make_shard` draws at most
SHARD_CHUNK = 1 << 22


def make_shard(p: int, shape: tuple, seed: int, slot: int, card: int,
               device) -> torch.Tensor:
    """One card's block of a pool slot, canonical random words uint32[W,
    ...] made on ``device`` from (seed, slot, card), in its local order. It
    is drawn in chunks of at most half its columns (and at most
    :data:`SHARD_CHUNK`), so that the int64 draw of a chunk is never larger
    than the block."""
    words = shape[0]
    out = torch.empty(shape, dtype=torch.uint32, device=device)
    flat = out.view(words, -1)
    cols = flat.shape[1]
    chunk = max(1, min(SHARD_CHUNK, cols // 2))
    top = p >> (32 * (words - 1))
    g = torch.Generator(device=device)
    g.manual_seed(shard_seed(seed, slot, card))
    for c0 in range(0, cols, chunk):
        c = min(chunk, cols - c0)
        x = torch.randint(0, 1 << 32, (words - 1, c), dtype=torch.int64,
                          generator=g, device=device)
        flat[:words - 1, c0:c0 + c] = x.to(torch.uint32)
        del x
        flat[words - 1, c0:c0 + c] = torch.randint(
            0, top, (c,), dtype=torch.int64, generator=g,
            device=device).to(torch.uint32)
    return out


def unit_inputs(traffic: Traffic, i: int, pool: list) -> list:
    return [pool[s] for s in traffic.unit_slots(i)]


def run_unit(executor, traffic: Traffic, inputs: list, span) -> tuple:
    """One unit of work: the traffic's steps through ``executor.call``, each
    inside ``span("step.<op>")``. (The unit's output, the transform points
    it completed.)"""
    env = dict(zip(traffic.inputs, inputs))
    points = 0
    for op, args, out in traffic.steps:
        xs = [env[a] for a in args]
        points += load_op(op).points(xs[0])
        with span(f"step.{op}"):
            env[out] = executor.call(op, *xs)
    return env[traffic.output], points


def quarter_means(starts: list, values: list, seconds: float) -> list:
    """The mean of ``values`` over each quarter of a window of ``seconds``,
    by each value's start (seconds into the window); None for an empty
    quarter."""
    sums, counts = [0.0] * 4, [0] * 4
    for s, v in zip(starts, values):
        q = min(3, max(0, math.floor(4 * s / seconds))) if seconds > 0 else 0
        sums[q] += v
        counts[q] += 1
    return [s / c if c else None for s, c in zip(sums, counts)]

"""One run of one cell: set-up, the measured window, the check, the result.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``,
its configuration in the file that names, its traffic in
``gpubench/traffic/<mix>.json`` (read by :mod:`gpubench.workload`, which
finds each operation it names in ``gpubench/ops/<op>.py``), and each metric
the cell reports in ``gpubench/metrics/<metric>.py``, a reader with
``read(run) -> float | None``; a metric ``<base>.<part>`` without a file of
its own is read by ``gpubench/metrics/<base>.py``, in units of the cell's
traffic. Adding any of them adds files and entries only.

A cell of ``chips`` above 1 runs on the cards ``devices`` (``cuda:0`` ..;
tests and trials may name one device several times, or the CPU). Its
vectors are lists of per-card tensors in the layouts its one sharded
operation declares (:class:`Sharding`); each card makes its own block of
the pool; a unit's wait synchronises every card; the check compares the
outputs at the indices r + S·t of each kept unit, gathered from the cards,
with the reference's blocked form; and the memory peak, the busy time and
the idle share are read card by card. On one device every path is the
one-card path.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import os
import random
import subprocess
import sys
import tempfile
import time

import torch

from . import roofline, workload
from .reference.ops import field_of, for_config
from .trace import WINDOW, TraceView

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)
BENCHMARK = os.path.join(ROOT, "BENCHMARK.json")
METRICS_DIR = os.path.join(PKG, "metrics")

#: top-level module names that must never be loaded in a run: JAX and the
#: reference package the program was ported from
FOREIGN = ("jax", "jaxlib", "flax", "ntt_tpu")


# -- finding things by name --------------------------------------------------

def load_benchmark(path: str = BENCHMARK) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[c['name'] for c in bench['workloads']]}")


def load_config(bench: dict, cell: dict, root: str = ROOT) -> dict:
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, entry["file"])) as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries the cell reports."""
    return [m for m in bench[kind]
            if cell in m.get("workloads", [cell])]


def load_reader(name: str, directory: str = METRICS_DIR):
    """The reader module of metric ``name``: ``<directory>/<name>.py``, or
    for ``<base>.<part>`` without such a file, ``<directory>/<base>.py``."""
    path = os.path.join(directory, f"{name}.py")
    if not os.path.isfile(path) and "." in name:
        path = os.path.join(directory, f"{name.rsplit('.', 1)[0]}.py")
    spec = importlib.util.spec_from_file_location(
        "gpubench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def foreign_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN)


# -- what a reader reads -----------------------------------------------------

@dataclasses.dataclass
class Window:
    units: int              # units of work completed
    seconds: float          # host clock, first call to the last unit's sync
    latencies_ms: list      # each unit, host clock, from its call until the
                            # wait for the card that covers it returned
    points: int             # transform points completed
    starts_s: list = dataclasses.field(default_factory=list)  # each call's
                            # start, seconds into the window


@dataclasses.dataclass
class Run:
    n: int
    elem_bytes: int
    window: Window
    setup_s: float
    peak_bytes: int         # the fullest card's
    tables_s: float         # seconds in the program's runner builds
    launches: int           # the program's kernel launches in the window
    trace: TraceView | None
    chips: int = 1


def keep_whole(i: int, out) -> tuple:
    """What a one-card cell keeps of a unit: (unit, a copy of its output)."""
    return (i, out.clone())


class _Keep:
    """A reservoir of ``k`` completed units drawn from the seed: what
    ``take(unit, output)`` keeps of each, by default (unit, a copy of its
    output)."""

    def __init__(self, k: int, seed: int, take=keep_whole):
        self.k, self.rng, self.items = k, random.Random(seed), []
        self.take = take

    def offer(self, i: int, out) -> None:
        if len(self.items) < self.k:
            self.items.append(self.take(i, out))
            return
        j = self.rng.randrange(i + 1)
        if j < self.k:
            self.items[j] = self.take(i, out)


def waiter(devices) -> callable:
    """The wait for a cell's cards: ``torch.cuda.synchronize`` of each
    distinct CUDA device, in order; nothing on the CPU."""
    cards = list(dict.fromkeys(d for d in devices if d.type == "cuda"))

    def wait():
        for d in cards:
            torch.cuda.synchronize(d)
    return wait


def _span(on: bool):
    if not on:
        return lambda name: contextlib.nullcontext()
    return torch.profiler.record_function


def measure(executor, traffic, pool, seconds: float, wait, keep: _Keep,
            span, points: int) -> Window:
    """The closed loop: unit after unit, ``traffic.sync_every`` of them to
    each ``wait()`` for the cards (:func:`waiter`), until ``seconds`` have
    passed; the units in flight then complete and count. Every time is the
    host's clock, each unit's from its call until that wait returns for
    the last card, where the window ends too."""
    lat, starts, pending, units = [], [], [], 0
    t0 = time.perf_counter()
    while True:
        inputs = workload.unit_inputs(traffic, units, pool)
        with span("unit"):
            h = time.perf_counter()
            out, _ = workload.run_unit(executor, traffic, inputs, span)
        pending.append((units, h, out))
        del out
        units += 1
        last = time.perf_counter() - t0 >= seconds
        if last or len(pending) >= traffic.sync_every:
            with span("sync"):
                wait()
            now = time.perf_counter()
            with span("keep"):
                for i, h, out in pending:
                    lat.append((now - h) * 1e3)
                    starts.append(h - t0)
                    keep.offer(i, out)
            pending.clear()
            del out                 # no output outlives its wait
        if last:
            break
    return Window(units, now - t0, lat, units * points, starts)


def _traced(fn):
    """``fn()`` under the profiler; (its result, the trace's events)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=False, with_stack=False,
                 profile_memory=False) as prof:
        with torch.profiler.record_function(WINDOW):
            result = fn()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return result, events


def check(traffic, config: dict, n: int, seed: int, kept: list,
          device, sharding: "Sharding | None" = None) -> dict:
    """Each kept output against the plain reference on the same inputs,
    made again from the seed. The numbers compared, each with its limit.
    Over several cards: :func:`check_sharded`."""
    if sharding is not None:
        return check_sharded(traffic, config, seed, kept, sharding)
    ref = for_config(config, device)
    f = ref.f
    mismatched, checked, elements = 0, 0, 0
    for i, got in kept:
        inputs = [workload.make_vector(f.p, traffic.shape(f.words, n), seed,
                                       s, device)
                  for s in traffic.unit_slots(i)]
        want, _ = workload.run_unit(ref, traffic, inputs,
                                    lambda name: contextlib.nullcontext())
        if got.shape != want.shape or got.dtype != want.dtype:
            mismatched += want[0].numel()
        else:
            mismatched += int((got.to(torch.int64) != want.to(torch.int64)
                               ).any(dim=0).sum())
        checked += 1
        elements += want[0].numel()
    return dict(_counts(mismatched, checked), elements=elements)


def _counts(mismatched: int, checked: int) -> dict:
    return {"mismatched_elements": {"value": mismatched, "limit": 0},
            "outputs_checked": {"value": checked, "limit": 1}}


# -- a cell over several cards -----------------------------------------------

#: outputs M a kept unit of a sharded cell compares (at most n), those at
#: r + S·t, S = n/M: the check's time grows with n and with M log M, and
#: 2^22 keeps it near the window's length at 2^30. A cell on one card
#: compares every output.
CHECK_POINTS = 1 << 22


def gather(shards: list, cards, pos, device) -> torch.Tensor:
    """uint32[W, len(pos)]: element j is card ``cards[j]``'s flat local
    position ``pos[j]``, gathered onto ``device``. Every card reads every
    position (the cards' local shapes are one) and each element is taken
    from its own card's reading, so that nothing waits for the host."""
    got = None
    for d, x in enumerate(shards):
        idx = torch.unravel_index(pos.to(x.device), tuple(x.shape[1:]))
        vals = x.view(torch.int32)[(slice(None),) + idx].to(device)
        got = vals if got is None else torch.where(cards == d, vals, got)
    return got.view(torch.uint32)


@dataclasses.dataclass
class Sharding:
    """A cell of several cards: its one sharded operation, its cards, the
    layouts of the operation's input and output (``gpubench/shard.py``),
    and the M outputs a kept unit's check compares, at r + S·t."""
    op: object
    devices: list
    words: int
    n: int
    M: int

    @property
    def S(self) -> int:
        return self.n // self.M

    @property
    def inp(self):
        return self.op.input_layout(self.words, self.n, len(self.devices))

    @property
    def out(self):
        return self.op.output_layout(self.words, self.n, len(self.devices))

    def residue(self, seed: int, i: int) -> int:
        """Unit i's r, drawn from the seed."""
        return random.Random(f"{seed}:{i}").randrange(self.S)

    def checked(self, r: int, assert_cards: bool = True) -> tuple:
        """(cards, positions) of the outputs r + S·t, t < M; raises unless
        they lie on every card (the assertion waits for the device: the
        window's ``take`` leaves it to the check)."""
        k = r + self.S * torch.arange(self.M, device=self.devices[0])
        cards, pos = self.out.locate(k)
        if assert_cards and torch.unique(cards).numel() != len(self.devices):
            raise ValueError(
                f"the outputs r + {self.S}·t lie on {torch.unique(cards)} "
                f"of {len(self.devices)} cards: raise CHECK_POINTS")
        return cards, pos

    def take(self, seed: int):
        """The reservoir's ``take``: (unit, r, its outputs at r + S·t)."""
        def take(i: int, out: list) -> tuple:
            r = self.residue(seed, i)
            cards, pos = self.checked(r, assert_cards=False)
            return (i, r, gather(out, cards, pos, self.devices[0]))
        return take

    def pool_vector(self, p: int, seed: int, slot: int) -> list:
        """One pool slot: each card's block, made on the card."""
        return [workload.make_shard(p, self.inp.shape, seed, slot, d, dev)
                for d, dev in enumerate(self.devices)]

    def blocks(self, shards: list):
        """The input's natural-order blocks x[M·b : M·(b+1)], b < S, each
        gathered from the cards onto the first."""
        dev = self.devices[0]
        for b in range(self.S):
            cards, pos = self.inp.locate(
                self.M * b + torch.arange(self.M, device=dev))
            yield gather(shards, cards, pos, dev)


def sharding(traffic, words: int, n: int, devices: list) -> Sharding:
    """The :class:`Sharding` of a cell on ``devices`` (two or more): its
    traffic must be one step of a sharded operation, unbatched. M is
    :data:`CHECK_POINTS`, at most n."""
    ops = [workload.load_op(op) for op, _, _ in traffic.steps]
    if len(ops) != 1 or not getattr(ops[0], "SHARDED", False) or (
            traffic.batch != 1):
        raise ValueError(f"{traffic.name}: a cell of several cards takes "
                         "one step of a sharded operation, unbatched")
    sh = Sharding(ops[0], list(devices), words, n, min(n, CHECK_POINTS))
    sh.checked(0)
    return sh


def check_sharded(traffic, config: dict, seed: int, kept: list,
                  sh: Sharding) -> dict:
    """Each kept unit's outputs at r + S·t against the reference's blocked
    form (``reference_at`` of the operation) on the unit's input, made
    again card by card from the seed and read in natural-order blocks, one
    at a time, on the first card."""
    ref = for_config(config, sh.devices[0])
    mismatched, checked, elements = 0, 0, 0
    for i, r, got in kept:
        sh.checked(r)
        (slot,) = traffic.unit_slots(i)
        shards = sh.pool_vector(ref.f.p, seed, slot)
        want = sh.op.reference_at(ref, sh.blocks(shards), sh.n, sh.S, r)
        del shards
        mismatched += int((got.to(torch.int64) != want.to(torch.int64)
                           ).any(dim=0).sum())
        checked += 1
        elements += want.shape[1]
    return dict(_counts(mismatched, checked), elements=elements)


def passed(checks: dict) -> bool:
    return (checks["mismatched_elements"]["value"]
            <= checks["mismatched_elements"]["limit"]
            and checks["outputs_checked"]["value"]
            >= checks["outputs_checked"]["limit"])


def cell_parts(bench: dict, name: str, log_n: int | None = None):
    """(cell entry, configuration, traffic, n, field) of cell ``name``;
    ``log_n`` overrides the configuration's domain (tests on the CPU)."""
    cell = find_cell(bench, name)
    config = load_config(bench, cell)
    n = 1 << (config["log_n"] if log_n is None else log_n)
    return (cell, config, workload.Traffic.load(cell["traffic"]), n,
            field_of(config))


def make_pool(traffic, field, n: int, seed: int, device,
              sh: Sharding | None = None) -> list:
    if sh is not None:
        return [sh.pool_vector(field.p, seed, s)
                for s in range(traffic.pool_slots)]
    return [workload.make_vector(field.p, traffic.shape(field.words, n), seed,
                                 s, device)
            for s in range(traffic.pool_slots)]


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             devices: list | None = None,
             log_n: int | None = None, make_executor=None,
             started: float | None = None, bench: dict | None = None) -> dict:
    """One run of cell ``name``; returns the result object the command
    prints. ``devices``: the cell's cards, as many as its ``chips`` (one
    may repeat: ``["cuda:0"] * 4``, ``["cpu"] * 4``); without it the one
    card ``cuda``. ``log_n`` overrides the configuration's domain (tests on
    the CPU); ``make_executor(config, traffic, device)`` replaces the
    program (the control, a broken program), given the list of devices in
    a sharded cell; ``started``: ``time.perf_counter()``'s reading at
    process start, from which ``setup_s`` counts."""
    started = time.perf_counter() if started is None else started
    marks = [("start", started), ("imports", time.perf_counter())]
    bench = load_benchmark() if bench is None else bench
    cell, config, traffic, n, field = cell_parts(bench, name, log_n)
    devices = [torch.device(d) for d in (devices or ["cuda"])]
    if len(devices) != cell["chips"]:
        raise ValueError(f"{name} takes {cell['chips']} card(s), given "
                         f"{len(devices)}")
    device = devices[0]
    sh = (sharding(traffic, field.words, n, devices) if len(devices) > 1
          else None)
    target = device if sh is None else devices
    if make_executor is None:
        from .program import Program
        executor = Program(config["field"], config["coset_shift"], target,
                           traffic.mont_io, options=config)
    else:
        executor = make_executor(config, traffic, target)
    marks.append(("program", time.perf_counter()))
    wait = waiter(devices)
    pool = make_pool(traffic, field, n, seed, device, sh)
    wait()
    marks.append(("pool", time.perf_counter()))
    span = _span(trace)
    tables = []
    tabled = getattr(executor, "timing_tables", None)
    with tabled(tables) if tabled else contextlib.nullcontext():
        for i in range(2):          # builds every runner, loads every kernel
            out, points = workload.run_unit(
                executor, traffic, workload.unit_inputs(traffic, i, pool),
                span)
            if sh is not None:          # loads the kernels of the keep
                sh.take(seed)(i, out)
            del out
            wait()
            marks.append((f"warm_unit_{i}", time.perf_counter()))
    count = getattr(executor, "launches", lambda: 0)
    keep = (_Keep(traffic.check_units, seed) if sh is None
            else _Keep(traffic.check_units, seed, sh.take(seed)))
    launches0 = count()
    setup_s = time.perf_counter() - started

    def window():
        return measure(executor, traffic, pool, seconds, wait, keep, span,
                       points)

    view = None
    if trace:
        win, events = _traced(window)
        t = time.perf_counter()
        cards = None if sh is None or device.type != "cuda" else sorted(
            {torch.cuda.current_device() if d.index is None else d.index
             for d in devices})
        view = TraceView(events, cards)
        del events
        trace_read_s = time.perf_counter() - t
        if not view.ops:
            raise RuntimeError("the traced window holds no device operation")
    else:
        win = window()
    launches = count() - launches0
    peaks = {str(d): torch.cuda.max_memory_allocated(d)
             for d in dict.fromkeys(devices) if d.type == "cuda"}
    peak = max(peaks.values(), default=0)

    del pool
    if hasattr(executor, "release"):
        executor.release()
    del executor
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks = check(traffic, config, n, seed, keep.items, device, sh)
    check_s = time.perf_counter() - t
    elements = checks.pop("elements")

    run = Run(n, 4 * field.words, win, setup_s, peak,
              sum(tables), launches, view, len(devices))
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(bench, name, kind):
        value = load_reader(m["name"]).read(run)
        if value is None and kind == "end_to_end":
            raise RuntimeError(f"{m['name']}: the run gave no reading")
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": passed(checks), "attempted": win.units,
              "failed": 0, "metrics": metrics, "device": _device(device, cell,
                                                                  peak)}
    if view is not None:
        result["device"].update(busy_s=view.busy_s, window_s=view.window_s)
        result["breakdown"] = view.breakdown()
    result["notes"] = _notes(run, device)
    result["notes"]["check_s"] = check_s
    result["notes"]["elements_checked"] = elements
    result["notes"]["tables_s"] = run.tables_s
    result["notes"]["memory_peak_by_card"] = peaks
    if view is not None:
        result["notes"]["idle_share_by_card"] = {
            str(device if c is None else c): v
            for c, v in view.card_idle_shares().items()}
    result["notes"]["setup_phases_s"] = {
        b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}
    if view is not None:
        result["notes"]["trace_read_s"] = trace_read_s
    result["checks"] = checks
    return result


def _device(device, cell: dict, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": cell["chips"],
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": cell["chips"], "memory_peak_bytes": peak}


def _notes(run: Run, device) -> dict:
    """What a reader of the result wants beside the metrics: the domain, the
    transform's least time on the cell's cards and the bound that sets it
    (operations, bytes or the exchange), the card's power limit."""
    t, by = roofline.least_time(run.n, run.elem_bytes, run.chips)
    w = run.window
    notes = {"n": run.n, "units": w.units, "window_s": w.seconds,
             "quarter_unit_ms": workload.quarter_means(
                 w.starts_s, w.latencies_ms, w.seconds),
             "transform_least_ms": t * 1e3, "bounded_by": by}
    if device.type == "cuda":
        notes["power_limit"] = power_limit()
    return notes


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
        "not read: " + out.stderr.strip()[:100])


def check_lines(checks: dict) -> list:
    """One line a number compared: its name, value and limit (a most for
    the mismatches, a least for the outputs checked)."""
    return [f"check mismatched_elements "
            f"{checks['mismatched_elements']['value']} <= limit "
            f"{checks['mismatched_elements']['limit']}",
            f"check outputs_checked {checks['outputs_checked']['value']} "
            f">= limit {checks['outputs_checked']['limit']}"]

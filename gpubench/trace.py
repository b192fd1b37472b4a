"""What the traced window did on the device, from the profiler's trace.

The benchmark runs its traced window under ``torch.profiler`` (CPU and CUDA
activities) inside a ``record_function`` span named :data:`WINDOW`, each unit
of work in a span ``unit``, each call into the program in a span
``step.<op>`` and each wait for the device in ``sync``. The trace is read in
its Chrome form (the profiler's ``export_chrome_trace``): a list of events
with ``cat``, ``name``, ``ts`` and ``dur`` in microseconds on one clock for
host and device, the host thread (``pid``, ``tid``), and ``args.correlation``
joining a device operation to the runtime call that launched it.

Each device operation (kernel, memcpy, memset) launched inside the window
falls in one class:

- ``port``: a kernel that is not a library's (its name names no ``at::``,
  ``c10::``, ``cub::``, ``thrust::``, cuBLAS or CUTLASS symbol): the
  program's own CUDA kernels;
- ``copy``: launched under a layout operation (:data:`LAYOUT_OPS`, the
  outermost PyTorch operation around the launch): the drivers' transposes;
- ``pass``: launched under any other PyTorch operation inside a step: the
  plain elementwise passes;
- ``harness``: launched outside every step (the benchmark's own copies).
"""

from __future__ import annotations

import bisect
import collections
import dataclasses

WINDOW = "gpubench.window"
DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
LAUNCH_CATS = frozenset({"cuda_runtime", "cuda_driver"})
HOST_OP_CATS = LAUNCH_CATS | {"cpu_op"}
LAYOUT_OPS = frozenset({"aten::contiguous", "aten::clone", "aten::reshape",
                        "aten::flatten"})
LIBRARY_MARKS = ("at::", "c10::", "cub::", "thrust::", "cutlass", "cublas",
                 "gemm")


def is_library_kernel(name: str) -> bool:
    low = name.lower()
    return any(m in name or m in low for m in LIBRARY_MARKS)


@dataclasses.dataclass
class DeviceOp:
    name: str
    start: float        # us
    end: float          # us
    cls: str            # port, copy, pass, harness


class _Intervals:
    """Non-overlapping (start, end, name) intervals, found by a point."""

    def __init__(self, items):
        self.items = sorted(items)
        self.starts = [s for s, _, _ in self.items]

    def at(self, t: float):
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and self.items[i][1] >= t:
            return self.items[i]
        return None


def _outermost(events) -> list:
    """The events not nested inside another, as (start, end, name)."""
    out, end = [], float("-inf")
    for s, e, name in sorted(events, key=lambda x: (x[0], -x[1])):
        if s >= end:
            out.append((s, e, name))
            end = e
    return out


def _short(name: str) -> str:
    name = name[5:] if name.startswith("void ") else name
    return name.split("(")[0][:100]


class TraceView:
    """The traced window: its device operations by class, its host spans,
    its busy time and its idle gaps."""

    def __init__(self, events: list):
        win = [e for e in events if e.get("cat") == "user_annotation"
               and e.get("name") == WINDOW]
        if not win:
            raise ValueError(f"the trace has no {WINDOW!r} span")
        w = win[0]
        self.w0, self.w1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        thread = (w.get("pid"), w.get("tid"))

        def host(e):
            return ((e.get("pid"), e.get("tid")) == thread
                    and self.w0 <= float(e["ts"]) <= self.w1)

        def iv(e):
            return (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                    e["name"])

        notes = [iv(e) for e in events
                 if e.get("cat") == "user_annotation" and host(e)]
        self.spans = [s for s in notes if s[2] != WINDOW]
        self._units = _Intervals([s for s in self.spans if s[2] == "unit"])
        self._steps = _Intervals([s for s in self.spans
                                  if s[2].startswith("step.")
                                  or s[2] in ("sync", "keep")])
        self._ops = _Intervals(_outermost(
            [iv(e) for e in events if host(e)
             and e.get("cat") in HOST_OP_CATS]))
        launch_ts = {e["args"]["correlation"]: float(e["ts"])
                     for e in events if e.get("cat") in LAUNCH_CATS
                     and "correlation" in e.get("args", {})}

        self.ops = []
        for e in events:
            if e.get("cat") not in DEVICE_CATS:
                continue
            t = launch_ts.get(e.get("args", {}).get("correlation"),
                              float(e["ts"]))
            if not self.w0 <= t <= self.w1:
                continue
            self.ops.append(DeviceOp(e["name"], float(e["ts"]),
                                     float(e["ts"]) + float(e.get("dur", 0)),
                                     self._classify(e, t)))
        self.window_s = (self.w1 - self.w0) / 1e6
        self.busy = self._busy()
        self.busy_s = sum(e - s for s, e in self.busy) / 1e6

    def _classify(self, e: dict, t: float) -> str:
        if e.get("cat") == "kernel" and not is_library_kernel(e["name"]):
            return "port"
        step = self._steps.at(t)
        if step is None or not step[2].startswith("step."):
            return "harness"
        op = self._ops.at(t)
        return "copy" if op is not None and op[2] in LAYOUT_OPS else "pass"

    def _busy(self) -> list:
        """The union of the device operations' intervals, cut to the
        window."""
        merged = []
        for op in sorted(self.ops, key=lambda o: o.start):
            s, e = max(op.start, self.w0), min(op.end, self.w1)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    # -- readings --------------------------------------------------------

    def device_ms(self, cls: str) -> float:
        """Device milliseconds of the operations of one class."""
        return sum(o.end - o.start for o in self.ops if o.cls == cls) / 1e3

    def span_ms(self, prefix: str) -> float:
        """Host milliseconds inside the spans whose name starts so."""
        return sum(e - s for s, e, name in self.spans
                   if name.startswith(prefix)) / 1e3

    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def gaps(self) -> list:
        """(start, end) of the window's stretches with no device operation."""
        out, t = [], self.w0
        for s, e in self.busy:
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.w1 > t:
            out.append((t, self.w1))
        return out

    def host_activity(self, t: float) -> str:
        """What the host thread was doing at ``t``: the innermost benchmark
        span and the outermost operation or runtime call."""
        span = self._steps.at(t) or self._units.at(t)
        op = self._ops.at(t)
        return (f"{span[2] if span else 'loop'} > "
                f"{_short(op[2]) if op else 'python'}")

    def breakdown(self, top: int = 10) -> dict:
        ops = collections.Counter()
        for o in self.ops:
            ops[f"{o.cls} {_short(o.name)}"] += (o.end - o.start) / 1e6
        gaps = collections.Counter()
        for s, e in self.gaps():
            gaps[self.host_activity((s + e) / 2)] += (e - s) / 1e6
        return {"device_ops": [[k, v] for k, v in ops.most_common(top)],
                "idle_gaps": [[k, v] for k, v in gaps.most_common(top)]}

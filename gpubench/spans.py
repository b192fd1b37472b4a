"""The program's own spans in the traced window, by layer.

The program marks its layers with profiler spans whose names start with
``ntt.`` (``ntt_tpu_torch/tracing.py``); they land on the window's host
thread beside the benchmark's own, so ``TraceView.spans`` holds them. A
span's self intervals are its interval less the intervals of the program
spans nested in it: the self intervals of all spans are disjoint, so the
readings of the layers add up. The layers are those of ``PERF.md``:

=====================================  ====================
``ntt.api``                            API
``ntt.runner.build``                   tables
``ntt.level``, ``ntt.base``,
``ntt.copy``                           drivers
``ntt.pass.<pass>``                    elementwise passes
``ntt.launch.<wrapper>``               kernels
=====================================  ====================

A window without an ``ntt.api`` span comes from a program without the
spans: :func:`of` gives None there, and the readers give no reading.
"""

from __future__ import annotations

import collections

PREFIX = "ntt."
API = "ntt.api"
RUNNER_BUILD = "ntt.runner.build"
_LAYERS = {API: "API", RUNNER_BUILD: "tables", "ntt.level": "drivers",
           "ntt.base": "drivers", "ntt.copy": "drivers"}
_PREFIX_LAYERS = (("ntt.pass", "elementwise passes"),
                  ("ntt.launch.", "kernels"))


def layer_of(name: str) -> str | None:
    """The layer of a program span's name; None for another name."""
    if name in _LAYERS:
        return _LAYERS[name]
    for prefix, layer in _PREFIX_LAYERS:
        if name.startswith(prefix):
            return layer
    return None


def self_intervals(spans) -> list:
    """(start, end, name) of each span's stretches outside its nested
    spans, from (start, end, name) spans nested as on one thread (a child
    running past its parent is cut at the parent's end)."""
    out, stack = [], []        # stack: [end, name, where its self resumes]
    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            end, top, cur = stack.pop()
            if cur < end:
                out.append((cur, end, top))
        if stack:
            parent = stack[-1]
            e = min(e, parent[0])
            if parent[2] < s:
                out.append((parent[2], s, parent[1]))
            parent[2] = max(parent[2], e)
        stack.append([e, name, s])
    while stack:
        end, top, cur = stack.pop()
        if cur < end:
            out.append((cur, end, top))
    return out


def overlap(a, b) -> float:
    """The length of the intersection of two sorted lists of disjoint
    intervals (start, end, ...)."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


class ProgramSpans:
    """The program spans of one traced window: their counts, their self
    time by layer and the device-idle time each layer's self intervals
    cover."""

    def __init__(self, view):
        spans = [s for s in view.spans if s[2].startswith(PREFIX)]
        self.counts = collections.Counter(name for _, _, name in spans)
        pieces = collections.defaultdict(list)
        for s, e, name in self_intervals(spans):
            pieces[layer_of(name)].append((s, e))
        self.pieces = {k: sorted(v) for k, v in pieces.items()}
        self.gaps = [view.gaps(card) for card in view.cards]

    def self_ms(self, layer: str) -> float:
        """Host ms in the layer's spans outside their nested spans."""
        return sum(e - s for s, e in self.pieces.get(layer, ())) / 1e3

    def idle_ms(self, layer: str) -> float:
        """Ms of the window with no operation on the card while the host
        was in the layer's self intervals (over several cards, the cards'
        mean)."""
        pieces = self.pieces.get(layer, [])
        return (sum(overlap(g, pieces) for g in self.gaps)
                / len(self.gaps) / 1e3)


def of(view) -> ProgramSpans | None:
    """The program spans of ``view`` (a ``trace.TraceView``), or None where
    its window holds no ``ntt.api`` span."""
    got = ProgramSpans(view)
    return got if got.counts[API] else None

"""The port's spans (``ntt_tpu_torch.tracing``): the names a transform
records under the PyTorch profiler and how they nest, the runner build on a
cache miss only, nothing recorded and ``record_function`` never called with
no profiler, the same words either way, and names apart from the
benchmark's own."""

import inspect
import pathlib
import re

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ntt_tpu_torch import api, tracing
from ntt_tpu_torch.fields import get_field
from ntt_tpu_torch.kernels import exchange, mxu_level, mxu_ntt, vmem_ntt

torch.set_num_threads(1)

#: the benchmark's own span names and prefix (``gpubench/trace.py``,
#: ``gpubench/harness.py``, ``gpubench/workload.py``), which no program
#: span may take
BENCH_NAMES = {"unit", "sync", "keep", "gpubench.window"}
BENCH_PREFIX = "step."

GOLD = get_field("goldilocks")
BLS = get_field("bls12-381-fr")


def _words(field, n, seed=1):
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(0, 1 << 32, (field.n_words, n), dtype=torch.int64,
                      generator=g)
    x[-1] %= field.p >> (32 * (field.n_words - 1))
    return x.to(torch.uint32)


def _traced(fn, *args, **kw):
    """``fn(*args, **kw)`` under the CPU profiler: (its result, the
    program's spans as (name, start, end) in the order they started)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn(*args, **kw)
    # the raw events: ``prof.events()`` builds a tree of every ATen op
    raw = prof.profiler.kineto_results.events()
    spans = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in raw if e.name().startswith("ntt.")),
                   key=lambda s: (s[1], -s[2]))
    return out, spans


def _inside(spans, inner: str, outer: str) -> bool:
    """Every ``inner`` span lies within some ``outer`` span."""
    outs = [(s, e) for name, s, e in spans if name == outer]
    return all(any(s0 <= s and e <= e0 for s0, e0 in outs)
               for name, s, e in spans if name == inner)


@pytest.mark.parametrize("op, field, log_n", [
    ("ntt", GOLD, 10), ("intt", GOLD, 10), ("coset_intt", GOLD, 11),
    ("ntt", BLS, 8), ("coset_intt", BLS, 8), ("coset_ntt", BLS, 8)])
def test_a_transform_records_its_layers(op, field, log_n):
    """The spans of a call whose runner is built, how they nest, and the
    same words as the call without the profiler."""
    x = _words(field, 1 << log_n)
    fn = getattr(api, op)
    plain = fn(x, field, device="cpu")               # the runner is built
    traced, spans = _traced(fn, x, field, device="cpu")
    assert torch.equal(plain, traced)
    names = [name for name, _, _ in spans]
    assert names[0] == "ntt.api" and names.count("ntt.api") == 1
    assert "ntt.runner.build" not in names
    assert names.count("ntt.level") >= 1 and names.count("ntt.base") == 1
    assert names.count("ntt.copy") >= names.count("ntt.level")
    for inner in ("ntt.level", "ntt.base", "ntt.copy", "ntt.pass.to_mont",
                  "ntt.pass.from_mont"):
        assert _inside(spans, inner, "ntt.api"), inner
    assert _inside(spans, "ntt.copy", "ntt.level")
    inverse = "intt" in op
    assert ("ntt.pass.scale" in names) == inverse
    assert _inside(spans, "ntt.pass.scale", "ntt.api")
    assert "ntt.pass.coset" not in names        # the coset rides level 0


def test_a_forward_coset_pass_is_its_own_span():
    """Where no four-step level takes the coset product (``naive``), it
    is a pass of its own, ``ntt.pass.coset``, inside the API span."""
    x = _words(GOLD, 1 << 6)
    _, spans = _traced(api.coset_ntt, x, GOLD, algorithm="naive",
                       device="cpu")
    names = [name for name, _, _ in spans]
    assert "ntt.pass.coset" in names
    assert _inside(spans, "ntt.pass.coset", "ntt.api")


def test_the_runner_build_is_recorded_on_a_miss_only(monkeypatch):
    monkeypatch.setattr(api, "_runner_cache", {})
    x = _words(GOLD, 1 << 10)
    _, first = _traced(api.ntt, x, GOLD, mont_io=True, device="cpu")
    _, second = _traced(api.ntt, x, GOLD, mont_io=True, device="cpu")
    assert [n for n, _, _ in first].count("ntt.runner.build") == 1
    assert _inside(first, "ntt.runner.build", "ntt.api")
    assert "ntt.runner.build" not in [n for n, _, _ in second]


def test_no_profiler_no_record_function(monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def counted(name):
        calls.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    x = _words(GOLD, 1 << 10)
    api.intt(x, GOLD, device="cpu")
    api.coset_intt(x, GOLD, device="cpu")
    assert calls == []
    assert tracing.span("ntt.api") is tracing.span("ntt.level")
    with profile(activities=[ProfilerActivity.CPU]):
        api.intt(x, GOLD, device="cpu")
    assert "ntt.api" in calls


def _source_names() -> set:
    """Every span name the program's source gives ``span`` or
    ``_chunked_pass``."""
    names = set()
    for path in pathlib.Path(tracing.__file__).parent.rglob("*.py"):
        text = path.read_text()
        names |= set(re.findall(r'span\("([^"]+)"\)', text))
        names |= set(re.findall(r'name="(ntt\.[^"]+)"', text))
    return names


def test_span_names_stay_apart_from_the_benchmarks():
    names = _source_names()
    assert {"ntt.api", "ntt.runner.build", "ntt.level", "ntt.base",
            "ntt.copy", "ntt.pass.to_mont", "ntt.pass.coset",
            "ntt.pass.scale", "ntt.pass.from_mont"} <= names
    for name in names:
        assert name.startswith("ntt."), name
        assert not name.startswith(BENCH_PREFIX) and name not in BENCH_NAMES


@pytest.mark.parametrize("module", [mxu_level, mxu_ntt, vmem_ntt, exchange])
def test_every_launching_wrapper_records_its_launch(module):
    """Each wrapper that counts its launches in ``_build.launches`` opens
    ``ntt.launch.<wrapper>`` around its CUDA branch, before the count."""
    found = 0
    for fn in vars(module).values():
        if not inspect.isfunction(fn) or fn.__module__ != module.__name__:
            continue
        name, src = fn.__name__, inspect.getsource(fn)
        if "_build.launches[" not in src:
            continue
        found += 1
        assert src.count(f'span("ntt.launch.{name}")') == 1, name
        head = src.split(f'span("ntt.launch.{name}")')[0]
        assert "_build.launches[" not in head, name
    assert found >= 1

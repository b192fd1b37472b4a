"""The readers of the program's spans on a synthetic timeline: self time by
layer, the idle gaps split over the layers by overlap, ``runner_builds``,
no reading without the spans, and ``TraceView``'s own readings unchanged
by them."""

import pytest

from gpubench import harness, spans
from gpubench.trace import TraceView

from test_gpubench_metrics import ann, dev, launch, op, run_of

#: the program's spans inside the step of one unit: the API span, a level
#: with a launch and a layout copy, the last base with a launch
PROGRAM = [
    ann("ntt.api", 22, 276),
    ann("ntt.level", 40, 160),
    ann("ntt.launch.fused_subntt", 50, 40),
    ann("ntt.copy", 120, 60),
    ann("ntt.base", 210, 70),
    ann("ntt.launch.fused_subntt", 220, 20),
]


def timeline(program=True):
    """A window of 1000 us holding one unit of one step; its kernels run
    at 100-140 (the level's), 180-200 (the copy) and 245-290 (the
    base's), so the gaps are 0-100, 140-180, 200-245 and 290-1000."""
    ev = [
        ann("gpubench.window", 0, 1000),
        ann("unit", 10, 380), ann("step.ntt", 20, 280),
        op("aten::contiguous", 125, 50),
        launch(1, 85), launch(2, 170), launch(3, 235),
        dev("void mxu::fused_subntt_wide_kernel<2>(int)", 1, 100, 40),
        dev("void at::native::elementwise_kernel<128, 2, direct_copy>()",
            2, 180, 20),
        dev("void mxu::fused_subntt_wide_kernel<2>(int)", 3, 245, 45),
    ]
    return ev + (PROGRAM if program else [])


def read(name, view, units=1):
    return harness.load_reader(name).read(run_of([1.0] * units, view=view))


def test_self_time_by_layer():
    s = spans.of(TraceView(timeline()))
    # API 22-40, 200-210, 280-298; level 40-50, 90-120, 180-200; copy
    # 120-180; base 210-220, 240-280; launches 50-90, 220-240
    assert s.self_ms("API") == pytest.approx(0.046)
    assert s.self_ms("drivers") == pytest.approx(0.170)
    assert s.self_ms("kernels") == pytest.approx(0.060)
    assert s.self_ms("tables") == 0
    v = TraceView(timeline())
    assert read("api_ms.ntt", v) == pytest.approx(0.046)
    assert read("driver_ms.ntt", v, units=2) == pytest.approx(0.085)
    assert read("launch_ms.ntt", v) == pytest.approx(0.060)


def test_idle_split_by_overlap():
    """The gap 0-100 straddles the API span, the level and its launch;
    200-245 the API span, the base and its launch: each gets its part."""
    v = TraceView(timeline())
    assert read("idle_api_ms.ntt", v) == pytest.approx(0.036)
    assert read("idle_driver_ms.ntt", v) == pytest.approx(0.075)
    assert read("idle_launch_ms.ntt", v) == pytest.approx(0.060)
    assert read("idle_pass_ms.hterm", v) == 0
    idle_ms = sum(e - s for s, e in v.gaps()) / 1e3
    assert 0.036 + 0.075 + 0.060 <= idle_ms


def test_a_pass_between_two_api_spans():
    ev = timeline(program=False) + [
        ann("ntt.api", 22, 100), ann("ntt.pass.scale", 60, 60),
        ann("ntt.api", 130, 160)]
    v = TraceView(ev)
    assert read("idle_pass_ms.hterm", v) == pytest.approx(0.040)
    assert read("idle_api_ms.ntt", v) == pytest.approx(
        0.038 + 0.040 + 0.045)


@pytest.mark.parametrize("extra, builds", [([], 0.0), (
    [ann("ntt.runner.build", 24, 10)], 1.0)])
def test_runner_builds_reads_zero_with_spans(extra, builds):
    v = TraceView(timeline() + extra)
    assert read("runner_builds.ntt", v) == builds
    assert read("runner_builds.hterm", v) == builds


@pytest.mark.parametrize("name", [
    "api_ms.ntt", "driver_ms.ntt", "launch_ms.ntt", "idle_api_ms.ntt",
    "idle_driver_ms.ntt", "idle_launch_ms.ntt", "idle_pass_ms.hterm",
    "runner_builds.ntt", "runner_builds.hterm"])
def test_no_reading_without_the_program_spans(name):
    assert read(name, TraceView(timeline(program=False))) is None
    assert read(name, TraceView(timeline())) is not None


def test_trace_view_readings_ignore_the_program_spans():
    a, b = TraceView(timeline(program=False)), TraceView(timeline())
    assert [(o.name, o.cls) for o in a.ops] == [(o.name, o.cls)
                                                for o in b.ops]
    for cls in ("port", "copy", "pass", "harness"):
        assert a.device_ms(cls) == b.device_ms(cls)
    assert a.span_ms("step.") == b.span_ms("step.")
    assert a.gaps() == b.gaps()
    assert a.breakdown() == b.breakdown()
    assert a.busy_s == b.busy_s and a.window_s == b.window_s


def test_a_child_past_its_parent_is_cut():
    got = spans.self_intervals([(0, 10, "ntt.api"), (5, 12, "ntt.level"),
                                (12, 14, "ntt.api")])
    assert sorted(got) == [(0, 5, "ntt.api"), (5, 10, "ntt.level"),
                           (12, 14, "ntt.api")]


@pytest.mark.parametrize("name, layer", [
    ("ntt.api", "API"), ("ntt.runner.build", "tables"),
    ("ntt.level", "drivers"), ("ntt.base", "drivers"),
    ("ntt.copy", "drivers"), ("ntt.pass.scale", "elementwise passes"),
    ("ntt.launch.fused_level_stack", "kernels"), ("step.ntt", None),
    ("unit", None)])
def test_layer_of(name, layer):
    assert spans.layer_of(name) == layer

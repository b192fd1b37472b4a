"""The metric arithmetic on synthetic windows and timelines: the window
rate, the 95th percentile over every sample, the idle share and the
device time by class from kernel intervals."""

import pytest

from gpubench import harness, roofline
from gpubench.trace import TraceView, is_library_kernel

T = {"pid": 1, "tid": 1}


def ann(name, ts, dur):
    return dict(T, cat="user_annotation", name=name, ts=ts, dur=dur)


def op(name, ts, dur):
    return dict(T, cat="cpu_op", name=name, ts=ts, dur=dur)


def launch(corr, ts):
    return dict(T, cat="cuda_runtime", name="cudaLaunchKernel", ts=ts,
                dur=2, args={"correlation": corr})


def dev(name, corr, ts, dur, cat="kernel", card=0):
    return {"pid": 0, "tid": 7, "cat": cat, "name": name, "ts": ts,
            "dur": dur, "args": {"correlation": corr, "device": card}}


#: a pass kernel of the program, launched inside the first step
PASS_KERNEL = [launch(7, 260),
               dev("void passes::field_pass_kernel<8, 1>(passes::Args)", 7,
                   300, 30)]


def timeline():
    """A window of 1000 us: two units, each one step; a port kernel, a
    layout copy, a pass, the harness's copy, a second port kernel, and one
    kernel launched after the window."""
    return [
        ann("gpubench.window", 0, 1000),
        ann("unit", 10, 390), ann("step.ntt", 20, 280),
        op("aten::contiguous", 100, 50), op("aten::clone", 105, 40),
        op("aten::mul", 200, 50),
        ann("keep", 410, 60), op("aten::clone", 440, 20),
        ann("unit", 500, 400), ann("step.ntt", 510, 290),
        launch(1, 30), launch(2, 120), launch(3, 210), launch(4, 450),
        launch(5, 520), launch(6, 1100),
        dev("void mxu::fused_subntt_wide_kernel<2>(int)", 1, 40, 100),
        dev("void at::native::elementwise_kernel<128, 2, direct_copy>()",
            2, 140, 50),
        dev("void at::native::vectorized_elementwise_kernel<4, Mul>()",
            3, 250, 40),
        dev("Memcpy DtoD (Device -> Device)", 4, 455, 10, "gpu_memcpy"),
        dev("void base_ntt_mxu_short_kernel<8>(int)", 5, 530, 200),
        dev("void base_ntt_mxu_short_kernel<8>(int)", 6, 1110, 200),
    ]


def test_classes_busy_and_idle():
    v = TraceView(timeline())
    assert [o.cls for o in v.ops] == ["port", "copy", "pass", "harness",
                                     "port"]
    assert v.device_ms("port") == pytest.approx(0.3)
    assert v.device_ms("copy") == pytest.approx(0.05)
    assert v.device_ms("pass") == pytest.approx(0.04)
    assert v.window_s == pytest.approx(1e-3)
    assert v.busy_s == pytest.approx(400e-6)
    assert v.idle_share() == pytest.approx(0.6)
    assert v.gaps() == [(0, 40), (190, 250), (290, 455), (465, 530),
                        (730, 1000)]
    assert v.span_ms("step.") == pytest.approx(0.57)


def test_overlapping_operations_count_once():
    ev = [ann("gpubench.window", 0, 100), ann("step.ntt", 0, 100),
          launch(1, 1), launch(2, 2),
          dev("void k1()", 1, 10, 50), dev("void k2()", 2, 30, 50)]
    v = TraceView(ev)
    assert v.busy_s == pytest.approx(70e-6)
    assert v.device_ms("port") == pytest.approx(0.1)


def test_breakdown_names_gaps_by_host_activity():
    b = TraceView(timeline()).breakdown()
    gaps = dict(b["idle_gaps"])
    assert gaps["step.ntt > aten::mul"] == pytest.approx(60e-6)
    assert gaps["unit > python"] == pytest.approx((165 + 270) * 1e-6)
    assert gaps["loop > python"] == pytest.approx(65e-6)
    ops = dict(b["device_ops"])
    assert ops["port base_ntt_mxu_short_kernel<8>"] == pytest.approx(200e-6)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_cards_are_read_apart():
    """Over two cards each card's busy time and gaps are its own; busy
    time and idle share are the cards' mean; on one timeline (cards None)
    the operations of both cards merge, as on one card."""
    ev = [ann("gpubench.window", 0, 100), ann("step.ntt", 0, 100),
          launch(1, 0), launch(2, 1), launch(3, 2),
          dev("void k1()", 1, 10, 50, card=0),
          dev("void k2()", 2, 30, 50, card=1),
          dev("void k3()", 3, 90, 10, card=1)]
    v = TraceView(ev, cards=[0, 1])
    assert v.card_busy_s == pytest.approx({0: 50e-6, 1: 60e-6})
    assert v.busy_s == pytest.approx(55e-6)
    assert v.idle_share() == pytest.approx(0.45)
    assert v.card_idle_shares() == pytest.approx({0: 0.5, 1: 0.4})
    assert v.gaps(0) == [(0, 10), (60, 100)]
    assert v.gaps(1) == [(0, 30), (80, 90)]
    gaps = dict(v.breakdown()["idle_gaps"])
    assert gaps["step.ntt > python"] == pytest.approx(45e-6)
    one = TraceView(ev)
    assert one.busy_s == pytest.approx(80e-6)
    assert one.gaps() == [(0, 10), (80, 90)]
    # a card with no operation is idle all the window
    assert TraceView(ev, cards=[0, 1, 2]).card_idle_shares()[2] == 1.0


def test_window_span_required():
    with pytest.raises(ValueError):
        TraceView([ann("unit", 0, 10)])


def test_four_cards_roofline_and_kernel_names():
    """Over four cards the roofline takes the least time on all four (the
    exchange at BLS 2^30) over the cards' mean busy time; a kernel in an
    anonymous namespace keeps its name in the breakdown."""
    ev = [ann("gpubench.window", 0, 1e6), ann("step.dist_ntt", 0, 1e6)]
    for card in range(4):
        ev += [launch(card + 1, card),
               dev("void (anonymous namespace)::a2a_pull_kernel<8>(int)",
                   card + 1, 0, 5e5, card=card)]
    v = TraceView(ev, cards=[0, 1, 2, 3])
    assert v.busy_s == pytest.approx(0.5)
    win = harness.Window(10, 1.0, [1.0] * 10, 10 << 30)
    run = harness.Run(1 << 30, 32, win, 1.0, 1, 0.0, 0, v, 4)
    least, by = roofline.least_time(1 << 30, 32, 4)
    assert by == "exchange"
    assert read("ntt_roofline", run) == pytest.approx(100 * least * 10 / 0.5)
    assert dict(v.breakdown()["device_ops"]) == pytest.approx(
        {"port a2a_pull_kernel<8>": 2.0})


def test_library_names():
    assert is_library_kernel("void at::native::vectorized_elementwise_kernel")
    assert is_library_kernel("sm90_xmma_gemm_s8s8_s32")
    assert not is_library_kernel("void fused_level_stack_kernel<8, 1>(int)")


def run_of(latencies, seconds=2.0, n=1 << 10, view=None, points=None):
    units = len(latencies)
    win = harness.Window(units, seconds, latencies,
                         units * n if points is None else points)
    return harness.Run(n, 32, win, 12.5, 3 << 30, 1.5, 5 * units,
                       view)


def read(name, run):
    return harness.load_reader(name).read(run)


def test_window_rates():
    run = run_of([1.0] * 400, seconds=2.0, n=1 << 20)
    assert read("ntt_gelem_s", run) == pytest.approx(400 * 2 ** 20 / 2e9)
    assert read("hterm_ms", run) == pytest.approx(5.0)
    assert read("peak_gib", run) == 3.0
    assert read("setup_s", run) == 12.5
    assert read("tables_s", run) == 1.5
    assert read("launches.ntt", run) == 5.0


@pytest.mark.parametrize("count, want", [(100, 95), (20, 19), (1, 1),
                                         (1000, 950)])
def test_p95_over_every_sample(count, want):
    lat = [float(i) for i in range(count, 0, -1)]      # any order
    assert read("ntt_p95_ms", run_of(lat)) == want


def test_layer_readers():
    v = TraceView(timeline())
    run = run_of([1.0, 1.0], view=v, n=1 << 22)
    assert read("kernel_ms.ntt", run) == pytest.approx(0.15)
    assert read("kernel_ms.hterm", run) == pytest.approx(0.15)
    assert read("copy_ms.ntt", run) == pytest.approx(0.025)
    assert read("pass_ms.hterm", run) == pytest.approx(0.02)
    assert read("idle_pct.ntt", run) == pytest.approx(60.0)
    assert read("host_ms.ntt", run) == pytest.approx(0.285)
    least, _ = roofline.least_time(1 << 22, 32)
    assert read("ntt_roofline", run) == pytest.approx(
        100 * least * 2 / 400e-6)
    # the program's pass kernels, by name, with the PyTorch pass: (40 +
    # 30) us over two units; they read under kernel_ms too
    run = run_of([1.0, 1.0], view=TraceView(timeline() + PASS_KERNEL),
                 n=1 << 22)
    assert read("pass_ms.hterm", run) == pytest.approx(0.035)
    assert read("kernel_ms.hterm", run) == pytest.approx(0.165)


def test_readers_find_nothing_to_read():
    ev = [ann("gpubench.window", 0, 100), ann("step.ntt", 0, 100),
          launch(1, 1), dev("void k1()", 1, 10, 50)]
    run = run_of([1.0], view=TraceView(ev))
    assert read("copy_ms.ntt", run) is None
    assert read("pass_ms.hterm", run) is None
    passes = run_of([1.0], view=TraceView(ev + [launch(7, 5), dev(
        "void passes::field_pass_kernel<2, 0>(passes::Args)", 7, 60, 30)]))
    assert read("pass_ms.hterm", passes) == pytest.approx(0.03)
    run.launches, run.tables_s = 0, 0.0
    assert read("launches.ntt", run) is None
    assert read("tables_s", run) is None


def test_a_dotted_metric_falls_back_to_its_base_reader(tmp_path):
    assert harness.load_reader("kernel_ms.hterm").__file__.endswith(
        "kernel_ms.py")
    (tmp_path / "x_ms.py").write_text("def read(run):\n    return 1\n")
    (tmp_path / "x_ms.a.py").write_text("def read(run):\n    return 2\n")
    assert harness.load_reader("x_ms.a", str(tmp_path)).read(None) == 2
    assert harness.load_reader("x_ms.b", str(tmp_path)).read(None) == 1


def test_quarter_means():
    from gpubench.workload import quarter_means
    starts = [0.0, 0.1, 0.3, 0.6, 0.7, 0.99]
    assert quarter_means(starts, [1, 3, 5, 7, 9, 11], 1.0) == [
        2.0, 5.0, 8.0, 11.0]
    assert quarter_means([0.1], [4.0], 1.0) == [4.0, None, None, None]


class _Sink:
    def __init__(self):
        self.calls = []

    def call(self, op, x):
        self.calls.append(op)
        return x + 1


@pytest.mark.parametrize("sync_every", [1, 3])
def test_measure_times_every_unit_on_the_host_clock(sync_every):
    import contextlib
    import torch
    from gpubench.workload import Traffic
    t = Traffic("t", ("x",), 2, (("ntt", ("x",), "y"),), "y", 2,
                sync_every=sync_every)
    pool = [torch.zeros(2, 4), torch.ones(2, 4)]
    keep = harness._Keep(2, 7)
    ex = _Sink()
    win = harness.measure(ex, t, pool, 0.05,
                          harness.waiter([torch.device("cpu")]), keep,
                          lambda name: contextlib.nullcontext(), 8)
    assert win.units == len(ex.calls) == len(win.latencies_ms)
    assert len(win.starts_s) == win.units and win.points == 8 * win.units
    assert all(0 <= ms <= 1e3 * win.seconds for ms in win.latencies_ms)
    assert len(keep.items) == min(2, win.units)

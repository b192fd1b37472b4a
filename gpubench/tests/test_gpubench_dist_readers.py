"""The readers of the four-card cell on a synthetic four-card timeline: K8
found by name and summed over the cards (``exchange_ms``), its share of the
exchange's least time a card (``exchange_roofline``), the host self time
of the distributed steps' spans and the cards' idle time under them
(``dist_ms``, ``idle_dist_ms``), none of the span readings without an
``ntt.api`` span; and the cell itself, run on four CPU devices."""

import pytest

from gpubench import harness, roofline
from gpubench.trace import TraceView

from test_gpubench_metrics import ann, dev, launch

CELL = "bls381-ntt-2e30-dist4"
N = 1 << 20

#: the program's spans of one forward transform: the API span; the local
#: column transform with its launch, the step-2 product with its launch,
#: the exchange with K8's launch, a local transpose, the row transform
PROGRAM = [
    ann("ntt.api", 20, 780),
    ann("ntt.dist.local", 30, 100),
    ann("ntt.launch.fused_subntt", 60, 40),
    ann("ntt.dist.twiddle", 130, 30),
    ann("ntt.launch.mont_mul", 140, 15),
    ann("ntt.dist.exchange", 200, 100),
    ann("ntt.launch.a2a_transpose", 220, 60),
    ann("ntt.copy", 300, 30),
    ann("ntt.dist.local", 330, 100),
]

#: K8's time on each card, us
K8_US = (200, 150, 100, 50)


def timeline(program=True, k8=True):
    """A window of 1000 us holding one unit of one step; on each card K3
    runs at 100-200 and K8 from 300 for ``K8_US``, so card d's gaps are
    0-100, 200-300 and 300 + K8_US[d] to 1000."""
    ev = [ann("gpubench.window", 0, 1000), ann("unit", 5, 900),
          ann("step.dist_ntt", 10, 880)]
    for card, k8_us in enumerate(K8_US):
        ev += [launch(2 * card + 1, 60),
               dev("void mxu::fused_subntt_kernel<8, 1>(int)", 2 * card + 1,
                   100, 100, card=card)]
        name = ("void (anonymous namespace)::a2a_pull_kernel<8>(int)" if k8
                else "void mxu::fused_level_kernel<8>(int)")
        ev += [launch(2 * card + 2, 250),
               dev(name, 2 * card + 2, 300, k8_us, card=card)]
    return ev + (PROGRAM if program else [])


def run_of(view, units=1):
    win = harness.Window(units, 1e-3, [1.0] * units, units * N)
    return harness.Run(N, 32, win, 12.5, 3 << 30, 1.5, 5 * units, view, 4)


def read(name, run):
    return harness.load_reader(name).read(run)


def test_k8_by_name_summed_over_the_cards():
    v = TraceView(timeline(), cards=[0, 1, 2, 3])
    assert read("exchange_ms.dist", run_of(v)) == pytest.approx(0.5)
    assert read("exchange_ms.dist", run_of(v, units=2)) == pytest.approx(
        0.25)
    other = TraceView(timeline(k8=False), cards=[0, 1, 2, 3])
    assert read("exchange_ms.dist", run_of(other)) is None
    assert read("exchange_roofline.dist", run_of(other)) is None


def test_exchange_share_a_card():
    """The least time, (D−1)/D²·n·d bytes at NVLink's rate, over K8's
    500 us of four cards: 125 us a card a transform."""
    v = TraceView(timeline(), cards=[0, 1, 2, 3])
    least = roofline.exchange_bytes(N, 32, 4) / roofline.NVLINK_BYTES_PER_S
    got = read("exchange_roofline.dist", run_of(v))
    assert got == pytest.approx(100 * least / 125e-6)
    assert 0 < got <= 100
    # the same K8 time over two transforms: half the time a transform a
    # card, twice the share
    assert read("exchange_roofline.dist", run_of(v, units=2)) == (
        pytest.approx(got * 2))
    # four shards of one card: nothing crosses NVLink
    one = TraceView(timeline(), cards=[0])
    assert read("exchange_roofline.dist", run_of(one)) is None


def test_dist_self_time_and_idle_by_card():
    """Self intervals of the ``ntt.dist.*`` spans: 30-60, 100-130, 130-140,
    155-160, 200-220, 280-300, 330-430 (215 us). The gaps each card
    shares, 0-100 and 200-300, overlap 70 of them; card 2's last gap,
    400-1000, 30 more, card 3's, 350-1000, 80: a mean of 97.5 us."""
    v = TraceView(timeline(), cards=[0, 1, 2, 3])
    assert read("dist_ms.dist", run_of(v)) == pytest.approx(0.215)
    assert read("idle_dist_ms.dist", run_of(v)) == pytest.approx(0.0975)
    assert read("idle_dist_ms.dist", run_of(v, units=3)) == pytest.approx(
        0.0325)
    # the API's own time leaves out the distributed steps and the copy,
    # 30-160 and 200-430 of its 20-800
    assert read("api_ms.dist", run_of(v)) == pytest.approx(0.42)
    assert read("runner_builds.dist", run_of(v)) == 0.0


@pytest.mark.parametrize("name", ["dist_ms.dist", "idle_dist_ms.dist",
                                  "runner_builds.dist"])
def test_no_reading_without_the_api_span(name):
    """A program whose distributed entries open no span: no reading, no
    error; the device readers still read."""
    v = TraceView(timeline(program=False), cards=[0, 1, 2, 3])
    assert read(name, run_of(v)) is None
    assert read("exchange_ms.dist", run_of(v)) == pytest.approx(0.5)
    assert read("ntt_roofline.dist", run_of(v)) is not None
    assert read("tables_s.dist", run_of(v)) == 1.5


def test_the_cell_runs_on_four_cpu_devices(monkeypatch):
    """The cell's configuration, mix and operation at 2^12 over four CPU
    devices, 256 outputs checked: correct, every metric of its own read."""
    monkeypatch.setattr(harness, "CHECK_POINTS", 256)
    r = harness.run_cell(CELL, 2 ** 33 + 11, 0.05, False,
                         devices=["cpu"] * 4, log_n=12)
    assert r["correct"] is True
    assert r["checks"]["mismatched_elements"]["value"] == 0
    assert r["notes"]["elements_checked"] == 256
    assert {"ntt_gelem_s", "ntt_p95_ms", "peak_gib", "setup_s"} <= set(
        r["metrics"])
    assert r["device"]["count"] == 4

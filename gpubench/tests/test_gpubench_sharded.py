"""A cell over several cards, on the CPU at a small domain: the layouts of
the sharded transform against the program's own, the pool made card by
card, the check in blocks against the full reference, and whole runs over
four CPU devices with the program sound, the control in its place, and a
program that swaps two cards' outputs. The one-card pool keeps its words."""

import hashlib
import json

import pytest
import torch

from gpubench import harness, workload
from gpubench.program import Program
from gpubench.reference.ops import field_of, for_config

BENCH = harness.load_benchmark()
CONFIG = harness.load_config(BENCH, {"config": "groth16-bls12-381-2e22"})
FIELD = field_of(CONFIG)
SEED = 2 ** 33 + 7          # wider than 32 signed bits, as run seeds may be
OP = workload.load_op("dist_ntt")


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def vector(n, seed=5):
    return workload.make_vector(FIELD.p, (FIELD.words, n), seed, 0, "cpu")


@pytest.mark.parametrize("log_n, S, r", [(10, 1, 0), (10, 4, 3), (11, 8, 5),
                                         (12, 16, 0), (12, 2, 1)])
def test_blocked_reference_is_the_full_one_at_its_indices(log_n, S, r):
    n = 1 << log_n
    M = n // S
    ref = for_config(CONFIG, "cpu")
    x = vector(n)
    full = ref.ntt(x)
    blocks = (x[:, M * b:M * (b + 1)] for b in range(S))
    got = ref.ntt_residue(blocks, n, S, r)
    assert torch.equal(got.to(torch.int64), full[:, r::S].to(torch.int64))


def test_blocked_reference_wants_every_block():
    ref = for_config(CONFIG, "cpu")
    x = vector(1 << 10)
    with pytest.raises(ValueError):
        ref.ntt_residue((x[:, 256 * b:256 * (b + 1)] for b in range(3)),
                        1 << 10, 4, 1)


@pytest.mark.parametrize("log_n, D", [(10, 4), (11, 2), (12, 4)])
def test_layouts_are_the_programs(log_n, D):
    """Card d's block of the declared input layout is the program's shard
    d of the natural-order vector, and the declared output layout places
    X[k] where the program's ``unshard`` reads it; ``locate`` inverts
    ``index``."""
    from ntt_tpu_torch.fields import get_field
    from ntt_tpu_torch.parallel import make_mesh, shard_for_ntt, unshard
    n, W = 1 << log_n, FIELD.words
    x = vector(n)
    shards = shard_for_ntt(x, get_field("bls12-381-fr"),
                           make_mesh(["cpu"] * D))
    for layout in (OP.input_layout(W, n, D), OP.output_layout(W, n, D)):
        size = n // D
        for d in range(D):
            g = layout.index(d, torch.arange(size))
            assert sorted(set(g.tolist())) == sorted(g.tolist())
            cards, pos = layout.locate(g)
            assert torch.equal(cards, torch.full_like(g, d))
            assert torch.equal(pos, torch.arange(size))
    inp = OP.input_layout(W, n, D)
    for d, s in enumerate(shards):
        assert s.shape == inp.shape
        g = inp.index(d, torch.arange(n // D))
        assert torch.equal(s.reshape(W, -1).to(torch.int64),
                           x[:, g].to(torch.int64))
    out = OP.output_layout(W, n, D)
    ys = [torch.arange(n // D, dtype=torch.int64).reshape(out.shape[1:])
          + d * (n // D) for d in range(D)]       # each element its place
    flat = unshard([y[None].to(torch.int32).view(torch.uint32) for y in ys])
    for d in range(D):
        k = out.index(d, torch.arange(n // D))
        assert torch.equal(flat[0, k].to(torch.int64),
                           ys[d].reshape(-1))


def test_pool_made_card_by_card():
    shape = OP.input_layout(FIELD.words, 1 << 10, 4).shape
    a = [workload.make_shard(FIELD.p, shape, SEED, 1, d, "cpu")
         for d in range(4)]
    again = workload.make_shard(FIELD.p, shape, SEED, 1, 2, "cpu")
    assert torch.equal(a[2].to(torch.int64), again.to(torch.int64))
    assert not torch.equal(a[0].to(torch.int64), a[1].to(torch.int64))
    top = FIELD.p >> (32 * (FIELD.words - 1))
    for s in a:
        assert s.shape == shape and s.dtype == torch.uint32
        assert int(s[-1].to(torch.int64).max()) < top


#: the pool's words at the parent, for the seed SEED at 2^8 (sha256)
POOL_DIGESTS = {
    "bls381-hterm-2e22":
        "96d0e94d3b607e8711cd3732c915f893a692ebd4173493e07bb18805ae3d69dd",
    "goldilocks-ntt-2e24":
        "7227bb662049e9d19e418b2df3fedb21164a840679917e94488b0c3e43c69317",
    "bls381-cosetfft-2e22":
        "96d0e94d3b607e8711cd3732c915f893a692ebd4173493e07bb18805ae3d69dd",
}


@pytest.mark.parametrize("cell", sorted(POOL_DIGESTS))
def test_one_card_pool_keeps_its_words(cell):
    _, _, traffic, n, field = harness.cell_parts(BENCH, cell, 8)
    pool = harness.make_pool(traffic, field, n, SEED, torch.device("cpu"))
    h = hashlib.sha256()
    for v in pool:
        h.update(v.numpy().tobytes())
    assert h.hexdigest() == POOL_DIGESTS[cell]


class SwapShards(Program):
    """The sharded transform with two cards' outputs swapped."""

    def call(self, op, *xs):
        y = list(super().call(op, *xs))
        y[0], y[1] = y[1], y[0]
        return y


@pytest.fixture
def trial_cell(tmp_path, monkeypatch):
    """A cell of four cards, not in BENCHMARK.json: BLS12-381 Fr at 2^10,
    the forward transform sharded, its files in ``tmp_path``, 256 outputs
    checked of each kept unit."""
    config = dict(CONFIG, name="bls-2e10-dist4", log_n=10, local="mxu_sub",
                  exchange="pallas")
    (tmp_path / "config.json").write_text(json.dumps(config))
    (tmp_path / "dist.json").write_text(json.dumps({
        "inputs": ["x"], "pool_slots": 2, "check_units": 2,
        "steps": [{"op": "dist_ntt", "args": ["x"], "out": "y"}],
        "output": "y"}))
    monkeypatch.setattr(workload, "TRAFFIC_DIR", str(tmp_path))
    monkeypatch.setattr(harness, "CHECK_POINTS", 256)
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "bls-2e10-dist4", "source": "test",
                             "file": str(tmp_path / "config.json"),
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "dist4", "config": "bls-2e10-dist4",
                               "traffic": "dist", "chips": 4, "why": "test"})
    return bench


EXECUTORS = {
    "program": (None, True),
    "reference": (lambda c, t, ds: for_config(c, ds[0]), True),
    "control": (lambda c, t, ds: for_config(c, ds[0], lazy=True), False),
    "swap": (lambda c, t, ds: SwapShards(c["field"], c["coset_shift"], ds,
                                         t.mont_io, options=c), False),
}


@pytest.mark.parametrize("executor", sorted(EXECUTORS))
def test_sharded_run(trial_cell, executor):
    """A run over four CPU devices: correct with the program and with the
    exact reference in its place (the control's four-step is sound but
    for its product), not with the control or the swapped shards."""
    make, correct = EXECUTORS[executor]
    r = harness.run_cell("dist4", SEED, 0.05, False, devices=["cpu"] * 4,
                         bench=trial_cell, make_executor=make)
    assert r["correct"] is correct
    checks = r["checks"]
    assert (checks["mismatched_elements"]["value"] == 0) is correct
    kept = checks["outputs_checked"]["value"]
    assert kept >= 1 and r["notes"]["elements_checked"] == kept * 256
    assert r["device"]["count"] == 4 and list(r)[-1] == "checks"
    assert r["notes"]["bounded_by"] == "exchange"


def test_sharded_cell_takes_one_sharded_step(trial_cell):
    mixed = workload.Traffic("m", ("x",), 1, (("ntt", ("x",), "y"),), "y", 1)
    with pytest.raises(ValueError):
        harness.sharding(mixed, 8, 1 << 10, [torch.device("cpu")] * 4)
    with pytest.raises(ValueError):
        harness.run_cell("dist4", SEED, 0.05, False, devices=["cpu"] * 2,
                         bench=trial_cell)


DIST_MIX = workload.Traffic("d", ("x",), 1, (("dist_ntt", ("x",), "y"),),
                            "y", 1)


def test_checked_outputs_lie_on_every_card(monkeypatch):
    cpu4 = [torch.device("cpu")] * 4
    # 2^10 = 32 x 32, k1 in blocks of 8 a card: S = 16 reaches two cards
    monkeypatch.setattr(harness, "CHECK_POINTS", 1 << 6)
    with pytest.raises(ValueError):
        harness.sharding(DIST_MIX, 8, 1 << 10, cpu4)
    # 2^12 = 64 x 64, blocks of 16: S = 16 reaches all four
    monkeypatch.setattr(harness, "CHECK_POINTS", 1 << 8)
    sh = harness.sharding(DIST_MIX, 8, 1 << 12, cpu4)
    for r in (0, sh.S - 1):
        cards, _ = sh.checked(r)
        assert sorted(torch.unique(cards).tolist()) == [0, 1, 2, 3]


def test_control_four_step_in_chunks(monkeypatch):
    """The plain four-step gives the same words in chunks of a few columns
    as in one chunk, and they are the full reference's, laid out as the
    output layout says."""
    n, D = 1 << 10, 4
    ref = for_config(CONFIG, "cpu")
    inp, out = OP.input_layout(FIELD.words, n, D), OP.output_layout(
        FIELD.words, n, D)
    x = vector(n)
    shards = [x[:, inp.index(d, torch.arange(n // D))].reshape(inp.shape)
              for d in range(D)]
    whole = OP.reference(ref, shards)
    monkeypatch.setattr(OP, "CHUNK", 64)
    chunked = OP.reference(ref, shards)
    full = ref.ntt(x).to(torch.int64)
    for d in range(D):
        assert torch.equal(whole[d].to(torch.int64),
                           chunked[d].to(torch.int64))
        k = out.index(d, torch.arange(n // D))
        assert torch.equal(chunked[d].reshape(FIELD.words, -1).to(
            torch.int64), full[:, k])

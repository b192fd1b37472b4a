"""The distributed four-step's step-2 table generated on each shard's
device (``parallel.dist_ntt.shard_twiddle`` through ``core.power_table``
above ``core.HOST_TW_LIMIT`` entries), on the CPU with the limit patched
low so that the generator engages at small sizes: the same words as the
host-built table, no host table above the limit, and the transform
word-equal to the unpatched one and to the benchmark's plain reference
(``gpubench/reference``: its textbook transform and the blocked form the
benchmark checks a sharded output with)."""

import importlib

import numpy as np
import pytest
import torch

from gpubench.reference.ops import Reference
from ntt_tpu_torch.fields import get_field
from ntt_tpu_torch.parallel import dist_ntt, make_mesh, shard_for_ntt, unshard
from ntt_tpu_torch.transforms import core

# the module (the package's name dist_ntt is the function)
tdist = importlib.import_module("ntt_tpu_torch.parallel.dist_ntt")

torch.set_num_threads(1)

FIELDS = ["bls12-381-fr", "goldilocks"]
#: a limit below every shard's table at the sizes here
LOW = 1 << 6


def _words(field, n, seed):
    """Canonical random elements as uint32[W, n] (top word < p's)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(0, 1 << 32, (field.n_words, n), dtype=torch.int64,
                      generator=g)
    x[-1] %= field.p >> (32 * (field.n_words - 1))
    return x.to(torch.uint32)


@pytest.fixture
def generated(monkeypatch):
    """The limit patched low; the sizes of the host-built power tables and
    the calls of the device generator, recorded; a fresh runner cache."""
    monkeypatch.setattr(core, "HOST_TW_LIMIT", LOW)
    monkeypatch.setattr(tdist, "_dist_cache", {})
    seen = {"host": [], "device": 0}
    host, device = core.host_power_matrix, core.power_matrix_chunked

    def host_counted(field, base, n1, n2):
        seen["host"].append(n1 * n2)
        return host(field, base, n1, n2)

    def device_counted(*args, **kw):
        seen["device"] += 1
        return device(*args, **kw)

    monkeypatch.setattr(core, "host_power_matrix", host_counted)
    monkeypatch.setattr(core, "power_matrix_chunked", device_counted)
    return seen


@pytest.mark.parametrize("log_n, D", [(12, 4), (14, 4), (13, 2)])
@pytest.mark.parametrize("fname", FIELDS)
def test_generated_step2_table_is_the_host_built_one(generated, fname,
                                                     log_n, D):
    """Every shard's ω^{k1·(d·n2_loc + j)}, generated on its device, has
    the words of the host-built static table times the shard's column, and
    of the slice of the full host-built decomposition twiddle."""
    f, n = get_field(fname), 1 << log_n
    n1, n2 = core.split_log(n)
    n2_loc = n2 // D
    omega = f.root_of_unity(n)
    Ts = core.host_power_matrix(f, omega, n1, n2_loc)
    full = core.host_power_matrix(f, omega, n1, n2)
    for d in range(D):
        got = tdist.shard_twiddle(f, omega, n1, n2_loc, d, "cpu")
        host = tdist.shard_twiddle(f, omega, n1, n2_loc, d, "cpu", Ts)
        assert torch.equal(got, host)
        assert np.array_equal(got.numpy(),
                              full[:, :, d * n2_loc:(d + 1) * n2_loc])
    assert generated["device"] == D


@pytest.mark.parametrize("fname", FIELDS)
def test_no_host_table_above_the_limit(generated, fname):
    """Above the limit ``make_dist_ntt`` builds every shard's step-2
    table on the shard's device and none on the host; at or below it one
    host table serves every shard."""
    f, D = get_field(fname), 4
    mesh = make_mesh(["cpu"] * D)
    tdist.make_dist_ntt(f, 1 << 12, mesh, algorithm="mxu_sub",
                        exchange="pallas")
    assert generated["device"] == D
    assert all(size <= LOW for size in generated["host"])
    generated["host"].clear()
    generated["device"] = 0
    tdist.make_dist_ntt(f, 1 << 8, mesh, algorithm="mxu_sub",
                        exchange="pallas")       # 16 x 4 entries a shard
    assert generated["device"] == 0 and generated["host"] == [16 * 4]


@pytest.mark.parametrize("fname, log_n", [("bls12-381-fr", 12),
                                          ("goldilocks", 13)])
def test_dist_ntt_on_generated_tables_is_the_reference(monkeypatch, fname,
                                                       log_n):
    """The forward transform over four CPU shards, its step-2 tables
    generated, against the unpatched transform, the plain reference's
    textbook transform and its blocked form at r + S·t."""
    f, n = get_field(fname), 1 << log_n
    mesh = make_mesh(["cpu"] * 4)
    x = _words(f, n, log_n)

    def run():
        monkeypatch.setattr(tdist, "_dist_cache", {})
        y = dist_ntt(shard_for_ntt(x, f, mesh), f, mesh, n,
                     algorithm="mxu_sub", exchange="pallas")
        return unshard(y)

    plain = run()
    monkeypatch.setattr(core, "HOST_TW_LIMIT", LOW)
    got = run()
    assert torch.equal(got, plain)
    ref = Reference(f.p, f.generator, f.generator, "cpu")
    want = ref.ntt(x)
    assert torch.equal(got.to(torch.int64), want.to(torch.int64))
    S, r = 8, 5
    M = n // S
    blocks = (x[:, M * b:M * (b + 1)] for b in range(S))
    at = ref.ntt_residue(blocks, n, S, r)
    assert torch.equal(got[:, r::S].to(torch.int64), at.to(torch.int64))

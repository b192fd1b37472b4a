"""The multi-device four-step of the port (``ntt_tpu_torch.parallel``) and
its exchange kernel K8 (plain version) against ntt_tpu on the CPU.

K8 a2a_transpose <- ntt_tpu.kernels.exchange.a2a_transpose (inside
                    shard_map, Pallas interpret mode on the 8-device CPU mesh)
make_dist_ntt    <- ntt_tpu.parallel.make_dist_ntt

A port mesh here names the CPU D times: D logical shards, the kernels'
plain versions. Two cases go through JAX's distributed path (its compiles
are the expensive part of tests/test_parallel.py); the others mirror
tests/test_parallel.py case by case against the pure-Python golden model
``ntt_tpu.oracle``. Canonical Montgomery words out: the tolerance is exact
equality everywhere.
"""

import importlib

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import ntt_tpu as nt
from ntt_tpu import limbs as jlimbs
from ntt_tpu import oracle
from ntt_tpu.kernels.exchange import a2a_transpose as j_a2a_transpose
from ntt_tpu.parallel import make_dist_ntt as j_make_dist_ntt
from ntt_tpu.parallel import make_mesh as j_make_mesh
from ntt_tpu.parallel import shard_for_ntt as j_shard_for_ntt
from ntt_tpu.parallel import unshard as j_unshard
from ntt_tpu.transforms import core as jcore
import ntt_tpu_torch as tnt
from ntt_tpu_torch import limbs as tlimbs
from ntt_tpu_torch.kernels import _build, exchange
from ntt_tpu_torch.parallel import (dist_intt, dist_lde, dist_ntt,
                                    exchange_options, make_dist_ntt,
                                    make_mesh, shard_for_ntt, unshard)
from ntt_tpu_torch.transforms import core as tcore

# the module (the package's name dist_ntt is the function)
tdist = importlib.import_module("ntt_tpu_torch.parallel.dist_ntt")

torch.set_num_threads(1)


def _mesh(D):
    return make_mesh(["cpu"] * D)


def _words(field, shape, seed):
    """Canonical random elements as uint32[W, *shape] (top word < p's)."""
    rng = np.random.default_rng(seed)
    W = field.n_words
    x = rng.integers(0, 1 << 32, size=(W,) + shape, dtype=np.uint64)
    x[W - 1] = rng.integers(0, field.p >> (32 * (W - 1)), size=shape,
                            dtype=np.uint64)
    return x.astype(np.uint32)


def _dist(f, vals, D, **kw):
    """The port's distributed transform of the ints ``vals`` (Montgomery
    I/O inside), back as ints."""
    mesh = _mesh(D)
    xs = shard_for_ntt(tlimbs.to_mont(tnt.from_ints(vals, f), f), f, mesh)
    y = make_dist_ntt(f, len(vals), mesh, **kw)(xs)
    return tnt.to_ints(tlimbs.from_mont(unshard(y), f), f)


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------

def test_a2a_plain_equals_jax_a2a_transpose():
    """K8's plain version against the JAX kernel inside shard_map on 4 CPU
    devices (interpret mode): SMALL, n = 256, C uint32[1, 16, 4] a shard."""
    f, D, n1, n2 = nt.SMALL, 4, 16, 16
    C = _words(f, (n1, n2), 80)
    jmesh = j_make_mesh(jax.devices()[:D])
    mapped = jax.jit(jax.shard_map(
        lambda c: j_a2a_transpose(c, "ntt", D), mesh=jmesh,
        in_specs=P(None, None, "ntt"), out_specs=P(None, "ntt", None),
        check_vma=False))
    want = np.asarray(mapped(C))                  # shard t: rows t*n1/D ..
    n2_loc = n2 // D
    shards = [torch.from_numpy(C[:, :, s * n2_loc:(s + 1) * n2_loc].copy())
              for s in range(D)]
    _build.launches.clear()
    got = exchange.a2a_transpose(shards, D)
    assert not _build.launches                      # CPU: the plain version
    assert [tuple(g.shape) for g in got] == [(1, n1 // D, n2)] * D
    assert np.array_equal(torch.cat(got, dim=1).numpy(), want)


def test_dist_equals_jax_make_dist_ntt():
    """The port's make_dist_ntt against the JAX one, exchange='pallas',
    SMALL 256 on D = 4, random input: the JAX input array goes into the
    port's shard_for_ntt as it is."""
    f, n, D = nt.SMALL, 256, 4
    x = _words(f, (n,), 81)
    jx = jlimbs.to_mont(jax.numpy.asarray(x), f)
    jmesh = j_make_mesh(jax.devices()[:D])
    jrun = j_make_dist_ntt(f, n, jmesh, exchange="pallas")
    want = np.asarray(j_unshard(jrun(j_shard_for_ntt(jx, f, jmesh))))
    mesh = _mesh(D)
    got = make_dist_ntt(f, n, mesh, exchange="pallas")(
        shard_for_ntt(np.asarray(jx), f, mesh))
    assert [tuple(g.shape) for g in got] == [(1, 16, 4)] * D
    assert np.array_equal(unshard(got).numpy(), want)


# ---------------------------------------------------------------------------
# Against the golden model (mirrors of tests/test_parallel.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", [2, 8])
def test_dist_forward_small(D):
    f, n = nt.SMALL, 256
    x = oracle.ramp(n, f)
    assert _dist(f, x, D) == oracle.ntt_golden(x, f)


def test_dist_roundtrip_small():
    f, n, D = nt.SMALL, 256, 4
    x = [(7 * i * i + 3) % f.p for i in range(n)]
    y = _dist(f, x, D)
    assert _dist(f, y, D, inverse=True) == x


def test_dist_bn254_on_8():
    f, n = nt.BN254_FR, 64
    x = oracle.ramp(n, f)
    assert _dist(f, x, 8) == oracle.ntt_golden(x, f)


@pytest.mark.parametrize("exchange_name", ["all_to_all", "ring", "pallas"])
@pytest.mark.parametrize("algorithm", ["jnp", "pallas", "mxu", "mxu_sub"])
def test_dist_local_algorithms_and_exchanges(algorithm, exchange_name):
    f, n = nt.SMALL, 256
    x = tnt.to_ints(_words(f, (n,), 82), f)
    got = _dist(f, x, 4, algorithm=algorithm, exchange=exchange_name)
    assert got == oracle.ntt_golden(x, f)


@pytest.mark.parametrize("algorithm", ["mxu", "mxu_sub"])
def test_dist_mxu_256bit(algorithm):
    f, n = nt.BN254_FR, 256
    x = oracle.ramp(n, f)
    assert _dist(f, x, 4, algorithm=algorithm) == oracle.ntt_golden(x, f)


def test_dist_coset_roundtrip():
    f, n, D = nt.SMALL, 256, 4
    shift = f.generator
    x = oracle.ramp(n, f)
    y = _dist(f, x, D, coset_shift=shift)
    assert y == oracle.coset_ntt_golden(x, f, shift)
    assert _dist(f, y, D, inverse=True, coset_shift=shift) == x


@pytest.mark.parametrize("algorithm", ["jnp", "mxu_sub"])
def test_dist_lde(algorithm):
    f, n, blowup, D = nt.SMALL, 64, 4, 4
    mesh = _mesh(D)
    x = oracle.ramp(n, f)
    xs = shard_for_ntt(tlimbs.to_mont(tnt.from_ints(x, f), f), f, mesh)
    y = dist_lde(xs, f, mesh, n, blowup=blowup, algorithm=algorithm)
    assert [tuple(t.shape) for t in y] == [(1, 16, 4)] * D
    got = tnt.to_ints(tlimbs.from_mont(unshard(y), f), f)
    assert got == oracle.lde_golden(x, f, blowup)


def test_dist_bls_2e12_on_8():
    f, n = nt.BLS12_381_FR, 1 << 12
    x = oracle.ramp(n, f)
    assert _dist(f, x, 8) == oracle.ntt_golden(x, f)


def test_dist_nonpow2_devices():
    """Six devices factor as a (replica=3, ntt=2) mesh; every replica row
    computes the whole transform."""
    f, n = nt.SMALL, 256
    mesh = _mesh(6)
    assert mesh.shape == {"replica": 3, "ntt": 2}
    assert mesh.axis_names == ("replica", "ntt")
    x = oracle.ramp(n, f)
    xs = shard_for_ntt(tlimbs.to_mont(tnt.from_ints(x, f), f), f, mesh)
    assert len(xs) == 2
    y = make_dist_ntt(f, n, mesh)(xs)
    got = tnt.to_ints(tlimbs.from_mont(unshard(y), f), f)
    assert got == oracle.ntt_golden(x, f)


def test_dist_mont_io_false():
    f, n, D = nt.GOLDILOCKS, 256, 4
    x = _words(f, (n,), 83)
    mesh = _mesh(D)
    y = make_dist_ntt(f, n, mesh, mont_io=False, algorithm="mxu_sub",
                      exchange="pallas")(shard_for_ntt(x, f, mesh))
    assert tnt.to_ints(unshard(y), f) == oracle.ntt_golden(
        tnt.to_ints(x, f), f)


def test_dist_donate():
    """donate=True: right words, and the input list is handed over (emptied)
    so that each shard can be freed once its column transforms read it."""
    f, n, D = nt.SMALL, 256, 4
    mesh = _mesh(D)
    x = oracle.ramp(n, f)
    xs = shard_for_ntt(tlimbs.to_mont(tnt.from_ints(x, f), f), f, mesh)
    y = make_dist_ntt(f, n, mesh, donate=True, exchange="pallas")(xs)
    assert xs == []
    got = tnt.to_ints(tlimbs.from_mont(unshard(y), f), f)
    assert got == oracle.ntt_golden(x, f)


def test_dist_ntt_and_dist_intt_entries():
    f, n, D = nt.GOLDILOCKS, 1 << 10, 4
    mesh = _mesh(D)
    x = _words(f, (n,), 84)
    xm = tlimbs.to_mont(torch.from_numpy(x), f)
    y = dist_ntt(shard_for_ntt(xm, f, mesh), f, mesh, n, algorithm="pallas",
                 exchange="ring")
    assert tnt.to_ints(tlimbs.from_mont(unshard(y), f), f) == \
        oracle.ntt_golden(tnt.to_ints(x, f), f)
    back = dist_intt(shard_for_ntt(unshard(y), f, mesh), f, mesh, n,
                     algorithm="mxu_sub", exchange="pallas")
    assert torch.equal(unshard(back), xm)


def test_dist_pallas_local_recursion():
    """The 'pallas' local transform above its base size recurses (m = 1024,
    two batch columns)."""
    f, m, cols = nt.SMALL, 1 << 10, 2
    vals = [(5 * i + 11) % f.p for i in range(m * cols)]
    x = tlimbs.to_mont(tnt.from_ints(vals, f).reshape(1, m, cols), f)
    fn, prepare = tdist._axis_fn("pallas", f)
    tws, _ = prepare(f, m, cols, False)
    y = fn(x, f, False, {"tws": [torch.from_numpy(t) for t in tws]})
    got = tnt.to_ints(tlimbs.from_mont(y, f), f)
    for c in range(cols):
        col = [vals[i * cols + c] for i in range(m)]
        assert [got[i * cols + c] for i in range(m)] == oracle.ntt_golden(
            col, f)


# ---------------------------------------------------------------------------
# Host tables byte for byte against the JAX package's own tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fname", ["small-proth", "bn254-fr"])
def test_power_matrix_equals_jax(fname):
    f = nt.get_field(fname)
    base = f.root_of_unity(64)
    got = tcore.power_matrix(f, base, 8, 4, "cpu")
    assert np.array_equal(got.numpy(),
                          np.asarray(jcore.power_matrix(f, base, 8, 4)))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("fname", ["goldilocks", "bls12-381-fr"])
def test_shard_twiddle_equals_jax_tables(fname, inverse):
    """Shard d's merged step-2 table is the slice of the full decomposition
    twiddle ω^{k1·i2}, and its row k1 = 1 at j = 0 is entry d of the JAX
    per-device base table host_powers(ω^{n2_loc}, D)."""
    f, n, D = nt.get_field(fname), 1 << 10, 4
    n1, n2 = jcore.split_log(n)
    n2_loc = n2 // D
    omega = f.inv_root_of_unity(n) if inverse else f.root_of_unity(n)
    full = jcore.host_power_matrix(f, omega, n1, n2)
    idx_base = jcore.host_powers(f, pow(omega, n2_loc, f.p), D)
    for d in range(D):
        T = tdist.shard_twiddle(f, omega, n1, n2_loc, d, "cpu").numpy()
        assert np.array_equal(T, full[:, :, d * n2_loc:(d + 1) * n2_loc])
        assert np.array_equal(T[:, 1, 0], idx_base[:, d])


@pytest.mark.parametrize("inverse", [False, True])
def test_coset_tables_equal_jax(inverse):
    """Both coset tables as ntt_tpu/parallel/dist_ntt.py builds them."""
    f, n, D = nt.BN254_FR, 1 << 10, 4
    n1, n2 = jcore.split_log(n)
    shift = f.generator
    if not inverse:
        c = shift % f.p
        pw = jcore.host_powers_fast(f, c, (n1 - 1) * n2 + n2 // D)
        idxm = np.arange(n1)[:, None] * n2 + np.arange(n2 // D)[None, :]
        dev = jcore.host_powers_fast(f, pow(c, n2 // D, f.p), D)
    else:
        ci = pow(shift, f.p - 2, f.p)
        pw = jcore.host_powers_fast(f, ci, (n2 - 1) * n1 + n1 // D)
        idxm = np.arange(n2)[:, None] * n1 + np.arange(n1 // D)[None, :]
        dev = jcore.host_powers_fast(f, pow(ci, n1 // D, f.p), D)
    local, got_dev = tdist.coset_tables(f, n, D, shift, inverse)
    assert np.array_equal(local, pw[:, idxm])
    assert np.array_equal(got_dev, dev)


# ---------------------------------------------------------------------------
# K8 and the exchanges
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("W", [1, 2, 8])
@pytest.mark.parametrize("D", [2, 4, 8])
def test_a2a_plain_layout(D, W):
    """out_t[:, i, s*n2_loc + j] = C_s[:, t*n1_loc + i, j], element by
    element; n2_loc = 3 (not a multiple of 4) at W = 1."""
    n1, n2_loc = 2 * D, 3 if W == 1 else 4
    rng = np.random.default_rng(D * 10 + W)
    C = [rng.integers(0, 1 << 32, size=(W, n1, n2_loc), dtype=np.uint64)
         .astype(np.uint32) for _ in range(D)]
    got = exchange.a2a_transpose([torch.from_numpy(c) for c in C], D)
    n1_loc = n1 // D
    for t in range(D):
        assert tuple(got[t].shape) == (W, n1_loc, D * n2_loc)
        for s in range(D):
            assert np.array_equal(
                got[t].numpy()[:, :, s * n2_loc:(s + 1) * n2_loc],
                C[s][:, t * n1_loc:(t + 1) * n1_loc, :])


@pytest.mark.parametrize("D", [2, 4, 8])
def test_ring_equals_a2a_plain(D):
    rng = np.random.default_rng(90 + D)
    C = [torch.from_numpy(rng.integers(0, 1 << 32, size=(2, 2 * D, 5),
                                       dtype=np.uint64).astype(np.uint32))
         for _ in range(D)]
    want = exchange.a2a_transpose_plain(C, D)
    got = tdist._ring_transpose(C, 2 * D, D)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_a2a_raises_on_what_it_cannot_take():
    """Neither the CPU nor CUDA: no fallback to the plain copy. Wrong shard
    counts and mismatched shards raise too."""
    meta = [torch.empty((1, 4, 4), dtype=torch.uint32, device="meta")
            for _ in range(2)]
    with pytest.raises(ValueError, match="all on CUDA devices"):
        exchange.a2a_transpose(meta, 2)
    cpu = [torch.zeros((1, 4, 4), dtype=torch.uint32) for _ in range(2)]
    with pytest.raises(ValueError, match="expected 4 shards"):
        exchange.a2a_transpose(cpu, 4)
    with pytest.raises(ValueError, match="shards differ"):
        exchange.a2a_transpose([cpu[0], cpu[1][:, :, :2]], 2)


# ---------------------------------------------------------------------------
# Reports and errors
# ---------------------------------------------------------------------------

def test_exchange_options_report():
    """The port's contract: a 1-D mesh, D dividing n1 and n2 (and at most
    MAX_SHARDS shards for K8); the TPU's 128-lane rule is gone."""
    mesh = _mesh(8)
    opt = exchange_options(1 << 13, mesh)
    assert all(opt[k]["eligible"] for k in ("all_to_all", "ring", "pallas"))
    small = exchange_options(1 << 10, mesh)      # chunk 16: the TPU refused
    assert small["pallas"]["eligible"]
    assert "128" not in small["pallas"]["why"]
    tiny = exchange_options(16, mesh)            # n1 = n2 = 4 < D
    assert not any(tiny[k]["eligible"] for k in tiny)
    assert "divide both split factors" in tiny["pallas"]["why"]
    factored = exchange_options(1 << 20, _mesh(6))
    assert not factored["pallas"]["eligible"]
    assert "1-D mesh" in factored["pallas"]["why"]
    assert factored["all_to_all"]["eligible"] and factored["ring"]["eligible"]


def test_dist_pallas_build_time_report():
    f = nt.SMALL
    with pytest.raises(ValueError, match="1-D mesh"):
        make_dist_ntt(f, 1 << 13, _mesh(6), exchange="pallas")
    with pytest.raises(ValueError, match="divide both split factors"):
        make_dist_ntt(f, 16, _mesh(8))
    with pytest.raises(ValueError, match="unknown exchange"):
        make_dist_ntt(f, 256, _mesh(4), exchange="nccl")
    with pytest.raises(ValueError, match="unknown local algorithm"):
        make_dist_ntt(f, 256, _mesh(4), algorithm="mxu_fused")


def test_make_mesh_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


def test_make_mesh_repeated_devices():
    mesh = make_mesh(["cpu"] * 4)
    assert mesh.shape == {"ntt": 4} and mesh.axis_names == ("ntt",)
    assert [str(d) for d in mesh.devices] == ["cpu"] * 4
    assert mesh == make_mesh([torch.device("cpu")] * 4)

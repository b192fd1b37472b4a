"""The periodic-residual level 0 (``TwStackResid``) of the port's 256-bit
path and the device table generators, against ntt_tpu on the CPU.

- ``transforms.mxu.matfold_tw_tables`` with the residual forced
  (``TW_MERGED_MAX`` set to 2^16 in both packages; 2^17, s0 = 128) is
  word-equal to the JAX package's: ``As``, ``rep`` and ``Tres`` of level 0
  and the deeper levels' tables, forward, inverse and coset, BLS12-381 Fr
  and BN254 Fr;
- K2's plain version with a periodic T3[W, 32, s0] equals the JAX
  ``fused_level_stack`` (Pallas interpret mode) given the same T3 tiled to
  [W, 32, B];
- the port's transform at BLS12-381 Fr 2^17 with the residual forced
  (``ntt``, ``intt``, ``coset_ntt``) equals the golden result of the
  port's hostlib and the port's merged path;
- the device generators, run on the CPU with small row chunks, equal the
  host tables and the JAX package's ``power_matrix_chunked``,
  ``geometric_outer_chunked`` and ``geometric_outer``.

Canonical words out: the tolerance is exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ntt_tpu as nt
from ntt_tpu.kernels.mxu_level import fused_level_stack as j_stack
from ntt_tpu.transforms import core as jcore
from ntt_tpu.transforms import mxu as jmxu
from ntt_tpu.transforms.fourstep import TwMatStack as JTwMatStack
from ntt_tpu.transforms.fourstep import TwStackResid as JTwStackResid
import ntt_tpu_torch as tnt
from ntt_tpu_torch import api as tapi
from ntt_tpu_torch import digits as tdigits
from ntt_tpu_torch import hostlib as thostlib
from ntt_tpu_torch import limbs as tlimbs
from ntt_tpu_torch.kernels import mxu_level
from ntt_tpu_torch.transforms import core as tcore
from ntt_tpu_torch.transforms import mxu as tmxu
from ntt_tpu_torch.transforms.fourstep import TwDeep, TwStackResid

torch.set_num_threads(1)

N = 1 << 17


def _words(field, shape, seed):
    """Canonical random elements as uint32[W, *shape] (top word < p's)."""
    rng = np.random.default_rng(seed)
    W = field.n_words
    x = rng.integers(0, 1 << 32, size=(W,) + shape, dtype=np.uint64)
    x[W - 1] = rng.integers(0, field.p >> (32 * (W - 1)), size=shape,
                            dtype=np.uint64)
    return x.astype(np.uint32)


def _rows(planes):
    """uint32[W, n] word planes -> the hostlib's np.uint64[n, 4] rows."""
    rows = np.zeros((planes.shape[1], 8), dtype=np.uint32)
    rows[:, :planes.shape[0]] = planes.T
    return rows.view(np.uint64)


def _golden(field, x_std, inverse=False):
    """The port's hostlib golden NTT of standard-form planes
    uint32[W, n]."""
    out = thostlib.ntt_np(_rows(x_std), field, inverse=inverse)
    return thostlib.host_planes(out, x_std.shape[0])


def _mont(field, planes):
    """Standard-form planes uint32[W, n] in Montgomery form (x R mod p),
    by the port's hostlib."""
    W, n = planes.shape
    r = (1 << (32 * W)) % field.p
    R = np.array([(r >> (32 * i)) & 0xFFFFFFFF for i in range(W)],
                 dtype=np.uint32)
    R = np.ascontiguousarray(np.broadcast_to(R[:, None], (W, n)))
    return thostlib.host_planes(
        thostlib.mul_mod_vec_np(_rows(planes), _rows(R), field), W)


@pytest.fixture
def resid(monkeypatch):
    """The periodic residual from 2^17 up, in both packages: the merged
    level-1 table's limit set to 2^16."""
    monkeypatch.setattr(tmxu, "TW_MERGED_MAX", 1 << 16)
    monkeypatch.setattr(jmxu, "TW_MERGED_MAX", 1 << 16)


# --- the tables -------------------------------------------------------------

@pytest.mark.parametrize("direction", ["forward", "inverse", "coset"])
@pytest.mark.parametrize("name", ["bls12-381-fr", "bn254-fr"])
def test_resid_tables_equal_jax(resid, name, direction):
    tf, jf = tnt.get_field(name), nt.get_field(name)
    inverse = direction == "inverse"
    shift = tf.generator if direction == "coset" else None
    got = tmxu.matfold_tw_tables(tf, N, inverse, coset_shift=shift)
    want = jmxu.matfold_tw_tables(jf, N, inverse, coset_shift=shift)
    assert [k for k, _ in tmxu.matfold_plan(tf, N)] == [
        "resid", "deep", "stack"]
    assert len(got) == len(want) == 3
    t0, j0 = got[0], want[0]
    assert t0["kind"] == "resid" and isinstance(j0, JTwStackResid)
    assert t0["rep"] == j0.rep == 128
    assert np.array_equal(t0["As"], np.asarray(j0.As))
    assert t0["Tres"].shape == (tf.n_words, 32, 128)
    assert np.array_equal(t0["Tres"], np.asarray(j0.Tres))
    assert got[1]["kind"] == "deep"
    assert np.array_equal(got[1]["T"], np.asarray(want[1]))
    assert got[2]["kind"] == "stack" and isinstance(want[2], JTwMatStack)
    assert got[2]["rep"] == want[2].rep
    assert np.array_equal(got[2]["As"], np.asarray(want[2].As))


@pytest.mark.parametrize("name, log_n, largest", [
    ("bls12-381-fr", 25, 1 << 15), ("bls12-381-fr", 26, 1 << 16),
    ("bn254-fr", 28, 1 << 18)])
def test_plan_above_2e24_has_no_data_sized_table(name, log_n, largest):
    """Under the default (auto) the residual starts above 2^24; no table
    has n entries, and the largest twiddle table is a [W, 32, n / 2^10]
    one (the residual's, or level 1's plain table)."""
    tf = tnt.get_field(name)
    n = 1 << log_n
    plan = tmxu.matfold_plan(tf, n)
    assert plan[0][0] == "resid"
    assert "batch" not in [k for k, _ in plan]
    assert tmxu.matfold_plan(tf, 1 << 24)[1][0] == "batch"
    sizes = [n1 * n2 // tmxu.BASE if kind == "resid" else n1 * n2
             for kind, (m, n1, n2) in plan if kind != "stack"]
    assert max(sizes) == 32 * largest < n


# --- K2 with a periodic T3 ---------------------------------------------------

@pytest.mark.parametrize("name, NT, rep, s0", [
    ("small-proth", 4, 128, 128), ("bls12-381-fr", 2, 128, 32)])
def test_stack_periodic_t3_equals_pallas(name, NT, rep, s0):
    """The shapes of tests/test_mxu.py's residual-stack test, with the
    residual periodic: the port reads T3[W, 32, s0] at column b mod s0,
    the JAX kernel reads it tiled to [W, 32, B]."""
    tf, jf = tnt.get_field(name), nt.get_field(name)
    m, B = 32, NT * rep
    x = _words(tf, (m, B), 1)
    T3 = _words(tf, (m, s0), 2)
    rng = np.random.default_rng(3)
    tvals = [[int(v) % tf.p for v in rng.integers(1, 1 << 62, size=m)]
             for _ in range(NT)]
    As = tmxu.twiddle_matrix_stack(tf, m, False, tvals)
    F = tmxu._fold_matrix(tf, m)
    got = mxu_level.fused_level_stack(
        torch.from_numpy(x), tf, torch.from_numpy(As), rep,
        None if F is None else torch.from_numpy(F), T3=torch.from_numpy(T3))
    want = j_stack(jnp.asarray(x), jf, jnp.asarray(As), rep=rep,
                   F=None if F is None else jnp.asarray(F),
                   T3=jnp.asarray(np.tile(T3, (1, 1, B // s0))))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_stack_t3_shapes():
    """T3 is [W, m, B] or periodic [W, m, s0] with s0 a power of two
    dividing B; anything else raises ValueError, as on the card."""
    tf = tnt.BLS12_381_FR
    m, B, D = 4, 48, tdigits.n_digits(tnt.BLS12_381_FR)
    x = torch.from_numpy(_words(tf, (m, B), 4))
    As = torch.zeros((3, D * m, D * m), dtype=torch.int8)
    F = torch.from_numpy(tmxu._fold_matrix(tf, m))
    for s0 in (1, 4, 16, 48):
        assert mxu_level.t3_period(x[:, :, :s0], 8, m, B) == s0
        mxu_level.fused_level_stack(x, tf, As, 16, F, x[:, :, :s0])
    for bad in (x[:, :, :3], x[:, :, :32], x[:, :2, :16], x[0]):
        with pytest.raises(ValueError, match="periodic"):
            mxu_level.fused_level_stack(x, tf, As, 16, F, bad)


# --- the transform at 2^17 ---------------------------------------------------

def test_transform_2e17_with_the_residual_equals_golden(resid, monkeypatch):
    """ntt, intt and coset_ntt at BLS12-381 Fr 2^17 with level 0 the
    stack plus its periodic residual (Montgomery I/O, converted on the
    host by the port's hostlib), against its golden result; the
    forward also against the port's merged path
    (level 1's TwBatch table)."""
    tf = tnt.BLS12_381_FR
    x = _words(tf, (N,), 17)
    xm = torch.from_numpy(_mont(tf, x))
    run, aux = tapi.get_runner(tf, N, device="cpu")
    assert isinstance(aux["tws"][0], TwStackResid)
    assert tuple(aux["tws"][0].Tres.shape) == (8, 32, 128)
    assert isinstance(aux["tws"][1], TwDeep)
    fwd = run(xm, aux)
    assert np.array_equal(fwd.numpy(), _mont(tf, _golden(tf, x)))
    run_i, aux_i = tapi.get_runner(tf, N, inverse=True, device="cpu")
    assert np.array_equal(run_i(xm, aux_i).numpy(),
                          _mont(tf, _golden(tf, x, inverse=True)))
    g = tf.generator
    run_c, aux_c = tapi.get_runner(tf, N, coset_shift=g, device="cpu")
    assert isinstance(aux_c["tws"][0], TwStackResid)
    scaled = thostlib.host_planes(thostlib.mul_mod_vec_np(
        _rows(x), _rows(thostlib.powers_np(g, N, tf)), tf), 8)
    assert np.array_equal(run_c(xm, aux_c).numpy(),
                          _mont(tf, _golden(tf, scaled)))
    monkeypatch.setattr(tmxu, "TW_MERGED_MAX", 1 << 24)
    run_m, aux_m = tapi.get_runner(tf, N, device="cpu")
    assert [type(t).__name__ for t in aux_m["tws"]] == [
        "TwMatStack", "TwBatch", "TwMatStack"]
    assert torch.equal(run_m(xm, aux_m), fwd)


# --- the device table generators ---------------------------------------------

GEN_FIELDS = ["bls12-381-fr", "goldilocks"]


@pytest.mark.parametrize("name", GEN_FIELDS)
def test_power_matrix_chunked_equals_host_and_jax(name, monkeypatch):
    """Row chunks of 2 rows and of 3 (the last chunk short); above
    HOST_TW_LIMIT entries ``power_table`` takes the generator."""
    tf, jf = tnt.get_field(name), nt.get_field(name)
    w = tf.root_of_unity(1 << 11)
    want = tcore.host_power_matrix(tf, w, 8, 16)
    for chunk in (32, 48):
        got = tcore.power_matrix_chunked(tf, w, 8, 16, "cpu", chunk=chunk)
        assert got.dtype == torch.uint32
        assert np.array_equal(got.numpy(), want)
    assert np.array_equal(
        want, np.asarray(jcore.power_matrix_chunked(jf, w, 8, 16)))
    assert isinstance(tcore.power_table(tf, w, 8, 16), np.ndarray)
    monkeypatch.setattr(tcore, "HOST_TW_LIMIT", 64)
    got = tcore.power_table(tf, w, 8, 16, "cpu")
    assert isinstance(got, torch.Tensor)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", GEN_FIELDS)
def test_geometric_outer_chunked_equals_host_and_jax(name):
    tf, jf = tnt.get_field(name), nt.get_field(name)
    c = tf.generator
    want = tcore.host_powers_fast(tf, c, 1 << 12)
    got = tcore.geometric_outer_chunked(tf, c, 1 << 12, "cpu", chunk=300)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(
        want, np.asarray(jcore.geometric_outer_chunked(jf, c, 1 << 12)))


@pytest.mark.parametrize("name", GEN_FIELDS)
def test_geometric_outer_and_scale_columns(name):
    tf, jf = tnt.get_field(name), nt.get_field(name)
    c = tf.generator
    got = tcore.geometric_outer(tf, c, 16, 32, "cpu")
    want = tcore.host_powers_fast(tf, c, 512).reshape(tf.n_words, 16, 32)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(
        want, np.asarray(jcore.geometric_outer(jf, c, 16, 32)))
    v = torch.from_numpy(_words(tf, (32,), 5))
    assert torch.equal(tcore.scale_columns(got, v, tf, chunk=40),
                       tlimbs.mont_mul(got, v[:, None, :], tf))

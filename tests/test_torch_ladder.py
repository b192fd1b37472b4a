"""The butterfly-ladder part of the port against ntt_tpu on the CPU: the new
``limbs`` functions, ``transforms/core`` (twiddle masters, bit reversal,
DIT stage, both ladders, ``split_log``) and the algorithms ``naive``,
``stockham``, ``fourstep``, ``fourstep_st`` through the API.

The same inputs, made from a numpy seed, go through the JAX function and
its counterpart. Canonical words out: the tolerance is exact equality.
The API comparisons run at the (field, n, algorithm) combinations the JAX
package's own tests compile (tests/test_transforms.py), so that the
persistent compile cache serves them; the wider sweep (all four fields,
inverse, coset, Montgomery I/O, batches) is held against the host golden
NTT, which costs nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ntt_tpu as nt
from ntt_tpu import limbs as jlimbs
from ntt_tpu import oracle
from ntt_tpu.api import get_runner as j_get_runner
from ntt_tpu.transforms import core as jcore
import ntt_tpu_torch as tnt
from ntt_tpu_torch import api as tapi
from ntt_tpu_torch import hostlib as thostlib
from ntt_tpu_torch import limbs as tlimbs
from ntt_tpu_torch.transforms import core as tcore
from ntt_tpu_torch.transforms import fourstep as tfourstep

torch.set_num_threads(1)

FIELDS = ["small-proth", "goldilocks", "bn254-fr", "bls12-381-fr"]
LADDER = ["naive", "stockham", "fourstep", "fourstep_st"]


def _words(field, shape, seed):
    """Canonical random elements as uint32[W, *shape] (top word < p's)."""
    rng = np.random.default_rng(seed)
    W = field.n_words
    x = rng.integers(0, 1 << 32, size=(W,) + shape, dtype=np.uint64)
    x[W - 1] = rng.integers(0, field.p >> (32 * (W - 1)), size=shape,
                            dtype=np.uint64)
    return x.astype(np.uint32)


def _edge_words(field, n, seed):
    """Random elements with the boundary values 0, 1, p-1, p-2 in front."""
    x = _words(field, (n,), seed)
    edge = tnt.from_ints([0, 1, field.p - 1, field.p - 2], field).numpy()
    x[:, :4] = edge
    return x


def _golden(field, x_std, inverse=False):
    """Host golden NTT of standard-form planes uint32[W, n], as planes."""
    rows = thostlib.planes_to_rows(np.ascontiguousarray(x_std))
    return thostlib.host_planes(
        thostlib.ntt_np(rows, field, inverse=inverse), field.n_words)


def _golden_coset(field, x_std, shift):
    ints = tnt.to_ints(x_std, field)
    scaled = [v * pow(shift, i, field.p) % field.p
              for i, v in enumerate(ints)]
    return _golden(field, tnt.from_ints(scaled, field).numpy())


# --- limbs ------------------------------------------------------------------

@pytest.mark.parametrize("name", FIELDS)
def test_add_sub_neg_equal_jax(name):
    """Goldilocks sums pass 2^64: the carry out of the top half counts."""
    jf, tf = nt.get_field(name), tnt.get_field(name)
    a, b = _edge_words(tf, 64, 1), _edge_words(tf, 64, 2)[:, ::-1].copy()
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for tfn, jfn in ((tlimbs.add_mod, jlimbs.add_mod),
                     (tlimbs.sub_mod, jlimbs.sub_mod)):
        got = tfn(ta, tb, tf)
        assert got.dtype == torch.uint32
        assert np.array_equal(got.numpy(), np.asarray(jfn(ja, jb, jf)))
        assert tlimbs.is_canonical(got, tf).all()
    assert np.array_equal(tlimbs.neg_mod(ta, tf).numpy(),
                          np.asarray(jlimbs.neg_mod(ja, jf)))
    ai, bi = tnt.to_ints(a, tf), tnt.to_ints(b, tf)
    assert tnt.to_ints(tlimbs.add_mod(ta, tb, tf), tf) == [
        (u + v) % tf.p for u, v in zip(ai, bi)]
    assert tnt.to_ints(tlimbs.sub_mod(ta, tb, tf), tf) == [
        (u - v) % tf.p for u, v in zip(ai, bi)]


@pytest.mark.parametrize("name", ["small-proth", "goldilocks"])
def test_mont_sqr_pow_equal_jax(name):
    jf, tf = nt.get_field(name), tnt.get_field(name)
    a = _edge_words(tf, 16, 3)
    ta, ja = torch.from_numpy(a), jnp.asarray(a)
    assert np.array_equal(tlimbs.mont_sqr(ta, tf).numpy(),
                          np.asarray(jlimbs.mont_sqr(ja, jf)))
    for e in (0, 1, 5, 37):
        got = tlimbs.mont_pow(ta, e, tf)
        assert got.dtype == torch.uint32
        assert np.array_equal(got.numpy(),
                              np.asarray(jlimbs.mont_pow(ja, e, jf))), e


def test_mont_pow_is_the_power():
    f = tnt.BN254_FR
    vals = [3, 5, f.p - 1, 12345678901234567890]
    xm = tlimbs.to_mont(tnt.from_ints(vals, f), f)
    got = tnt.to_ints(tlimbs.from_mont(tlimbs.mont_pow(xm, 65537, f), f), f)
    assert got == [pow(v, 65537, f.p) for v in vals]


# --- transforms/core --------------------------------------------------------

@pytest.mark.parametrize("name, m, inverse", [
    ("small-proth", 512, False), ("goldilocks", 64, True),
    ("bls12-381-fr", 64, False), ("bn254-fr", 2, True)])
def test_twiddle_master_equals_jax(name, m, inverse):
    got = tcore.twiddle_master(tnt.get_field(name), m, inverse)
    want = jcore.twiddle_master(nt.get_field(name), m, inverse)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_bit_reversal_and_split_log_equal_jax():
    for m in (1, 2, 8, 64, 1024):
        assert list(tcore.bit_reverse_table(m)) == oracle.bit_reverse_table(m)
    x = _words(tnt.GOLDILOCKS, (16, 3), 4)
    assert np.array_equal(
        tcore.bit_reverse_axis1(torch.from_numpy(x)).numpy(),
        np.asarray(jcore.bit_reverse_axis1(jnp.asarray(x))))
    for log_n in range(0, 27):
        assert tcore.split_log(1 << log_n) == jcore.split_log(1 << log_n)


@pytest.mark.parametrize("name, s", [("small-proth", 1), ("small-proth", 4),
                                     ("goldilocks", 8)])
def test_dit_stage_equals_jax(name, s):
    jf, tf = nt.get_field(name), tnt.get_field(name)
    m = 32
    x = _words(tf, (m, 5), s)
    tw = None if s == 1 else _words(tf, (s,), 9)
    got = tcore.dit_stage(torch.from_numpy(x), s,
                          None if tw is None else torch.from_numpy(tw), tf)
    want = jcore.dit_stage(jnp.asarray(x), s,
                           None if tw is None else jnp.asarray(tw), jf)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name, m, inverse", [
    ("small-proth", 64, False), ("goldilocks", 16, True)])
def test_ladders_equal_jax(name, m, inverse):
    """Both ladders on a batched input."""
    jf, tf = nt.get_field(name), tnt.get_field(name)
    x = _words(tf, (m, 3), m)
    for tfn, jfn in ((tcore.ntt_along_axis, jcore.ntt_along_axis),
                     (tcore.ntt_along_axis_stockham,
                      jcore.ntt_along_axis_stockham)):
        got = tfn(torch.from_numpy(x), tf, inverse=inverse)
        want = jax.jit(lambda v: jfn(v, jf, inverse=inverse))(jnp.asarray(x))
        assert np.array_equal(got.numpy(), np.asarray(want))


# --- the algorithms through the API, against ntt_tpu -------------------------

@pytest.mark.parametrize("algo", LADDER)
@pytest.mark.parametrize("log_n", [2, 3, 6, 9])
def test_small_field_equals_jax(algo, log_n):
    jf, tf = nt.SMALL, tnt.SMALL
    x = _edge_words(tf, 1 << log_n, log_n)
    for call in ("ntt", "intt"):
        want = np.asarray(getattr(nt, call)(x, jf, algorithm=algo))
        got = getattr(tnt, call)(x, tf, algorithm=algo, device="cpu")
        assert got.dtype == torch.uint32
        assert np.array_equal(got.numpy(), want), call


@pytest.mark.parametrize("name, n, algo", [
    ("bn254-fr", 16, "naive"), ("bn254-fr", 32, "fourstep"),
    ("bls12-381-fr", 16, "naive"), ("bls12-381-fr", 16, "fourstep"),
    ("bls12-381-fr", 16, "stockham"), ("goldilocks", 64, "fourstep")])
def test_wide_fields_equal_jax(name, n, algo):
    jf, tf = nt.get_field(name), tnt.get_field(name)
    x = _edge_words(tf, n, n)
    for call in ("ntt", "intt"):
        want = np.asarray(getattr(nt, call)(x, jf, algorithm=algo))
        got = getattr(tnt, call)(x, tf, algorithm=algo, device="cpu")
        assert np.array_equal(got.numpy(), want), call


def test_fourstep_fused_coset_equals_jax():
    """n = 2^10 > BASE_MAX: c^{i2} in the top table, c^{i1·n2} as the
    ``coset_col`` column inside a generic level; the inverse coset
    post-multiplies."""
    jf, tf = nt.SMALL, tnt.SMALL
    x = _edge_words(tf, 1 << 10, 10)
    want = np.asarray(nt.coset_ntt(x, jf, algorithm="fourstep"))
    got = tnt.coset_ntt(x, tf, algorithm="fourstep", device="cpu")
    assert np.array_equal(got.numpy(), want)
    want = np.asarray(nt.coset_intt(x, jf, algorithm="fourstep"))
    got = tnt.coset_intt(x, tf, algorithm="fourstep", device="cpu")
    assert np.array_equal(got.numpy(), want)
    _, aux = tapi.get_runner(tf, 1 << 10, algorithm="fourstep",
                             coset_shift=tf.generator, device="cpu")
    assert "coset_col" in aux and "coset" not in aux


@pytest.mark.parametrize("algo", LADDER)
def test_mont_io_and_coset_equal_jax(algo):
    """Montgomery-form I/O and the whole-vector coset product (n within one
    base transform) on the small field, where a fresh JAX compile is
    cheap."""
    jf, tf = nt.SMALL, tnt.SMALL
    x = _edge_words(tf, 64, 7)
    xm = tlimbs.to_mont(torch.from_numpy(x), tf).numpy()
    want = np.asarray(nt.ntt(xm, jf, algorithm=algo, mont_io=True))
    got = tnt.ntt(xm, tf, algorithm=algo, mont_io=True, device="cpu")
    assert np.array_equal(got.numpy(), want)
    want = np.asarray(nt.coset_ntt(x, jf, algorithm=algo))
    got = tnt.coset_ntt(x, tf, algorithm=algo, device="cpu")
    assert np.array_equal(got.numpy(), want)


def test_jax_tables_drive_the_port():
    """The aux of ntt_tpu.api.get_runner, as numpy arrays, through
    aux_from_numpy into the port's fourstep transform; the table lists
    byte for byte."""
    jf, tf, n = nt.SMALL, tnt.SMALL, 1 << 10
    _, jaux = j_get_runner(jf, n, False, "fourstep", True, None)
    jtws = [np.asarray(t) for t in jaux["tws"]]
    tws, mats = tapi.ALGORITHMS["fourstep"][1](tf, n, False)
    assert mats == {} and len(tws) == len(jtws) == 1
    for t, jt in zip(tws, jtws):
        assert t.dtype == jt.dtype and np.array_equal(t, jt)
    aux = tapi.aux_from_numpy(jtws, {}, device="cpu")
    x = _words(tf, (n,), 11)
    xm = tlimbs.to_mont(torch.from_numpy(x), tf)
    got = tfourstep.ntt_fourstep(xm, tf, False, iter(aux["tws"]))
    assert np.array_equal(tlimbs.from_mont(got, tf).numpy(), _golden(tf, x))


# --- the wider sweep, against the host golden NTT -----------------------------

@pytest.mark.parametrize("algo", LADDER)
@pytest.mark.parametrize("name", FIELDS)
def test_every_call_equals_golden(name, algo):
    """Forward, inverse, coset and coset-inverse, standard and Montgomery
    I/O, at a size within one base transform and at n = 2^10 (a generic
    four-step level for fourstep and fourstep_st)."""
    tf = tnt.get_field(name)
    g = tf.generator
    for log_n in (1, 5, 10):
        n = 1 << log_n
        x = _edge_words(tf, n, log_n) if n >= 4 else _words(tf, (n,), 1)
        kw = dict(algorithm=algo, device="cpu")
        y = tnt.ntt(x, tf, **kw)
        assert np.array_equal(y.numpy(), _golden(tf, x)), n
        assert np.array_equal(tnt.intt(x, tf, **kw).numpy(),
                              _golden(tf, x, inverse=True)), n
        yc = tnt.coset_ntt(x, tf, **kw)
        assert np.array_equal(yc.numpy(), _golden_coset(tf, x, g)), n
        assert np.array_equal(tnt.coset_intt(yc, tf, **kw).numpy(), x), n
        xm = tlimbs.to_mont(torch.from_numpy(x), tf)
        ym = tnt.ntt(xm, tf, mont_io=True, **kw)
        assert np.array_equal(tlimbs.from_mont(ym, tf).numpy(), y.numpy()), n


@pytest.mark.parametrize("algo", LADDER)
def test_batched_input_equals_columns(algo):
    tf = tnt.GOLDILOCKS
    x = _words(tf, (1 << 10, 3), 12)
    got = tnt.coset_ntt(x, tf, algorithm=algo, device="cpu").numpy()
    for j in range(3):
        col = np.ascontiguousarray(x[:, :, j])
        assert np.array_equal(got[:, :, j],
                              _golden_coset(tf, col, tf.generator))

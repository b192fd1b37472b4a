"""Kernels K4 and K7 (plain versions), the algorithms ``mxu``,
``mxu_pallas``, ``mxu_fused`` and the two cross pairs (``mxu_chunked`` on a
narrow field, ``mxu_sub`` on a 256-bit one) of the port against ntt_tpu on
the CPU.

K4 fused_level       <- ntt_tpu.kernels.mxu_level.fused_level
K7 fused_level_probe <- ntt_tpu.kernels.mxu_level.fused_level_probe

The JAX entries run as the JAX package's own tests run them on the CPU
(Pallas interpret mode); the port's wrappers run their plain versions
because the tensors lie on the CPU. Canonical Montgomery words out (and for
the probe's ``digits`` and ``matmul`` stages the integers the JAX kernel
defines): the tolerance is exact equality. The API comparisons run at the
combinations tests/test_mxu.py and tests/test_transforms.py compile; the
wider sweep is held against the host golden NTT.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ntt_tpu as nt
from ntt_tpu.api import get_runner as j_get_runner
from ntt_tpu.kernels.mxu_level import PROBE_STAGES as J_PROBE_STAGES
from ntt_tpu.kernels.mxu_level import fused_level as j_fused_level
from ntt_tpu.kernels.mxu_level import fused_level_probe as j_probe
import ntt_tpu_torch as tnt
from ntt_tpu_torch import api as tapi
from ntt_tpu_torch import hostlib as thostlib
from ntt_tpu_torch import limbs as tlimbs
from ntt_tpu_torch.kernels import _build, mxu_level
from ntt_tpu_torch.transforms import mxu as tmxu

torch.set_num_threads(1)

FIELDS = ["small-proth", "goldilocks", "bn254-fr", "bls12-381-fr"]
MXU = ["mxu", "mxu_pallas", "mxu_fused"]


def _words(field, shape, seed):
    """Canonical random elements as uint32[W, *shape] (top word < p's)."""
    rng = np.random.default_rng(seed)
    W = field.n_words
    x = rng.integers(0, 1 << 32, size=(W,) + shape, dtype=np.uint64)
    x[W - 1] = rng.integers(0, field.p >> (32 * (W - 1)), size=shape,
                            dtype=np.uint64)
    return x.astype(np.uint32)


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


def _mats(field, m, inverse=False):
    """{m, -m, -1} in numpy form (the fold matrices for wide fields)."""
    return tmxu._mats_for(field, {m}, inverse)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


# --- K4, plain version against the Pallas entry --------------------------------

@pytest.mark.parametrize("name, m, B, has_tw, transpose", [
    ("small-proth", 32, 256, True, True),
    ("small-proth", 32, 256, False, False),
    ("small-proth", 4, 128, True, False),
    ("goldilocks", 16, 128, True, True),
    ("goldilocks", 16, 128, False, True),
    ("bn254-fr", 8, 128, True, True),
    ("bn254-fr", 8, 128, False, False)])
def test_fused_level_plain_equals_pallas(name, m, B, has_tw, transpose):
    jf, tf = nt.get_field(name), tnt.get_field(name)
    x = _words(tf, (m, B), m)
    T3 = _words(tf, (m, B), m + 1) if has_tw else None
    mats = _mats(tf, m)
    got = mxu_level.fused_level(_t(x), tf, _t(mats[m]), _t(T3), transpose,
                                _t(mats.get(-m)), _t(mats.get(-1)))
    want = j_fused_level(_j(x), jf, _j(mats[m]), _j(T3),
                         transpose_out=transpose, F=_j(mats.get(-m)),
                         F2=_j(mats.get(-1)) if has_tw else None)
    assert got.dtype == torch.uint32 and got.is_contiguous()
    assert got.shape == ((tf.n_words, B, m) if transpose
                         else (tf.n_words, m, B))
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", FIELDS)
def test_fused_level_is_the_golden_ntt(name):
    """On every field: the level is the m-point NTT of each column, its
    epilogue a Montgomery product and a transpose; the inverse matrix gives
    the inverse transform."""
    tf = tnt.get_field(name)
    m, B = 16, 3
    x = _words(tf, (m, B), 3)
    xm = tlimbs.to_mont(torch.from_numpy(x), tf)
    T3 = torch.from_numpy(_words(tf, (m, B), 4))
    for inverse in (False, True):
        mats = {k: torch.from_numpy(v)
                for k, v in _mats(tf, m, inverse).items()}
        y = mxu_level.fused_level(xm, tf, mats[m], None, False, mats.get(-m))
        ys = tlimbs.from_mont(y, tf).numpy()
        for j in range(B):
            want = _golden(tf, np.ascontiguousarray(x[:, :, j]), inverse)
            if inverse:             # the golden inverse scales by 1/m
                want = tnt.from_ints(
                    [v * m % tf.p for v in tnt.to_ints(want, tf)],
                    tf).numpy()
            assert np.array_equal(ys[:, :, j], want), (inverse, j)
        got = mxu_level.fused_level(xm, tf, mats[m], T3, True, mats.get(-m),
                                    mats.get(-1))
        want = tlimbs.mont_mul(y, T3, tf).transpose(1, 2)
        assert np.array_equal(got.numpy(), want.numpy())


# --- K7, every stage against the Pallas entry ---------------------------------

def test_probe_stages_are_the_jax_package_s():
    assert mxu_level.PROBE_STAGES == J_PROBE_STAGES


@pytest.mark.parametrize("stage", J_PROBE_STAGES)
@pytest.mark.parametrize("name, m, B", [("small-proth", 32, 256),
                                        ("goldilocks", 8, 128)])
def test_probe_plain_equals_pallas(name, m, B, stage):
    jf, tf = nt.get_field(name), tnt.get_field(name)
    x = _words(tf, (m, B), m + 2)
    T3 = _words(tf, (m, B), m + 3) if stage == "tw" else None
    A = _mats(tf, m)[m]
    got = mxu_level.fused_level_probe(_t(x), tf, _t(A), stage, _t(T3))
    want = j_probe(_j(x), jf, _j(A), stage, T3=_j(T3))
    assert got.dtype == torch.uint32 and got.shape == x.shape
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("stage", ["matmul", "tw"])
def test_probe_plain_equals_pallas_256_bit(stage):
    """The folded matrices: E = D accumulator planes, the fold reduction."""
    jf, tf = nt.BN254_FR, tnt.BN254_FR
    m, B = 8, 128
    x = _words(tf, (m, B), 21)
    T3 = _words(tf, (m, B), 22) if stage == "tw" else None
    A = _mats(tf, m)[m]
    got = mxu_level.fused_level_probe(_t(x), tf, _t(A), stage, _t(T3))
    want = j_probe(_j(x), jf, _j(A), stage, T3=_j(T3))
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", FIELDS)
def test_probe_tw_is_the_fused_level(name):
    tf = tnt.get_field(name)
    m, B = 8, 37
    x = torch.from_numpy(_words(tf, (m, B), 5))
    T3 = torch.from_numpy(_words(tf, (m, B), 6))
    mats = {k: torch.from_numpy(v) for k, v in _mats(tf, m).items()}
    tw = mxu_level.fused_level_probe(x, tf, mats[m], "tw", T3)
    assert np.array_equal(
        tw.numpy(), mxu_level.fused_level(x, tf, mats[m], T3, False).numpy())
    reduce = mxu_level.fused_level_probe(x, tf, mats[m], "reduce")
    assert np.array_equal(
        reduce.numpy(),
        mxu_level.fused_level(x, tf, mats[m], None, False).numpy())
    stream = mxu_level.fused_level_probe(x, tf, mats[m], "stream")
    assert np.array_equal(stream.numpy(), x.numpy())
    with pytest.raises(ValueError, match="stage"):
        mxu_level.fused_level_probe(x, tf, mats[m], "bogus")
    with pytest.raises(ValueError, match="T3"):
        mxu_level.fused_level_probe(x, tf, mats[m], "tw")


def test_wrappers_check_their_operands():
    tf = tnt.SMALL
    x = torch.from_numpy(_words(tf, (16, 8), 7))
    A = torch.from_numpy(_mats(tf, 16)[16])
    with pytest.raises(ValueError, match="CUDA"):
        mxu_level.fused_level(x.to("meta"), tf, A)
    with pytest.raises(ValueError, match="CUDA"):
        mxu_level.fused_level_probe(x.to("meta"), tf, A, "stream")
    before = dict(_build.launches)
    mxu_level.fused_level(x, tf, A)
    tnt.ntt(_words(tf, (1 << 11,), 8), tf, algorithm="mxu_fused",
            device="cpu")
    assert dict(_build.launches) == before     # CPU tensors launch nothing


# --- tables -------------------------------------------------------------------

@pytest.mark.parametrize("algo, name, log_n, inverse", [
    ("mxu", "goldilocks", 11, False), ("mxu_pallas", "bn254-fr", 7, True),
    ("mxu_fused", "small-proth", 11, False),
    ("mxu_fused", "bls12-381-fr", 7, False),
    ("mxu_chunked", "goldilocks", 11, False),
    ("mxu_sub", "bn254-fr", 7, False)])
def test_table_lists_equal_jax(algo, name, log_n, inverse):
    """The prepared tables and matrices byte for byte, and the JAX
    package's aux, as numpy arrays, through aux_from_numpy into the port's
    transform."""
    jf, tf = nt.get_field(name), tnt.get_field(name)
    n = 1 << log_n
    _, jaux = j_get_runner(jf, n, inverse, algo, True, None)
    jtws = [np.asarray(t) for t in jaux["tws"]]
    jmats = {int(k): np.asarray(v) for k, v in jaux["mats"].items()}
    tws, mats = tapi.ALGORITHMS[algo][1](tf, n, inverse)
    assert len(tws) == len(jtws) >= 1
    for t, jt in zip(tws, jtws):
        t = t["T"] if isinstance(t, dict) else t
        assert t.dtype == jt.dtype and np.array_equal(t, jt)
    assert sorted(mats) == sorted(jmats)
    for k in mats:
        assert mats[k].dtype == jmats[k].dtype
        assert np.array_equal(mats[k], jmats[k]), k
    aux = tapi.aux_from_numpy(jtws, jmats, device="cpu")
    x = _words(tf, (n,), log_n)
    xm = tlimbs.to_mont(torch.from_numpy(x), tf)
    got = tapi.ALGORITHMS[algo][0](xm, tf, inverse, aux)
    if inverse:
        got = tlimbs.mont_mul(got, tlimbs.const_planes(
            tf.to_mont_int(pow(n, -1, tf.p)), tf, ndim=1), tf)
    assert np.array_equal(tlimbs.from_mont(got, tf).numpy(),
                          _golden(tf, x, inverse))


def test_twiddle_requests_and_base_sizes():
    assert tmxu.twiddle_requests(32) == []
    assert tmxu.twiddle_requests(1 << 11) == [(1 << 11, 32, 64), (64, 32, 2)]
    assert tmxu.base_sizes(1 << 11) == {32, 2}
    assert tmxu.base_sizes(16) == {16}


# --- mxu, mxu_pallas, mxu_fused through the API, against ntt_tpu ------------

@pytest.mark.parametrize("name, log_n", [
    ("small-proth", 2), ("small-proth", 6), ("small-proth", 9),
    ("bn254-fr", 6), ("bls12-381-fr", 7), ("goldilocks", 6)])
def test_mxu_equals_jax(name, log_n):
    jf, tf = nt.get_field(name), tnt.get_field(name)
    x = _words(tf, (1 << log_n,), log_n)
    for call in ("ntt", "intt"):
        want = np.asarray(getattr(nt, call)(x, jf, algorithm="mxu"))
        got = getattr(tnt, call)(x, tf, algorithm="mxu", device="cpu")
        assert np.array_equal(got.numpy(), want), call


def test_mxu_pallas_equals_jax():
    jf, tf = nt.SMALL, tnt.SMALL
    x = _words(tf, (512,), 1)
    for call in ("ntt", "intt"):
        want = np.asarray(getattr(nt, call)(x, jf, algorithm="mxu_pallas"))
        got = getattr(tnt, call)(x, tf, algorithm="mxu_pallas", device="cpu")
        assert np.array_equal(got.numpy(), want), call
    jf, tf = nt.BN254_FR, tnt.BN254_FR
    x = _words(tf, (64,), 2)
    want = np.asarray(nt.ntt(x, jf, algorithm="mxu_pallas"))
    got = tnt.ntt(x, tf, algorithm="mxu_pallas", device="cpu")
    assert np.array_equal(got.numpy(), want)


def test_mxu_fused_two_levels_equals_jax():
    """n = 2^11: two twiddled levels, the suffix-reversing relayout."""
    jf, tf = nt.SMALL, tnt.SMALL
    x = _words(tf, (1 << 11,), 11)
    want = np.asarray(nt.ntt(x, jf, algorithm="mxu_fused"))
    got = tnt.ntt(x, tf, algorithm="mxu_fused", device="cpu")
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("algo", MXU)
def test_mont_io_and_coset_equal_jax(algo):
    """Montgomery-form I/O, coset and coset-inverse (a whole-vector
    product for these three) on the small field at n = 2^6."""
    jf, tf = nt.SMALL, tnt.SMALL
    x = _words(tf, (64,), 6)
    xm = tlimbs.to_mont(torch.from_numpy(x), tf).numpy()
    want = np.asarray(nt.ntt(xm, jf, algorithm=algo, mont_io=True))
    got = tnt.ntt(xm, tf, algorithm=algo, mont_io=True, device="cpu")
    assert np.array_equal(got.numpy(), want)
    for call in ("coset_ntt", "coset_intt"):
        want = np.asarray(getattr(nt, call)(x, jf, algorithm=algo))
        got = getattr(tnt, call)(x, tf, algorithm=algo, device="cpu")
        assert np.array_equal(got.numpy(), want), call


# --- the cross pairs -------------------------------------------------------------

def test_mxu_chunked_on_a_narrow_field_equals_jax():
    """Plain tables (the matrix fold is for the 256-bit fields), the coset
    in the first conv matrix; n = 2^11 has a deep level (rep 32)."""
    jf, tf = nt.SMALL, tnt.SMALL
    x = _words(tf, (1 << 10,), 10)
    for call in ("ntt", "coset_ntt"):
        want = np.asarray(getattr(nt, call)(x, jf, algorithm="mxu_chunked"))
        got = getattr(tnt, call)(x, tf, algorithm="mxu_chunked",
                                 device="cpu")
        assert np.array_equal(got.numpy(), want), call
    x = _words(tf, (1 << 11,), 11)
    want = np.asarray(nt.ntt(x, jf, algorithm="mxu_chunked"))
    got = tnt.ntt(x, tf, algorithm="mxu_chunked", device="cpu")
    assert np.array_equal(got.numpy(), want)
    tws, _ = tapi.ALGORITHMS["mxu_chunked"][1](tf, 1 << 17, False)
    assert all(not (isinstance(t, dict) and t["kind"] in ("stack", "batch"))
               for t in tws)


def test_mxu_sub_on_a_256_bit_field_equals_jax():
    """The peel is the single-level BASE: n = 2^8 is one twiddled level
    and a base of 8, both through fused_subntt."""
    jf, tf = nt.BLS12_381_FR, tnt.BLS12_381_FR
    x = _words(tf, (1 << 8,), 8)
    want = np.asarray(nt.ntt(x, jf, algorithm="mxu_sub"))
    got = tnt.ntt(x, tf, algorithm="mxu_sub", device="cpu")
    assert np.array_equal(got.numpy(), want)
    _, aux = tapi.get_runner(tf, 1 << 8, algorithm="mxu_sub",
                             coset_shift=tf.generator, device="cpu")
    assert "first_mats" in aux and "coset_col" not in aux


def test_mxu_sub_256_bit_takes_the_matrix_fold():
    """At n = 2^17 the table list is the fold (stack, merged batch table,
    deep stack), as for mxu_chunked; the transform equals the golden NTT
    and the coset rides the same tables."""
    tf = tnt.BN254_FR
    n = 1 << 17
    tws, mats = tapi.ALGORITHMS["mxu_sub"][1](tf, n, False)
    assert [t["kind"] for t in tws] == ["stack", "batch", "stack"]
    x = _words(tf, (n,), 17)
    got = tnt.ntt(x, tf, algorithm="mxu_sub", device="cpu")
    assert np.array_equal(got.numpy(), _golden(tf, x))
    with pytest.raises(AssertionError, match="two-adicity"):
        j_get_runner(nt.BN254_FR, 1 << 29, False, "mxu_sub", True, None)
    with pytest.raises(AssertionError, match="two-adicity"):
        tapi.get_runner(tf, 1 << 29, algorithm="mxu_sub", device="cpu")
    # above 2^24 level 0 takes the periodic residual; no table has n
    # entries (the plan builds none)
    for kind, (m, n1, n2) in tmxu.matfold_plan(tf, 1 << 25):
        entries = n1 * n2 // tmxu.BASE if kind == "resid" else n1 * n2
        assert entries < 1 << 25, (kind, m)
    assert tmxu.matfold_plan(tf, 1 << 25)[0][0] == "resid"


# --- the wider sweep, against the host golden NTT -----------------------------

@pytest.mark.parametrize("algo", MXU + ["mxu_chunked", "mxu_sub"])
@pytest.mark.parametrize("name", FIELDS)
def test_every_call_equals_golden(name, algo):
    """Forward, inverse, coset and coset-inverse, standard and Montgomery
    I/O, at n = 2 (a base alone), 2^7 (one level) and 2^11 (two)."""
    tf = tnt.get_field(name)
    g = tf.generator
    for log_n in (1, 7, 11):
        n = 1 << log_n
        x = _words(tf, (n,), log_n)
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


def test_mxu_fused_three_levels_equals_golden():
    tf = tnt.SMALL
    x = _words(tf, (1 << 16,), 16)
    got = tnt.ntt(x, tf, algorithm="mxu_fused", device="cpu")
    assert np.array_equal(got.numpy(), _golden(tf, x))


def test_batched_input():
    """``mxu`` and ``mxu_pallas`` take a batch natively; ``mxu_fused``
    takes unbatched input only, as in the JAX package."""
    tf = tnt.GOLDILOCKS
    x = _words(tf, (1 << 7, 3), 13)
    for algo in ("mxu", "mxu_pallas"):
        got = tnt.ntt(x, tf, algorithm=algo, device="cpu").numpy()
        for j in range(3):
            assert np.array_equal(
                got[:, :, j], _golden(tf, np.ascontiguousarray(x[:, :, j])))
    with pytest.raises(AssertionError, match="unbatched"):
        tnt.ntt(x, tf, algorithm="mxu_fused", device="cpu")

"""ntt_tpu_torch.digits and the transform's host-side constructors against
ntt_tpu.

The host-side constructors must give byte-equal int8 matrices; the plain
PyTorch arithmetic must give the same canonical words (exact equality).
Inputs are made with numpy from fixed seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ntt_tpu.digits as jdigits
import ntt_tpu.fields as jfields
import ntt_tpu.transforms.mxu as jmxu
import ntt_tpu_torch.fields as tfields
from ntt_tpu_torch import digits as tdigits
from ntt_tpu_torch.transforms import mxu as tmxu

torch.set_num_threads(1)

JF, TF = jfields.BLS12_381_FR, tfields.BLS12_381_FR


def _words(field, shape, seed):
    """Canonical random elements as uint32[W, *shape] (top word < p's)."""
    rng = np.random.default_rng(seed)
    W = field.n_words
    x = rng.integers(0, 1 << 32, size=(W,) + shape, dtype=np.uint64)
    x[W - 1] = rng.integers(0, field.p >> (32 * (W - 1)), size=shape,
                            dtype=np.uint64)
    return x.astype(np.uint32)


@pytest.mark.parametrize("m", [4, 8, 32])
def test_conv_matrix_byte_equal(m):
    rng = np.random.default_rng(m)
    entries = [[int.from_bytes(rng.bytes(40), "little") % TF.p
                for _ in range(m)] for _ in range(m)]
    got = tdigits.conv_matrix(entries, TF)
    assert got.dtype == np.int8 and got.shape == (37 * m, 37 * m)
    assert np.array_equal(got, jdigits.conv_matrix(entries, JF))
    assert np.array_equal(tmxu._base_matrix(TF, m),
                          np.asarray(jmxu._base_matrix(JF, m, False)))


@pytest.mark.parametrize("name", ["bn254-fr", "bls12-381-fr"])
def test_fold_matrices_byte_equal(name):
    jf, tf = jfields.get_field(name), tfields.get_field(name)
    for m in (2, 8, 32):
        assert np.array_equal(tmxu._fold_matrix(tf, m),
                              np.asarray(jmxu._fold_matrix(jf, m)))
        zb = tmxu._zmax_bits(tf, m)
        assert zb == jmxu._zmax_bits(jf, m)
        assert tdigits.halves_info(37, zb) == jdigits.halves_info(37, zb)
    assert np.array_equal(tdigits.fold_mul_matrix(tf),
                          jdigits.fold_mul_matrix(jf))
    assert tdigits.matrix_prescale(tf) == jdigits.matrix_prescale(jf)


def test_twiddle_matrix_stack_byte_equal():
    rng = np.random.default_rng(7)
    tvals = [[int.from_bytes(rng.bytes(40), "little") % TF.p
              for _ in range(32)] for _ in range(2)]
    got = tmxu.twiddle_matrix_stack(TF, 32, False, tvals)
    assert got.shape == (2, 1184, 1184)
    assert np.array_equal(got, jmxu.twiddle_matrix_stack(JF, 32, False,
                                                         tvals))


def test_extract_digits_and_recompose_reduce():
    m, B = 32, 16
    x = _words(TF, (m, B), 11)
    d = tdigits.extract_digits(torch.from_numpy(x), TF)
    assert d.dtype == torch.int8
    assert np.array_equal(d.numpy(), np.asarray(jdigits.extract_digits(
        jnp.asarray(x), JF)))
    zb = tmxu._zmax_bits(TF, m)
    rng = np.random.default_rng(12)
    Z = rng.integers(0, 1 << zb, size=(37, m, B), dtype=np.int64)
    got = tdigits.recompose_reduce(torch.from_numpy(Z), TF, zb)
    want = jdigits.recompose_reduce(jnp.asarray(Z.astype(np.int32)), JF, zb)
    assert got.dtype == torch.uint32
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_mont_mul_fold():
    m, B = 32, 16
    x = _words(TF, (m, B), 13)
    y = _words(TF, (m, B), 14)
    F2 = tdigits.fold_mul_matrix(TF)
    got = tdigits.mont_mul_fold(torch.from_numpy(x), torch.from_numpy(y), TF,
                                torch.from_numpy(F2))
    want = jdigits.mont_mul_fold(jnp.asarray(x), jnp.asarray(y), JF,
                                 jnp.asarray(F2))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_apply_matrix():
    m, B = 32, 16
    x = _words(TF, (m, B), 15)
    A = tmxu._base_matrix(TF, m)
    F = tmxu._fold_matrix(TF, m)
    zb = tmxu._zmax_bits(TF, m)
    got = tdigits.apply_matrix(torch.from_numpy(A), torch.from_numpy(x), TF,
                               m, zb, fold_mat=torch.from_numpy(F))
    want = jdigits.apply_matrix(jnp.asarray(A), jnp.asarray(x), JF, m, zb,
                                fold_mat=jnp.asarray(F))
    assert np.array_equal(got.numpy(), np.asarray(want))

"""The inverse and coset entry points of the port on the 256-bit fields
(``mxu_chunked``).

Against the same calls of ntt_tpu at 2^10 (two levels; the coset rides the
first level's conv matrix and twiddle table): BLS12-381 Fr ``intt`` and
``coset_ntt``, BN254 Fr ``intt``. The JAX package's interpret-mode run costs
about 20 s a call here, so the other forms and the larger sizes are held
against the host golden NTT and ntt_tpu.oracle: ``coset_intt``, a
Montgomery-form call, the whole-vector coset at n = 32, and the
matrix-folded coset, inverse and LDE at 2^17. Canonical words out: the
tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

import ntt_tpu as nt
from ntt_tpu import oracle
import ntt_tpu_torch as tnt
from ntt_tpu_torch import hostlib as thostlib
from ntt_tpu_torch import limbs as tlimbs

torch.set_num_threads(1)

BLS, JBLS = tnt.BLS12_381_FR, nt.BLS12_381_FR


def _words(field, n, seed):
    """Canonical random elements as uint32[W, n] (top word < p's)."""
    rng = np.random.default_rng(seed)
    W = field.n_words
    x = rng.integers(0, 1 << 32, size=(W, n), dtype=np.uint64)
    x[W - 1] = rng.integers(0, field.p >> (32 * (W - 1)), size=n,
                            dtype=np.uint64)
    return x.astype(np.uint32)


def _rows(x):
    return np.ascontiguousarray(x.T).view(np.uint64)


def _golden(field, x, inverse=False):
    """The port's hostlib golden NTT of standard-form planes."""
    return thostlib.host_planes(thostlib.ntt_np(_rows(x), field, inverse),
                                field.n_words)


def _golden_coset(field, x, shift):
    pw = thostlib.powers_np(shift, x.shape[1], field)
    xs = thostlib.host_planes(
        thostlib.mul_mod_vec_np(_rows(x), _rows(pw), field), field.n_words)
    return _golden(field, xs)


@pytest.mark.parametrize("name, call", [("bls12-381-fr", "intt"),
                                        ("bls12-381-fr", "coset_ntt"),
                                        ("bn254-fr", "intt")])
def test_call_equals_jax_at_2e10(name, call):
    jf, tf = nt.get_field(name), tnt.get_field(name)
    x = _words(tf, 1 << 10, 10)
    want = np.asarray(getattr(nt, call)(x, jf))
    got = getattr(tnt, call)(x, tf, device="cpu")
    assert np.array_equal(got.numpy(), want)


def test_coset_forms_at_2e10_equal_golden():
    x = _words(BLS, 1 << 10, 11)
    y = tnt.coset_ntt(x, BLS, shift=5, device="cpu")
    assert np.array_equal(y.numpy(), _golden_coset(BLS, x, 5))
    back = tnt.coset_intt(y, BLS, shift=5, device="cpu")
    assert np.array_equal(back.numpy(), x)
    xm = tlimbs.to_mont(torch.from_numpy(x), BLS)
    ym = tnt.coset_ntt(xm, BLS, shift=5, mont_io=True, device="cpu")
    assert np.array_equal(tlimbs.from_mont(ym, BLS).numpy(), y.numpy())


def test_small_sizes_equal_oracle():
    """n = 32: one base transform, the coset as a whole-vector product;
    n = 64: a 2-point base."""
    for n in (32, 64):
        vals = [int(v) for v in np.random.default_rng(n).integers(
            0, 1 << 62, size=n)]
        x = tnt.from_ints(vals, BLS)
        got = tnt.to_ints(tnt.coset_ntt(x, BLS, device="cpu"), BLS)
        assert got == oracle.coset_ntt_golden(vals, JBLS, JBLS.generator)
        got = tnt.to_ints(tnt.intt(x, BLS, device="cpu"), BLS)
        assert got == oracle.intt_golden(vals, JBLS)
        back = tnt.coset_intt(tnt.coset_ntt(x, BLS, device="cpu"), BLS,
                              device="cpu")
        assert tnt.to_ints(back, BLS) == vals


def test_matrix_folded_inverse_and_coset_at_2e17_equal_golden():
    """From 2^17 the coset is absorbed into the level-0 matrix stack and
    the merged table."""
    x = _words(BLS, 1 << 17, 17)
    y = tnt.coset_ntt(x, BLS, device="cpu")
    assert np.array_equal(y.numpy(), _golden_coset(BLS, x, BLS.generator))
    got = tnt.intt(x, BLS, device="cpu")
    assert np.array_equal(got.numpy(), _golden(BLS, x, inverse=True))
    back = tnt.coset_intt(y, BLS, device="cpu")
    assert np.array_equal(back.numpy(), x)


def test_lde_bn254_equals_golden():
    f = tnt.BN254_FR
    n = 1 << 8
    x = _words(f, n, 8)
    coeffs = _golden(f, x, inverse=True)
    padded = np.concatenate(
        [coeffs, np.zeros((f.n_words, 3 * n), dtype=np.uint32)], axis=1)
    got = tnt.lde(x, f, blowup=4, device="cpu")
    assert np.array_equal(got.numpy(), _golden_coset(f, padded, f.generator))


def test_polymul_bls_is_the_schoolbook_product():
    a = [BLS.p - 1, 2, 3, BLS.p - 4]
    b = [5, BLS.p - 6, 7, 8]
    want = [0] * 8
    for i, u in enumerate(a):
        for j, v in enumerate(b):
            want[i + j] = (want[i + j] + u * v) % BLS.p
    got = tnt.polymul(tnt.from_ints(a, BLS), tnt.from_ints(b, BLS), BLS,
                      device="cpu")
    assert tnt.to_ints(got, BLS) == want

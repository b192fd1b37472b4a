"""ntt_tpu_torch fields, limbs and hostlib against ntt_tpu, word for word.

Inputs are made with numpy from fixed seeds and fed to both packages;
outputs are canonical words, so the tolerance is exact equality.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import ntt_tpu.fields as jfields
import ntt_tpu.limbs as jlimbs
from ntt_tpu import oracle
import ntt_tpu_torch.fields as tfields
from ntt_tpu_torch import hostlib as thostlib
from ntt_tpu_torch import limbs as tlimbs
from ntt_tpu_torch.transforms import core as tcore

torch.set_num_threads(1)

WIDE = ["bn254-fr", "bls12-381-fr"]


def _random_values(field, count, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(40), "little") % field.p
            for _ in range(count)]


@pytest.mark.parametrize("name", sorted(jfields.FIELDS))
def test_field_constants_equal(name):
    jf, tf = jfields.get_field(name), tfields.get_field(name)
    for attr in ("name", "p", "generator", "two_adicity", "bits", "n_words",
                 "n_halves", "mont_bits", "R", "R2", "R_inv", "np0",
                 "p_halves"):
        assert getattr(tf, attr) == getattr(jf, attr), attr
    for log_n in range(0, tf.two_adicity + 1, 3):
        n = 1 << log_n
        assert tf.root_of_unity(n) == jf.root_of_unity(n)
        assert tf.inv_root_of_unity(n) == jf.inv_root_of_unity(n)
    assert tf.p * tf.np0_32 % (1 << 32) == (1 << 32) - 1
    tf.validate()


@pytest.mark.parametrize("name", WIDE)
def test_from_to_ints_and_canonical(name):
    jf, tf = jfields.get_field(name), tfields.get_field(name)
    vals = _random_values(tf, 256, 1)
    x = tlimbs.from_ints(vals, tf)
    assert x.dtype == torch.uint32
    assert np.array_equal(x.numpy(), np.asarray(jlimbs.from_ints(vals, jf)))
    assert tlimbs.to_ints(x, tf) == vals == jlimbs.to_ints(x.numpy(), jf)
    over = tlimbs.from_ints([tf.p, tf.p + 5, tf.p - 1], tf)
    assert tlimbs.is_canonical(over, tf).tolist() == [False, False, True]
    assert np.array_equal(tlimbs.is_canonical(x, tf).numpy(),
                          np.asarray(jlimbs.is_canonical(x.numpy(), jf)))


@pytest.mark.parametrize("name", WIDE)
def test_mont_mul_and_conversions(name):
    jf, tf = jfields.get_field(name), tfields.get_field(name)
    a = tlimbs.from_ints(_random_values(tf, 256, 2), tf)
    b = tlimbs.from_ints(_random_values(tf, 256, 3), tf)
    got = tlimbs.mont_mul(a, b, tf)
    assert np.array_equal(got.numpy(), np.asarray(
        jlimbs.mont_mul(a.numpy(), b.numpy(), jf)))
    want = [x * y * tf.R_inv % tf.p for x, y in
            zip(tlimbs.to_ints(a, tf), tlimbs.to_ints(b, tf))]
    assert tlimbs.to_ints(got, tf) == want
    m = tlimbs.to_mont(a, tf)
    assert np.array_equal(m.numpy(), np.asarray(jlimbs.to_mont(a.numpy(), jf)))
    back = tlimbs.from_mont(m, tf)
    assert np.array_equal(back.numpy(), a.numpy())
    assert np.array_equal(back.numpy(),
                          np.asarray(jlimbs.from_mont(m.numpy(), jf)))


@pytest.mark.parametrize("name", WIDE)
def test_mont_reduce_wide(name):
    """Reduce the lazy schoolbook half-product planes of a*b by 2^256."""
    jf, tf = jfields.get_field(name), tfields.get_field(name)
    a = tlimbs.from_ints(_random_values(tf, 256, 4), tf)
    b = tlimbs.from_ints(_random_values(tf, 256, 5), tf)
    ha = [h.numpy() for h in tlimbs.unpack(a)]
    hb = [h.numpy() for h in tlimbs.unpack(b)]
    L = tf.n_halves
    planes = [np.zeros(256, np.int64) for _ in range(2 * L + 1)]
    for i in range(L):
        for j in range(L):
            prod = ha[i] * hb[j]
            planes[i + j] += prod & 0xFFFF
            planes[i + j + 1] += prod >> 16
    got = tlimbs.mont_reduce_wide([torch.from_numpy(p) for p in planes], tf, L)
    want = jlimbs.mont_reduce_wide([p.astype(np.uint32) for p in planes],
                                   jf, L)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy(), tlimbs.mont_mul(a, b, tf).numpy())


def test_hostlib_powers_and_golden():
    """The port's own hostlib build equals the pure-Python powers and
    ntt_tpu.oracle's Python-int golden NTT (forward and inverse): no port
    test needs the JAX package's hostlib build."""
    f = tfields.BLS12_381_FR
    jf = jfields.BLS12_381_FR
    w = f.root_of_unity(1 << 10)
    got = thostlib.powers_np(w, 1000, f, mont_form=True)
    assert np.array_equal(got, tcore.host_powers(f, w, 1000))
    assert np.array_equal(tcore.host_power_matrix(f, w, 4, 6),
                          got[:, np.outer(np.arange(4), np.arange(6))])
    rows = thostlib.ramp_np(64)
    want = oracle.ntt_golden(oracle.ramp(64, jf), jf)
    assert np.array_equal(thostlib.ntt_np(rows, f),
                          thostlib.ints_to_rows(want))
    assert np.array_equal(
        thostlib.ntt_np(thostlib.ints_to_rows(want), f, inverse=True), rows)


def test_import_leaves_jax_out():
    """Importing the port (and its API, kernels, transforms and the
    multi-device path) loads neither JAX nor ntt_tpu."""
    code = ("import sys, ntt_tpu_torch, ntt_tpu_torch.api, "
            "ntt_tpu_torch.kernels._build, ntt_tpu_torch.transforms.mxu, "
            "ntt_tpu_torch.parallel; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ntt_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr

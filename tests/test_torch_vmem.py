"""Kernels K5 and K6 (plain versions) and the algorithms ``pallas`` and
``pallas_fused`` of the port against ntt_tpu on the CPU.

K5 stage_ntt         <- ntt_tpu.kernels.vmem_ntt.ntt_along_axis_pallas
K6 fused_stage_level <- ntt_tpu.kernels.vmem_ntt.fused_stage_level

The JAX entries run as the JAX package's own tests run them on the CPU
(Pallas interpret mode); the port's wrappers run their plain versions
because the tensors lie on the CPU. Canonical Montgomery words out: the
tolerance is exact equality. The API comparisons run at the combinations
tests/test_pallas.py compiles; the suffix-reversing relayout of
``pallas_fused`` beyond one level pair (n = 2^15 on a narrow field, which
no JAX test reaches) is held against the host golden NTT.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ntt_tpu as nt
from ntt_tpu.api import get_runner as j_get_runner
from ntt_tpu.kernels.vmem_ntt import fused_stage_level as j_fused_stage_level
from ntt_tpu.kernels.vmem_ntt import ntt_along_axis_pallas as j_stage_ntt
from ntt_tpu.transforms import fourstep as jfourstep
from ntt_tpu.transforms import mxu as jmxu
import ntt_tpu_torch as tnt
from ntt_tpu_torch import api as tapi
from ntt_tpu_torch import hostlib as thostlib
from ntt_tpu_torch import limbs as tlimbs
from ntt_tpu_torch.kernels import _build, vmem_ntt
from ntt_tpu_torch.transforms import fourstep as tfourstep
from ntt_tpu_torch.transforms import mxu as tmxu

torch.set_num_threads(1)

FIELDS = ["small-proth", "goldilocks", "bn254-fr", "bls12-381-fr"]


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


# --- K5 and K6, plain version against the Pallas entry -----------------------

@pytest.mark.parametrize("name, m, B, inverse", [
    ("small-proth", 64, 128, False), ("small-proth", 256, 8, True),
    ("goldilocks", 16, 128, False), ("goldilocks", 2, 4, True),
    ("bn254-fr", 8, 128, False)])
def test_stage_ntt_plain_equals_pallas(name, m, B, inverse):
    jf, tf = nt.get_field(name), tnt.get_field(name)
    x = _words(tf, (m, B), m)
    got = vmem_ntt.stage_ntt(torch.from_numpy(x), tf, inverse)
    want = j_stage_ntt(jnp.asarray(x), jf, inverse=inverse)
    assert got.dtype == torch.uint32 and got.shape == (tf.n_words, m, B)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name, m, B, inverse, has_tw, transpose", [
    ("small-proth", 64, 128, False, True, True),
    ("small-proth", 64, 128, False, False, False),
    ("small-proth", 128, 16, True, True, False),
    ("goldilocks", 16, 128, False, True, True),
    ("goldilocks", 16, 128, True, False, True),
    ("bn254-fr", 8, 128, False, True, True)])
def test_fused_stage_level_plain_equals_pallas(name, m, B, inverse, has_tw,
                                               transpose):
    jf, tf = nt.get_field(name), tnt.get_field(name)
    x = _words(tf, (m, B), m + 1)
    T3 = _words(tf, (m, B), m + 2) if has_tw else None
    got = vmem_ntt.fused_stage_level(
        torch.from_numpy(x), tf, inverse,
        None if T3 is None else torch.from_numpy(T3), transpose)
    want = j_fused_stage_level(jnp.asarray(x), jf, inverse,
                               None if T3 is None else jnp.asarray(T3),
                               transpose_out=transpose)
    assert got.shape == ((tf.n_words, B, m) if transpose
                         else (tf.n_words, m, B))
    assert got.is_contiguous()
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", FIELDS)
def test_stage_kernels_are_the_golden_ntt(name):
    """Both wrappers on every field, against the host golden NTT column by
    column; K6's epilogue is a Montgomery product and a transpose."""
    tf = tnt.get_field(name)
    m, B = 32, 3
    x = _words(tf, (m, B), 5)
    xm = tlimbs.to_mont(torch.from_numpy(x), tf)
    y = vmem_ntt.stage_ntt(xm, tf)
    ys = tlimbs.from_mont(y, tf).numpy()
    for j in range(B):
        assert np.array_equal(ys[:, :, j],
                              _golden(tf, np.ascontiguousarray(x[:, :, j])))
    T3 = torch.from_numpy(_words(tf, (m, B), 6))
    got = vmem_ntt.fused_stage_level(xm, tf, False, T3, True)
    want = tlimbs.mont_mul(y, T3, tf).transpose(1, 2)
    assert np.array_equal(got.numpy(), want.numpy())
    assert np.array_equal(
        vmem_ntt.fused_stage_level(xm, tf, False, None, False).numpy(),
        y.numpy())


def test_wrappers_check_their_operands():
    tf = tnt.SMALL
    x = torch.from_numpy(_words(tf, (16, 8), 7))
    with pytest.raises(ValueError, match="T3"):
        vmem_ntt.fused_stage_level(x, tf, False, x[:, :8], True)
    with pytest.raises(ValueError, match="CUDA"):
        vmem_ntt.stage_ntt(x.to("meta"), tf)
    with pytest.raises(ValueError, match="CUDA"):
        vmem_ntt.fused_stage_level(x.to("meta"), tf)
    one = x[:, :1]                      # m == 1 is the identity
    assert vmem_ntt.stage_ntt(one, tf) is one
    assert vmem_ntt.fused_stage_level(one, tf).shape == (1, 8, 1)


def test_cpu_tensors_launch_nothing():
    tf = tnt.GOLDILOCKS
    before = dict(_build.launches)
    tnt.ntt(_words(tf, (1 << 9,), 8), tf, algorithm="pallas", device="cpu")
    tnt.ntt(_words(tf, (1 << 9,), 8), tf, algorithm="pallas_fused",
            device="cpu")
    assert dict(_build.launches) == before


# --- sizes and tables ---------------------------------------------------------

@pytest.mark.parametrize("name", FIELDS)
def test_base_sizes_equal_jax(name):
    jf, tf = nt.get_field(name), tnt.get_field(name)
    assert tfourstep.pallas_base_max(tf) == jfourstep.pallas_base_max(jf)
    assert tfourstep.fused_m(tf) == jfourstep.fused_m(jf)
    assert tfourstep.BASE_MAX == jfourstep.BASE_MAX


@pytest.mark.parametrize("name, log_n, inverse", [
    ("small-proth", 15, False), ("goldilocks", 11, True),
    ("bn254-fr", 9, False)])
def test_expanded_twiddles_equal_jax(name, log_n, inverse):
    """Byte for byte, at the pallas_fused level size and at the mxu one."""
    jf, tf = nt.get_field(name), tnt.get_field(name)
    n = 1 << log_n
    for base in (tfourstep.fused_m(tf), tmxu.BASE):
        got = tmxu.expanded_twiddles(tf, n, inverse, base=base)
        want = jmxu.expanded_twiddles(jf, n, inverse, base=base)
        assert len(got) == len(want)
        for t, jt in zip(got, want):
            jt = np.asarray(jt)
            assert t.shape == (tf.n_words, base, n // base)
            assert t.dtype == jt.dtype and np.array_equal(t, jt)


@pytest.mark.parametrize("algo, name, log_n", [
    ("pallas", "goldilocks", 10), ("pallas", "bn254-fr", 7),
    ("pallas_fused", "small-proth", 11)])
def test_table_lists_equal_jax(algo, name, log_n):
    """The prepared tables byte for byte, and the JAX package's aux, as
    numpy arrays, through aux_from_numpy into the port's transform."""
    jf, tf = nt.get_field(name), tnt.get_field(name)
    n = 1 << log_n
    _, jaux = j_get_runner(jf, n, False, algo, True, None)
    jtws = [np.asarray(t) for t in jaux["tws"]]
    tws, mats = tapi.ALGORITHMS[algo][1](tf, n, False)
    assert mats == {} and len(tws) == len(jtws) >= 1
    for t, jt in zip(tws, jtws):
        assert t.dtype == jt.dtype and np.array_equal(t, jt)
    aux = tapi.aux_from_numpy(jtws, {}, device="cpu")
    x = _words(tf, (n,), log_n)
    xm = tlimbs.to_mont(torch.from_numpy(x), tf)
    got = tapi.ALGORITHMS[algo][0](xm, tf, False, aux)
    assert np.array_equal(tlimbs.from_mont(got, tf).numpy(), _golden(tf, x))


# --- pallas and pallas_fused through the API, against ntt_tpu ---------------

@pytest.mark.parametrize("name, log_n", [
    ("small-proth", 3), ("small-proth", 6), ("small-proth", 9),
    ("bn254-fr", 5), ("goldilocks", 10)])
def test_pallas_equals_jax(name, log_n):
    jf, tf = nt.get_field(name), tnt.get_field(name)
    x = _words(tf, (1 << log_n,), log_n)
    for call in ("ntt", "intt"):
        want = np.asarray(getattr(nt, call)(x, jf, algorithm="pallas"))
        got = getattr(tnt, call)(x, tf, algorithm="pallas", device="cpu")
        assert np.array_equal(got.numpy(), want), call


@pytest.mark.parametrize("log_n", [8, 9, 11])
def test_pallas_fused_small_field_equals_jax(log_n):
    jf, tf = nt.SMALL, tnt.SMALL
    x = _words(tf, (1 << log_n,), log_n)
    want = np.asarray(nt.ntt(x, jf, algorithm="pallas_fused"))
    got = tnt.ntt(x, tf, algorithm="pallas_fused", device="cpu")
    assert np.array_equal(got.numpy(), want)


def test_pallas_fused_bn254_equals_jax():
    jf, tf = nt.BN254_FR, tnt.BN254_FR
    x = _words(tf, (32,), 32)
    for call in ("ntt", "intt"):
        want = np.asarray(getattr(nt, call)(x, jf, algorithm="pallas_fused"))
        got = getattr(tnt, call)(x, tf, algorithm="pallas_fused",
                                 device="cpu")
        assert np.array_equal(got.numpy(), want), call


@pytest.mark.parametrize("algo", ["pallas", "pallas_fused"])
def test_mont_io_and_coset_equal_jax(algo):
    """Montgomery-form I/O, coset and coset-inverse on the small field at
    n = 2^9: above the pallas base (256, so the coset rides the top level)
    and above the pallas_fused level (128, a whole-vector product)."""
    jf, tf = nt.SMALL, tnt.SMALL
    x = _words(tf, (1 << 9,), 9)
    xm = tlimbs.to_mont(torch.from_numpy(x), tf).numpy()
    want = np.asarray(nt.ntt(xm, jf, algorithm=algo, mont_io=True))
    got = tnt.ntt(xm, tf, algorithm=algo, mont_io=True, device="cpu")
    assert np.array_equal(got.numpy(), want)
    for call in ("coset_ntt", "coset_intt"):
        want = np.asarray(getattr(nt, call)(x, jf, algorithm=algo))
        got = getattr(tnt, call)(x, tf, algorithm=algo, device="cpu")
        assert np.array_equal(got.numpy(), want), call
    _, aux = tapi.get_runner(tf, 1 << 9, algorithm=algo,
                             coset_shift=tf.generator, device="cpu")
    assert ("coset_col" in aux) == (algo == "pallas")


# --- the wider sweep, against the host golden NTT -----------------------------

@pytest.mark.parametrize("name, log_n, levels", [
    ("small-proth", 15, 2), ("goldilocks", 15, 2), ("bls12-381-fr", 13, 2),
    ("small-proth", 14, 1)])
def test_pallas_fused_relayout_equals_golden(name, log_n, levels):
    """More than one twiddled level: the suffix digits come out in reverse
    peel order and one relayout restores the four-step order."""
    tf = tnt.get_field(name)
    n = 1 << log_n
    assert len(tmxu.expanded_twiddles(
        tf, n, base=tfourstep.fused_m(tf))) == levels
    x = _words(tf, (n,), log_n)
    got = tnt.ntt(x, tf, algorithm="pallas_fused", device="cpu")
    assert np.array_equal(got.numpy(), _golden(tf, x))
    back = tnt.intt(got, tf, algorithm="pallas_fused", device="cpu")
    assert np.array_equal(back.numpy(), x)


@pytest.mark.parametrize("algo", ["pallas", "pallas_fused"])
@pytest.mark.parametrize("name", FIELDS)
def test_every_call_equals_golden(name, algo):
    tf = tnt.get_field(name)
    g = tf.generator
    for log_n in (1, 4, 10):
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


def test_batched_input():
    """``pallas`` takes a batch natively; the flat-peel transform takes
    unbatched input only, as in the JAX package."""
    tf = tnt.GOLDILOCKS
    x = _words(tf, (1 << 10, 3), 13)
    got = tnt.ntt(x, tf, algorithm="pallas", device="cpu").numpy()
    for j in range(3):
        assert np.array_equal(
            got[:, :, j], _golden(tf, np.ascontiguousarray(x[:, :, j])))
    with pytest.raises(AssertionError, match="unbatched"):
        tnt.ntt(x, tf, algorithm="pallas_fused", device="cpu")

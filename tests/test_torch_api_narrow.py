"""The port's entry points on the narrow fields (``mxu_sub``) against the same
calls of ntt_tpu, on the CPU (the kernels' plain versions; the JAX package's
Pallas kernels in interpret mode).

ntt, intt, coset_ntt and coset_intt at 2^9 (one 512-point base), 2^11 (a
512-point level and a 4-point base, the coset through a pre-multiplied
column) and 2^13 (a 16-point base), on Goldilocks and the small Proth prime,
standard-form and Montgomery-form I/O. Canonical words out: the tolerance is
exact equality.
"""

import numpy as np
import pytest
import torch

import ntt_tpu as nt
import ntt_tpu.limbs as jlimbs
import ntt_tpu_torch as tnt
from ntt_tpu_torch import limbs as tlimbs

torch.set_num_threads(1)

CALLS = ["ntt", "intt", "coset_ntt", "coset_intt"]


def _words(field, shape, seed):
    """Canonical random elements as uint32[W, *shape] (top word < p's)."""
    rng = np.random.default_rng(seed)
    W = field.n_words
    x = rng.integers(0, 1 << 32, size=(W,) + shape, dtype=np.uint64)
    x[W - 1] = rng.integers(0, field.p >> (32 * (W - 1)), size=shape,
                            dtype=np.uint64)
    return x.astype(np.uint32)


@pytest.mark.parametrize("call", CALLS)
@pytest.mark.parametrize("log_n", [9, 11, 13])
@pytest.mark.parametrize("name", ["goldilocks", "small-proth"])
def test_call_equals_jax(name, log_n, call):
    jf, tf = nt.get_field(name), tnt.get_field(name)
    x = _words(tf, (1 << log_n,), log_n)
    want = np.asarray(getattr(nt, call)(x, jf))
    got = getattr(tnt, call)(x, tf, device="cpu")
    assert got.dtype == torch.uint32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("call", CALLS)
def test_mont_io_call_equals_jax(call):
    """Montgomery words in and out, a shift other than the generator."""
    jf, tf = nt.GOLDILOCKS, tnt.GOLDILOCKS
    x = _words(tf, (1 << 11,), 5)
    kw = {"shift": 11} if call.startswith("coset") else {}
    xm = np.asarray(jlimbs.to_mont(x, jf))
    assert np.array_equal(tlimbs.to_mont(torch.from_numpy(x), tf).numpy(), xm)
    want = np.asarray(getattr(nt, call)(xm, jf, mont_io=True, **kw))
    got = getattr(tnt, call)(xm, tf, mont_io=True, device="cpu", **kw)
    assert np.array_equal(got.numpy(), want)


def test_explicit_algorithm_and_field_name():
    x = _words(tnt.SMALL, (1 << 9,), 1)
    want = np.asarray(nt.ntt(x, "small-proth", algorithm="mxu_sub"))
    got = tnt.ntt(x, "small-proth", algorithm="mxu_sub", device="cpu")
    assert np.array_equal(got.numpy(), want)


def test_roundtrips():
    """intt(ntt(x)) == x and coset_intt(coset_ntt(x)) == x at 2^14 (a
    32-point base), without the JAX package."""
    for f in (tnt.GOLDILOCKS, tnt.SMALL):
        x = torch.from_numpy(_words(f, (1 << 14,), 14))
        back = tnt.intt(tnt.ntt(x, f, device="cpu"), f, device="cpu")
        assert torch.equal(back, x)
        back = tnt.coset_intt(tnt.coset_ntt(x, f, device="cpu"), f,
                              device="cpu")
        assert torch.equal(back, x)

"""The port's transform under each knob of ``ntt_tpu_torch.config``,
against the golden result and, one transform a knob family, against the
JAX entry (Pallas in interpret mode), on the CPU.

- for each setting (the peel sizes, NTT_TW_MATFOLD=0 with NTT_FUSE_TW 1
  and 0, NTT_TW_STACK_MAX_NT, set alike in both packages by
  ``test_torch_knobs._set``) the port's transform at n = 2^7 to 2^16 is
  word-equal to the hostlib's golden result, as at the default knobs;
- for each family one transform is word-equal to the JAX entry: the peel
  sizes (small Proth, Goldilocks) and NTT_FUSE_TW=0 (Goldilocks); under
  NTT_MXU_BASE_LOG=6 (the single-level kernels' plain versions at
  m = 64) Goldilocks 2^12 under ``mxu_chunked`` and ``mxu_fused``, and
  one 256-bit transform, BLS12-381 Fr 2^7 ``mxu_chunked`` (about 20 s on
  one CPU core, most of it the JAX package's trace and compile). No other
  256-bit JAX transform: where the 256-bit knobs act, one costs 20 s to a
  minute, and the suite's longest file (``test_mxu.py``, on one worker)
  sets its time; the 256-bit settings are held against the golden
  result, and their plans and tables against the JAX package's
  (``test_torch_knobs.py``).

Canonical words out: the tolerance is exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ntt_tpu as nt
import ntt_tpu_torch as tnt
from ntt_tpu_torch import limbs as tlimbs
from test_torch_knobs import (_fresh_caches, _golden, _set,  # noqa: F401
                              _words)

torch.set_num_threads(1)


# --- the transform under each knob -------------------------------------------

def _port(x, field, algorithm, **kw):
    return tnt.ntt(x, field, algorithm=algorithm, device="cpu", **kw).numpy()


#: (label, knobs, field, log n, algorithms): the port under the knobs
#: against the golden result, which the port at the default knobs gives
#: (the tests of the default paths)
TRANSFORMS = [
    ("BASE_LOG=4", {"BASE_LOG": 4}, "bls12-381-fr", 15, ("mxu_chunked",)),
    ("BASE_LOG=4", {"BASE_LOG": 4}, "goldilocks", 12,
     ("mxu_fused", "mxu_pallas", "mxu_sub")),
    ("SUBBASE_LOG=8", {"SUBBASE_LOG": 8}, "small-proth", 12, ("mxu_sub",)),
    ("SUBBASE_LOG=10", {"SUBBASE_LOG": 10}, "small-proth", 12,
     ("mxu_sub",)),
    ("SUB256_LOG=6", {"SUB256_LOG": 6}, "bn254-fr", 7, ("mxu_sub",)),
    ("SUB256_LOG=7", {"SUB256_LOG": 7}, "bls12-381-fr", 9, ("mxu_sub",)),
    ("TW_MATFOLD=0", {"TW_MATFOLD": False}, "bls12-381-fr", 16,
     ("mxu_chunked",)),
    ("TW_MATFOLD=0,FUSE_TW=0", {"TW_MATFOLD": False, "FUSE_TW": False},
     "bls12-381-fr", 12, ("mxu_chunked",)),
    ("TW_STACK_MAX_NT=1", {"BASE_LOG": 4, "TW_STACK_MAX_NT": 1},
     "bls12-381-fr", 13, ("mxu_chunked", "mxu_sub")),
    ("BASE_LOG=6", {"BASE_LOG": 6}, "goldilocks", 16,
     ("mxu_chunked", "mxu_fused", "mxu_pallas", "mxu_sub")),
    ("BASE_LOG=6", {"BASE_LOG": 6}, "small-proth", 13,
     ("mxu_chunked", "mxu_fused", "mxu_pallas", "mxu_sub")),
    ("BASE_LOG=6", {"BASE_LOG": 6}, "bls12-381-fr", 16,
     ("mxu_chunked", "mxu_fused")),
    ("BASE_LOG=6", {"BASE_LOG": 6}, "bls12-381-fr", 12,
     ("mxu_pallas", "mxu_sub")),
]


@pytest.mark.parametrize("label, knobs, name, log_n, algorithms",
                         TRANSFORMS,
                         ids=[f"{t[0]}-{t[2]}-{t[3]}" for t in TRANSFORMS])
def test_transform_under_knob_equals_golden(monkeypatch, label, knobs, name,
                                            log_n, algorithms):
    f = tnt.get_field(name)
    x = _words(f, 1 << log_n, log_n)
    want = _golden(f, x)
    _set(monkeypatch, **knobs)
    for alg in algorithms:
        assert np.array_equal(_port(x, f, alg), want), alg


# --- against the JAX entry, one transform a family ---------------------------

def _jax(x, jf, algorithm, **kw):
    return np.asarray(nt.ntt(jnp.asarray(x), jf, algorithm=algorithm,
                             mont_io=True, **kw))


#: (family, knobs, field, log n, algorithm, coset): the port's transform
#: word-equal to the JAX entry (Montgomery I/O) under the same knobs
AGAINST_JAX = [
    ("peel", {"BASE_LOG": 4}, "small-proth", 10, "mxu_chunked", False),
    ("peel", {"BASE_LOG": 4}, "small-proth", 10, "mxu_chunked", True),
    ("peel", {"SUBBASE_LOG": 8}, "goldilocks", 12, "mxu_sub", False),
    ("fuse", {"TW_MATFOLD": False, "FUSE_TW": False}, "goldilocks", 12,
     "mxu_chunked", False),
    ("base64", {"BASE_LOG": 6}, "goldilocks", 12, "mxu_chunked", False),
    ("base64", {"BASE_LOG": 6}, "goldilocks", 12, "mxu_fused", False),
    ("base64", {"BASE_LOG": 6}, "bls12-381-fr", 7, "mxu_chunked", False),
]


@pytest.mark.parametrize(
    "family, knobs, name, log_n, algorithm, coset", AGAINST_JAX,
    ids=[f"{a[0]}-{a[2]}-{a[4]}{'-coset' if a[5] else ''}"
         for a in AGAINST_JAX])
def test_transform_under_knob_equals_jax(monkeypatch, family, knobs, name,
                                         log_n, algorithm, coset):
    jf, tf = nt.get_field(name), tnt.get_field(name)
    _set(monkeypatch, **knobs)
    x = _words(tf, 1 << log_n, log_n + 1)
    kw = {"coset_shift": tf.generator} if coset else {}
    got = tnt.ntt(x, tf, algorithm=algorithm, mont_io=True, device="cpu",
                  **kw).numpy()
    assert np.array_equal(got, _jax(x, jf, algorithm, **kw))
    if not coset:
        want = _golden(tf, tlimbs.from_mont(torch.from_numpy(x), tf).numpy())
        assert np.array_equal(tlimbs.from_mont(torch.from_numpy(got),
                                               tf).numpy(), want)

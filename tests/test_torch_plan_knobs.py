"""The JAX package's three plan-only knobs in the port: NTT_RADIX4,
NTT_RESIDENT_SPLIT and NTT_FACTOR_TW_MIN, on the CPU.

Each picks another plan of the JAX package's ladders or four-step and
never its output words; the port keeps its default plan under them and
warns when a runner is built under one (``config.warn_plan_only_knobs``).
The tests hold that:

- the port reads each variable by the JAX package's rule for "set";
- ``api.get_runner`` and ``make_dist_ntt`` warn, naming the knob, and
  their runners are the default's, tables and words alike;
- under each knob, set in the JAX package too (``transforms.core.RADIX4``,
  ``api.FACTOR_TW_MIN``, the environment for NTT_RESIDENT_SPLIT, with the
  JAX package's ``core.CHUNK_SINGLE`` shrunk so that its residency split
  engages at 2^12 instead of above 2^18), the port's transform and coset
  transform equal the JAX entry's (Pallas in interpret mode, narrow
  fields) and the golden result of ``ntt_tpu_torch.hostlib``;
- where the JAX package fails under a knob (``mxu_sub`` under the
  residency split: its matrices lack a base size the split reaches), the
  port runs its default plan and gives the golden words.

Canonical words out: the tolerance is exact equality.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ntt_tpu as nt
from ntt_tpu import api as japi
from ntt_tpu import limbs as jlimbs
from ntt_tpu.parallel import make_dist_ntt as j_make_dist_ntt
from ntt_tpu.parallel import make_mesh as j_make_mesh
from ntt_tpu.parallel import shard_for_ntt as j_shard_for_ntt
from ntt_tpu.parallel import unshard as j_unshard
from ntt_tpu.transforms import core as jcore
import ntt_tpu_torch as tnt
from ntt_tpu_torch import api as tapi
from ntt_tpu_torch import config as tconfig
from ntt_tpu_torch import limbs as tlimbs
from ntt_tpu_torch.parallel import (make_dist_ntt, make_mesh, shard_for_ntt,
                                    unshard)
from test_torch_knobs import _golden, _words

torch.set_num_threads(1)

KNOBS = ("NTT_RADIX4", "NTT_RESIDENT_SPLIT", "NTT_FACTOR_TW_MIN")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """No plan-only knob from the environment; empty runner caches before
    and after (the JAX package's compiled cache is not keyed by
    CHUNK_SINGLE, and the port warns only when it builds a runner)."""
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    japi._compiled_cache.clear()
    tapi._runner_cache.clear()
    yield
    japi._compiled_cache.clear()
    tapi._runner_cache.clear()


#: (environment, what ``plan_only_knobs`` names): the JAX package's rule,
#: "1" for the two flags (``core.py:189``, ``fourstep.py:127``), a non-zero
#: integer for the size (``api.py:48``)
READS = [({}, []),
         ({"NTT_RADIX4": "0", "NTT_RESIDENT_SPLIT": "0",
           "NTT_FACTOR_TW_MIN": "0"}, []),
         ({"NTT_RADIX4": "true", "NTT_RESIDENT_SPLIT": "2"}, []),
         ({"NTT_RADIX4": "1"}, ["NTT_RADIX4=1"]),
         ({"NTT_RESIDENT_SPLIT": "1"}, ["NTT_RESIDENT_SPLIT=1"]),
         ({"NTT_FACTOR_TW_MIN": "1048576"}, ["NTT_FACTOR_TW_MIN=1048576"]),
         ({"NTT_RADIX4": "1", "NTT_RESIDENT_SPLIT": "1",
           "NTT_FACTOR_TW_MIN": "256"},
          ["NTT_RADIX4=1", "NTT_RESIDENT_SPLIT=1", "NTT_FACTOR_TW_MIN=256"])]


@pytest.mark.parametrize("env, named", READS,
                         ids=["unset", "zeros", "not-one", "radix4",
                              "resident", "factor", "all"])
def test_plan_only_knobs_follow_the_jax_rule(monkeypatch, env, named):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert tconfig.plan_only_knobs() == named


def test_factor_tw_min_not_an_integer_raises(monkeypatch):
    """As the JAX package's import does (``int(...)`` of the variable)."""
    monkeypatch.setenv("NTT_FACTOR_TW_MIN", "2^20")
    with pytest.raises(ValueError):
        tconfig.plan_only_knobs()


def _same(a, b):
    """Two runners' aux alike: the same keys, tables and plan, word for
    word (a deep table by its laid-out tensor)."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(map(_same, a, b)))
    if hasattr(a, "__dict__"):
        return type(a) is type(b) and _same(vars(a), vars(b))
    return a == b


@pytest.mark.parametrize("knob, value", [("NTT_RADIX4", "1"),
                                         ("NTT_RESIDENT_SPLIT", "1"),
                                         ("NTT_FACTOR_TW_MIN", "256")])
def test_runner_warns_and_keeps_the_default_plan(monkeypatch, knob, value):
    """Goldilocks 2^12 ``mxu_chunked``: the runner built under the knob
    warns, naming it, and has the default runner's tables and words; with
    no knob set nothing warns."""
    f, n = tnt.get_field("goldilocks"), 1 << 12
    x = _words(f, n, 3)
    xm = tlimbs.to_mont(torch.from_numpy(x), f)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        plain = tapi.get_runner(f, n, algorithm="mxu_chunked", device="cpu")
    assert not [w for w in caught if "default plan" in str(w.message)]
    monkeypatch.setenv(knob, value)
    with pytest.warns(UserWarning, match=f"{knob}={value}.*default plan"):
        under = tapi.get_runner(f, n, algorithm="mxu_chunked", device="cpu")
    assert _same(under[1], plain[1])
    want = _golden(f, x)
    for run, aux in (plain, under):
        assert np.array_equal(tlimbs.from_mont(run(xm, aux), f).numpy(),
                              want)


def _set(monkeypatch, knob, value, chunk_single=None):
    """The knob in both packages: the JAX package's constant (read at its
    import) or the environment (NTT_RESIDENT_SPLIT, read live by both),
    and the port's environment."""
    monkeypatch.setenv(knob, value)
    if knob == "NTT_RADIX4":
        monkeypatch.setattr(jcore, "RADIX4", True)
    elif knob == "NTT_FACTOR_TW_MIN":
        monkeypatch.setattr(japi, "FACTOR_TW_MIN", int(value))
    if chunk_single is not None:
        monkeypatch.setattr(jcore, "CHUNK_SINGLE", chunk_single)


def _jax_entry(x, jf, algorithm, coset):
    entry = nt.coset_ntt if coset else nt.ntt
    return np.asarray(entry(jnp.asarray(x), jf, algorithm=algorithm))


def _port_entry(x, tf, algorithm, coset):
    entry = tnt.coset_ntt if coset else tnt.ntt
    return entry(x, tf, algorithm=algorithm, device="cpu").numpy()


#: (knob, value, JAX CHUNK_SINGLE, field, log2 n, algorithm, coset). The
#: residency split at r = 1024 (8192 bytes on Goldilocks, 4096 on the small
#: Proth prime): a (1024, n/1024) top level over a column four-step; the
#: factored top table above 2^8; the paired ladders
AGAINST_JAX = [
    ("NTT_RADIX4", "1", None, "goldilocks", 7, "naive", False),
    ("NTT_RADIX4", "1", None, "small-proth", 10, "fourstep", True),
    ("NTT_RESIDENT_SPLIT", "1", 8192, "goldilocks", 12, "fourstep", False),
    ("NTT_RESIDENT_SPLIT", "1", 4096, "small-proth", 12, "pallas", True),
    ("NTT_RESIDENT_SPLIT", "1", 8192, "goldilocks", 12, "mxu_chunked",
     True),
    ("NTT_FACTOR_TW_MIN", "256", None, "small-proth", 12, "fourstep", False),
    ("NTT_FACTOR_TW_MIN", "256", None, "small-proth", 10, "mxu_chunked",
     True),
    ("NTT_FACTOR_TW_MIN", "256", None, "small-proth", 12, "mxu_sub", False),
]


@pytest.mark.parametrize(
    "knob, value, chunk_single, name, log_n, algorithm, coset", AGAINST_JAX,
    ids=[f"{a[0][4:].lower()}-{a[3]}-{a[4]}-{a[5]}"
         f"{'-coset' if a[6] else ''}" for a in AGAINST_JAX])
def test_transform_under_knob_equals_jax(monkeypatch, knob, value,
                                         chunk_single, name, log_n,
                                         algorithm, coset):
    jf, tf = nt.get_field(name), tnt.get_field(name)
    _set(monkeypatch, knob, value, chunk_single)
    x = _words(tf, 1 << log_n, log_n + 7)
    with pytest.warns(UserWarning, match=knob):
        got = _port_entry(x, tf, algorithm, coset)
    assert np.array_equal(got, _golden(
        tf, x, shift=tf.generator if coset else None))
    assert np.array_equal(got, _jax_entry(x, jf, algorithm, coset))


def test_resident_mxu_sub_fails_in_jax_and_runs_in_the_port(monkeypatch):
    """Goldilocks 2^12 under the residency split at r = 1024: the JAX
    package's ``mxu_sub`` splits off 2- and 4-point base transforms that
    its ``sub_mats`` does not build, and its trace fails; the port warns
    and gives the golden words by its default plan."""
    jf, tf = nt.get_field("goldilocks"), tnt.get_field("goldilocks")
    _set(monkeypatch, "NTT_RESIDENT_SPLIT", "1", 8192)
    x = _words(tf, 1 << 12, 5)
    with pytest.raises(ValueError, match="in_specs"):
        _jax_entry(x, jf, "mxu_sub", False)
    with pytest.warns(UserWarning, match="NTT_RESIDENT_SPLIT=1"):
        got = _port_entry(x, tf, "mxu_sub", False)
    assert np.array_equal(got, _golden(tf, x))


def test_dist_under_radix4_equals_jax(monkeypatch):
    """``make_dist_ntt`` warns under NTT_RADIX4=1, and its words equal the
    JAX package's dist transform, whose plain local steps take their
    stages in pairs there: SMALL 256 on D = 4."""
    f, n, D = nt.SMALL, 256, 4
    _set(monkeypatch, "NTT_RADIX4", "1")
    x = _words(f, n, 81)
    jx = jlimbs.to_mont(jnp.asarray(x), f)
    jmesh = j_make_mesh(jax.devices()[:D])
    want = np.asarray(j_unshard(j_make_dist_ntt(f, n, jmesh)(
        j_shard_for_ntt(jx, f, jmesh))))
    mesh = make_mesh(["cpu"] * D)
    with pytest.warns(UserWarning, match="NTT_RADIX4=1"):
        run = make_dist_ntt(f, n, mesh)
    got = unshard(run(shard_for_ntt(np.asarray(jx), f, mesh))).numpy()
    assert np.array_equal(got, want)

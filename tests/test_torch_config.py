"""The port's knob registry (``ntt_tpu_torch.config``), its runner cache
key, its signatures and its plan rows above 2^26, against ntt_tpu.

- ``config_key()`` changes with every knob, and ``api.ntt`` builds a fresh
  runner after a flip; a runner built before a flip, or under one, keeps
  its plan and gives the golden words after it; the knobs are read from
  the environment at import (one subprocess), and the three that have no
  counterpart are not read;
- every function that the reference's ``transforms/{core, fourstep, mxu,
  naive}.py`` and ``api.py`` define and the port keeps takes the
  reference's parameters in the reference's order (the port may append
  ``device``, ``chunk`` and ``deep``, and the plan its drivers take as
  keywords); the differences by design are listed here, so the next
  drift fails;
- the ``NTT_DEBUG`` tripwire, the ``NTT_FUSE_TW=0`` / ``NTT_TW_MATFOLD=1``
  error, the single-level algorithms under ``NTT_MXU_BASE_LOG=6`` (m = 64)
  and the ``NTT_MXU_BASE_LOG=7`` rejection on the CPU;
- the matrix-fold plan of BLS12-381 Fr 2^27 and 2^28 and BN254 Fr 2^28.

Canonical words out: the tolerance is exact equality.
"""

import importlib
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import ntt_tpu_torch as tnt
from ntt_tpu_torch import api as tapi
from ntt_tpu_torch import config as tconfig
from ntt_tpu_torch import hostlib as thostlib
from ntt_tpu_torch import limbs as tlimbs
from ntt_tpu_torch.transforms import mxu as tmxu

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _words(field, n, seed):
    rng = np.random.default_rng(seed)
    W = field.n_words
    x = rng.integers(0, 1 << 32, size=(W, n), dtype=np.uint64)
    x[W - 1] = rng.integers(0, field.p >> (32 * (W - 1)), size=n,
                            dtype=np.uint64)
    return x.astype(np.uint32)


def _golden(field, x, inverse=False):
    return thostlib.host_planes(thostlib.ntt_np(
        thostlib.planes_to_rows(x), field, inverse), field.n_words)


# --- the registry and the cache key ------------------------------------------

#: (module, constant, a value other than the default)
KNOB_CONSTANTS = [
    (tmxu, "BASE_LOG", 4), (tmxu, "BASE", 16), (tmxu, "SUBBASE_LOG", 8),
    (tmxu, "SUBBASE", 256), (tmxu, "SUB256_LOG", 7),
    (tmxu, "TW_MATFOLD", False), (tmxu, "TW_STACK_MAX_NT", 32),
    (tmxu, "TW_MERGED_MAX", 1 << 16), (tmxu, "TW_RESID", "1"),
    (tmxu, "FUSE_TW", False)]


@pytest.mark.parametrize("module, name, value", KNOB_CONSTANTS,
                         ids=[c[1] for c in KNOB_CONSTANTS])
def test_config_key_follows_each_constant(monkeypatch, module, name, value):
    before = tconfig.config_key()
    monkeypatch.setattr(module, name, value)
    assert tconfig.config_key() != before


@pytest.mark.parametrize("var", ["NTT_DEBUG"])
def test_config_key_reads_the_live_knobs(monkeypatch, var):
    monkeypatch.delenv(var, raising=False)
    before = tconfig.config_key()
    monkeypatch.setenv(var, "1")
    assert tconfig.config_key() != before


def test_a_knob_flip_builds_a_fresh_runner(monkeypatch):
    """The runner cached at the default peel is not served under
    NTT_MXU_BASE_LOG=4: a second runner is built, with BASE = 16 tables,
    and both give the golden words."""
    f, n = tnt.SMALL, 1 << 10
    x = _words(f, n, 1)
    want = _golden(f, x)
    monkeypatch.setattr(tapi, "_runner_cache", {})
    y0 = tnt.ntt(x, f, algorithm="mxu_chunked", device="cpu")
    monkeypatch.setattr(tmxu, "BASE_LOG", 4)
    monkeypatch.setattr(tmxu, "BASE", 16)
    y1 = tnt.ntt(x, f, algorithm="mxu_chunked", device="cpu")
    runners = list(tapi._runner_cache.values())
    assert len(runners) == 2
    shapes = [[tuple(getattr(t, "Tt", t).shape) for t in aux["tws"]]
              for _, aux in runners]
    assert shapes == [[(1, 32, 32)], [(1, 16, 64), (1, 4, 16)]]
    assert np.array_equal(y0.numpy(), want)
    assert np.array_equal(y1.numpy(), want)


#: (label, constants flipped, field, log2 n, algorithms whose driver reads
#: the flipped constant when it runs)
FLIPS = [
    ("BASE_LOG=4", {"BASE_LOG": 4, "BASE": 16}, "goldilocks", 12,
     ("mxu", "mxu_pallas", "mxu_fused", "mxu_chunked")),
    ("SUBBASE_LOG=8", {"SUBBASE_LOG": 8, "SUBBASE": 256}, "goldilocks", 12,
     ("mxu_sub",)),
    ("SUB256_LOG=7", {"SUB256_LOG": 7}, "bls12-381-fr", 9, ("mxu_sub",)),
    ("TW_MATFOLD=0,FUSE_TW=0", {"TW_MATFOLD": False, "FUSE_TW": False},
     "goldilocks", 12, ("mxu_chunked",)),
]


@pytest.mark.parametrize("label, flips, name, log_n, algorithms", FLIPS,
                         ids=[f[0] for f in FLIPS])
def test_a_runner_keeps_its_plan_across_a_flip(monkeypatch, label, flips,
                                               name, log_n, algorithms):
    """``get_runner``'s runner runs the plan its tables were built for: one
    built at the default knobs, run under the flip, and one built under the
    flip, run after the knobs are restored, both give the golden words."""
    f = tnt.get_field(name)
    x = _words(f, 1 << log_n, log_n)
    want = _golden(f, x)
    xm = tlimbs.to_mont(torch.from_numpy(x), f)

    def runners():
        return [tapi.get_runner(f, 1 << log_n, algorithm=a, device="cpu")
                for a in algorithms]
    before = runners()
    with monkeypatch.context() as m:
        for k, v in flips.items():
            m.setattr(tmxu, k, v)
        under = runners()
        for alg, (run, aux) in zip(algorithms, before):
            got = tlimbs.from_mont(run(xm, aux), f).numpy()
            assert np.array_equal(got, want), (alg, "built before")
    for alg, (run, aux) in zip(algorithms, under):
        got = tlimbs.from_mont(run(xm, aux), f).numpy()
        assert np.array_equal(got, want), (alg, "built under")


def test_knobs_are_read_at_import():
    """Each knob's environment variable sets its constant when the port is
    imported (one subprocess, every knob at once), the knobs without a
    counterpart change nothing, and JAX stays out."""
    env = dict(os.environ, NTT_MXU_BASE_LOG="4", NTT_MXU_SUBBASE_LOG="8",
               NTT_MXU_SUB256_LOG="7", NTT_TW_MATFOLD="0",
               NTT_TW_STACK_MAX_NT="32", NTT_TW_MERGED_MAX="65536",
               NTT_TW_RESID="1", NTT_FUSE_TW="0", NTT_RADIX4="1",
               NTT_RESIDENT_SPLIT="1", NTT_FACTOR_TW_MIN="1024")
    code = ("import sys; import ntt_tpu_torch; "
            "from ntt_tpu_torch.config import config_key; "
            "print(config_key()); "
            "print(any(m == 'jax' or m.startswith(('jax.', 'ntt_tpu.')) "
            "for m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.splitlines()
    assert out[0] == str((4, 16, 8, 256, 7, False, 32, 65536, "1", False,
                          "0"))
    assert out[1] == "False"


# --- signatures --------------------------------------------------------------

MODULES = ["transforms.core", "transforms.fourstep", "transforms.mxu",
           "transforms.naive", "api"]

#: trailing parameters the port may add: the device its tables are built
#: on, the row chunk of its device generators, the layout of a level
#: kernel's table, and the plan a runner fixes when it is built (the peel
#: and the twiddle fusion its driver would otherwise read when it runs)
PORT_EXTRAS = {"device", "chunk", "deep", "base_max", "fuse"}

#: differences by design (ROADMAP): the flat drivers' tables carry the
#: direction, so they take no ``inverse``; the parameters of
#: NTT_RESIDENT_SPLIT (a field for the residency-aware split, ``residency``)
#: and NTT_FACTOR_TW_MIN (``allow_factored``), which have no counterpart
DIFFERENT = {
    ("transforms.mxu", "ntt_mxu"): ["x", "field", "tws", "mats",
                                    "base_max"],
    ("transforms.mxu", "ntt_mxu_pallas"): ["x", "field", "tws", "mats",
                                           "base_max"],
    ("transforms.mxu", "ntt_mxu_fused"): ["x", "field", "tws", "mats",
                                          "base_max"],
    ("transforms.fourstep", "_split"): ["m", "base_max"],
    ("transforms.fourstep", "twiddle_requests"): ["m", "base_max"],
    ("transforms.mxu", "base_sizes"): ["n"],
    ("transforms.mxu", "base_mats"): ["field", "n", "inverse"],
    ("api", "_tw_tables"): ["field", "n", "inverse", "requests", "deep",
                            "device"],
}

#: reference functions the port has no counterpart of, by design: the TPU
#: chunking helpers (a level is one launch; ``api._chunked_pass`` cuts the
#: plain passes), the jit wrappers, the base transforms the port names
#: after what they run (``fourstep._base_ladder``, ``mxu._base_ntt_kernel``)
#: and the code of the knobs without a counterpart (NTT_RADIX4,
#: NTT_RESIDENT_SPLIT, NTT_FACTOR_TW_MIN)
MISSING = {
    "transforms.core": {"_bcast_tw", "n_chunks_for", "chunked_along_axis",
                        "dit_stage4"},
    "transforms.fourstep": {"_base_jnp", "_resident_elems"},
    "transforms.mxu": {"_base_ntt_pallas"},
    "transforms.naive": set(),
    "api": {"_build", "_get_compiled", "_field_jits", "_factor_split"},
}


def _functions(module):
    return {name: fn for name, fn in vars(module).items()
            if inspect.isfunction(fn) and fn.__module__ == module.__name__}


@pytest.mark.parametrize("mod", MODULES)
def test_signatures_take_the_reference_order(mod):
    ref = _functions(importlib.import_module("ntt_tpu." + mod))
    port = importlib.import_module("ntt_tpu_torch." + mod)
    assert {n for n in ref if not hasattr(port, n)} == MISSING[mod]
    for name, fn in ref.items():
        if name in MISSING[mod]:
            continue
        want = list(inspect.signature(fn).parameters)
        got = list(inspect.signature(getattr(port, name)).parameters)
        if (mod, name) in DIFFERENT:
            assert got == DIFFERENT[(mod, name)], name
            continue
        assert got[:len(want)] == want, (name, want, got)
        assert set(got[len(want):]) <= PORT_EXTRAS, (name, got)


# --- errors and the debug tripwire -------------------------------------------

def test_ntt_debug_tripwire(monkeypatch):
    """NTT_DEBUG=1 raises on a non-canonical input word, naming the count,
    as tests/test_errors.py holds the JAX package to; a clean input
    passes, and without the variable nothing is checked."""
    f = tnt.SMALL
    good = tnt.from_ints(list(range(16)), f)
    bad = tnt.from_ints([f.p] + list(range(15)), f)
    bad[0, 3] = f.p + 7
    tnt.ntt(bad, f, algorithm="naive", device="cpu")     # unchecked
    monkeypatch.setenv("NTT_DEBUG", "1")
    tnt.ntt(good, f, algorithm="naive", device="cpu")
    with pytest.raises(ValueError, match="2 non-canonical"):
        tnt.ntt(bad, f, algorithm="naive", device="cpu")
    with pytest.raises(ValueError, match="non-canonical.*ntt input"):
        tnt.ntt(bad, f, algorithm="mxu_sub", mont_io=True, device="cpu")


def test_fuse_tw_off_with_the_matrix_fold_raises(monkeypatch):
    """The pair that fails at trace time in the JAX package raises
    ValueError naming both knobs; with NTT_TW_MATFOLD=0 as well the same
    size runs."""
    monkeypatch.setattr(tmxu, "FUSE_TW", False)
    f, n = tnt.BLS12_381_FR, 1 << 16
    with pytest.raises(ValueError, match="NTT_FUSE_TW=0 with NTT_TW_MATFOLD"):
        tapi.get_runner(f, n, algorithm="mxu_chunked", device="cpu")
    monkeypatch.setattr(tmxu, "TW_MATFOLD", False)
    _, aux = tapi.get_runner(f, n, algorithm="mxu_chunked", device="cpu")
    assert all(isinstance(t, torch.Tensor) for t in aux["tws"])


@pytest.mark.parametrize("algorithm", ["mxu_chunked", "mxu_pallas",
                                       "mxu_fused", "mxu_sub"])
def test_base_log_6_runs_where_a_kernel_takes_m_64(monkeypatch, algorithm):
    """The single-level kernels take m = 64, so NTT_MXU_BASE_LOG=6 runs
    every single-level algorithm: BLS12-381 Fr 2^8 (a 64-point level and
    a base of 4) word-equal to the golden result, through the kernels'
    plain versions. ``mxu_sub`` takes the 256-bit matrix fold at BASE 64
    only from 2^19 (a transform too large for the plain versions on one
    core here: the card holds it, ``chip_smoke.py``; the plan,
    ``test_torch_knobs.py``)."""
    monkeypatch.setattr(tmxu, "BASE_LOG", 6)
    monkeypatch.setattr(tmxu, "BASE", 64)
    f = tnt.BLS12_381_FR
    if algorithm == "mxu_sub":
        sub = tmxu.effective_subbase(f)
        assert sub == 64 and not tapi._matfold_on(f, 1 << 18, sub)
        assert tapi._matfold_on(f, 1 << 19, sub)
    x = _words(f, 1 << 8, 8)
    run, aux = tapi.get_runner(f, 1 << 8, algorithm=algorithm, device="cpu")
    assert aux["plan"]["base_max"] == 64
    got = tnt.ntt(x, f, algorithm=algorithm, device="cpu")
    assert np.array_equal(got.numpy(), _golden(f, x))


def test_base_log_7_is_rejected_where_a_kernel_takes_m_128(monkeypatch):
    """By design: the single-level kernels contract one conv matrix of at
    most 64 points (a 128-point one of a 256-bit field is 22 MB, which the
    JAX package's kernels do not take either), so NTT_MXU_BASE_LOG=7
    raises a ValueError that names the limit; the plain ``mxu`` transform
    takes it."""
    monkeypatch.setattr(tmxu, "BASE_LOG", 7)
    monkeypatch.setattr(tmxu, "BASE", 128)
    f = tnt.BLS12_381_FR
    with pytest.raises(ValueError, match=r"NTT_MXU_BASE_LOG=7.*m <= 64"):
        tapi.get_runner(f, 1 << 8, algorithm="mxu_chunked", device="cpu")
    x = _words(f, 1 << 8, 7)
    got = tnt.ntt(x, f, algorithm="mxu", device="cpu")
    assert np.array_equal(got.numpy(), _golden(f, x))


# --- the plan above 2^26 -----------------------------------------------------

def test_plan_rows_above_2e26():
    """The matrix-fold plan where no chip run had gone before this slice:
    at 2^27 a 128-entry deep stack (TW_STACK_MAX_NT) and the last base
    m = 4 over 2^25 columns; at 2^28 a third deep level (8192, 32, 256)
    where 2^26 has a stack, BN254 Fr alike."""
    bls, bn = tnt.BLS12_381_FR, tnt.BN254_FR
    assert tmxu.matfold_plan(bls, 1 << 27) == [
        ("resid", (1 << 27, 32, 1 << 22)), ("deep", (1 << 22, 32, 1 << 17)),
        ("deep", (1 << 17, 32, 4096)), ("stack", (4096, 32, 128)),
        ("stack", (128, 32, 4))]
    rows28 = [("resid", (1 << 28, 32, 1 << 23)),
              ("deep", (1 << 23, 32, 1 << 18)),
              ("deep", (1 << 18, 32, 8192)), ("deep", (8192, 32, 256)),
              ("stack", (256, 32, 8))]
    assert tmxu.matfold_plan(bls, 1 << 28) == rows28
    assert tmxu.matfold_plan(bn, 1 << 28) == rows28
    assert tmxu.base_sizes(1 << 27) == {32, 4}
    assert tmxu.base_sizes(1 << 28) == {32, 8}

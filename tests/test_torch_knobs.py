"""Every knob of ``ntt_tpu_torch.config`` against ntt_tpu, on the CPU: the
plans (``test_torch_knobs_run.py`` holds the transforms).

For each knob setting, set alike in both packages (the consuming module's
constant, or the environment for the knobs read live, :func:`_set`):

- the plan functions are equal: ``fourstep.twiddle_requests`` (and the
  split behind it; the JAX package's given the field, as its drivers call
  it), ``mxu.twiddle_requests``, ``base_sizes``,
  ``sub_base_sizes``, ``effective_subbase``, ``api._first_level``, the
  matrix fold's gate and ``mxu.matfold_tw_tables``'s plan (its kinds,
  reps, stack lengths and table shapes, with both packages' table builders
  replaced by shapes, so that n up to 2^28 is cheap) on all four fields,
  at the sizes where a plan rule changes (the ``mxu_sub`` peel under
  every setting too: the small Proth prime's 1024 under
  NTT_MXU_SUBBASE_LOG=10, the 256-bit fields' 256 under
  NTT_MXU_SUB256_LOG=9; ``test_torch_sub1024.py`` holds the whole grid);
- the 256-bit table-plan knobs (the fold, its residual, its stacks) act
  from 2^13 at the smallest peel (BASE = 16), where one JAX transform
  costs about a minute on one CPU core: their tables are word-equal to
  the JAX package's, and at 2^15 the port's transform equals the golden
  result and, on the JAX package's own tables, the port's own.

Canonical words out: the tolerance is exact equality.
"""

import types

import numpy as np
import pytest
import torch

import ntt_tpu as nt
from ntt_tpu import api as japi
from ntt_tpu import digits as jdigits
from ntt_tpu.transforms import core as jcore
from ntt_tpu.transforms import fourstep as jfourstep
from ntt_tpu.transforms import mxu as jmxu
import ntt_tpu_torch as tnt
from ntt_tpu_torch import api as tapi
from ntt_tpu_torch import hostlib as thostlib
from ntt_tpu_torch import limbs as tlimbs
from ntt_tpu_torch.transforms import fourstep as tfourstep
from ntt_tpu_torch.transforms import mxu as tmxu

torch.set_num_threads(1)

FIELDS = ["bn254-fr", "bls12-381-fr", "goldilocks", "small-proth"]


def _set(monkeypatch, **knobs):
    """Sets knobs alike in both packages (``transforms/mxu.py``): BASE_LOG,
    SUBBASE_LOG (with their powers of two), SUB256_LOG, TW_MATFOLD,
    TW_STACK_MAX_NT, TW_MERGED_MAX, TW_RESID, FUSE_TW. BASE also goes into
    the default ``base`` of the JAX package's ``expanded_twiddles``, which
    its ``mxu_fused`` tables take and which its import binds to BASE, as
    the environment variable would have set it."""
    for name, v in knobs.items():
        if name in ("BASE_LOG", "SUBBASE_LOG"):
            for m in (jmxu, tmxu):
                monkeypatch.setattr(m, name, v)
                monkeypatch.setattr(m, name[:-4], 1 << v)
            if name == "BASE_LOG":
                monkeypatch.setattr(jmxu.expanded_twiddles, "__defaults__",
                                    (1 << v,))
        else:
            for m in (jmxu, tmxu):
                monkeypatch.setattr(m, name, v)
    jmxu._subbase_cache.clear()


@pytest.fixture(autouse=True)
def _fresh_caches():
    """The JAX package's peel cache is not keyed by BASE; its compiled
    cache and the port's runners are keyed by the knobs themselves."""
    jmxu._subbase_cache.clear()
    yield
    jmxu._subbase_cache.clear()


def _words(field, n, seed):
    rng = np.random.default_rng(seed)
    W = field.n_words
    x = rng.integers(0, 1 << 32, size=(W, n), dtype=np.uint64)
    x[W - 1] = rng.integers(0, field.p >> (32 * (W - 1)), size=n,
                            dtype=np.uint64)
    return x.astype(np.uint32)


def _golden(field, x, inverse=False, shift=None):
    rows = thostlib.planes_to_rows(x)
    if shift is not None:
        rows = thostlib.mul_mod_vec_np(rows, thostlib.planes_to_rows(
            thostlib.powers_np(shift, x.shape[1], field)), field)
    return thostlib.host_planes(thostlib.ntt_np(rows, field, inverse),
                                field.n_words)


# --- the plan functions ------------------------------------------------------

class _Shape:
    """A table stood for by its shape (the stubbed builders' output)."""

    def __init__(self, *shape):
        self.shape = tuple(int(s) for s in shape)

    def reshape(self, *shape):
        return _Shape(*shape)

    def transpose(self, *axes):
        return _Shape(*(self.shape[a] for a in axes))

    permute = transpose

    def contiguous(self):
        return self


def _stub_builders(m, jf):
    """Both packages' matfold_tw_tables with their table builders replaced
    by shapes (inside a monkeypatch context ``m``)."""
    W, D, E = jf.n_words, jdigits.n_digits(jf), jdigits.out_planes(jf)

    def stack(field, mm, inverse, tvals, col_shift=None):
        return _Shape(len(tvals), E * mm, D * mm)

    m.setattr(jmxu, "twiddle_matrix_stack", stack)
    m.setattr(jmxu, "host_power_matrix",
              lambda field, w, n1, n2: _Shape(W, n1, n2))
    m.setattr(jcore, "power_matrix_chunked",
              lambda field, w, n1, n2: _Shape(W, n1, n2))
    m.setattr(jmxu, "jnp", types.SimpleNamespace(asarray=lambda a: a))
    m.setattr(jmxu, "jax", types.SimpleNamespace(jit=lambda f: f))
    m.setattr(tmxu, "twiddle_matrix_stack", stack)
    m.setattr(tmxu, "power_table",
              lambda field, w, n1, n2, device=None: _Shape(W, n1, n2))


def _jax_rows(tws):
    out = []
    for t in tws:
        if isinstance(t, jfourstep.TwStackResid):
            out.append(("resid", t.rep, t.As.shape, t.Tres.shape))
        elif isinstance(t, jfourstep.TwMatStack):
            out.append(("stack", t.rep, t.As.shape))
        elif isinstance(t, jfourstep.TwBatch):
            out.append(("batch", t.T4.shape))
        else:
            out.append(("table", t.shape))
    return out


def _port_rows(tws):
    out = []
    for t in tws:
        kind = t["kind"] if isinstance(t, dict) else "table"
        if kind == "resid":
            out.append(("resid", t["rep"], t["As"].shape, t["Tres"].shape))
        elif kind == "stack":
            out.append(("stack", t["rep"], t["As"].shape))
        elif kind == "batch":
            out.append(("batch", t["T4"].shape))
        else:
            out.append(("table", (t["T"] if kind == "deep" else t).shape))
    return out


#: one level at BASE 16 or 32 (2^7), the deep stack and the fold's first
#: sizes at the two peels (2^12, 2^13, 2^15, 2^17), the merged table's
#: last size and the residual's first (2^24, 2^25), the plan rows above
#: 2^26 (2^28)
SIZES = [1 << k for k in (7, 12, 13, 15, 17, 24, 25, 28)]


def _check_plans(monkeypatch, sizes=SIZES):
    for name in FIELDS:
        jf, tf = nt.get_field(name), tnt.get_field(name)
        sub = jmxu.effective_subbase(jf)
        assert tmxu.effective_subbase(tf) == sub
        for n in sizes:
            if n > 1 << tf.two_adicity:
                continue
            for bm in (jmxu.BASE, sub, jfourstep.BASE_MAX):
                assert (tfourstep.twiddle_requests(n, bm)
                        == jfourstep.twiddle_requests(n, bm, jf)), (n, bm)
                assert tfourstep._split(n, bm) == \
                    jfourstep._split(n, bm, jf)
            assert tmxu.twiddle_requests(n) == jmxu.twiddle_requests(n)
            assert tmxu.base_sizes(n) == jmxu.base_sizes(n)
            assert tmxu.base_sizes(n) == jmxu.base_sizes(n, jf)
            assert tmxu.sub_base_sizes(n, sub) == jmxu.sub_base_sizes(n, sub)
            for alg in ("fourstep", "mxu_chunked", "mxu_sub"):
                assert (tapi._first_level(alg, tf, n)
                        == japi._first_level(alg, jf, n)), (alg, n)
            if tf.n_words < 8:
                continue
            with monkeypatch.context() as m:
                _stub_builders(m, jf)
                want = jmxu.matfold_tw_tables(jf, n, False)
                got = tmxu.matfold_tw_tables(tf, n, False)
                assert (got is None) == (want is None), n
                if want is not None:
                    rows = _jax_rows(want)
                    assert _port_rows(got) == rows, (name, n)
                    kinds = [k for k, _ in tmxu.matfold_plan(tf, n)]
                    assert [k if k in ("stack", "resid", "batch") else
                            "table" for k in kinds] == [r[0] for r in rows]
                # the gate, with the tables just built standing for a build
                m.setattr(jmxu, "matfold_tw_tables", lambda *a, **k: want)
                for bm in (jmxu.BASE, sub):
                    gate = japi._matfold_tws(jf, n, False, bm) is not None
                    assert tapi._matfold_on(tf, n, bm) == gate, (n, bm)


#: every knob setting of the slice, one value a parameter
SETTINGS = {
    "default": {},
    "BASE_LOG=4": {"BASE_LOG": 4},
    "BASE_LOG=6": {"BASE_LOG": 6},
    "SUBBASE_LOG=8": {"SUBBASE_LOG": 8},
    "SUBBASE_LOG=10": {"SUBBASE_LOG": 10},
    "SUB256_LOG=6": {"SUB256_LOG": 6},
    "SUB256_LOG=7": {"SUB256_LOG": 7},
    "SUB256_LOG=9": {"SUB256_LOG": 9},
    "TW_MATFOLD=0": {"TW_MATFOLD": False},
    "TW_MATFOLD=0,FUSE_TW=0": {"TW_MATFOLD": False, "FUSE_TW": False},
    "TW_STACK_MAX_NT=32": {"TW_STACK_MAX_NT": 32},
    "TW_MERGED_MAX=2^16": {"TW_MERGED_MAX": 1 << 16},
    "TW_RESID=1": {"TW_RESID": "1"},
    "TW_RESID=0": {"TW_RESID": "0"},
}


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_plan_functions_equal_jax(monkeypatch, setting):
    _set(monkeypatch, **SETTINGS[setting])
    _check_plans(monkeypatch)


def test_matfold_tables_equal_jax_under_knobs(monkeypatch):
    """The real tables, word for word (inverse roots), where the knobs act
    at the smallest peel: BLS12-381 Fr 2^15 at BASE = 16 with the residual
    (TW_RESID=1), and 2^13 at BASE = 16 with its deep stack and without it
    (TW_STACK_MAX_NT=1: nothing folds)."""
    tf, jf = tnt.BLS12_381_FR, nt.BLS12_381_FR
    _set(monkeypatch, BASE_LOG=4)
    for n, knobs, kinds in (
            (1 << 15, {"TW_RESID": "1"}, ["resid", "deep", "stack"]),
            (1 << 13, {}, ["plain", "deep", "stack"]),
            (1 << 13, {"TW_STACK_MAX_NT": 1}, None)):
        _set(monkeypatch, **knobs)
        plan = tmxu.matfold_plan(tf, n)
        assert (plan and [k for k, _ in plan]) == kinds
        got = tmxu.matfold_tw_tables(tf, n, True)
        want = jmxu.matfold_tw_tables(jf, n, True)
        assert (got is None) == (want is None) == (kinds is None)
        for g, w in zip(got or [], want or [], strict=True):
            kind = g["kind"] if isinstance(g, dict) else "plain"
            pairs = {"stack": [("As", "As")], "resid": [("As", "As"),
                                                          ("Tres", "Tres")],
                     "batch": [("T4", "T4")]}.get(kind)
            if pairs is None:
                t = g["T"] if kind == "deep" else g
                assert np.array_equal(np.asarray(t), np.asarray(w)), kind
                continue
            for a, b in pairs:
                assert np.array_equal(np.asarray(g[a]),
                                      np.asarray(getattr(w, b))), (kind, a)
            if "rep" in g:
                assert g["rep"] == w.rep


@pytest.mark.parametrize("knobs, kinds", [
    ({"TW_RESID": "1"}, ["TwStackResid", "TwDeep", "TwMatStack"]),
    ({"TW_MERGED_MAX": 1 << 14}, ["TwStackResid", "TwDeep", "TwMatStack"]),
    ({"TW_MERGED_MAX": 1 << 14, "TW_RESID": "0"},
     ["Tensor", "TwDeep", "TwMatStack"])],
    ids=["resid=1", "merged_max", "resid=0"])
def test_table_plan_knobs_at_2e15(monkeypatch, knobs, kinds):
    """The table-plan knobs at BLS12-381 Fr 2^15, BASE = 16 (the smallest
    size where level 0 folds): the forward, inverse and coset transforms
    equal the golden result (the inverse and the coset with the residual),
    and the forward equals the port's transform on the JAX package's own
    tables."""
    tf, jf = tnt.BLS12_381_FR, nt.BLS12_381_FR
    n = 1 << 15
    _set(monkeypatch, BASE_LOG=4, **knobs)
    x = _words(tf, n, 15)
    xm = tlimbs.to_mont(torch.from_numpy(x), tf)
    run, aux = tapi.get_runner(tf, n, device="cpu")
    assert [type(t).__name__ for t in aux["tws"]] == kinds
    y = run(xm, aux)
    assert np.array_equal(tlimbs.from_mont(y, tf).numpy(), _golden(tf, x))
    g = tf.generator
    for kw, want in (({"inverse": True}, _golden(tf, x, inverse=True)),
                     ({"coset_shift": g}, _golden(tf, x, shift=g))):
        if knobs.get("TW_RESID") != "1":
            break
        r, a = tapi.get_runner(tf, n, device="cpu", **kw)
        assert np.array_equal(tlimbs.from_mont(r(xm, a), tf).numpy(), want)
    _, jaux = japi.get_runner(jf, n, False, "mxu_chunked", True, None)
    tws = []
    for t in jaux["tws"]:
        if isinstance(t, jfourstep.TwStackResid):
            tws.append({"kind": "resid", "As": np.asarray(t.As),
                        "rep": t.rep, "Tres": np.asarray(t.Tres)})
        elif isinstance(t, jfourstep.TwMatStack):
            tws.append({"kind": "stack", "As": np.asarray(t.As),
                        "rep": t.rep})
        elif isinstance(t, jfourstep.TwBatch):
            tws.append({"kind": "batch", "T4": np.asarray(t.T4)})
        elif len(tws) == 0:
            tws.append(np.asarray(t))
        else:
            tws.append({"kind": "deep", "T": np.asarray(t)})
    jmats = {int(k): np.asarray(v) for k, v in jaux["mats"].items()}
    on_jax = tapi.aux_from_numpy(tws, jmats, device="cpu")
    got = tmxu.ntt_mxu_chunked(xm, tf, False, iter(on_jax["tws"]),
                               on_jax["mats"])
    assert torch.equal(got, y)

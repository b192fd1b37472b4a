"""The multi-level K3 at m = 1024 and the JAX package's peel rule, and the
transposed store of K2 and K3, against ntt_tpu on the CPU:

- ``mxu.effective_subbase`` equals the JAX package's at every setting of
  NTT_MXU_BASE_LOG 4-6, NTT_MXU_SUBBASE_LOG 8-11 and NTT_MXU_SUB256_LOG 0
  and 6-10 on all four fields (the small Proth prime peels 1024 under
  NTT_MXU_SUBBASE_LOG >= 10, the 256-bit fields 256 under
  NTT_MXU_SUB256_LOG >= 9), the constants set alike in both packages;
- the launch plans at m = 1024 (m2 = 32, bt = 4) on W = 1, 2, 8 for 132,
  114 and 4 SMs: the present form fits every width; the wide form fits
  W = 1 only, so that W = 2 takes the present form above one wave too;
  the small Proth prime's launches at 2^19, 2^20 and 2^22 under
  NTT_MXU_SUBBASE_LOG=10;
- the plain version at m = 1024 against the JAX ``fused_subntt`` in
  interpret mode (no twiddle, T3 at rep 1, the i2-resolution table at
  rep 2; forward and inverse), and torch emulations of both forms' blocks
  (``test_torch_sub.py``'s and ``test_torch_sub_wide.py``'s, at m = 1024)
  against the plain version;
- ``transpose_out=True`` of ``fused_level_stack`` and ``fused_subntt``
  (single- and multi-level) against the JAX entries in interpret mode, on
  a narrow and a 256-bit field; ``base_ntt_mxu_pallas`` and
  ``ntt_along_axis_pallas`` under the JAX package's names against its
  entries.

Canonical words: the tolerance is exact equality.
"""

import functools
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ntt_tpu as nt
import ntt_tpu.kernels as jkernels
from ntt_tpu.kernels import mxu_level as jlevel
from ntt_tpu.kernels import mxu_ntt as jntt
from ntt_tpu.transforms import mxu as jmxu
import ntt_tpu_torch as tnt
import ntt_tpu_torch.kernels as tkernels
from ntt_tpu_torch.kernels import mxu_level, mxu_ntt
from ntt_tpu_torch.transforms import mxu as tmxu
from test_torch_knobs import _set
from test_torch_sub import _emulated_multi
from test_torch_sub_wide import _emulated_wide

torch.set_num_threads(1)

FIELDS = ["bn254-fr", "bls12-381-fr", "goldilocks", "small-proth"]
M = 1024


def _words(field, shape, seed):
    """Canonical random elements as uint32[W, *shape] (top word < p's)."""
    rng = np.random.default_rng(seed)
    W = field.n_words
    x = rng.integers(0, 1 << 32, size=(W,) + shape, dtype=np.uint64)
    x[W - 1] = rng.integers(0, field.p >> (32 * (W - 1)), size=shape,
                            dtype=np.uint64)
    return x.astype(np.uint32)


def _mats(field, sizes, inverse):
    return {k: torch.from_numpy(v)
            for k, v in tmxu._mats_for(field, sizes, inverse).items()}


@pytest.fixture(autouse=True)
def _fresh_peels():
    """Both packages cache the peel; the JAX package's key leaves BASE
    out."""
    jmxu._subbase_cache.clear()
    tmxu._subbase_cache.clear()
    yield
    jmxu._subbase_cache.clear()
    tmxu._subbase_cache.clear()


# --- the peel rule ------------------------------------------------------------

@pytest.mark.parametrize("base_log", [4, 5, 6])
def test_peel_equals_the_reference_on_the_knob_grid(monkeypatch, base_log):
    _set(monkeypatch, BASE_LOG=base_log)
    seen = set()
    for sub_log, s256 in itertools.product((8, 9, 10, 11),
                                           (0, 6, 7, 8, 9, 10)):
        _set(monkeypatch, SUBBASE_LOG=sub_log, SUB256_LOG=s256)
        tmxu._subbase_cache.clear()
        for name in FIELDS:
            want = jmxu.effective_subbase(nt.get_field(name))
            got = tmxu.effective_subbase(tnt.get_field(name))
            assert got == want, (name, sub_log, s256)
            seen.add((name, got))
    assert ("small-proth", 1024) in seen
    assert ("goldilocks", 1024) not in seen
    if base_log <= 5:
        assert ("bls12-381-fr", 256) in seen
        assert ("bls12-381-fr", 512) not in seen


def test_a_peel_no_kernel_takes_raises(monkeypatch):
    """Above m = 1024 (where the reference would peel 2048) the port
    raises, naming the field and the peel, and does not peel smaller."""
    monkeypatch.setattr(tmxu, "reference_peel_fits", lambda f, s: True)
    _set(monkeypatch, SUBBASE_LOG=11)
    with pytest.raises(ValueError, match="small-proth: mxu_sub peels 2048"):
        tmxu.effective_subbase(tnt.SMALL)


# --- the plans at m = 1024 ----------------------------------------------------

#: the present form's shared bytes at m = 1024 (A1's ring and digit tile or
#: A2's, then Y) by field width
PRESENT_BYTES = {1: 169216, 2: 178176, 8: 229120}


@pytest.mark.parametrize("name", ["small-proth", "goldilocks",
                                  "bls12-381-fr"])
def test_plans_at_1024(name):
    f = tnt.get_field(name)
    W = f.n_words
    assert mxu_level.sub_wide_holds(f, M) == (W == 1)
    assert mxu_level.sub_wide_holds(f, 512) == (W < 8)
    for sms, B in itertools.product((132, 114, 4),
                                    (1, 3, 4, 5, 512, 528, 529, 1024, 4096)):
        p = mxu_level.sub_plan(f, M, B)
        assert (p.bt, p.kt2) == (4, min(32, mxu_level.TC_KT[W]))
        assert p.kb_pad == p.ka_pad
        assert p.smem_bytes == PRESENT_BYTES[W] <= mxu_level.TC_MAX_SMEM
        assert p.blocks == -(-B // 4) * (32 // p.kt)
        wide = mxu_level.sub_wide(f, M, B, sms)
        if W == 1:
            w = mxu_level.sub_wide_plan(f, M, B, sms)
            assert (w.lb, w.kt, w.chunks, w.bt) == (32, 32, 1, 4)
            assert w.smem_bytes == 156416
            assert w.blocks <= max(sms, 1) and w.col_tiles == -(-B // 4)
            assert -(-w.col_tiles // w.span) == w.blocks
            assert wide == (p.blocks > sms)
        else:
            with pytest.raises(ValueError):
                mxu_level.sub_wide_plan(f, M, B, sms)
            assert not wide
    with pytest.raises(ValueError, match="no multi-level plan"):
        mxu_level.sub_plan(f, 2 * M, 8)


@pytest.mark.parametrize("log_n, launches", [
    (19, [(1024, 512, False), (512, 1024, False)]),
    (20, [(1024, 1024, True), (1024, 1024, True)]),
    (22, [(1024, 4096, True), (1024, 4096, True), (4, 1 << 20, None)]),
])
def test_small_proth_launches_under_subbase_log_10(monkeypatch, log_n,
                                                    launches):
    """(m, B, wide form) of each K3 launch of ``mxu_sub`` on the card's 132
    SMs; None: the single-level K3."""
    _set(monkeypatch, SUBBASE_LOG=10)
    f = tnt.SMALL
    sub = tmxu.effective_subbase(f)
    assert sub == 1024
    got, m = [], 1 << log_n
    while m > 1:
        s = min(m, sub)
        got.append((s, (1 << log_n) // s,
                    None if s <= 32 else mxu_level.sub_wide(
                        f, s, (1 << log_n) // s)))
        m //= s
    assert got == launches


# --- the plain version and the emulated blocks at m = 1024 ---------------------

@functools.cache
def _case(tw, inverse):
    """small-proth [1, 1024, B] (B = 16 for the table at rep 2, else 8),
    its twiddle and the JAX ``fused_subntt``'s words (interpret mode)."""
    jf, f = nt.SMALL, tnt.SMALL
    B = 16 if tw == "rep2" else 8
    x = _words(f, (M, B), B + inverse)
    T3, rep = None, 1
    if tw == "rep1":
        T3 = _words(f, (M, B), 3)
    elif tw == "rep2":
        T3, rep = _words(f, (B // 2, M), 4), 2
    want = jlevel.fused_subntt(
        jnp.asarray(x), jf, inverse, {32: jmxu._base_matrix(jf, 32, inverse)},
        None if T3 is None else jnp.asarray(T3), transpose_out=False,
        batch_tile=B, rep=rep)
    return x, T3, rep, np.asarray(want)


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("tw", ["none", "rep1", "rep2"])
def test_plain_at_1024_equals_pallas(tw, inverse):
    x, T3, rep, want = _case(tw, inverse)
    got = mxu_level.fused_subntt(
        torch.from_numpy(x), tnt.SMALL, inverse, _mats(tnt.SMALL, {32},
                                                       inverse),
        None if T3 is None else torch.from_numpy(T3), rep=rep)
    assert got.dtype == torch.uint32 and np.array_equal(got.numpy(), want)


def _operands(name, B, tw, inverse, seed):
    f = tnt.get_field(name)
    x = torch.from_numpy(_words(f, (M, B), seed))
    T3, rep = None, 1
    if tw == "rep1":
        T3 = torch.from_numpy(_words(f, (M, B), seed + 1))
    elif tw is not None:
        rep = tw
        T3 = torch.from_numpy(_words(f, (B // rep, M), seed + 1))
    return f, x, T3, rep, _mats(f, {32}, inverse)


@pytest.mark.parametrize("name, B, tw, inverse, sms", [
    ("small-proth", 37, "rep1", False, 2),     # spans of 5 tiles, ragged
    ("small-proth", 24, 8, True, 1),           # one block, six tiles
    ("small-proth", 9, None, False, 3),        # three spans of one tile
])
def test_emulated_wide_at_1024_equals_plain(name, B, tw, inverse, sms):
    """The wide form: level B's two row units of 16 slots (lb = 32, one
    vector a column)."""
    f, x, T3, rep, mats = _operands(name, B, tw, inverse, B)
    got = _emulated_wide(x, f, mats, T3, rep, inverse, sms)
    assert torch.equal(got, mxu_level.fused_subntt_plain(
        x, f, inverse, mats, T3, rep=rep))


@pytest.mark.parametrize("name, B, tw, inverse", [
    ("small-proth", 9, "rep1", True),     # one row chunk, three tiles
    ("goldilocks", 6, 2, False),          # two chunks, level B kt2 = 16
    ("bls12-381-fr", 5, None, True),      # eight chunks, four row passes
])
def test_emulated_present_at_1024_equals_plain(name, B, tw, inverse):
    f, x, T3, rep, mats = _operands(name, B, tw, inverse, 2 * B)
    got = _emulated_multi(x, f, mats, T3, rep, inverse)
    assert torch.equal(got, mxu_level.fused_subntt_plain(
        x, f, inverse, mats, T3, rep=rep))


# --- the transposed store -------------------------------------------------------

def _stack(jf, f, m, NT, seed):
    rng = np.random.default_rng(seed)
    tvals = [[int(v) for v in rng.integers(1, 1 << 62, size=m)]
             for _ in range(NT)]
    return tmxu.twiddle_matrix_stack(f, m, False, tvals)


@pytest.mark.parametrize("name, m, rep, tw", [("goldilocks", 16, 128, True),
                                               ("bn254-fr", 4, 128, False)])
def test_transposed_stack_equals_pallas(name, m, rep, tw):
    """Two stack entries of ``rep`` columns (the JAX kernel's tile is one
    entry's columns, 128 lanes); the residual T3 on the narrow field (the
    256-bit twiddle product costs the JAX compile half a minute more)."""
    jf, f = nt.get_field(name), tnt.get_field(name)
    x = _words(f, (m, 2 * rep), m)
    T3 = _words(f, (m, 2 * rep), m + 1) if tw else None
    As = _stack(jf, f, m, 2, m + 2)
    F = tmxu._fold_matrix(f, m)
    got = mxu_level.fused_level_stack(
        torch.from_numpy(x), f, torch.from_numpy(As), rep,
        None if F is None else torch.from_numpy(F),
        None if T3 is None else torch.from_numpy(T3), transpose_out=True)
    want = jlevel.fused_level_stack(
        jnp.asarray(x), jf, jnp.asarray(As), rep,
        None if F is None else jnp.asarray(F),
        None if T3 is None else jnp.asarray(T3), transpose_out=True)
    assert got.shape == (f.n_words, 2 * rep, m)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name, m, rep", [("small-proth", 64, 2),
                                          ("bls12-381-fr", 8, None)])
def test_transposed_subntt_equals_pallas(name, m, rep):
    """The multi-level form (m = 64) on the narrow field with the table at
    rep 2; the single-level one on the 256-bit field without a twiddle."""
    jf, f = nt.get_field(name), tnt.get_field(name)
    B = 16
    x = _words(f, (m, B), m + B)
    T3 = None if rep is None else _words(f, (B // rep, m), 5)
    sizes = {m} if m <= 32 else {32, m // 32}
    mats = tmxu._mats_for(f, sizes, False)
    got = mxu_level.fused_subntt(
        torch.from_numpy(x), f, False,
        {k: torch.from_numpy(v) for k, v in mats.items()},
        None if T3 is None else torch.from_numpy(T3), transpose_out=True,
        rep=rep or 1)
    want = jlevel.fused_subntt(
        jnp.asarray(x), jf, False, {k: jnp.asarray(v) for k, v in mats.items()},
        None if T3 is None else jnp.asarray(T3), transpose_out=True,
        batch_tile=B, rep=rep or 1)
    assert got.shape == (f.n_words, B, m)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_entries_under_the_reference_names():
    """``base_ntt_mxu_pallas`` builds the conv matrix of the direction
    where none is given; ``ntt_along_axis_pallas`` is K5."""
    jf, f = nt.GOLDILOCKS, tnt.GOLDILOCKS
    x = _words(f, (8, 16), 11)
    for inverse in (False, True):
        got = mxu_ntt.base_ntt_mxu_pallas(torch.from_numpy(x), f, inverse)
        want = jntt.base_ntt_mxu_pallas(jnp.asarray(x), jf, inverse)
        assert np.array_equal(got.numpy(), np.asarray(want))
    got = tkernels.ntt_along_axis_pallas(torch.from_numpy(x), f, True)
    want = jkernels.ntt_along_axis_pallas(jnp.asarray(x), jf, True)
    assert np.array_equal(got.numpy(), np.asarray(want))

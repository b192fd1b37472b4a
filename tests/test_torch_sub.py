"""The narrow-field pieces of the port against ntt_tpu.

- the plain version of the multi-level K3 (``fused_subntt_plain``, m = 64
  and 512) against ``ntt_tpu.kernels.mxu_level.fused_subntt``, run as the
  JAX package's own tests run it on the CPU (interpret mode), on Goldilocks
  and the small Proth prime: no twiddle, rep 1 and rep > 1, forward and
  inverse; and a torch emulation of the CUDA kernel's block dataflow
  (``csrc/mxu_sub.cu``, on the int8 tensor cores) against both;
- the host-built operands byte for byte: the unfolded conv matrix, the
  ``sub_mats`` dict, ``coset_base_matrix``, the inverse base matrices and
  the coset-folded ``matfold_tw_tables`` at 2^17;
- ``ntt_mxu_sub`` run on the JAX package's own coset tables.

Canonical words and int8 digits: the tolerance is exact equality.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ntt_tpu.fields as jfields
from ntt_tpu import digits as jdigits
from ntt_tpu.api import get_runner as j_get_runner
from ntt_tpu.kernels.mxu_level import fused_subntt as j_subntt
from ntt_tpu.transforms import mxu as jmxu
from ntt_tpu.transforms.fourstep import TwBatch as JTwBatch
from ntt_tpu.transforms.fourstep import TwMatStack as JTwMatStack
import ntt_tpu_torch.fields as tfields
from ntt_tpu_torch import api as tapi
from ntt_tpu_torch import digits as tdigits
from ntt_tpu_torch import limbs as tlimbs
from ntt_tpu_torch.kernels import mxu_level
from ntt_tpu_torch.transforms import mxu as tmxu

torch.set_num_threads(1)

NARROW = ["goldilocks", "small-proth"]
ALL = NARROW + ["bls12-381-fr", "bn254-fr"]


def _words(field, shape, seed):
    """Canonical random elements as uint32[W, *shape] (top word < p's)."""
    rng = np.random.default_rng(seed)
    W = field.n_words
    x = rng.integers(0, 1 << 32, size=(W,) + shape, dtype=np.uint64)
    x[W - 1] = rng.integers(0, field.p >> (32 * (W - 1)), size=shape,
                            dtype=np.uint64)
    return x.astype(np.uint32)


@functools.cache
def _multi_case(name, m, tw, inverse):
    """One case of the multi-level K3 at B = 16 columns (one batch tile of
    the JAX kernel): x, T3, rep, the mats dict and the JAX
    ``fused_subntt``'s words (interpret mode; computed once a case and
    shared by the tests below). rep8: the i2-resolution table [W, 2, m],
    each row covering 8 columns."""
    jf, tf = jfields.get_field(name), tfields.get_field(name)
    B = 16
    x = _words(tf, (m, B), m + B)
    T3, rep = None, 1
    if tw == "rep1":
        T3 = _words(tf, (m, B), 1)
    elif tw == "rep8":
        T3, rep = _words(tf, (B // 8, m), 2), 8
    tmats = {k: torch.from_numpy(v)
             for k, v in tmxu.sub_mats(tf, m, inverse).items()}
    want = j_subntt(jnp.asarray(x), jf, inverse, jmxu.sub_mats(jf, m, inverse),
                    None if T3 is None else jnp.asarray(T3),
                    transpose_out=False, batch_tile=16, rep=rep)
    return x, T3, rep, tmats, np.asarray(want)


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("tw", ["none", "rep1", "rep8"])
@pytest.mark.parametrize("m", [64, 512])
@pytest.mark.parametrize("name", NARROW)
def test_fused_subntt_multi_plain_equals_pallas(name, m, tw, inverse):
    """B = 16 columns in one batch tile. rep8: the i2-resolution table
    [W, 2, m], each row covering 8 columns."""
    tf = tfields.get_field(name)
    x, T3, rep, tmats, want = _multi_case(name, m, tw, inverse)
    got = mxu_level.fused_subntt(
        torch.from_numpy(x), tf, inverse, tmats,
        None if T3 is None else torch.from_numpy(T3), rep=rep)
    assert got.dtype == torch.uint32
    assert np.array_equal(got.numpy(), want)


def _contract(A, m_op, kt_op, k0, k_pad, dig, E, D):
    """Z int32[E * kt_op, 128] of one block's contraction as the kernel runs
    it: the conv-matrix rows e * m_op + k0 + kk in GEMM row order
    e * kt_op + kk, the depth zero-padded to k_pad and taken 32 a step
    against the digit tile dig int32[128, k_pad]."""
    rows = [e * m_op + k0 + kk for e in range(E) for kk in range(kt_op)]
    ring = torch.zeros((len(rows), k_pad), dtype=torch.int32)
    ring[:, :D * m_op] = A[rows].to(torch.int32)
    acc = torch.zeros((len(rows), dig.shape[0]), dtype=torch.int32)
    for kb in range(0, k_pad, 32):
        acc += ring[:, kb:kb + 32] @ dig[:, kb:kb + 32].T
    return acc


def _digit_columns(y, field, k_pad):
    """The digit tile int32[128, k_pad] of the columns of y (words as int64
    [W, r, 128]): digit j of element i at contraction index j * r + i,
    zeros beyond."""
    D, r = tdigits.n_digits(field), y.shape[1]
    d = tdigits.extract_digits(y.to(torch.uint32), field).reshape(D * r, -1).T
    dig = torch.zeros((d.shape[0], k_pad), dtype=torch.int32)
    dig[:, :D * r] = d.to(torch.int32)
    return dig


def _emulated_multi(x3, field, mats, T3, rep, inverse):
    """The multi-level K3 block by block as ``csrc/mxu_sub.cu`` runs it
    (plan ``mxu_level.sub_plan``): level A over the 128 virtual columns
    (i2, b) of the block's bt batch columns against the chunk's rows of
    A[32], reduced, times the inner twiddle, into the tile Y[w][i2][kk * bt
    + bl]; level B per 128 virtual columns (k1, b) of Y and per kt2 rows k2
    of A[m2], reduced, times T3 read at (row, b) or (b / rep, row), stored
    at row k2 * 32 + k1."""
    W, m, B = x3.shape
    D, E = tdigits.n_digits(field), tdigits.out_planes(field)
    p = mxu_level.sub_plan(field, m, B)
    m2, bt, kt, kt2, N = m // 32, p.bt, p.kt, p.kt2, mxu_level.TC_COLS
    Tin = mxu_level.inner_twiddle(field, m, inverse, "cpu")
    flat = None if T3 is None else T3.reshape(W, -1)
    out = torch.full((W, m, B), -1, dtype=torch.int64)
    xv = x3.reshape(W, 32, m2, B)
    for blk in range(p.blocks):
        tile, chunk = divmod(blk, p.chunks)
        b0, k0 = tile * bt, chunk * kt
        v = torch.arange(N)                       # level A: (i2, bl)
        i2, b = v // bt, b0 + v % bt
        ok = b < B
        xa = torch.zeros((W, 32, N), dtype=torch.int64)
        xa[:, :, ok] = xv[:, :, i2[ok], b[ok]].to(torch.int64)
        Z = _contract(mats[32], 32, kt, k0, p.ka_pad,
                      _digit_columns(xa, field, p.ka_pad), E, D)
        y = tdigits.recompose_reduce(Z.reshape(E, kt, N), field,
                                     mxu_level._zmax_bits(field, 32),
                                     fold_mat=mats.get(-32))
        y = tlimbs.mont_mul(y, Tin[:, k0:k0 + kt][:, :, i2], field)
        Y = torch.zeros((W, m2, p.ys), dtype=torch.int64)
        for kk in range(kt):
            Y[:, i2, kk * bt + v % bt] = y[:, kk].to(torch.int64)
        for u0 in range(0, kt * bt, N):           # level B: (k1, bl)
            u = u0 + torch.arange(N)
            inb = u < kt * bt
            yb = torch.zeros((W, m2, N), dtype=torch.int64)
            yb[:, :, inb] = Y[:, :, u[inb]]
            dig = _digit_columns(yb, field, p.kb_pad)
            k1, b = k0 + u // bt, b0 + u % bt
            ok = inb & (b < B)
            for k2_0 in range(0, m2, kt2):
                Z = _contract(mats[m2], m2, kt2, k2_0, p.kb_pad, dig, E, D)
                y = tdigits.recompose_reduce(Z.reshape(E, kt2, N), field,
                                             mxu_level._zmax_bits(field, m2),
                                             fold_mat=mats.get(-m2))
                for kk2 in range(kt2):
                    row = (k2_0 + kk2) * 32 + k1[ok]
                    val = y[:, kk2, ok]
                    if T3 is not None:
                        at = (row * B + b[ok] if rep == 1
                              else (b[ok] // rep) * m + row)
                        val = tlimbs.mont_mul(val, flat[:, at], field)
                    out[:, row, b[ok]] = val.to(torch.int64)
    assert bool((out >= 0).all()), "an output no block stored"
    return out.to(torch.uint32)


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("tw", ["none", "rep1", "rep8"])
@pytest.mark.parametrize("m", [64, 512])
@pytest.mark.parametrize("name", NARROW)
def test_emulated_multi_level_equals_plain_and_pallas(name, m, tw, inverse):
    """The kernel's block dataflow (two row chunks at m = 512 Goldilocks,
    one on small-proth; two column tiles of bt = 8 at m = 512, one ragged
    tile of bt = 64 at m = 64) gives the plain version's words and the JAX
    kernel's."""
    tf = tfields.get_field(name)
    x, T3, rep, tmats, want = _multi_case(name, m, tw, inverse)
    xt = torch.from_numpy(x)
    Tt = None if T3 is None else torch.from_numpy(T3)
    got = _emulated_multi(xt, tf, tmats, Tt, rep, inverse)
    assert torch.equal(got, mxu_level.fused_subntt_plain(
        xt, tf, inverse, tmats, Tt, rep=rep))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("name, m, B, rep", [
    ("goldilocks", 64, 300, 25),      # a rep that divides no block's columns
    ("small-proth", 256, 37, None),   # level B in four column tiles, ragged
    ("bls12-381-fr", 64, 70, 1),      # W = 8: eight row chunks of kt = 4
])
def test_emulated_multi_level_equals_plain(name, m, B, rep):
    tf = tfields.get_field(name)
    x = torch.from_numpy(_words(tf, (m, B), m + B))
    T3 = None
    if rep is not None:
        T3 = torch.from_numpy(_words(tf, (m, B) if rep == 1
                                     else (B // rep, m), 5))
    mats = {k: torch.from_numpy(v)
            for k, v in tmxu._mats_for(tf, {32, m // 32}, True).items()}
    got = _emulated_multi(x, tf, mats, T3, rep or 1, True)
    assert torch.equal(got, mxu_level.fused_subntt_plain(
        x, tf, True, mats, T3, rep=rep or 1))


@pytest.mark.parametrize("name", NARROW)
def test_unfolded_conv_matrix_equals_jax(name):
    jf, tf = jfields.get_field(name), tfields.get_field(name)
    rng = np.random.default_rng(7)
    m = 8
    entries = [[int(v) % tf.p for v in rng.integers(0, 1 << 62, size=m)]
               for _ in range(m)]
    got = tdigits.conv_matrix(entries, tf)
    want = jdigits.conv_matrix(entries, jf)
    D = tdigits.n_digits(tf)
    assert got.shape == ((2 * D - 1) * m, D * m) and got.dtype == want.dtype
    assert np.array_equal(got, want)


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("name, n", [("goldilocks", 1 << 18),
                                     ("small-proth", 1 << 13),
                                     ("bls12-381-fr", 1 << 11)])
def test_sub_mats_equal_jax(name, n, inverse):
    """Keys and bytes: the conv matrices of every inner base size, and the
    fold matrices where the field has them."""
    jf, tf = jfields.get_field(name), tfields.get_field(name)
    assert tmxu.effective_subbase(tf) == jmxu.effective_subbase(jf)
    got = tmxu.sub_mats(tf, n, inverse)
    want = {k: np.asarray(v) for k, v in jmxu.sub_mats(jf, n, inverse).items()}
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("name", ALL)
def test_coset_base_matrix_equals_jax(name):
    jf, tf = jfields.get_field(name), tfields.get_field(name)
    for m, inverse, col in ((32, False, 7), (16, True, tf.p - 5)):
        got = tmxu.coset_base_matrix(tf, m, inverse, col)
        want = np.asarray(jmxu.coset_base_matrix(jf, m, inverse, col))
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_coset_folded_matfold_tables_equal_jax_at_2e17():
    """The coset absorbed into the fold: the stack's input diagonal and
    per-entry scalars, c^b in the merged table."""
    jf, tf = jfields.BLS12_381_FR, tfields.BLS12_381_FR
    n, shift = 1 << 17, 7
    got = tmxu.matfold_tw_tables(tf, n, False, coset_shift=shift)
    want = jmxu.matfold_tw_tables(jf, n, False, coset_shift=shift)
    assert [t["kind"] for t in got] == ["stack", "batch", "stack"]
    assert len(got) == len(want)
    for t, jt in zip(got, want):
        if t["kind"] == "stack":
            assert isinstance(jt, JTwMatStack) and t["rep"] == jt.rep
            assert np.array_equal(t["As"], np.asarray(jt.As))
        else:
            assert isinstance(jt, JTwBatch)
            assert np.array_equal(t["T4"], np.asarray(jt.T4))
    plain = tmxu.matfold_tw_tables(tf, n, False)
    assert not np.array_equal(plain[0]["As"], got[0]["As"])
    assert np.array_equal(plain[2]["As"], got[2]["As"])


def test_inverse_matfold_tables_equal_jax_at_2e17():
    jf, tf = jfields.BLS12_381_FR, tfields.BLS12_381_FR
    n = 1 << 17
    got = tmxu.matfold_tw_tables(tf, n, True)
    want = jmxu.matfold_tw_tables(jf, n, True)
    for t, jt in zip(got, want):
        key = "As" if t["kind"] == "stack" else "T4"
        assert np.array_equal(t[key], np.asarray(getattr(jt, key)))


def test_multi_level_wrapper_checks_its_operands():
    tf = tfields.GOLDILOCKS
    mats = {k: torch.from_numpy(v)
            for k, v in tmxu.sub_mats(tf, 512, False).items()}
    x = torch.from_numpy(_words(tf, (512, 8), 3))
    with pytest.raises(ValueError, match="T3 must be"):
        mxu_level.fused_subntt(x, tf, False, mats, x[:, :64])
    with pytest.raises(ValueError, match="CUDA"):
        mxu_level.fused_subntt(x.to("meta"), tf, False, mats)


@pytest.mark.parametrize("name", NARROW)
def test_ntt_mxu_sub_on_jax_tables(name):
    """The JAX package's own aux tables of a 2^11 coset runner (the level's
    table with c^{i2} folded in, the conv matrices, the c^{i1·n2} column)
    carried across: the port's transform gives the JAX runner's output."""
    jf, tf = jfields.get_field(name), tfields.get_field(name)
    n = 1 << 11
    x = _words(tf, (n,), 11)
    run, jaux = j_get_runner(jf, n, False, "mxu_sub", True, 7)
    want = np.asarray(jax.jit(run)(x, jaux))
    assert "coset_col" in jaux and "first_mats" not in jaux
    aux = tapi.aux_from_numpy(
        [np.asarray(t) for t in jaux["tws"]],
        {int(k): np.asarray(v) for k, v in jaux["mats"].items()},
        device="cpu", coset_col=np.asarray(jaux["coset_col"]))
    got = tmxu.ntt_mxu_sub(torch.from_numpy(x), tf, False, iter(aux["tws"]),
                           aux["mats"], pre_col=aux["coset_col"])
    assert np.array_equal(got.numpy(), want)
    # and the port's own tables are those tables
    _, own = tapi.get_runner(tf, n, coset_shift=7, device="cpu")
    assert np.array_equal(own["tws"][0].numpy(), np.asarray(jaux["tws"][0]))
    assert np.array_equal(own["coset_col"].numpy(),
                          np.asarray(jaux["coset_col"]))

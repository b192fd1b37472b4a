"""The narrow-field pieces of the port against ntt_tpu.

- the plain version of the multi-level K3 (``fused_subntt_plain``, m = 64
  and 512) against ``ntt_tpu.kernels.mxu_level.fused_subntt``, run as the
  JAX package's own tests run it on the CPU (interpret mode), on Goldilocks
  and the small Proth prime: no twiddle, rep 1 and rep > 1, forward and
  inverse;
- the host-built operands byte for byte: the unfolded conv matrix, the
  ``sub_mats`` dict, ``coset_base_matrix``, the inverse base matrices and
  the coset-folded ``matfold_tw_tables`` at 2^17;
- ``ntt_mxu_sub`` run on the JAX package's own coset tables.

Canonical words and int8 digits: the tolerance is exact equality.
"""

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


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("tw", ["none", "rep1", "rep8"])
@pytest.mark.parametrize("m", [64, 512])
@pytest.mark.parametrize("name", NARROW)
def test_fused_subntt_multi_plain_equals_pallas(name, m, tw, inverse):
    """B = 16 columns in one batch tile. rep8: the i2-resolution table
    [W, 2, m], each row covering 8 columns."""
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
    got = mxu_level.fused_subntt(
        torch.from_numpy(x), tf, tmats,
        None if T3 is None else torch.from_numpy(T3), rep=rep,
        inverse=inverse)
    want = j_subntt(jnp.asarray(x), jf, inverse, jmxu.sub_mats(jf, m, inverse),
                    None if T3 is None else jnp.asarray(T3),
                    transpose_out=False, batch_tile=16, rep=rep)
    assert got.dtype == torch.uint32
    assert np.array_equal(got.numpy(), np.asarray(want))


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
        mxu_level.fused_subntt(x, tf, mats, x[:, :64], rep=1)
    with pytest.raises(ValueError, match="CUDA"):
        mxu_level.fused_subntt(x.to("meta"), tf, mats)


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
    got = tmxu.ntt_mxu_sub(torch.from_numpy(x), tf, iter(aux["tws"]),
                           aux["mats"], pre_col=aux["coset_col"])
    assert np.array_equal(got.numpy(), want)
    # and the port's own tables are those tables
    _, own = tapi.get_runner(tf, n, coset_shift=7, device="cpu")
    assert np.array_equal(own["tws"][0].numpy(), np.asarray(jaux["tws"][0]))
    assert np.array_equal(own["coset_col"].numpy(),
                          np.asarray(jaux["coset_col"]))

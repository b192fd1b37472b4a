"""lde, polymul, batched input and the input-validation errors of the port,
against the same calls of ntt_tpu on the CPU. Canonical words out: the
tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

import ntt_tpu as nt
import ntt_tpu_torch as tnt
from ntt_tpu_torch import api as tapi
from ntt_tpu_torch import limbs as tlimbs
from ntt_tpu_torch.transforms import mxu as tmxu

torch.set_num_threads(1)


def _words(field, shape, seed):
    """Canonical random elements as uint32[W, *shape] (top word < p's)."""
    rng = np.random.default_rng(seed)
    W = field.n_words
    x = rng.integers(0, 1 << 32, size=(W,) + shape, dtype=np.uint64)
    x[W - 1] = rng.integers(0, field.p >> (32 * (W - 1)), size=shape,
                            dtype=np.uint64)
    return x.astype(np.uint32)


@pytest.mark.parametrize("name, log_n", [("goldilocks", 11),
                                         ("small-proth", 9)])
def test_lde_equals_jax(name, log_n):
    jf, tf = nt.get_field(name), tnt.get_field(name)
    x = _words(tf, (1 << log_n,), log_n)
    want = np.asarray(nt.lde(x, jf, blowup=4))
    got = tnt.lde(x, tf, blowup=4, device="cpu")
    assert got.shape == (tf.n_words, 4 << log_n)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("name, log_n, cyclic", [
    ("goldilocks", 9, False), ("small-proth", 11, False),
    ("goldilocks", 11, True)])
def test_polymul_equals_jax(name, log_n, cyclic):
    jf, tf = nt.get_field(name), tnt.get_field(name)
    n = 1 << log_n
    a, b = _words(tf, (n,), 1), _words(tf, (n,), 2)
    want = np.asarray(nt.polymul(a, b, jf, cyclic=cyclic))
    got = tnt.polymul(a, b, tf, cyclic=cyclic, device="cpu")
    assert got.shape == (tf.n_words, n if cyclic else 2 * n)
    assert np.array_equal(got.numpy(), want)


def test_polymul_is_the_schoolbook_product():
    f = tnt.SMALL
    a, b = [3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8, 1, 8]
    want = [0] * 16
    for i, u in enumerate(a):
        for j, v in enumerate(b):
            want[i + j] = (want[i + j] + u * v) % f.p
    got = tnt.polymul(tnt.from_ints(a, f), tnt.from_ints(b, f), f,
                      device="cpu")
    assert tnt.to_ints(got, f) == want


@pytest.mark.parametrize("call", ["ntt", "intt", "coset_ntt", "coset_intt"])
def test_batched_goldilocks_equals_jax(call):
    """uint32[W, 2^11, 3] goes through the recursion natively."""
    jf, tf = nt.GOLDILOCKS, tnt.GOLDILOCKS
    x = _words(tf, (1 << 11, 3), 3)
    want = np.asarray(getattr(nt, call)(x, jf))
    got = getattr(tnt, call)(x, tf, device="cpu")
    assert got.shape == x.shape
    assert np.array_equal(got.numpy(), want)


def test_batched_small_proth_equals_jax():
    jf, tf = nt.SMALL, tnt.SMALL
    x = _words(tf, (1 << 11, 3), 4)
    want = np.asarray(nt.ntt(x, jf))
    got = tnt.ntt(x, tf, device="cpu")
    assert np.array_equal(got.numpy(), want)
    for j in range(3):
        col = tnt.ntt(np.ascontiguousarray(x[:, :, j]), tf, device="cpu")
        assert np.array_equal(col.numpy(), want[:, :, j])


# --- the error paths of tests/test_errors.py, case by case ------------------

def test_unknown_field():
    with pytest.raises(ValueError, match="unknown field"):
        tnt.get_field("nope")
    with pytest.raises(ValueError, match="unknown field"):
        tnt.ntt(torch.zeros((1, 16), dtype=torch.uint32), "nope",
                device="cpu")


@pytest.mark.parametrize("call", ["ntt", "intt", "coset_ntt", "coset_intt",
                                  "lde"])
def test_non_power_of_two(call):
    x = tnt.from_ints(list(range(48)), tnt.SMALL)
    with pytest.raises(ValueError, match="power of two"):
        getattr(tnt, call)(x, tnt.SMALL, device="cpu")


def test_wrong_limb_count():
    x = tnt.from_ints(list(range(16)), tnt.SMALL)  # W=1
    with pytest.raises(ValueError, match="limb-leading"):
        tnt.ntt(x, tnt.BN254_FR, device="cpu")
    with pytest.raises(ValueError, match="limb-leading"):
        tnt.ntt(x.to(torch.int64), tnt.SMALL, device="cpu")


def test_two_adicity_exceeded():
    with pytest.raises(AssertionError, match="two-adicity"):
        tnt.SMALL.root_of_unity(1 << 27)


def test_unknown_algorithm():
    x = tnt.from_ints(list(range(16)), tnt.SMALL)
    with pytest.raises(KeyError):
        tnt.ntt(x, tnt.SMALL, algorithm="bogus", device="cpu")


def test_algorithms_still_to_port_say_so():
    """Every name of the JAX package's registry runs, at every size the
    field allows: only n above BN254 Fr's two-adicity (2^28) raises, as in
    ntt_tpu; at 2^25 the 256-bit paths' plan takes the periodic residual at
    level 0 (no table is built to say so)."""
    assert sorted(tapi.ALGORITHMS) == sorted(nt.api.ALGORITHMS)
    for alg in ("mxu_chunked", "mxu_sub"):
        with pytest.raises(AssertionError, match="two-adicity"):
            nt.api.get_runner(nt.BN254_FR, 1 << 29, False, alg, True, None)
        with pytest.raises(AssertionError, match="two-adicity"):
            tapi.get_runner(tnt.BN254_FR, 1 << 29, algorithm=alg,
                            device="cpu")
    plan = tmxu.matfold_plan(tnt.BN254_FR, 1 << 25)
    assert [kind for kind, _ in plan] == ["resid", "deep", "deep", "stack"]


@pytest.mark.parametrize("alg", ["naive", "fourstep", "pallas", "mxu_fused",
                                 "mxu_chunked"])
def test_algorithms_once_to_port_equal_jax(alg):
    """The names that raised on the small field before the whole ladder
    was ported, at n = 16 against ntt_tpu."""
    x = _words(tnt.SMALL, (16,), 16)
    want = np.asarray(nt.ntt(x, nt.SMALL, algorithm=alg))
    got = tnt.ntt(x, tnt.SMALL, algorithm=alg, device="cpu")
    assert np.array_equal(got.numpy(), want)


def test_is_canonical():
    f = tnt.SMALL
    ok = tnt.from_ints([0, 1, f.p - 1], f)
    bad = tnt.from_ints([f.p], f)
    assert tlimbs.is_canonical(ok, f).all()
    assert not tlimbs.is_canonical(bad, f).any()


def test_field_validate():
    for f in tnt.FIELDS.values():
        f.validate()


def test_polymul_shapes_must_agree():
    a = tnt.from_ints(list(range(16)), tnt.SMALL)
    with pytest.raises(ValueError, match="shape"):
        tnt.polymul(a, a[:, :8], tnt.SMALL, device="cpu")


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = tnt.from_ints(list(range(16)), tnt.SMALL)
    for call in (tnt.intt, tnt.coset_ntt, tnt.coset_intt, tnt.lde):
        with pytest.raises(RuntimeError, match="CUDA"):
            call(x, tnt.SMALL)
    with pytest.raises(RuntimeError, match="CUDA"):
        tnt.polymul(x, x, tnt.SMALL)
    with pytest.raises(RuntimeError, match="CUDA"):
        tapi.get_runner(tnt.SMALL, 16)

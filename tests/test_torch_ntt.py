"""The port's forward mxu_chunked NTT as a whole, against ntt_tpu.

- the aux tables at 2^18 BLS are byte-equal to the JAX package's;
- the output at 2^17 (the smallest size with the full fold composition:
  level-0 stack, merged TwBatch table, deep stack) and 2^14 (plain tables,
  a rep > 1 deep level) equals ntt_tpu.ntt(..., "mxu_chunked", mont_io=True),
  also when run on the JAX package's tables carried across;
- at 2^18 BLS (ramp) and 2^17 BN254 (random) it equals the host golden NTT.

Canonical words out: the tolerance is exact equality.
"""

import jax
import numpy as np
import pytest
import torch

import ntt_tpu.fields as jfields
from ntt_tpu.api import get_runner as j_get_runner
from ntt_tpu.transforms.fourstep import TwBatch as JTwBatch
from ntt_tpu.transforms.fourstep import TwMatStack as JTwMatStack
import ntt_tpu_torch as tnt
from ntt_tpu_torch import api as tapi
from ntt_tpu_torch import hostlib as thostlib
from ntt_tpu_torch import limbs as tlimbs
from ntt_tpu_torch.transforms import mxu as tmxu

torch.set_num_threads(1)

BLS, JBLS = tnt.BLS12_381_FR, jfields.BLS12_381_FR


def _words(field, n, seed):
    """Canonical random elements as uint32[W, n] (top word < p's)."""
    rng = np.random.default_rng(seed)
    W = field.n_words
    x = rng.integers(0, 1 << 32, size=(W, n), dtype=np.uint64)
    x[W - 1] = rng.integers(0, field.p >> (32 * (W - 1)), size=n,
                            dtype=np.uint64)
    return x.astype(np.uint32)


def _jax_aux_to_numpy(aux):
    """The JAX package's aux pytree as plain numpy (aux_from_numpy's form)."""
    tws = []
    for t in aux["tws"]:
        if isinstance(t, JTwMatStack):
            tws.append({"kind": "stack", "As": np.asarray(t.As),
                        "rep": int(t.rep)})
        elif isinstance(t, JTwBatch):
            tws.append({"kind": "batch", "T4": np.asarray(t.T4)})
        else:
            tws.append(np.asarray(t))
    return tws, {int(k): np.asarray(v) for k, v in aux["mats"].items()}


def _golden_mont(field, x_std):
    """Host golden NTT of standard-form planes uint32[W, n], as planes."""
    rows = np.ascontiguousarray(x_std.T).view(np.uint64)
    return thostlib.host_planes(thostlib.ntt_np(rows, field),
                                field.n_words)


@pytest.fixture(scope="module")
def jax_2e17():
    """(input, output, aux as numpy) of the JAX package at 2^17 BLS."""
    n = 1 << 17
    x = _words(BLS, n, 17)
    run, aux = j_get_runner(JBLS, n, False, "mxu_chunked", True, None)
    y = np.asarray(jax.jit(run)(x, aux))
    return x, y, _jax_aux_to_numpy(aux)


def test_aux_tables_equal_at_2e18():
    n = 1 << 18
    _, jaux = j_get_runner(JBLS, n, False, "mxu_chunked", True, None)
    jtws, jmats = _jax_aux_to_numpy(jaux)
    tws, mats = tapi._prep_mxu_chunked(BLS, n)
    assert [t["kind"] for t in tws] == ["stack", "batch", "stack"]
    assert len(tws) == len(jtws)
    for t, jt in zip(tws, jtws):
        assert t["kind"] == jt["kind"]
        key = "As" if t["kind"] == "stack" else "T4"
        assert t[key].dtype == jt[key].dtype
        assert np.array_equal(t[key], jt[key])
        assert t.get("rep") == jt.get("rep")
    assert sorted(mats) == sorted(jmats)
    for k in mats:
        assert mats[k].dtype == jmats[k].dtype
        assert np.array_equal(mats[k], jmats[k]), k


def test_ntt_equals_jax_at_2e17(jax_2e17):
    x, want, _ = jax_2e17
    got = tnt.ntt(torch.from_numpy(x), BLS, mont_io=True, device="cpu")
    assert got.dtype == torch.uint32
    assert np.array_equal(got.numpy(), want)


def test_ntt_on_jax_tables_at_2e17(jax_2e17):
    x, want, (tws, mats) = jax_2e17
    aux = tapi.aux_from_numpy(tws, mats, device="cpu")
    got = tmxu.ntt_mxu_chunked(torch.from_numpy(x), BLS, False,
                               iter(aux["tws"]), aux["mats"])
    assert np.array_equal(got.numpy(), want)


def test_ntt_2e14_equals_golden():
    """Plain tables: rep = 1 top level, rep = 32 deep level, base m = 16.
    Held against the golden NTT, not ntt_tpu: the JAX interpret-mode run
    at 2^14 costs 90 s with a cold compile cache (K3 at rep = 32 is held
    against its Pallas entry in test_torch_kernels.py)."""
    n = 1 << 14
    x = _words(BLS, n, 14)
    xm = tlimbs.to_mont(torch.from_numpy(x), BLS)
    got = tnt.ntt(xm, BLS, mont_io=True, device="cpu")
    assert np.array_equal(tlimbs.from_mont(got, BLS).numpy(),
                          _golden_mont(BLS, x))


def test_ntt_ramp_2e18_equals_golden():
    n = 1 << 18
    got = tnt.ntt(tapi.ramp_mont(BLS, n, device="cpu"), BLS, mont_io=True,
                  device="cpu")
    ramp = np.zeros((BLS.n_words, n), dtype=np.uint32)
    ramp[0] = np.arange(n, dtype=np.uint32)
    want = _golden_mont(BLS, ramp)
    assert np.array_equal(tlimbs.from_mont(got, BLS).numpy(), want)


def test_ntt_bn254_2e17_equals_golden():
    """mont_io=False: the API converts in and out itself."""
    f, n = tnt.BN254_FR, 1 << 17
    x = _words(f, n, 254)
    got = tnt.ntt(x, f, device="cpu")
    assert np.array_equal(got.numpy(), _golden_mont(f, x))


def test_batched_and_small_sizes_equal_golden():
    """n = 2 .. 64 (base only, one level with a 2-point base) and a batch
    of two columns."""
    for log_n in (1, 3, 5, 6):
        n = 1 << log_n
        x = _words(BLS, n, log_n)
        got = tnt.ntt(x, BLS, device="cpu")
        assert np.array_equal(got.numpy(), _golden_mont(BLS, x)), n
    xb = _words(BLS, 2 * 256, 9).reshape(BLS.n_words, 256, 2)
    got = tnt.ntt(xb, BLS, device="cpu").numpy()
    for j in range(2):
        assert np.array_equal(
            got[:, :, j], _golden_mont(BLS,
                                       np.ascontiguousarray(xb[:, :, j])))


def test_outside_the_slice_raises():
    """What still raises: n above BLS12-381 Fr's two-adicity (2^32), as in
    ntt_tpu, a batched input to a flat-peel transform, an unknown name, a
    size that is no power of two. 2^25 plans the periodic residual at
    level 0 instead of raising."""
    for alg in ("auto", "mxu_chunked", "mxu_sub"):
        with pytest.raises(AssertionError, match="two-adicity"):
            j_get_runner(JBLS, 1 << 33, False, alg, True, None)
        with pytest.raises(AssertionError, match="two-adicity"):
            tapi.get_runner(BLS, 1 << 33, algorithm=alg, device="cpu")
    assert [kind for kind, _ in tmxu.matfold_plan(BLS, 1 << 25)] == [
        "resid", "deep", "deep", "stack"]
    xb = torch.from_numpy(_words(BLS, 128, 1).reshape(8, 64, 2))
    for alg in ("mxu_fused", "pallas_fused"):
        with pytest.raises(AssertionError, match="unbatched"):
            tnt.ntt(xb, BLS, device="cpu", algorithm=alg)
    with pytest.raises(KeyError):
        tnt.ntt(xb, BLS, device="cpu", algorithm="mxu_chunked_2")
    with pytest.raises(ValueError):
        tnt.ntt(torch.zeros((8, 48), dtype=torch.uint32), BLS, device="cpu")


@pytest.mark.parametrize("alg", ["fourstep", "mxu_fused", "mxu_sub"])
def test_once_outside_the_slice_now_runs(alg):
    """The names that raised before the whole ladder was ported."""
    x = _words(BLS, 64, 1)
    got = tnt.ntt(x, BLS, device="cpu", algorithm=alg)
    assert np.array_equal(got.numpy(), _golden_mont(BLS, x))


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tnt.ntt(torch.from_numpy(_words(BLS, 64, 2)), BLS)

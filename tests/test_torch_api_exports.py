"""The port's top-level names and the ``donate`` argument of its entry
points, against ``ntt_tpu`` on the CPU. Canonical words out: the tolerance
is exact equality.
"""

import inspect
import subprocess
import sys

import numpy as np
import pytest
import torch

import ntt_tpu as nt
import ntt_tpu_torch as tnt

torch.set_num_threads(1)


def _words(field, shape, seed):
    """Canonical random elements as uint32[W, *shape] (top word < p's)."""
    rng = np.random.default_rng(seed)
    W = field.n_words
    x = rng.integers(0, 1 << 32, size=(W,) + shape, dtype=np.uint64)
    x[W - 1] = rng.integers(0, field.p >> (32 * (W - 1)), size=shape,
                            dtype=np.uint64)
    return x.astype(np.uint32)


def test_donated_buffer():
    """Mirror of ``test_transforms.test_donated_buffer``: donate=True gives
    the reference's words and takes over the input's storage; donate=False
    leaves the input as it was."""
    assert "donate" in inspect.signature(tnt.ntt).parameters
    x = _words(tnt.SMALL, (256,), 6)
    want = np.asarray(nt.ntt(nt.from_ints([int(v) for v in x[0]], nt.SMALL),
                             nt.SMALL, donate=True))
    kept = torch.from_numpy(x.copy())
    y = tnt.ntt(kept, tnt.SMALL, device="cpu")
    assert np.array_equal(y.numpy(), want)
    assert np.array_equal(kept.numpy(), x), "donate=False changed the input"
    given = torch.from_numpy(x.copy())
    y = tnt.ntt(given, tnt.SMALL, donate=True, device="cpu")
    assert np.array_equal(y.numpy(), want)
    assert y.data_ptr() == given.data_ptr(), "the output took no storage"


@pytest.mark.parametrize("entry", ["intt", "coset_ntt", "coset_intt"])
def test_donate_passes_through(entry):
    """intt, coset_ntt and coset_intt hand ``donate`` to ntt through their
    keywords: the same words as without it, in the input's storage."""
    f = tnt.GOLDILOCKS
    x = _words(f, (64,), 7)
    fn = getattr(tnt, entry)
    want = fn(torch.from_numpy(x.copy()), f, device="cpu")
    given = torch.from_numpy(x.copy())
    got = fn(given, f, donate=True, device="cpu")
    assert torch.equal(got, want)
    assert got.data_ptr() == given.data_ptr()


def test_to_mont_from_mont_equal_jax():
    jf, tf = nt.SMALL, tnt.SMALL
    x = _words(tf, (33,), 8)
    m = tnt.to_mont(torch.from_numpy(x), tf)
    assert np.array_equal(m.numpy(), np.asarray(nt.to_mont(x, jf)))
    back = tnt.from_mont(m, tf)
    assert np.array_equal(back.numpy(), np.asarray(nt.from_mont(
        np.asarray(nt.to_mont(x, jf)), jf)))
    assert np.array_equal(back.numpy(), x)


def test_top_level_names():
    assert tnt.__version__ == nt.__version__
    for name in ("to_mont", "from_mont"):
        assert name in tnt.__all__ and hasattr(tnt, name)
    # ``bigint`` at the top, as ``ntt_tpu.bigint`` is; importing it alone
    # loads neither JAX nor ntt_tpu
    import ntt_tpu_torch.bigint
    assert tnt.bigint is ntt_tpu_torch.bigint
    code = ("import sys, ntt_tpu_torch.bigint; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ntt_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr

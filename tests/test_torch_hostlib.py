"""ntt_tpu_torch.hostlib: the list forms, pow_mod, full_compare and the
loader's failure handling, against the port's oracle and Python ints.

Only the port's hostlib is built here (its build is atomic); this file
never imports ntt_tpu.hostlib, whose loader races under parallel workers.
Inputs are made with numpy from fixed seeds; outputs are exact words.
"""

import subprocess

import numpy as np
import pytest
import torch

import ntt_tpu_torch.fields as tfields
from ntt_tpu_torch import api, hostlib, limbs, oracle

torch.set_num_threads(1)

FIELDS = sorted(tfields.FIELDS)


def _values(f, count, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(40), "little") % f.p
            for _ in range(count)]


def test_available():
    assert hostlib.available()
    assert hostlib.available()      # a second call loads the cached library


@pytest.mark.parametrize("name", FIELDS)
def test_ntt_list_form(name):
    f = tfields.get_field(name)
    for x in (oracle.ramp(64, f), _values(f, 128, 1)):
        y = hostlib.ntt(x, f)
        assert y == oracle.ntt_golden(x, f)
        assert hostlib.ntt(y, f, inverse=True) == x
        assert hostlib.ntt(x, f, inverse=True) == oracle.intt_golden(x, f)


@pytest.mark.parametrize("name", FIELDS)
def test_powers(name):
    f = tfields.get_field(name)
    base = f.root_of_unity(1 << 10)
    want = [pow(base, i, f.p) for i in range(300)]
    assert hostlib.powers(base, 300, f) == want
    assert hostlib.powers(base, 300, f, mont_form=True) == [
        f.to_mont_int(v) for v in want]
    # the base is reduced mod p first
    assert hostlib.powers(base + f.p, 5, f) == want[:5]


@pytest.mark.parametrize("name", FIELDS)
def test_pow_mod(name):
    f = tfields.get_field(name)
    xs = _values(f, 6, 2) + [0, 1, f.p - 1]
    es = [0, 1, 2, f.p - 2, f.p - 1, f.p, (1 << 256) - 1, 12345]
    for x in xs:
        for e in es:
            assert hostlib.pow_mod(x, e, f) == pow(x, e, f.p), (x, e)
    assert hostlib.pow_mod(f.p + 3, 5, f) == pow(3, 5, f.p)
    for bad in (-1, 1 << 256):
        with pytest.raises(ValueError, match="exponent"):
            hostlib.pow_mod(2, bad, f)


@pytest.mark.parametrize("name", FIELDS)
def test_mul_mod_vec(name):
    f = tfields.get_field(name)
    a, b = _values(f, 200, 3), _values(f, 200, 4)
    a[:3], b[:3] = [0, 1, f.p - 1], [f.p - 1, f.p - 1, f.p - 1]
    assert hostlib.mul_mod_vec(a, b, f) == [
        u * v % f.p for u, v in zip(a, b)]
    with pytest.raises(ValueError, match="length"):
        hostlib.mul_mod_vec(a, b[:-1], f)


def test_rows_round_trip():
    rng = np.random.default_rng(5)
    vals = [0, 1, (1 << 64) - 1, 1 << 64, (1 << 256) - 1] + [
        int.from_bytes(rng.bytes(32), "little") for _ in range(100)]
    rows = hostlib.ints_to_rows(vals)
    assert rows.dtype == np.uint64 and rows.shape == (len(vals), 4)
    assert hostlib.rows_to_ints(rows) == vals
    assert hostlib.rows_to_ints(rows[:0]) == []


@pytest.fixture(scope="module")
def bls_result():
    """The port's forward NTT of random words at 2^10 on the CPU
    (Montgomery I/O) and the golden rows of the same input."""
    f = tfields.BLS12_381_FR
    vals = _values(f, 1 << 10, 6)
    x = limbs.to_mont(limbs.from_ints(vals, f), f)
    y = api.ntt(x, f, mont_io=True, device="cpu")
    return f, y, hostlib.ntt_np(hostlib.ints_to_rows(vals), f)


@pytest.mark.parametrize("where", ["first", "middle", "last"])
def test_full_compare_catches_one_word(bls_result, where):
    f, y, want = bls_result
    assert hostlib.full_compare(y, want, f, chunk_log=8)
    col = {"first": 3, "middle": 517, "last": (1 << 10) - 1}[where]
    bad = y.clone()
    # one word of one element in the slice: 256 columns a slice at 2^8
    bad[5, col] = int(bad[5, col]) ^ 1
    assert not hostlib.full_compare(bad, want, f, chunk_log=8)
    assert hostlib.full_compare(y, want, f, chunk_log=8)


def test_full_compare_rejects_wrong_row_count(bls_result):
    f, y, want = bls_result
    with pytest.raises(ValueError, match="golden rows"):
        hostlib.full_compare(y, want[:-1], f)


@pytest.mark.parametrize("fault", ["missing-source", "compile-error"])
def test_failed_build_is_not_cached(monkeypatch, tmp_path, fault):
    """available() is False while the build fails and True on the next
    call once the source is back: a failure is not remembered."""
    if fault == "missing-source":
        src = str(tmp_path / "missing.cpp")
    else:
        src = str(tmp_path / "broken.cpp")
        with open(src, "w") as fh:
            fh.write("this is not C++\n")
    hostlib._load.cache_clear()
    monkeypatch.setattr(hostlib, "_SRC", src)
    assert not hostlib.available()
    assert not hostlib.available()
    # the numpy forms raise: they never fall back
    with pytest.raises((OSError, subprocess.CalledProcessError)):
        hostlib.powers_np(3, 4, tfields.SMALL)
    monkeypatch.undo()
    assert hostlib.available()
    assert hostlib.pow_mod(3, 4, tfields.SMALL) == 81

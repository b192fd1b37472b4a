"""ntt_tpu_torch.oracle against ntt_tpu.oracle, word for word, and the
self-consistency checks of tests/test_oracle.py on the port's copy.

The port keeps its own copy of the executable specification (it imports
nothing of ntt_tpu). Inputs are the ramp and seeded random values made with
numpy, on all four fields at n = 2^2 .. 2^8; outputs are lists of Python
ints, so the tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

import ntt_tpu.fields as jfields
from ntt_tpu import oracle as joracle
import ntt_tpu_torch.fields as tfields
from ntt_tpu_torch import oracle as toracle

torch.set_num_threads(1)

FIELDS = sorted(tfields.FIELDS)
LOGS = range(2, 9)


def _pair(name):
    return jfields.get_field(name), tfields.get_field(name)


def _inputs(f, log_n):
    """The ramp and a seeded random vector of 2^log_n canonical values."""
    n = 1 << log_n
    rng = np.random.default_rng(1000 * log_n + f.n_words)
    rand = [int.from_bytes(rng.bytes(40), "little") % f.p for _ in range(n)]
    return [toracle.ramp(n, f), rand]


def _equal_on_inputs(name, fn, logs=LOGS):
    """fn(oracle module, field, x) gives the same words from both packages
    on every input."""
    jf, tf = _pair(name)
    for log_n in logs:
        for x in _inputs(tf, log_n):
            assert fn(toracle, tf, x) == fn(joracle, jf, x), (name, log_n)


def test_bit_reverse_and_ramp():
    for log_n in range(0, 9):
        n = 1 << log_n
        assert toracle.bit_reverse_table(n) == joracle.bit_reverse_table(n)
        for i in range(n):
            assert (toracle.bit_reverse(i, log_n)
                    == joracle.bit_reverse(i, log_n))
        for name in FIELDS:
            jf, tf = _pair(name)
            assert toracle.ramp(n, tf) == joracle.ramp(n, jf)


@pytest.mark.parametrize("name", FIELDS)
def test_ntt_golden_equal(name):
    _equal_on_inputs(name, lambda o, f, x: o.ntt_golden(x, f))
    inv_g = pow(tfields.get_field(name).generator, -1,
                tfields.get_field(name).p)
    _equal_on_inputs(name, lambda o, f, x: o.ntt_golden(x, f, omega=inv_g))


@pytest.mark.parametrize("name", FIELDS)
def test_ntt_dif_equal(name):
    _equal_on_inputs(name, lambda o, f, x: o.ntt_dif(x, f))


@pytest.mark.parametrize("name", FIELDS)
def test_ssip_phases_equal(name):
    """pro1 and pro2 in place, each phase's words, and the whole SSIP."""
    def phases(o, f, x):
        d = list(x)
        log_len = len(d).bit_length() - 1
        o.ntt_pro1(d, log_len, f)
        after1 = list(d)
        o.ntt_pro2(d, log_len, f)
        return [after1, d, o.ntt_ssip(x, f)]
    _equal_on_inputs(name, phases)


@pytest.mark.parametrize("name", FIELDS)
def test_intt_golden_equal(name):
    _equal_on_inputs(name, lambda o, f, x: o.intt_golden(x, f))


@pytest.mark.parametrize("name", FIELDS)
def test_coset_and_lde_equal(name):
    shift = 5

    def both(o, f, x):
        return [o.coset_ntt_golden(x, f, f.generator),
                o.coset_ntt_golden(x, f, shift),
                o.lde_golden(x, f, 2), o.lde_golden(x, f, 4, shift=shift)]
    _equal_on_inputs(name, both, logs=range(2, 7))


@pytest.mark.parametrize("name", FIELDS)
def test_naive_dft_equal(name):
    _equal_on_inputs(name, lambda o, f, x: o.naive_dft(x, f),
                     logs=range(2, 7))


# -- the self-consistency checks of tests/test_oracle.py on the port's copy

def test_port_golden_matches_dft_dif_ssip():
    for f in tfields.FIELDS.values():
        x = toracle.ramp(16, f)
        assert toracle.ntt_golden(x, f) == toracle.naive_dft(x, f)
        for log_n in (2, 4, 6):
            x = [(i * i + 7) % f.p for i in range(1 << log_n)]
            golden = toracle.ntt_golden(x, f)
            assert toracle.ntt_dif(x, f) == golden
            assert toracle.ntt_ssip(x, f) == golden
        # X[0] of the ramp is the sum 0 .. n-1
        assert toracle.ntt_golden(toracle.ramp(32, f), f)[0] == 32 * 31 // 2


def test_port_roundtrip_coset_lde():
    for f in tfields.FIELDS.values():
        _roundtrip_coset_lde(f)


def _roundtrip_coset_lde(f):
    p, n = f.p, 16
    x = toracle.ramp(n, f)
    assert toracle.intt_golden(toracle.ntt_golden(x, f), f) == x
    coeffs = toracle.intt_golden(x, f)
    shift = f.generator

    def interpolant_at(pt):
        acc = 0
        for c in reversed(coeffs):
            acc = (acc * pt + c) % p
        return acc

    w = f.root_of_unity(n)
    assert toracle.coset_ntt_golden(coeffs, f, shift) == [
        interpolant_at(shift * pow(w, k, p) % p) for k in range(n)]
    ext = toracle.lde_golden(x, f, blowup=2, shift=shift)
    w2 = f.root_of_unity(2 * n)
    assert len(ext) == 2 * n
    for k in (0, 1, 5, 2 * n - 1):
        assert ext[k] == interpolant_at(shift * pow(w2, k, p) % p)

"""The plain reference against a transform in Python integers, and the
control against the reference."""

import random

import pytest
import torch

from gpubench import harness
from gpubench.reference.field import PrimeField
from gpubench.reference.ops import Reference, bit_reverse, field_of

BENCH = harness.load_benchmark()
CONFIGS = {c["name"]: harness.load_config(BENCH, {"config": c["name"]})
           for c in BENCH["configs"]}


def words(f, values):
    return torch.tensor([[(v >> (32 * w)) & 0xFFFFFFFF for v in values]
                         for w in range(f.words)],
                        dtype=torch.int64).to(torch.uint32)


def ints(f, t):
    a = t.to(torch.int64)
    return [sum(int(a[w, j]) << (32 * w) for w in range(f.words))
            for j in range(a.shape[1])]


def dft(values, w, p):
    n = len(values)
    return [sum(values[i] * pow(w, i * k, p) for i in range(n)) % p
            for k in range(n)]


@pytest.fixture(params=sorted(CONFIGS))
def case(request):
    f = field_of(CONFIGS[request.param])
    rng = random.Random(request.param)
    n = 32
    xs = [rng.randrange(f.p) for _ in range(n)]
    ys = [rng.randrange(f.p) for _ in range(n)]
    R = pow(2, 16 * f.L, f.p)
    mont = lambda vals: words(f, [v * R % f.p for v in vals])  # noqa: E731
    plain = lambda t: [v * pow(R, -1, f.p) % f.p  # noqa: E731
                       for v in ints(f, t)]
    return f, n, xs, ys, mont, plain


def test_forward_inverse_and_cosets(case):
    f, n, xs, _, mont, plain = case
    ref = Reference(f.p, f.generator, f.generator, "cpu")
    w = pow(f.generator, (f.p - 1) // n, f.p)
    assert plain(ref.ntt(mont(xs))) == dft(xs, w, f.p)
    assert plain(ref.intt(mont(xs))) == [
        v * pow(n, -1, f.p) % f.p for v in dft(xs, pow(w, -1, f.p), f.p)]
    shifted = [x * pow(f.generator, i, f.p) % f.p for i, x in enumerate(xs)]
    assert plain(ref.coset_ntt(mont(xs))) == dft(shifted, w, f.p)
    assert plain(ref.coset_intt(ref.coset_ntt(mont(xs)))) == xs


def test_elementwise(case):
    f, n, xs, ys, mont, plain = case
    ref = Reference(f.p, f.generator, f.generator, "cpu")
    p = f.p
    assert plain(ref.mont_mul(mont(xs), mont(ys))) == [
        a * b % p for a, b in zip(xs, ys)]
    assert plain(ref.sub_mod(mont(xs), mont(ys))) == [
        (a - b) % p for a, b in zip(xs, ys)]
    assert plain(ref.sub_mod(mont(ys), mont(ys))) == [0] * n
    zinv = pow(pow(f.generator, n, p) - 1, -1, p)
    assert plain(ref.call("div_vanishing", mont(xs))) == [
        a * zinv % p for a in xs]


def test_edges(case):
    """0, 1 and p - 1 through every elementwise operation."""
    f, n, _, _, mont, plain = case
    ref = Reference(f.p, f.generator, f.generator, "cpu")
    edge = [0, 1, f.p - 1, f.p - 2] * (n // 4)
    rev = edge[::-1]
    p = f.p
    assert plain(ref.mont_mul(mont(edge), mont(rev))) == [
        a * b % p for a, b in zip(edge, rev)]
    assert plain(ref.sub_mod(mont(edge), mont(rev))) == [
        (a - b) % p for a, b in zip(edge, rev)]
    assert plain(Reference(p, f.generator, f.generator, "cpu").intt(
        ref.ntt(mont(edge)))) == edge


def test_control_breaks_canonical_words(case):
    """The control (no final subtraction in the product) gives other words
    than the reference: the check can tell them apart."""
    f, n, xs, _, mont, _ = case
    exact = Reference(f.p, f.generator, f.generator, "cpu").ntt(mont(xs))
    lazy = Reference(f.p, f.generator, f.generator, "cpu",
                     lazy=True).ntt(mont(xs))
    assert (exact.to(torch.int64) != lazy.to(torch.int64)).any()


def test_bit_reverse():
    assert bit_reverse(8, "cpu").tolist() == [0, 4, 2, 6, 1, 5, 3, 7]


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_configured_fields_have_their_domains(config):
    f = field_of(CONFIGS[config])
    log_n = CONFIGS[config]["log_n"]
    w = f.root_of_unity(1 << log_n)
    assert pow(w, 1 << log_n, f.p) == 1
    assert pow(w, 1 << (log_n - 1), f.p) == f.p - 1
    assert f.words == CONFIGS[config]["element_words"]
    with pytest.raises(ValueError):
        f.root_of_unity(3)
    with pytest.raises(ValueError):
        PrimeField(f.p + 1, 7)


def test_batched_vectors_transform_column_by_column(case):
    """A trailing batch axis: every operation acts on each column as on a
    vector of its own."""
    f, n, xs, ys, mont, _ = case
    ref = Reference(f.p, f.generator, f.generator, "cpu")
    cols = [mont(xs), mont(ys), mont(xs[::-1])]
    batch = torch.stack(cols, dim=2)
    for op in ("ntt", "intt", "coset_ntt", "coset_intt", "div_vanishing"):
        got = ref.call(op, batch)
        for j, c in enumerate(cols):
            assert torch.equal(got[:, :, j], ref.call(op, c)), op

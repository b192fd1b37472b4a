"""The port's big-integer layer against ``ntt_tpu.bigint`` and Python ints on
the CPU, the long algorithms: division and remainder (plain and wide), gcd,
modular and binary inverse, Barrett division and modular power, with the
sentinels (division by zero, inverses that do not exist, gcd(0, 0), the
Barrett approximation of 0). The square roots and a modulus broadcast
against a batch are in ``test_torch_bigint.py``, which keeps each file
under a minute on one core. Exact equality.

Same inputs, same checks as ``test_torch_bigint.py`` (its ``check``): both
packages, each JAX op once a width, the port's outputs equal to the JAX
module's in dtype, shape and value, and both equal to Python ints. One
exception: ``modular_power`` at W = 8 is held to Python ints alone, since
the JAX module's XLA compile of it takes over a minute on one core; at
W = 2 it runs in both packages.
"""

import math
import random

import numpy as np
import pytest
import torch
from test_bigint import _rand
from test_torch_bigint import N, WIDTHS, check, ints, pack

import ntt_tpu_torch.bigint as tb
from ntt_tpu_torch.fields import BLS12_381_FR

torch.set_num_threads(1)


def data(W) -> dict:
    """The seeded inputs of one width: numerators, divisors with zeros,
    odd moduli, Barrett divisors."""
    bits = 32 * W
    top = (1 << bits) - 1
    rng = random.Random(600 + W)
    xs, ys = _rand(W, N, 50 + W), _rand(W, N, 60 + W)
    # divisors: 0 (the sentinel), tiny, powers of two, x itself, random
    ds = list(ys)
    ds[:8] = [0, 1, 2, 3, 1 << 16, (1 << (16 * W)) + 1, xs[6] or 5, 0]
    # wide numerators: hi < d except in the last 8 columns (q truncates)
    his = [rng.randrange(d) if d else rng.randrange(top) for d in ds]
    his[-8:] = [ds[-8 + j] + j for j in range(8)]
    los = _rand(W, N, 70 + W)
    # gcd: shared powers of two, zeros
    g = rng.randrange(1, 1 << 20) << 5
    ga, gb = list(xs), list(ys)
    ga[:6] = [g * 3 & top, g * 4 & top, 0, xs[3], 0, 1]
    gb[:6] = [g * 5 & top, g * 6 & top, ys[2], 0, 0, top]
    # moduli: odd, one prime, inverses that do not exist
    ms = [rng.randrange(3, 1 << bits) | 1 for _ in range(N)]
    if W == 8:
        ms[0] = BLS12_381_FR.p
    ms[3] = 15 * (rng.randrange(1, (1 << bits) // 15) | 1)
    inv_x = [rng.randrange(1 << bits) for _ in range(N)]
    inv_x[1] = 0
    inv_x[2] = ms[2]
    inv_x[3] = 5 * rng.randrange(1, (1 << bits) // 5)
    # Barrett divisors: nonzero, the top bit set and clear
    bd = [d or 7 for d in ds]
    bd[:5] = [1, 2, 3, (1 << (bits - 1)) + 1, top]
    bhi = [rng.randrange(d) for d in bd]
    return {"W": W, "bits": bits, "top": top, "xs": xs, "ds": ds,
            "his": his, "los": los, "ga": ga, "gb": gb,
            "ms": ms, "inv_x": inv_x, "bd": bd, "bhi": bhi}


@pytest.fixture(scope="module", params=WIDTHS)
def d(request):
    return data(request.param)


def P(d, key):
    return pack(d[key], d["W"])


def test_div_rem(d):
    """y == 0 columns give q all-ones and r = x."""
    top = d["top"]
    q = [top if y == 0 else a // y for a, y in zip(d["xs"], d["ds"])]
    r = [a if y == 0 else a % y for a, y in zip(d["xs"], d["ds"])]
    args = (P(d, "xs"), P(d, "ds"))
    check("div_rem", args, (q, r))
    check("div", args, q)
    check("rem", args, r)


def test_div_rem_wide(d):
    """hi < y gives the true quotient; hi >= y (the last 8 columns) the
    quotient truncated to W words and the exact remainder; y == 0 gives
    q all-ones and r = lo."""
    bits, top = d["bits"], d["top"]
    nums = [(h << bits) | lo for h, lo in zip(d["his"], d["los"])]
    q = [top if y == 0 else (n // y) & top for n, y in zip(nums, d["ds"])]
    r = [lo if y == 0 else n % y
         for n, lo, y in zip(nums, d["los"], d["ds"])]
    args = (P(d, "los"), P(d, "his"), P(d, "ds"))
    check("div_rem_wide", args, (q, r))
    check("div_wide", args, q)
    check("rem_wide", args, r)


def test_gcd(d):
    """gcd(0, 0) = 0, gcd(x, 0) = x, shared powers of two."""
    check("gcd", (P(d, "ga"), P(d, "gb")),
          [math.gcd(a, b) for a, b in zip(d["ga"], d["gb"])])


def test_modular_inverse(d):
    """0 where gcd(x, m) != 1 (x = 0, x a multiple of m's factors)."""
    want = [pow(a, -1, m) if math.gcd(a, m) == 1 else 0
            for a, m in zip(d["inv_x"], d["ms"])]
    assert want[1] == want[2] == want[3] == 0
    check("modular_inverse", (P(d, "inv_x"), P(d, "ms")), want)


def test_binary_inverse(d):
    odds = [a | 1 for a in d["xs"]]
    check("binary_inverse", (pack(odds, d["W"]),),
          [pow(a, -1, 1 << d["bits"]) for a in odds])


def test_barrett_approximation(d):
    """d == 0 gives approx all-ones and shift = bits."""
    bits, top = d["bits"], d["top"]
    ds = list(d["bd"])
    ds[7] = 0
    approx, shift = [], []
    for v in ds:
        s = bits - v.bit_length()
        shift.append(s)
        approx.append(top if v == 0 else
                      ((1 << (2 * bits)) - 1) // (v << s) - (1 << bits))
    check("barrett_approximation", (pack(ds, d["W"]),), (approx, shift))


def barrett_args(d):
    """The divisors with their approximation and shift, from Python ints."""
    bits = d["bits"]
    shift = [bits - v.bit_length() for v in d["bd"]]
    approx = [((1 << (2 * bits)) - 1) // (v << s) - (1 << bits)
              for v, s in zip(d["bd"], shift)]
    return (P(d, "bd"), pack(approx, d["W"]),
            np.array(shift, dtype=np.int32))


def test_barrett_div_rem(d):
    D, A, S = barrett_args(d)
    q = [a // v for a, v in zip(d["xs"], d["bd"])]
    r = [a % v for a, v in zip(d["xs"], d["bd"])]
    args = (P(d, "xs"), D, A, S)
    check("barrett_div_rem", args, (q, r))
    check("barrett_div", args, q)
    check("barrett_rem", args, r)


def test_barrett_div_rem_wide(d):
    D, A, S = barrett_args(d)
    nums = [(h << d["bits"]) | lo for h, lo in zip(d["bhi"], d["los"])]
    q = [n // v for n, v in zip(nums, d["bd"])]
    r = [n % v for n, v in zip(nums, d["bd"])]
    args = (P(d, "los"), P(d, "bhi"), D, A, S)
    check("barrett_div_rem_wide", args, (q, r))
    check("barrett_div_wide", args, q)
    check("barrett_rem_wide", args, r)


def power_case(W, n):
    rng = random.Random(700 + W)
    bits = 32 * W
    ms = [rng.randrange(2, 1 << bits) for _ in range(n)]
    ms[0] = 1 << (bits - 1)          # even modulus
    ms[1] = 2
    xs = [rng.randrange(1 << bits) for _ in range(n)]
    es = [rng.randrange(1 << bits) for _ in range(n)]
    es[2] = 0
    es[3] = (1 << bits) - 1
    xs[4] = 0
    return xs, es, ms


def test_modular_power_w2():
    W = 2
    xs, es, ms = power_case(W, N)
    check("modular_power", (pack(xs, W), pack(es, W), pack(ms, W)),
          [pow(a, e, m) for a, e, m in zip(xs, es, ms)])


def test_modular_power_w8():
    """Python ints alone at W = 8 (the module docstring says why)."""
    W = 8
    xs, es, ms = power_case(W, N)
    got = tb.modular_power(torch.from_numpy(pack(xs, W)),
                           torch.from_numpy(pack(es, W)),
                           torch.from_numpy(pack(ms, W)))
    assert got.dtype == torch.uint32 and got.shape == (W, N)
    assert ints(got.numpy()) == [pow(a, e, m) for a, e, m in zip(xs, es, ms)]


def test_barrett_outside_the_contract(d):
    """Where Barrett has no defined result (hi >= denom, denom 0 with its
    all-ones approximation, shifts that are not clz), the port still gives
    the JAX module's words."""
    W, bits, top = d["W"], d["bits"], d["top"]
    rng = random.Random(900 + W)
    D, A, S = barrett_args(d)
    ds = list(d["bd"])
    ds[:2] = [0, 0]
    approx = pack([top] * 2 + ints(A)[2:], W)
    shift = np.array([bits, bits] + S.tolist()[2:], dtype=np.int32)
    shift[2:10] = [rng.randrange(-300, 600) for _ in range(8)]
    his = [h + v for h, v in zip(d["bhi"], ds)]     # hi >= denom
    check("barrett_div_rem_wide",
          (P(d, "los"), pack([h & top for h in his], W), pack(ds, W),
           approx, shift), None)
    check("barrett_div_rem", (P(d, "xs"), pack(ds, W), approx, shift), None)

"""The port's big-integer layer (``ntt_tpu_torch.bigint``) against
``ntt_tpu.bigint`` and Python ints on the CPU: add, sub, compare and bit
counting; set, swap, negate; the logical, shift, rotate, bit-field and mask
ops; multiply; the square roots; the ui32 family; the accumulator;
``limbs.eq``; broadcast batches; the public names and the constructors'
device rule. The division, gcd, inverse, Barrett and power ops are in
``test_torch_bigint_div.py``.

Every case runs the same numpy inputs (``test_bigint``'s seeded generator,
N = 64 columns, W = 2 and 8) through both packages, each JAX op once a
width, and holds the port's outputs to the JAX module's (dtype, shape and
every word) and both to Python-int arithmetic. Tolerance: exact equality.
"""

import math
import random
import types

import numpy as np
import pytest
import torch
from test_bigint import _rand
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

import ntt_tpu.bigint as jb
import ntt_tpu.limbs as jlimbs
import ntt_tpu_torch.bigint as tb
from ntt_tpu_torch import limbs as tlimbs

torch.set_num_threads(1)

WIDTHS = [2, 8]
N = 64
M32 = 0xFFFFFFFF
#: 32-bit edge words: where uint32 wraps and int64 does not
EDGE_WORDS = [0, 1, 2, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFFE, M32]


def pack(vals, W) -> np.ndarray:
    """Python ints -> uint32[W, n] words."""
    raw = b"".join(v.to_bytes(4 * W, "little") for v in vals)
    return np.frombuffer(raw, dtype="<u4").reshape(len(vals), W).T.copy()


def ints(words) -> list:
    """uint32[W, n] words -> Python ints, one ``int.from_bytes`` a column."""
    cols = np.ascontiguousarray(np.asarray(words, dtype=np.uint32).T)
    return [int.from_bytes(c.tobytes(), "little") for c in cols]


def leaves(out) -> list:
    """An op's outputs (an array or nested tuples) as a flat list."""
    if isinstance(out, tuple):
        return [leaf for o in out for leaf in leaves(o)]
    return [out]


def to_torch(a):
    return torch.from_numpy(a.copy()) if isinstance(a, np.ndarray) else a


def values(leaf) -> list:
    """Words [W, n] as Python ints; a plane [n] as its list."""
    return ints(leaf) if leaf.ndim == 2 else leaf.tolist()


def check(name, args, want, port_kwargs=None):
    """Run ``name`` on ``args`` in both packages: the port's outputs (on
    the CPU) equal the JAX module's in dtype, shape and value, and both
    equal ``want`` (tuples nested like the outputs, a list of Python ints
    or bools for each output; None: no Python-int result, outside an op's
    contract)."""
    got_j = [np.asarray(v) for v in leaves(getattr(jb, name)(*args))]
    got_t = leaves(getattr(tb, name)(*[to_torch(a) for a in args],
                                     **(port_kwargs or {})))
    assert len(got_t) == len(got_j), name
    want = leaves(want) if want is not None else [None] * len(got_j)
    for k, (j, t) in enumerate(zip(got_j, got_t)):
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu", name
        t = t.numpy()
        assert t.dtype == j.dtype and t.shape == j.shape, (name, k, t.dtype,
                                                           j.dtype)
        assert np.array_equal(t, j), (name, k)
        assert want[k] is None or values(t) == want[k], (name, k)


def data(W) -> dict:
    """The seeded inputs of one width."""
    bits = 32 * W
    rng = random.Random(300 + W)
    xs, ys, zs = _rand(W, N, 10 + W), _rand(W, N, 20 + W), \
        _rand(W, N, 30 + W)
    ys[10:14] = xs[10:14]                 # equal columns
    us = [rng.randrange(1 << 32) for _ in range(N)]
    us[:6] = [0, 1, 2, M32, 0x80000000, 0x7FFFFFFF]
    us[6:10] = [xs[j] & M32 for j in range(6, 10)]
    us[10:14] = xs[:4]                    # x == u for small x
    return {"W": W, "bits": bits, "top": (1 << bits) - 1, "xs": xs,
            "ys": ys, "zs": zs, "us": us, "X": pack(xs, W),
            "Y": pack(ys, W), "Z": pack(zs, W),
            "U": np.array(us, dtype=np.uint32)}


@pytest.fixture(scope="module", params=WIDTHS)
def d(request):
    return data(request.param)


def mask_value(bits, nb):
    if 0 <= nb < bits:
        return (1 << nb) - 1
    if -bits < nb < 0:
        return ((1 << -nb) - 1) << (bits + nb)
    return (1 << bits) - 1


# ---------------------------------------------------------------------------
# add, sub, compare, bit counting; set, swap, negate
# ---------------------------------------------------------------------------

def test_add_sub(d):
    xs, ys, bits, top = d["xs"], d["ys"], d["bits"], d["top"]
    check("add", (d["X"], d["Y"]),
          ([(a + b) & top for a, b in zip(xs, ys)],
           [(a + b) >> bits for a, b in zip(xs, ys)]))
    check("sub", (d["X"], d["Y"]),
          ([(a - b) & top for a, b in zip(xs, ys)],
           [int(a < b) for a, b in zip(xs, ys)]))


def test_compare_equals(d):
    xs, ys = d["xs"], d["ys"]
    check("compare", (d["X"], d["Y"]),
          [(a > b) - (a < b) for a, b in zip(xs, ys)])
    check("equals", (d["X"], d["Y"]), [a == b for a, b in zip(xs, ys)])
    check("equals", (d["X"], d["X"]), [True] * N)


def test_limbs_eq(d):
    xs, ys = d["xs"], d["ys"]
    got = tlimbs.eq(to_torch(d["X"]), to_torch(d["Y"]))
    want = np.asarray(jlimbs.eq(d["X"], d["Y"]))
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)
    assert got.tolist() == [a == b for a, b in zip(xs, ys)]


def test_bit_counting(d):
    xs, bits = d["xs"], d["bits"]
    check("pop_count", (d["X"],), [bin(a).count("1") for a in xs])
    check("clz", (d["X"],), [bits - a.bit_length() for a in xs])
    check("ctz", (d["X"],),
          [bits if a == 0 else (a & -a).bit_length() - 1 for a in xs])


def test_set_swap_negate(d):
    xs, ys, top = d["xs"], d["ys"], d["top"]
    check("set_", (d["X"],), xs)
    check("swap", (d["X"], d["Y"]), (ys, xs))
    check("negate", (d["X"],), [(-a) & top for a in xs])


# ---------------------------------------------------------------------------
# logical, shift, rotate, bit field, masks
# ---------------------------------------------------------------------------

def test_bitwise(d):
    xs, ys, top = d["xs"], d["ys"], d["top"]
    check("bitwise_and", (d["X"], d["Y"]), [a & b for a, b in zip(xs, ys)])
    check("bitwise_ior", (d["X"], d["Y"]), [a | b for a, b in zip(xs, ys)])
    check("bitwise_xor", (d["X"], d["Y"]), [a ^ b for a, b in zip(xs, ys)])
    check("bitwise_complement", (d["X"],), [a ^ top for a in xs])


@pytest.mark.parametrize("name", ["shift_left", "shift_right", "rotate_left",
                                  "rotate_right"])
def test_shift_rotate(d, name):
    """Static counts, at and past the width too (shifts give 0 there)."""
    xs, bits, top = d["xs"], d["bits"], d["top"]
    for k in (0, 1, 7, 16, 31, 32, 100 % bits, bits - 1, bits, bits + 5):
        r = k % bits
        want = {"shift_left": [(a << k) & top for a in xs],
                "shift_right": [a >> k for a in xs],
                "rotate_left": [((a << r) | (a >> (bits - r))) & top
                                for a in xs],
                "rotate_right": [((a >> r) | (a << (bits - r))) & top
                                 for a in xs]}[name]
        check(name, (d["X"], k), want)


def test_bit_field(d):
    xs, ys, bits, top = d["xs"], d["ys"], d["bits"], d["top"]
    for start, length in ((13, 37), (0, bits), (bits - 5, 20), (40, 0),
                          (bits, 8)):
        n = max(min(length, bits - start), 0)
        field = (1 << n) - 1
        check("bit_extract", (d["X"], start, length),
              [(a >> start) & field for a in xs])
        m = (field << start) & top
        check("bit_insert", (d["X"], d["Y"], start, length),
              [(a & ~m & top) | (((b & field) << start) & top)
               for a, b in zip(xs, ys)])


@pytest.mark.parametrize("nb", [0, 1, 13, 32, -1, -13, 2 ** 20, -2 ** 20,
                                "bits-1", "bits", "-bits"])
def test_masks(d, nb):
    """The mask rule for numbits in [0, bits), in (-bits, 0) and out of
    range (all ones)."""
    xs, ys, zs, bits, top = d["xs"], d["ys"], d["zs"], d["bits"], d["top"]
    if isinstance(nb, str):
        nb = eval(nb, {"bits": bits})
    m = mask_value(bits, nb)
    check("bitwise_mask_copy", (d["W"], nb, (N,)), [m] * N,
          port_kwargs={"device": "cpu"})
    check("bitwise_mask_and", (d["X"], nb), [a & m for a in xs])
    check("bitwise_mask_ior", (d["X"], nb), [a | m for a in xs])
    check("bitwise_mask_xor", (d["X"], nb), [a ^ m for a in xs])
    check("bitwise_mask_select", (d["X"], d["Y"], nb),
          [(a & ~m & top) | (b & m) for a, b in zip(xs, ys)])
    check("bitwise_select", (d["X"], d["Y"], d["Z"]),
          [(a & ~s & top) | (b & s) for a, b, s in zip(xs, ys, zs)])


# ---------------------------------------------------------------------------
# multiply
# ---------------------------------------------------------------------------

def test_mul(d):
    xs, ys, bits, top = d["xs"], d["ys"], d["bits"], d["top"]
    prods = [a * b for a, b in zip(xs, ys)]
    squares = [a * a for a in xs]
    check("mul_wide", (d["X"], d["Y"]),
          ([p & top for p in prods], [p >> bits for p in prods]))
    check("mul", (d["X"], d["Y"]), [p & top for p in prods])
    check("mul_high", (d["X"], d["Y"]), [p >> bits for p in prods])
    check("sqr", (d["X"],), [p & top for p in squares])
    check("sqr_wide", (d["X"],),
          ([p & top for p in squares], [p >> bits for p in squares]))
    check("sqr_high", (d["X"],), [p >> bits for p in squares])


class LargestBuffer(TorchDispatchMode):
    """Notes the bytes of the largest storage any op returns."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.largest = max(self.largest,
                                   t.untyped_storage().nbytes())
        return out


@pytest.mark.parametrize("W", WIDTHS)
def test_product_memory_is_linear_in_width(W):
    """The products hold one [2L, *batch] int64 buffer of column sums (L =
    2W halves), not the L x 2L table of half products, so that 2^24
    columns fit the card at W = 8; checked on a batch of 4,096 against
    Python ints."""
    n, bits = 4096, 32 * W
    xs, ys = _rand(W, n, 40 + W), _rand(W, n, 50 + W)
    X, Y = torch.from_numpy(pack(xs, W)), torch.from_numpy(pack(ys, W))
    with LargestBuffer() as seen:
        lo, hi = tb.mul_wide(X, Y)
        lo_u, over = tb.mul_ui32(X, Y[0])
    assert seen.largest <= 2 * (2 * W) * n * 8, seen.largest
    top = (1 << bits) - 1
    assert ints(lo.numpy()) == [a * b & top for a, b in zip(xs, ys)]
    assert ints(hi.numpy()) == [a * b >> bits for a, b in zip(xs, ys)]
    us = [b & M32 for b in ys]
    assert ints(lo_u.numpy()) == [a * u & top for a, u in zip(xs, us)]
    assert over.numpy().tolist() == [a * u >> bits for a, u in zip(xs, us)]


# ---------------------------------------------------------------------------
# square roots
# ---------------------------------------------------------------------------

def test_sqrt(d):
    """Exact squares and their neighbours, 0 and all-ones."""
    W, bits = d["W"], d["bits"]
    rng = random.Random(900 + W)
    rad = list(d["xs"])
    rad[20:28] = [rng.randrange(1 << (bits // 2)) ** 2 for _ in range(8)]
    rad[28:32] = [max(v - 1, 0) for v in rad[20:24]]
    s = [math.isqrt(a) for a in rad]
    check("sqrt", (pack(rad, W),), s)
    check("sqrt_rem", (pack(rad, W),),
          (s, [a - v * v for a, v in zip(rad, s)]))


def test_sqrt_wide(d):
    W, bits, top = d["W"], d["bits"], d["top"]
    rng = random.Random(910 + W)
    nums = [rng.randrange(1 << (2 * bits)) for _ in range(N)]
    nums[:4] = [0, (1 << (2 * bits)) - 1, (1 << (2 * bits)) >> 2,
                (top << bits) | top]
    los = pack([v & top for v in nums], W)
    his = pack([v >> bits for v in nums], W)
    s = [math.isqrt(v) for v in nums]
    rem = [v - t * t for v, t in zip(nums, s)]
    check("sqrt_wide", (los, his), s)
    check("sqrt_rem_wide", (los, his),
          (s, ([v & top for v in rem], [v >> bits for v in rem])))


# ---------------------------------------------------------------------------
# the ui32 family
# ---------------------------------------------------------------------------

def test_get_set_ui32(d):
    check("get_ui32", (d["X"],), [a & M32 for a in d["xs"]])
    check("set_ui32", (d["W"], d["U"], (N,)), d["us"],
          port_kwargs={"device": "cpu"})


def test_add_sub_mul_ui32(d):
    xs, us, bits, top = d["xs"], d["us"], d["bits"], d["top"]
    check("add_ui32", (d["X"], d["U"]),
          ([(a + u) & top for a, u in zip(xs, us)],
           [(a + u) >> bits for a, u in zip(xs, us)]))
    check("sub_ui32", (d["X"], d["U"]),
          ([(a - u) & top for a, u in zip(xs, us)],
           [int(a < u) for a, u in zip(xs, us)]))
    check("mul_ui32", (d["X"], d["U"]),
          ([(a * u) & top for a, u in zip(xs, us)],
           [((a * u) >> bits) & M32 for a, u in zip(xs, us)]))
    # a Python int operand
    check("add_ui32", (d["X"], M32),
          ([(a + M32) & top for a in xs], [(a + M32) >> bits for a in xs]))


def test_div_rem_ui32(d):
    """u == 0 columns give q all-ones and r the low word."""
    xs, us, top = d["xs"], d["us"], d["top"]
    q = [top if u == 0 else a // u for a, u in zip(xs, us)]
    r = [a & M32 if u == 0 else a % u for a, u in zip(xs, us)]
    check("div_rem_ui32", (d["X"], d["U"]), (q, r))
    check("div_ui32", (d["X"], d["U"]), q)
    check("rem_ui32", (d["X"], d["U"]), r)


def test_equals_compare_ui32(d):
    xs, us = d["xs"], d["us"]
    check("equals_ui32", (d["X"], d["U"]), [a == u for a, u in zip(xs, us)])
    check("compare_ui32", (d["X"], d["U"]),
          [(a > u) - (a < u) for a, u in zip(xs, us)])


def test_bits_ui32(d):
    xs, us, bits, top = d["xs"], d["us"], d["bits"], d["top"]
    for start, length in ((13, 27), (0, 40), (bits - 8, 32), (bits, 5)):
        n = max(min(length, 32, bits - start), 0)
        field = (1 << n) - 1
        check("extract_bits_ui32", (d["X"], start, length),
              [(a >> start) & field for a in xs])
        m = (field << start) & top
        check("insert_bits_ui32", (d["X"], start, length, d["U"]),
              [(a & ~m & top) | (((u & field) << start) & top)
               for a, u in zip(xs, us)])


def test_binary_inverse_and_gcd_ui32(d):
    xs, us = d["xs"], d["us"]
    odds = [u | 1 for u in us]
    check("binary_inverse_ui32", (np.array(odds, dtype=np.uint32),),
          [pow(u, -1, 1 << 32) for u in odds])
    check("gcd_ui32", (d["X"], d["U"]),
          [0 if u == 0 else math.gcd(a, u) for a, u in zip(xs, us)])


# ---------------------------------------------------------------------------
# accumulator
# ---------------------------------------------------------------------------

def test_accumulator(d):
    W, bits = d["W"], d["bits"]
    xs, ys, zs = d["xs"], d["ys"], d["zs"]
    ja = jb.Accumulator(W, (N,))
    ja.add(d["X"]).add(d["Y"]).sub(d["Z"])
    ta = tb.Accumulator(W, (N,), device="cpu")
    ta.add(to_torch(d["X"])).add(to_torch(d["Y"])).sub(to_torch(d["Z"]))
    got, want = ta.resolve(), np.asarray(ja.resolve())
    assert got.dtype == torch.uint32 and np.array_equal(got.numpy(), want)
    assert ints(want) == [(a + b - c) % (1 << bits)
                          for a, b, c in zip(xs, ys, zs)]
    many = tb.Accumulator(W, (N,), device="cpu")
    for _ in range(100):
        many.sub(to_torch(d["X"]))
    assert ints(many.resolve().numpy()) == [(-100 * a) % (1 << bits)
                                           for a in xs]


def test_accumulator_asserts_before_overflow():
    acc = tb.Accumulator(1, (1,), device="cpu")
    acc._ops = (1 << 15) - 2
    one = torch.ones((1, 1), dtype=torch.uint32)
    acc.add(one)
    with pytest.raises(AssertionError, match="resolve"):
        acc.add(one)


# ---------------------------------------------------------------------------
# uint32 wrap edges, broadcasting, names, devices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("W", WIDTHS)
def test_wrap_edges(W):
    """Every op that uint32 wraps in the JAX module, at words 0, 1, the
    top bit, 2^32 - 1 and their neighbours: every word of a column the
    same edge, and the edges in mixed columns."""
    bits, top = 32 * W, (1 << (32 * W)) - 1
    rng = random.Random(400 + W)
    xs = [sum(e << (32 * w) for w in range(W)) for e in EDGE_WORDS]
    xs += [sum(rng.choice(EDGE_WORDS) << (32 * w) for w in range(W))
           for _ in range(24)]
    ys = xs[::-1]
    X, Y = pack(xs, W), pack(ys, W)
    check("pop_count", (X,), [bin(a).count("1") for a in xs])
    check("clz", (X,), [bits - a.bit_length() for a in xs])
    check("ctz", (X,),
          [bits if a == 0 else (a & -a).bit_length() - 1 for a in xs])
    check("bitwise_complement", (X,), [a ^ top for a in xs])
    check("bitwise_select", (X, Y, X ^ Y),
          [(a & ~(a ^ b) & top) | (b & (a ^ b)) for a, b in zip(xs, ys)])
    m = mask_value(bits, -3)
    check("bitwise_mask_select", (X, Y, -3),
          [(a & ~m & top) | (b & m) for a, b in zip(xs, ys)])
    f = ((1 << 33) - 1) << 31
    check("bit_insert", (X, Y, 31, 33),
          [(a & ~f & top) | (((b & ((1 << 33) - 1)) << 31) & top)
           for a, b in zip(xs, ys)])
    check("sub", (X, Y), ([(a - b) & top for a, b in zip(xs, ys)],
                          [int(a < b) for a, b in zip(xs, ys)]))
    check("negate", (X,), [(-a) & top for a in xs])
    us = ([e for e in EDGE_WORDS if e] * 5)[:len(xs)]
    U = np.array(us, dtype=np.uint32)
    check("div_rem_ui32", (X, U), ([a // u for a, u in zip(xs, us)],
                                   [a % u for a, u in zip(xs, us)]))
    odds = [1, 3, 0x7FFFFFFF, 0x80000001, 0xFFFFFFFD, M32]
    check("binary_inverse_ui32", (np.array(odds, dtype=np.uint32),),
          [pow(u, -1, 1 << 32) for u in odds])


def test_broadcast_batch():
    """A [1]-batch operand against a [64]-batch one, and a [64] ui32 plane
    against a [1]-batch value, as the JAX module broadcasts them."""
    W = 2
    top = (1 << 64) - 1
    xs, ys = _rand(W, N, 500), _rand(W, N, 501)[-1:]
    check("add", (pack(xs, W), pack(ys, W)),
          ([(a + ys[0]) & top for a in xs], [(a + ys[0]) >> 64 for a in xs]))
    check("mul_wide", (pack(ys, W), pack(xs, W)),
          ([(a * ys[0]) & top for a in xs], [(a * ys[0]) >> 64 for a in xs]))
    us = [random.Random(502).randrange(1 << 32) for _ in range(N)]
    check("add_ui32", (pack(ys, W), np.array(us, dtype=np.uint32)),
          ([(ys[0] + u) & top for u in us], [(ys[0] + u) >> 64 for u in us]))



def test_broadcast_modulus():
    """m with batch shape [1] against x with [64]: gcd, modular_inverse
    and div_rem_wide in both packages, modular_power against Python ints
    and against the port's own result on m repeated 64 times."""
    W = 2
    bits = 32 * W
    rng = random.Random(800)
    xs = _rand(W, N, 801)
    m = rng.randrange(1 << (bits - 1), 1 << bits) | 1
    X, M = pack(xs, W), pack([m], W)
    check("gcd", (X, M), [math.gcd(a, m) for a in xs])
    check("modular_inverse", (X, M),
          [pow(a, -1, m) if math.gcd(a, m) == 1 else 0 for a in xs])
    his = [rng.randrange(m) for _ in range(N)]
    nums = [(h << bits) | a for h, a in zip(his, xs)]
    check("div_rem_wide", (X, pack(his, W), M),
          ([n // m for n in nums], [n % m for n in nums]))
    es = _rand(W, N, 802)
    got = tb.modular_power(to_torch(X), to_torch(pack(es, W)), to_torch(M))
    assert ints(got.numpy()) == [pow(a, e, m) for a, e in zip(xs, es)]
    full = tb.modular_power(to_torch(X), to_torch(pack(es, W)),
                            to_torch(pack([m] * N, W)))
    assert torch.equal(got, full)


def _module_names(mod) -> set:
    return {n for n in dir(mod) if not n.startswith("_")
            and not isinstance(getattr(mod, n), types.ModuleType)}


def test_public_names_equal_jax():
    """The same public names as ``ntt_tpu.bigint``: its 68 functions and
    the Accumulator, defined here, and the same imported constants."""
    assert _module_names(tb) == _module_names(jb)
    own = {n for n in _module_names(tb)
           if getattr(getattr(tb, n), "__module__", None) == tb.__name__}
    assert len(own) == 68


def test_bitwise_ops_take_uint32_words():
    """The ops that read the words' bits as int32 refuse other dtypes
    (an int64 view would change the shape)."""
    x = torch.ones((2, 3), dtype=torch.int64)
    with pytest.raises(TypeError, match="uint32"):
        tb.bitwise_and(x, x)
    with pytest.raises(TypeError, match="uint32"):
        tb.equals(x, x)


def test_constructors_need_a_card_or_cpu(monkeypatch):
    """set_ui32, bitwise_mask_copy and Accumulator run on the card by
    default: without one they raise, unless given device="cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda **k: tb.set_ui32(2, 5, (3,), **k),
                 lambda **k: tb.bitwise_mask_copy(2, 7, (3,), **k),
                 lambda **k: tb.Accumulator(2, (3,), **k)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
        make(device="cpu")
    assert tb.set_ui32(2, 5, (3,), device="cpu").device.type == "cpu"

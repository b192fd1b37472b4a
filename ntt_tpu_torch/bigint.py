"""General fixed-width big-integer ops in plain PyTorch: the CGBN breadth
layer.

The port's counterpart of ``ntt_tpu.bigint`` (CGBN's public surface,
``cgbn.h:85-512``): add/sub with carries, compare and bit counting,
multiply, division and remainder (plain, wide and Barrett), integer square
root, gcd, modular and binary inverses, modular power, shifts, rotations,
bit fields, masks, the ui32 family and a deferred-carry accumulator. The
layout is ``ntt_tpu_torch.limbs``'s: a value is ``torch.uint32[W, *batch]``,
limb-major little-endian words, for any width W; batch shapes broadcast as
in ``ntt_tpu.bigint``. Every op is word-equal to the JAX module, sentinels
included: division by zero gives an all-ones quotient and r = x, an
inverse that does not exist is 0, ``gcd(0, 0) = 0``, shifts of at least
the width give 0.

PyTorch has no uint32 add, shift or compare on the CPU, so the ops compute
on int64 planes, 16-bit half planes as in the JAX module, and cast to
``torch.uint32`` at their boundary: words come back as ``torch.uint32``,
the carry and borrow of ``add``/``sub`` as uint32 planes, compares, bit
counts and the Barrett shift as ``torch.int32``, equality as
``torch.bool``. Bitwise ops run on the words' bits viewed as int32.

Each op runs on its operands' device; a ui32 operand that is a Python int
or an array is moved there. The constructors that take only a shape
(``set_ui32``, ``bitwise_mask_copy``, ``Accumulator``) take ``device``:
``None`` is the CUDA card, and without one only ``device="cpu"`` runs. No
op copies data to the host. The long algorithms keep the JAX module's
iteration counts (``lax.fori_loop`` bodies become Python loops over the
same indices) and never stop early on the data, which would cost the host a
sync a step. There is no TPU kernel behind ``ntt_tpu.bigint``; these ops
are plain PyTorch on the card too.
"""

from __future__ import annotations

import numpy as np
import torch

from .fields import HALF_BITS, HALF_MASK
from .limbs import _halves_stacked as _to_halves
from .limbs import resolve_device as _device

_I64 = torch.int64
_MASK = HALF_MASK
_WORD = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Stacked-half helpers: uint32[W, *b] words <-> int64[L = 2W, *b] little-
# endian 16-bit half planes (``_to_halves`` is limbs' ``_halves_stacked``)
# ---------------------------------------------------------------------------

def _words64(h) -> torch.Tensor:
    """int64 halves [L, *b] -> int64 words [L/2, *b]."""
    return h[0::2] | (h[1::2] << HALF_BITS)


def _to_words(h) -> torch.Tensor:
    return _words64(h).to(torch.uint32)


def _bits(x) -> torch.Tensor:
    """uint32 words as int32 of the same bits: PyTorch's bitwise ops and
    equality run on int32 on every device."""
    if x.dtype != torch.uint32:
        raise TypeError(f"expected torch.uint32 words, got {x.dtype}")
    return x.view(torch.int32)


def _zeros(like, planes: int) -> torch.Tensor:
    return torch.zeros((planes,) + tuple(like.shape[1:]), dtype=_I64,
                       device=like.device)


def _carry_words(s):
    """Resolve the carries of an even number of int64 planes s (lazy
    little-endian halves: sums or differences) over 32-bit words, pairs of
    planes that int64 holds with their carries -> (canonical words as int64
    [P/2, *b], the carry out of the top: a sum's carry, or minus a
    difference's borrow, which int64's arithmetic shift gives)."""
    w = s[0::2] + (s[1::2] << HALF_BITS)
    for i in range(1, w.shape[0]):
        w[i].add_(w[i - 1] >> 32)
    c = w[-1] >> 32
    w &= _WORD
    return w, c


def _ripple(s):
    """Resolve the carries of int64 planes s (P >= 2 of them) ->
    (canonical halves, carry out of the top plane), as ``_carry_words``;
    an odd top plane takes the words' carry on its own."""
    P = s.shape[0]
    E = P - P % 2
    w, c = _carry_words(s[:E])
    out = torch.stack([w & _MASK, w >> HALF_BITS], dim=1).reshape(
        (E,) + tuple(s.shape[1:]))
    if P % 2:
        last = s[E] + c
        c = last >> HALF_BITS
        out = torch.cat([out, (last & _MASK)[None]], dim=0)
    return out, c


def _add_h(a, b):
    """(a + b) over stacked halves -> (halves, carry in {0,1}) (entries
    may be lazy, < 2^31)."""
    return _ripple(a + b)


def _sub_h(a, b):
    """(a - b) wrapped -> (halves, borrow in {0,1})."""
    d, c = _ripple(a - b)
    return d, -c


def _shl1_h(h, bit_in=None):
    """(h << 1) | bit_in over stacked halves (drops the top bit)."""
    first = _zeros(h, 1) if bit_in is None else bit_in[None].to(_I64)
    carry = torch.cat([first, h[:-1] >> (HALF_BITS - 1)], dim=0)
    return ((h << 1) & _MASK) | carry


def _shr1_h(h, top_in=None):
    """(h >> 1) with an optional incoming top bit."""
    last = _zeros(h, 1) if top_in is None else top_in[None].to(_I64)
    top = torch.cat([h[1:] & 1, last], dim=0)
    return (h >> 1) | (top << (HALF_BITS - 1))


def _is_zero_h(h):
    return torch.sum(h, dim=0) == 0        # halves are non-negative


# ---------------------------------------------------------------------------
# add / sub / compare / bit counting  (cgbn.h:88-97, :156-166, :352-366)
# ---------------------------------------------------------------------------

def add(x, y):
    """(x + y) mod 2^bits and the carry out (cgbn_add, cgbn.h:88)."""
    s, c = _add_h(_to_halves(x), _to_halves(y))
    return _to_words(s), c.to(torch.uint32)


def sub(x, y):
    """(x - y) mod 2^bits and the borrow out (cgbn_sub, cgbn.h:92)."""
    d, brw = _sub_h(_to_halves(x), _to_halves(y))
    return _to_words(d), brw.to(torch.uint32)


def compare(x, y):
    """Three-way unsigned compare -> int32 in {-1, 0, 1}
    (cgbn_compare, cgbn.h:161)."""
    d, brw = _sub_h(_to_halves(x), _to_halves(y))
    out = torch.where(brw != 0, -1, torch.where(_is_zero_h(d), 0, 1))
    return out.to(torch.int32)


def equals(x, y):
    return torch.all(_bits(x) == _bits(y), dim=0)


def pop_count(x):
    """Population count over the full width (cgbn_pop_count,
    cgbn.h:353)."""
    v = x.to(_I64)
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    # the byte sums gather in bits 24..31; int64 keeps the bits above 32
    # that uint32 drops
    per_word = ((v * 0x01010101) >> 24) & 0xFF
    return torch.sum(per_word, dim=0).to(torch.int32)


def _clz32(w):
    """Count leading zeros of each 32-bit word held in int64 (branch-free
    binary probe; x << sh is taken only where it stays below 2^32)."""
    n = torch.zeros_like(w)
    x = w
    for sh in (16, 8, 4, 2, 1):
        mask = x < (1 << (32 - sh))
        n = n + mask * sh
        x = torch.where(mask, x << sh, x)
    return torch.where(w == 0, 32, n)


def clz(x):
    """Leading zeros over the full width (cgbn_clz, cgbn.h:357)."""
    x = x.to(_I64)
    total = torch.zeros_like(x[0])
    done = torch.zeros(x.shape[1:], dtype=torch.bool, device=x.device)
    for w in range(x.shape[0] - 1, -1, -1):
        total = torch.where(done, total, total + _clz32(x[w]))
        done = done | (x[w] != 0)
    return total.to(torch.int32)


def ctz(x):
    """Trailing zeros over the full width (cgbn_ctz, cgbn.h:361)."""
    x = x.to(_I64)
    total = torch.zeros_like(x[0])
    done = torch.zeros(x.shape[1:], dtype=torch.bool, device=x.device)
    for w in range(x.shape[0]):
        # x & -x isolates the lowest set bit (uint32's x & (~x + 1))
        rev = _clz32(x[w] & -x[w])
        c = torch.where(x[w] == 0, 32, 31 - rev)
        total = torch.where(done, total, total + c)
        done = done | (x[w] != 0)
    return total.to(torch.int32)


# ---------------------------------------------------------------------------
# multiply  (cgbn_mul / cgbn_mul_wide, cgbn.h:100-107, :243-249)
# ---------------------------------------------------------------------------

def _mul_h(a, b):
    """Full product of two L-half operands as int64 words [L, *b] (low W
    words first). Row i of the half products (each < 2^32) is added onto
    halves i .. i + L - 1 of one [2L, *b] buffer: L launches, 2L planes of
    memory. A column sum is below L * 2^32, so one carry ripple over
    32-bit words resolves it."""
    L = a.shape[0]
    bshape = tuple(torch.broadcast_shapes(a.shape[1:], b.shape[1:]))
    cols = torch.zeros((2 * L,) + bshape, dtype=_I64, device=a.device)
    for i in range(L):
        cols[i:i + L].addcmul_(a[i], b)
    return _carry_words(cols)[0]


def mul_wide(x, y):
    """Full 2W-word product (lo, hi) (cgbn_mul_wide, cgbn.h:243)."""
    w = _mul_h(_to_halves(x), _to_halves(y)).to(torch.uint32)
    W = x.shape[0]
    return w[:W], w[W:]


def mul(x, y):
    """(x * y) mod 2^bits (cgbn_mul, cgbn.h:100)."""
    return mul_wide(x, y)[0]


def mul_high(x, y):
    """High W words of the 2W-word product (cgbn_mul_high,
    cgbn.h:104)."""
    return mul_wide(x, y)[1]


def sqr(x):
    return mul(x, x)


def sqr_wide(x):
    """(lo, hi) of x^2 (cgbn_sqr_wide, cgbn.h:247)."""
    return mul_wide(x, x)


def sqr_high(x):
    """High W words of x^2 (cgbn_sqr_high, cgbn.h:112)."""
    return mul_wide(x, x)[1]


# ---------------------------------------------------------------------------
# division / remainder  (cgbn_div_rem / cgbn_div / cgbn_rem,
# cgbn.h:131-146): a vectorised restoring long division, one
# shift/compare/conditional-subtract step a numerator bit
# ---------------------------------------------------------------------------

def _restoring_div_h(X, Y):
    """Restoring long division over stacked halves: X (N halves) / Y
    (L halves, L <= N) -> (q: N halves, r: L halves). 16 N steps."""
    N, L = X.shape[0], Y.shape[0]
    bshape = tuple(torch.broadcast_shapes(X.shape[1:], Y.shape[1:]))
    X = X.expand((N,) + bshape)
    Yx = torch.cat([Y.expand((L,) + bshape),
                    torch.zeros((1,) + bshape, dtype=_I64, device=Y.device)])
    r = torch.zeros((L + 1,) + bshape, dtype=_I64, device=X.device)
    q = torch.zeros((N,) + bshape, dtype=_I64, device=X.device)
    for bit_idx in range(HALF_BITS * N - 1, -1, -1):
        plane, sh = divmod(bit_idx, HALF_BITS)
        r = _shl1_h(r, (X[plane] >> sh) & 1)
        diff, brw = _sub_h(r, Yx)
        ge = brw == 0
        r = torch.where(ge, diff, r)
        q[plane].bitwise_or_(ge.to(_I64) << sh)
    return q, r[:L]


def _div_rem_words(Xh, y, lo):
    """Quotient words (the low W) and remainder words of halves Xh by the
    words y, with div_rem's zero-divisor sentinel (q all-ones, r = lo)."""
    Yh = _to_halves(y)
    L = Yh.shape[0]
    q, r = _restoring_div_h(Xh, Yh)
    y_zero = _is_zero_h(Yh)
    qw = torch.where(y_zero, _WORD, _words64(q[:L]))
    rw = torch.where(y_zero, lo.to(_I64), _words64(r))
    return qw.to(torch.uint32), rw.to(torch.uint32)


def div_rem(x, y):
    """(q, r) with x = q*y + r, 0 <= r < y. y == 0 -> q all-ones, r = x."""
    return _div_rem_words(_to_halves(x), y, x)


def div(x, y):
    return div_rem(x, y)[0]


def rem(x, y):
    return div_rem(x, y)[1]


def _wide_halves(lo, hi):
    lo_h, hi_h = _to_halves(lo), _to_halves(hi)
    L = lo_h.shape[0]
    bshape = tuple(torch.broadcast_shapes(lo_h.shape[1:], hi_h.shape[1:]))
    return torch.cat([lo_h.expand((L,) + bshape),
                      hi_h.expand((L,) + bshape)], dim=0)


def div_rem_wide(lo, hi, y):
    """(q, r) for the 2W-word numerator hi*2^bits + lo divided by y
    (cgbn_div_rem_wide, cgbn.h:265). Defined for hi < y (CGBN's
    precondition — the quotient must fit W words); for hi >= y the
    returned q is the true quotient truncated to W words. y == 0 ->
    q all-ones, r = lo (the div_rem sentinel)."""
    return _div_rem_words(_wide_halves(lo, hi), y, lo)


def div_wide(lo, hi, y):
    return div_rem_wide(lo, hi, y)[0]


def rem_wide(lo, hi, y):
    return div_rem_wide(lo, hi, y)[1]


# ---------------------------------------------------------------------------
# integer square root  (cgbn_sqrt, cgbn.h:149-152): the restoring bit-pair
# method, bits/2 steps
# ---------------------------------------------------------------------------

def _sqrt_h(num):
    """Restoring bit-pair square root over stacked halves ->
    (result halves, remainder halves): result = floor(sqrt(x)),
    remainder = x - result^2 (both the width of the input). res has no bit
    at or below the current ``bit`` (nor does res >> 1), so res + bit is
    res | bit: the JAX module's adds, without their carry ripple."""
    L = num.shape[0]
    nd = num.dim() - 1
    res = torch.zeros_like(num)
    # every step's bit, 4^k from k = bits/2 - 1 down, as one host table
    table = np.zeros((HALF_BITS * L // 2, L), dtype=np.int64)
    for i in range(table.shape[0]):
        pos = HALF_BITS * L - 2 - 2 * i
        table[i, pos // HALF_BITS] = 1 << (pos % HALF_BITS)
    bit_table = torch.from_numpy(table).to(num.device).reshape(
        table.shape + (1,) * nd)
    for bit in bit_table:
        diff, brw = _sub_h(num, res | bit)
        ge = brw == 0
        num = torch.where(ge, diff, num)
        res = _shr1_h(res)
        res = torch.where(ge, res | bit, res)
    return res, num


def sqrt(x):
    """floor(sqrt(x))."""
    return _to_words(_sqrt_h(_to_halves(x))[0])


def sqrt_rem(x):
    """(s, r) with s = floor(sqrt(x)), r = x - s^2 (cgbn_sqrt_rem,
    cgbn.h:152)."""
    res, num = _sqrt_h(_to_halves(x))
    return _to_words(res), _to_words(num)


def sqrt_wide(lo, hi):
    """floor(sqrt(hi*2^bits + lo)) — always fits W words
    (cgbn_sqrt_wide, cgbn.h:273)."""
    L = 2 * lo.shape[0]
    res, _ = _sqrt_h(_wide_halves(lo, hi))
    return _to_words(res[:L])


def sqrt_rem_wide(lo, hi):
    """(s, (r_lo, r_hi)) for the 2W-word radicand: s = floor(sqrt(.)),
    r = radicand - s^2 <= 2s, returned wide to match CGBN's signature
    (cgbn_sqrt_rem_wide, cgbn.h:277)."""
    L = 2 * lo.shape[0]
    res, num = _sqrt_h(_wide_halves(lo, hi))
    return (_to_words(res[:L]),
            (_to_words(num[:L]), _to_words(num[L:])))


# ---------------------------------------------------------------------------
# gcd  (cgbn_gcd, cgbn.h:407-409): the branch-free binary GCD, 2*bits steps
# of vectorised selects
# ---------------------------------------------------------------------------

def _shl_const(h, k: int):
    """h << k (static k), dropping overflow; k >= width -> zeros
    (CGBN's defined out-of-range shift result)."""
    L = h.shape[0]
    if k >= HALF_BITS * L:
        return torch.zeros_like(h)
    planes, rem_bits = divmod(k, HALF_BITS)
    if planes:
        h = torch.cat([_zeros(h, planes), h[:L - planes]], dim=0)
    if rem_bits:
        carry = torch.cat([_zeros(h, 1), h[:-1] >> (HALF_BITS - rem_bits)],
                          dim=0)
        h = ((h << rem_bits) & _MASK) | carry
    return h


def _shr_const(h, k: int):
    L = h.shape[0]
    if k >= HALF_BITS * L:
        return torch.zeros_like(h)
    planes, rem_bits = divmod(k, HALF_BITS)
    if planes:
        h = torch.cat([h[planes:], _zeros(h, planes)], dim=0)
    if rem_bits:
        top = torch.cat([h[1:] & ((1 << rem_bits) - 1), _zeros(h, 1)], dim=0)
        h = (h >> rem_bits) | (top << (HALF_BITS - rem_bits))
    return h


def _common_shapes(x, y):
    """x, y halves broadcast to one batch shape."""
    a, b = _to_halves(x), _to_halves(y)
    L = a.shape[0]
    bshape = tuple(torch.broadcast_shapes(a.shape[1:], b.shape[1:]))
    return a.expand((L,) + bshape), b.expand((L,) + bshape)


def gcd(x, y):
    """gcd(x, y); gcd(0, 0) = 0."""
    a, b = _common_shapes(x, y)
    bits = HALF_BITS * a.shape[0]
    sh = torch.zeros(a.shape[1:], dtype=_I64, device=a.device)
    for _ in range(2 * bits):
        active = ~_is_zero_h(a) & ~_is_zero_h(b)
        a_even = (a[0] & 1) == 0
        b_even = (b[0] & 1) == 0
        both_even = active & a_even & b_even
        only_a_even = active & a_even & ~b_even
        only_b_even = active & ~a_even & b_even
        both_odd = active & ~a_even & ~b_even
        diff_ab, brw = _sub_h(a, b)
        a_ge_b = brw == 0
        diff_ba, _ = _sub_h(b, a)
        na = torch.where(both_even | only_a_even, _shr1_h(a),
                         torch.where(both_odd & a_ge_b, _shr1_h(diff_ab), a))
        nb = torch.where(both_even | only_b_even, _shr1_h(b),
                         torch.where(both_odd & ~a_ge_b, _shr1_h(diff_ba),
                                     b))
        sh = sh + both_even.to(_I64)
        a, b = na, nb
    g, _ = _add_h(a, b)   # one of them is zero
    return _to_words(_shl_dyn(g, sh))     # the common power of two


# ---------------------------------------------------------------------------
# modular inverse, odd modulus  (cgbn_modular_inverse, cgbn.h:417-420): the
# binary extended GCD with mod-m coefficient arithmetic, 2*bits steps
# ---------------------------------------------------------------------------

def modular_inverse(x, m):
    """x^{-1} mod m for odd m; 0 where gcd(x, m) != 1.

    Invariants: b*x = u (mod m), c*x = v (mod m); each step halves an
    even u/v (coefficients halved mod m: even -> >>1, odd -> (+m)>>1) or
    replaces the larger of two odds by half the difference. After 2*bits
    steps u = 0 and v = gcd(x, m)."""
    u, v = _common_shapes(x, m)
    L = u.shape[0]
    M = v
    b = torch.zeros_like(u)
    b[0] = 1
    c = torch.zeros_like(u)

    def half_mod(t):
        # t/2 mod m (m odd): even -> t>>1; odd -> (t+m)>>1 with the
        # add's carry as the incoming top bit
        s, cy = _add_h(t, M)
        odd = (t[0] & 1) != 0
        return torch.where(odd, _shr1_h(s, cy), _shr1_h(t))

    def sub_mod(p, q):
        d, brw = _sub_h(p, q)
        dm, _ = _add_h(d, M)
        return torch.where(brw != 0, dm, d)

    for _ in range(2 * HALF_BITS * L):
        active = ~_is_zero_h(u)
        u_even = (u[0] & 1) == 0
        v_even = (v[0] & 1) == 0
        diff_uv, brw = _sub_h(u, v)
        u_ge_v = brw == 0
        diff_vu, _ = _sub_h(v, u)
        case_u = active & u_even
        case_v = active & ~u_even & v_even
        case_ge = active & ~u_even & ~v_even & u_ge_v
        case_lt = active & ~u_even & ~v_even & ~u_ge_v
        nu = torch.where(case_u, _shr1_h(u),
                         torch.where(case_ge, _shr1_h(diff_uv), u))
        nv = torch.where(case_v, _shr1_h(v),
                         torch.where(case_lt, _shr1_h(diff_vu), v))
        nb = torch.where(case_u, half_mod(b),
                         torch.where(case_ge, half_mod(sub_mod(b, c)), b))
        nc = torch.where(case_v, half_mod(c),
                         torch.where(case_lt, half_mod(sub_mod(c, b)), c))
        u, v, b, c = nu, nv, nb, nc
    is_unit = (v[0] == 1) & _is_zero_h(v[1:])
    return torch.where(is_unit, _words64(c), 0).to(torch.uint32)


# ---------------------------------------------------------------------------
# modular power, general modulus  (cgbn_modular_power, cgbn.h:421-425):
# square and multiply with Barrett reduction (CGBN: impl_cuda.cu:938-970)
# ---------------------------------------------------------------------------

def modular_power(x, e, m):
    """x^e mod m (m > 1; e a W-word exponent). Barrett-reduced square
    and multiply — one restoring division precomputes the approximation
    (CGBN does the same, impl_cuda.cu:938-970), then every step is a
    few wide multiplies instead of a bit-serial rem."""
    W = x.shape[0]
    bshape = tuple(torch.broadcast_shapes(x.shape[1:], e.shape[1:],
                                          m.shape[1:]))
    mb = m.expand((W,) + bshape)
    approx, shift = barrett_approximation(mb)
    mh, ah = _to_halves(mb), _to_halves(approx)

    def mulmod(a, b):
        # hi < m always (a, b < m), the wide-Barrett precondition
        return _barrett_core(_to_halves(_mul_h(a, b)), mh, ah, shift)[1]

    base = _to_halves(div_rem(x.expand((W,) + bshape), m)[1])
    one = torch.zeros((W,) + bshape, dtype=_I64, device=x.device)
    one[0] = 1
    acc = _to_halves(div_rem(one, m)[1])    # 1 mod m (handles m == 1)
    E = e.to(_I64).expand((W,) + bshape)
    for i in range(32 * W):
        bit = (E[i // 32] >> (i % 32)) & 1
        acc = torch.where(bit != 0, mulmod(acc, base), acc)
        base = mulmod(base, base)
    return _to_words(acc)


# ---------------------------------------------------------------------------
# logical / shift / rotate / bit field ops  (cgbn.h:280-349, :169-173)
# ---------------------------------------------------------------------------

def bitwise_and(x, y):
    return (_bits(x) & _bits(y)).view(torch.uint32)


def bitwise_ior(x, y):
    return (_bits(x) | _bits(y)).view(torch.uint32)


def bitwise_xor(x, y):
    return (_bits(x) ^ _bits(y)).view(torch.uint32)


def bitwise_complement(x):
    return (~_bits(x)).view(torch.uint32)


def shift_left(x, k: int):
    """x << k mod 2^bits (static shift count, cgbn_shift_left
    cgbn.h:315)."""
    return _to_words(_shl_const(_to_halves(x), int(k)))


def shift_right(x, k: int):
    """x >> k (static shift count, cgbn_shift_right cgbn.h:319)."""
    return _to_words(_shr_const(_to_halves(x), int(k)))


def rotate_left(x, k: int):
    bits = 32 * x.shape[0]
    k = int(k) % bits
    h = _to_halves(x)
    return _to_words((_shl_const(h, k) | _shr_const(h, bits - k))
                     if k else h)


def rotate_right(x, k: int):
    bits = 32 * x.shape[0]
    return rotate_left(x, (bits - int(k)) % bits)


def _low_bits_h(h, length: int):
    """Halves h masked to their low ``length`` bits."""
    out = []
    for j in range(h.shape[0]):
        lo = j * HALF_BITS
        if lo + HALF_BITS <= length:
            out.append(h[j])
        elif lo >= length:
            out.append(torch.zeros_like(h[j]))
        else:
            out.append(h[j] & ((1 << (length - lo)) - 1))
    return torch.stack(out, dim=0)


def bit_extract(x, start: int, length: int):
    """Unsigned bit-field extract (cgbn_extract_bits, cgbn.h:172)."""
    length = min(int(length), 32 * x.shape[0] - int(start))
    return _to_words(_low_bits_h(_shr_const(_to_halves(x), int(start)),
                                 length))


def bit_insert(x, y, start: int, length: int):
    """Insert the low ``length`` bits of y into x at ``start``
    (cgbn_insert_bits, cgbn.h:169)."""
    W = x.shape[0]
    start = int(start)
    length = min(int(length), 32 * W - start)
    field = ((1 << max(length, 0)) - 1) << start
    mask = _words_const(W, field & ((1 << (32 * W)) - 1), x)
    yf = shift_left(bit_extract(y, 0, length), start)
    return ((_bits(x) & ~mask) | _bits(yf)).view(torch.uint32)


# ---------------------------------------------------------------------------
# accumulator  (cgbn_set/add/sub/resolve accumulator, cgbn.h:369-403): a
# lazy half-plane sum resolved mod 2^bits
# ---------------------------------------------------------------------------

class Accumulator:
    """Deferred-carry accumulator: ``add``/``sub`` cost one add per half
    plane (no carry chain); ``resolve`` ripples carries once and wraps mod
    2^bits. Up to ~2^15 deferred ops between resolves (each add contributes
    < 2^17 per lazy entry; entries stay below 2^32, as in the JAX module's
    uint32 planes). ``device=None`` is the CUDA card."""

    def __init__(self, W: int, batch_shape: tuple = (), device=None):
        self.L = 2 * W
        self._acc = torch.zeros((self.L,) + tuple(batch_shape), dtype=_I64,
                                device=_device(device))
        self._ops = 0

    def add(self, x):
        self._acc = self._acc + _to_halves(x)
        self._ops += 1
        assert self._ops < (1 << 15), "resolve() before accumulator overflow"
        return self

    def sub(self, x):
        """Subtract mod 2^bits: adds the two's complement
        (per-half complement + 1, exact mod 2^bits)."""
        comp = _MASK - _to_halves(x)
        comp[0].add_(1)
        self._acc = self._acc + comp
        self._ops += 2
        return self

    def resolve(self):
        """Canonical uint32[W, *batch] value mod 2^bits."""
        return _carry_words(self._acc)[0].to(torch.uint32)


# ---------------------------------------------------------------------------
# set / swap / negate  (cgbn_set/swap/negate, cgbn.h:85-87, :97) — value
# semantics here, so set/swap are identities returned for surface parity
# ---------------------------------------------------------------------------

def set_(x):
    """Copy (cgbn_set) — returned as-is, as the JAX module does."""
    return x


def swap(x, y):
    """(y, x) (cgbn_swap) — functional swap."""
    return y, x


def negate(x):
    """Two's-complement negate: (2^bits - x) mod 2^bits (cgbn_negate,
    cgbn.h:97)."""
    h = _to_halves(x)
    d, _ = _sub_h(torch.zeros_like(h), h)
    return _to_words(d)


# ---------------------------------------------------------------------------
# ui32 family  (cgbn.h:176-240) — one 32-bit operand (a Python int or a
# batch-shaped tensor), vectorised over the batch like everything else here
# ---------------------------------------------------------------------------

def _u32(u, device) -> torch.Tensor:
    """A 32-bit operand as int64 on ``device`` (uint32's wrap for ints)."""
    return torch.as_tensor(u, device=device).to(_I64) & _WORD


def get_ui32(x):
    """Low word (cgbn_get_ui32, cgbn.h:178)."""
    return x[0]


def set_ui32(W: int, value, batch_shape: tuple = (), device=None):
    """A W-word value holding ``value`` (cgbn_set_ui32, cgbn.h:183).
    ``device=None`` is the CUDA card."""
    dev = _device(device)
    out = torch.zeros((W,) + tuple(batch_shape), dtype=_I64, device=dev)
    out[0] = _u32(value, dev)
    return out.to(torch.uint32)


def _ui32_operand(x, u):
    """A 32-bit operand broadcast to x's word layout (int64 words)."""
    u = _u32(u, x.device)
    bshape = tuple(torch.broadcast_shapes(x.shape[1:], u.shape))
    out = torch.zeros((x.shape[0],) + bshape, dtype=_I64, device=x.device)
    out[0] = u
    return out


def add_ui32(x, u):
    """(x + u) mod 2^bits and the carry out (cgbn_add_ui32,
    cgbn.h:188)."""
    return add(x, _ui32_operand(x, u))


def sub_ui32(x, u):
    """(x - u) mod 2^bits and the borrow out (cgbn_sub_ui32,
    cgbn.h:193)."""
    return sub(x, _ui32_operand(x, u))


def mul_ui32(x, u):
    """(x * u) mod 2^bits and the overflow word (cgbn_mul_ui32,
    cgbn.h:198 returns the high word)."""
    lo, hi = mul_wide(x, _ui32_operand(x, u))
    return lo, hi[0]


def div_rem_ui32(x, u):
    """(q: W words, r: uint32) = divmod(x, u). u == 0 -> q all-ones,
    r = low word of x (the module's division-by-zero sentinel;
    CGBN raises a monitor error). Bit-serial: 32*W steps. The partial
    remainder's doubling, below 2^33, is held whole in int64: the JAX
    module's wrapped ``r << 1`` and ``r2 - U`` give the same r."""
    W = x.shape[0]
    U = _u32(u, x.device)
    bshape = tuple(torch.broadcast_shapes(x.shape[1:], U.shape))
    X = x.to(_I64).expand((W,) + bshape)
    U = U.expand(bshape)
    q = torch.zeros((W,) + bshape, dtype=_I64, device=x.device)
    r = torch.zeros(bshape, dtype=_I64, device=x.device)
    for bit_idx in range(32 * W - 1, -1, -1):
        word, sh = divmod(bit_idx, 32)
        r2 = (r << 1) | ((X[word] >> sh) & 1)
        ge = r2 >= U
        r = torch.where(ge, r2 - U, r2)
        q[word].bitwise_or_(ge.to(_I64) << sh)
    zero = U == 0
    q = torch.where(zero, _WORD, q)
    r = torch.where(zero, X[0], r)
    return q.to(torch.uint32), r.to(torch.uint32)


def div_ui32(x, u):
    """x // u (cgbn_div_ui32 stores the quotient; its uint32 return is
    the remainder — use div_rem_ui32 for both)."""
    return div_rem_ui32(x, u)[0]


def rem_ui32(x, u):
    """x % u as uint32 (cgbn_rem_ui32, cgbn.h:207)."""
    return div_rem_ui32(x, u)[1]


def equals_ui32(x, u):
    """x == u (cgbn_equals_ui32, cgbn.h:212)."""
    x = x.to(_I64)
    return (x[0] == _u32(u, x.device)) & torch.all(x[1:] == 0, dim=0)


def compare_ui32(x, u):
    """Three-way unsigned compare vs a uint32 (cgbn_compare_ui32,
    cgbn.h:217)."""
    x = x.to(_I64)
    u = _u32(u, x.device)
    hi_nonzero = torch.any(x[1:] != 0, dim=0)
    out = torch.where(hi_nonzero | (x[0] > u), 1,
                      torch.where(x[0] == u, 0, -1))
    return out.to(torch.int32)


def extract_bits_ui32(x, start: int, length: int):
    """Low min(length, 32) bits of (x >> start) as uint32
    (cgbn_extract_bits_ui32, cgbn.h:222)."""
    h = _shr_const(_to_halves(x), int(start))
    word = h[0] | (h[1] << HALF_BITS)
    length = min(int(length), 32)
    if length < 32:
        word = word & ((1 << length) - 1)
    return word.to(torch.uint32)


def insert_bits_ui32(x, start: int, length: int, value):
    """Insert the low min(length, 32) bits of a uint32 ``value`` into x
    at ``start`` (cgbn_insert_bits_ui32, cgbn.h:227)."""
    return bit_insert(x, _ui32_operand(x, value), int(start),
                      min(int(length), 32))


def _mul32(a, b):
    """(a * b) mod 2^32 for 32-bit values in int64, from half products
    (the full product would pass int64's range)."""
    a_lo, a_hi = a & _MASK, a >> HALF_BITS
    b_lo, b_hi = b & _MASK, b >> HALF_BITS
    cross = (a_lo * b_hi + a_hi * b_lo) << HALF_BITS
    return (a_lo * b_lo + cross) & _WORD


def binary_inverse_ui32(u):
    """u^{-1} mod 2^32 for odd u (cgbn_binary_inverse_ui32, cgbn.h:232;
    the reference's Newton iteration, arith/math.cu:50-58). A tensor ``u``
    runs on its device; anything else goes to the CUDA card."""
    dev = u.device if isinstance(u, torch.Tensor) else _device(None)
    u = _u32(u, dev)
    v = u
    for _ in range(4):                 # 3 -> 6 -> 12 -> 24 -> 48 bits
        v = _mul32(v, (2 - _mul32(u, v)) & _WORD)
    return v.to(torch.uint32)


def gcd_ui32(x, u):
    """gcd(x, u) as uint32; u == 0 -> 0 (the reference's exact edge
    semantics, impl_cuda.cu:330-334: gcd_ui32(a, 0) = 0, else
    ugcd(u, a % u))."""
    u = _u32(u, x.device)
    r = rem_ui32(x, u)
    g = gcd(_ui32_operand(x, u)[:1], r[None])   # 1-word bigint gcd
    return torch.where(u == 0, 0, g[0].to(_I64)).to(torch.uint32)


# ---------------------------------------------------------------------------
# masked bitwise ops + select  (cgbn.h:280-311; reference mask semantics
# from impl_mpz.cc make_mask: numbits in [0, bits) -> low ``numbits``
# ones; in (-bits, 0) -> high ``|numbits|`` ones; else all ones)
# ---------------------------------------------------------------------------

def _mask_value(W: int, numbits: int) -> int:
    bits = 32 * W
    numbits = int(numbits)
    if 0 <= numbits < bits:
        return (1 << numbits) - 1
    if -bits < numbits < 0:
        return ((1 << -numbits) - 1) << (bits + numbits)
    return (1 << bits) - 1


def _words_const(W: int, value: int, like) -> torch.Tensor:
    """A W-word constant as int32 bits [W, 1, ..., 1] on ``like``'s
    device, broadcastable against ``like``."""
    words = np.array([(value >> (32 * w)) & _WORD for w in range(W)],
                     dtype=np.uint32).view(np.int32)
    return torch.from_numpy(words).to(like.device).reshape(
        (W,) + (1,) * (like.dim() - 1))


def bitwise_mask_copy(W: int, numbits: int, batch_shape: tuple = (),
                      device=None):
    """The mask itself (cgbn_bitwise_mask_copy, cgbn.h:292).
    ``device=None`` is the CUDA card."""
    dev = _device(device)
    words = torch.tensor([(_mask_value(W, numbits) >> (32 * w)) & _WORD
                          for w in range(W)], dtype=_I64, device=dev)
    return words.to(torch.uint32).reshape(
        (W,) + (1,) * len(batch_shape)).expand((W,) + tuple(batch_shape))


def _mask_like(x, numbits: int):
    return _words_const(x.shape[0], _mask_value(x.shape[0], numbits), x)


def bitwise_mask_and(x, numbits: int):
    return (_bits(x) & _mask_like(x, numbits)).view(torch.uint32)


def bitwise_mask_ior(x, numbits: int):
    return (_bits(x) | _mask_like(x, numbits)).view(torch.uint32)


def bitwise_mask_xor(x, numbits: int):
    return (_bits(x) ^ _mask_like(x, numbits)).view(torch.uint32)


def bitwise_mask_select(clear, set_val, numbits: int):
    """Bits where the mask is 1 come from ``set_val``, the rest from
    ``clear`` (cgbn_bitwise_mask_select, cgbn.h:308)."""
    m = _mask_like(clear, numbits)
    return ((_bits(clear) & ~m) | (_bits(set_val) & m)).view(torch.uint32)


def bitwise_select(clear, set_val, select):
    """Per-bit select (cgbn_bitwise_select, cgbn.h:288)."""
    s = _bits(select)
    return ((_bits(clear) & ~s) | (_bits(set_val) & s)).view(torch.uint32)


# ---------------------------------------------------------------------------
# binary inverse mod 2^bits  (cgbn_binary_inverse, cgbn.h:411-414;
# reference: Newton iteration, core_binary_inverse.cu:28-78)
# ---------------------------------------------------------------------------

def binary_inverse(x):
    """x^{-1} mod 2^bits for odd x. Newton: v <- v*(2 - x*v) doubles
    the correct low bits each step; log2(bits)+1 full-width products."""
    W = x.shape[0]
    v = _ui32_operand(x, binary_inverse_ui32(x[0]))     # 32 bits
    two = _ui32_operand(x, 2)
    correct = 32
    while correct < 32 * W:
        t, _ = sub(two, mul(x, v))
        v = mul(v, t)
        correct *= 2
    return v.to(torch.uint32)


# ---------------------------------------------------------------------------
# Barrett division  (cgbn.h:455-488; reference algorithm
# impl_cuda.cu:1062-1310: approx = floor((2^(2b)-1)/(d << clz(d))) - 2^b,
# then q^ = mulhi(high, approx) + high + 3 with a small correction loop —
# O(1) wide multiplies instead of the restoring division's b steps)
# ---------------------------------------------------------------------------

def _shl_dyn(h, k):
    """h << k for a per-element shift tensor (conditional static shifts
    over k's binary digits)."""
    j = 1
    while j <= HALF_BITS * h.shape[0]:
        h = torch.where((k & j) != 0, _shl_const(h, j), h)
        j <<= 1
    return h


def _shr_dyn(h, k):
    """h >> k for a per-element shift tensor, as the JAX module's
    conditional shifts by k's binary digits j <= 16 * planes compose: a
    shift by k's low bits up to the top such j, zero from the width on.
    Each output plane is gathered from the two planes it straddles."""
    P = h.shape[0]
    eff = k.to(_I64) & ((1 << (HALF_BITS * P).bit_length()) - 1)
    bshape = tuple(torch.broadcast_shapes(h.shape[1:], eff.shape))
    src = torch.cat([h.expand((P,) + bshape),
                     torch.zeros((1,) + bshape, dtype=_I64,
                                 device=h.device)], dim=0)
    j = torch.arange(P, device=h.device).reshape((P,) + (1,) * len(bshape))
    q, r = eff // HALF_BITS, eff % HALF_BITS
    lo = torch.gather(src, 0, torch.clamp(j + q, max=P).expand(
        (P,) + bshape)) >> r
    hi = torch.gather(src, 0, torch.clamp(j + q + 1, max=P).expand(
        (P,) + bshape)) << (HALF_BITS - r)
    return lo | (hi & _MASK)


def barrett_approximation(d):
    """(approx, shift) for Barrett division by d (cgbn_barrett_
    approximation, cgbn.h:457): shift = clz(d), approx =
    floor((2^(2b) - 1) / (d << shift)) - 2^b. d == 0 -> approx all-ones,
    shift = bits (CGBN's 0xFFFFFFFF error return)."""
    dh = _to_halves(d)
    L = dh.shape[0]
    s = clz(d)
    d_norm = _shl_dyn(dh, s)
    num = torch.cat([torch.full_like(d_norm, _MASK), d_norm ^ _MASK], dim=0)
    q, _ = _restoring_div_h(num, d_norm)
    approx = torch.where(_is_zero_h(dh), _WORD, _words64(q[:L]))
    return approx.to(torch.uint32), s


def _barrett_core(num2, dh, ah, shift):
    """Shared Barrett quotient/remainder over a 2L-half numerator, the
    denominator's and the approximation's halves. Returns (q words,
    r halves[:L]). Preconditions: denom != 0 and the true quotient
    < 2^bits (guaranteed for the non-wide entry points; the wide ones
    require num_hi < denom, as in CGBN)."""
    L = num2.shape[0] // 2
    bits = HALF_BITS * L
    # high = floor(num / 2^(bits - shift)) — < 2^bits by precondition
    high = _shr_dyn(num2, bits - shift.to(_I64))[:L]
    # q^ = floor(high * (approx + 2^bits) / 2^bits) + 3, saturated
    mh = _to_halves(_mul_h(high, ah)[L // 2:])
    qhat, c1 = _add_h(mh, high)
    three = torch.zeros((L,) + (1,) * (qhat.dim() - 1), dtype=_I64,
                        device=qhat.device)
    three[0] = 3
    qhat, c2 = _add_h(qhat, three)
    qhat = torch.where((c1 + c2) != 0, _MASK, qhat)
    # t = num - q^ * denom  (wide, tracked with an explicit sign flag)
    t, brw = _sub_h(num2, _to_halves(_mul_h(qhat, dh)))
    neg = brw != 0
    # q^ - q <= 4 (approx floor + the +3 overshoot); 8 conditional
    # correction steps is comfortably past the bound. A step adds denom to
    # t's low L halves; the high L halves take only the carries, and the
    # step's carry out of all 2L halves (which ends the corrections) is a
    # low carry met while the high halves are all ones: after k carries
    # they are ones - d0 + k, so when k == d0 (d0 counts up to 8 only)
    t, comp = t[:L], _MASK - t[L:]
    d0 = torch.where(_is_zero_h(comp[1:]) & (comp[0] <= 8), comp[0], 9)
    k = torch.zeros_like(d0)
    subs = torch.zeros_like(d0)
    for _ in range(8):
        t2, c = _add_h(t, dh)
        t = torch.where(neg, t2, t)
        applied = neg.to(_I64)
        subs = subs + applied
        carry_out = (c != 0) & (k == d0)
        k = k + c * applied
        neg = neg & ~carry_out
    subs_h = torch.zeros_like(qhat)
    subs_h[0] = subs
    q, _ = _sub_h(qhat, subs_h)
    return _to_words(q), t


def barrett_div_rem(num, denom, approx, shift):
    """(q, r) = divmod(num, denom) using a precomputed
    barrett_approximation (cgbn_barrett_div_rem, cgbn.h:470)."""
    nh = _to_halves(num)
    L = nh.shape[0]
    bshape = tuple(torch.broadcast_shapes(nh.shape[1:], denom.shape[1:],
                                          approx.shape[1:]))
    num2 = torch.cat([nh.expand((L,) + bshape),
                      torch.zeros((L,) + bshape, dtype=_I64,
                                  device=nh.device)], dim=0)
    q, r = _barrett_core(num2, _to_halves(denom), _to_halves(approx), shift)
    return q, _to_words(r)


def barrett_div(num, denom, approx, shift):
    return barrett_div_rem(num, denom, approx, shift)[0]


def barrett_rem(num, denom, approx, shift):
    return barrett_div_rem(num, denom, approx, shift)[1]


def barrett_div_rem_wide(lo, hi, denom, approx, shift):
    """Wide Barrett divmod (cgbn_barrett_div_rem_wide, cgbn.h:485):
    requires hi < denom so the quotient fits W words."""
    q, r = _barrett_core(_wide_halves(lo, hi), _to_halves(denom),
                         _to_halves(approx), shift)
    return q, _to_words(r)


def barrett_div_wide(lo, hi, denom, approx, shift):
    return barrett_div_rem_wide(lo, hi, denom, approx, shift)[0]


def barrett_rem_wide(lo, hi, denom, approx, shift):
    return barrett_div_rem_wide(lo, hi, denom, approx, shift)[1]

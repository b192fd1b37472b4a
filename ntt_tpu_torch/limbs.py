"""Multi-limb Montgomery field arithmetic in plain PyTorch.

The port's counterpart of ``ntt_tpu.limbs``: an element is a stack of word
planes ``torch.uint32[W, *batch]`` (limb-major, little-endian), and the
Montgomery arithmetic is planned onto 16-bit half-limbs exactly as in the
JAX package (lazy-carry CIOS, ``np0 = -p^{-1} mod 2^16``).

PyTorch has no uint32 add, shift or compare on the CPU, so every function
here computes on int64 planes and casts to ``torch.uint32`` only at its
boundary. Half-limb intermediates are int64 planes holding values < 2^16
(lazy sums a few bits wider). Every public op takes canonical inputs (< p)
and returns canonical outputs.

These are the plain arithmetic the kernels' plain versions are built from,
and the ``mont_io=False`` conversion passes of the API; none is a kernel.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .fields import HALF_BITS, HALF_MASK, Field

_I64 = torch.int64


def resolve_device(device) -> torch.device:
    """The port's device rule: ``None`` means the CUDA card; without one,
    only an explicit ``device="cpu"`` runs (the plain versions)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain versions")
        return torch.device("cuda")
    return torch.device(device)


# ---------------------------------------------------------------------------
# Host <-> tensor conversions
# ---------------------------------------------------------------------------

def from_ints(values, field: Field) -> torch.Tensor:
    """Pack python ints (canonical, < p) into the limb-leading layout
    ``torch.uint32[W, n]`` (on the CPU)."""
    W = field.n_words
    arr = np.empty((W, len(values)), dtype=np.uint32)
    for j, v in enumerate(values):
        for w in range(W):
            arr[w, j] = (v >> (32 * w)) & 0xFFFFFFFF
    return torch.from_numpy(arr)


def to_ints(x, field: Field) -> list:
    """Unpack a ``uint32[W, *batch]`` tensor back to a flat list of ints
    (batch dims flattened in C order)."""
    a = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    flat = a.astype(np.uint64).reshape(field.n_words, -1)
    out = []
    for j in range(flat.shape[1]):
        v = 0
        for w in range(field.n_words):
            v |= int(flat[w, j]) << (32 * w)
        out.append(v)
    return out


def const_planes(value: int, field: Field, ndim: int = 1,
                 device=None) -> torch.Tensor:
    """A broadcastable constant element: int64[W, 1, ..., 1] with ``ndim``
    trailing singleton dims."""
    words = field.int_to_words(value)
    return torch.tensor(words, dtype=_I64, device=device).reshape(
        (field.n_words,) + (1,) * ndim)


# ---------------------------------------------------------------------------
# Half-limb pack/unpack
# ---------------------------------------------------------------------------

def unpack(x) -> list:
    """uint32 (or int64) [W, *b] word planes -> list of 2W int64[*b]
    16-bit half planes (little-endian)."""
    x = x.to(_I64)
    halves = []
    for w in range(x.shape[0]):
        halves.append(x[w] & HALF_MASK)
        halves.append(x[w] >> HALF_BITS)
    return halves


def pack(halves: list) -> torch.Tensor:
    """Inverse of :func:`unpack`: canonical half planes -> uint32 words."""
    words = [halves[2 * w] | (halves[2 * w + 1] << HALF_BITS)
             for w in range(len(halves) // 2)]
    return torch.stack(words, dim=0).to(torch.uint32)


def _halves_stacked(x) -> torch.Tensor:
    """uint32[W, *b] -> int64[2W, *b] stacked half planes."""
    x = x.to(_I64)
    stacked = torch.stack([x & HALF_MASK, x >> HALF_BITS], dim=1)
    return stacked.reshape((2 * x.shape[0],) + tuple(x.shape[1:]))


def _p_halves(field: Field, ndim: int, device) -> torch.Tensor:
    """int64[L, 1, ..., 1] half-limbs of p, broadcastable over a batch."""
    return torch.tensor(field.p_halves, dtype=_I64, device=device).reshape(
        (field.n_halves,) + (1,) * ndim)


# ---------------------------------------------------------------------------
# Carry/borrow chains on half-limb lists
# ---------------------------------------------------------------------------

def _add_halves(a: list, b: list):
    """(a + b) over L half-limbs -> (L half-limbs, carry-out in {0,1})."""
    out = []
    c = 0
    for j in range(len(a)):
        s = a[j] + b[j] + c
        out.append(s & HALF_MASK)
        c = s >> HALF_BITS
    return out, c


def _sub_halves(a: list, b: list):
    """(a - b) wrapped over L half-limbs -> (limbs, borrow-out in {0,1})."""
    out = []
    brw = 0
    for j in range(len(a)):
        s = a[j] - b[j] - brw
        out.append(s & HALF_MASK)
        brw = (s >> HALF_BITS) & 1      # arithmetic shift: -1 on borrow
    return out, brw


def _cond_sub_p(t: list, top, field: Field) -> list:
    """Given t (L half-limbs) + top word (value = t + top*2^(16L)) with
    value < 2p, return value mod p as L canonical half-limbs."""
    u, brw = _sub_halves(t, list(field.p_halves))
    ge = top >= brw
    return [torch.where(ge, u[j], t[j]) for j in range(len(t))]


# ---------------------------------------------------------------------------
# Modular add, subtract, negate (word planes in, word planes out)
# ---------------------------------------------------------------------------

def add_mod(x, y, field: Field) -> torch.Tensor:
    """(x + y) mod p, canonical in and out. The carry out of the top half
    counts: for Goldilocks a + b passes 2^64."""
    t, c = _add_halves(unpack(x), unpack(y))
    return pack(_cond_sub_p(t, c, field))


def _add_p_where(d: list, neg, field: Field) -> torch.Tensor:
    """d + p where ``neg`` holds, else d (half-limb lists), packed."""
    dp, _ = _add_halves(d, list(field.p_halves))
    return pack([torch.where(neg, dp[j], d[j]) for j in range(len(d))])


def sub_mod(x, y, field: Field) -> torch.Tensor:
    """(x - y) mod p, canonical in and out."""
    d, brw = _sub_halves(unpack(x), unpack(y))
    return _add_p_where(d, brw != 0, field)


def neg_mod(x, field: Field) -> torch.Tensor:
    """(-x) mod p, canonical."""
    a = unpack(x)
    d, brw = _sub_halves([torch.zeros_like(a[0])] * len(a), a)
    return _add_p_where(d, brw != 0, field)      # borrow: x != 0


# ---------------------------------------------------------------------------
# Montgomery ops
# ---------------------------------------------------------------------------

def mont_mul(x, y, field: Field) -> torch.Tensor:
    """Montgomery product x*y*R^{-1} mod p, canonical in/out (uint32 word
    planes, broadcasting over the batch dims): the lazy-carry CIOS of
    ``ntt_tpu.limbs.mont_mul`` with the half-limb axis vectorised."""
    L = field.n_halves
    a = _halves_stacked(x)
    b = _halves_stacked(y)
    bb = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    p_h = _p_halves(field, len(bb), a.device)
    t = torch.zeros((L + 1,) + tuple(bb), dtype=_I64, device=a.device)
    for i in range(L):
        prod = a[i] * b                       # exact: both < 2^16
        t[:L] += prod & HALF_MASK
        t[1:] += prod >> HALF_BITS
        m = (t[0] * field.np0) & HALF_MASK
        mp = m * p_h
        t[:L] += mp & HALF_MASK
        t[1:] += mp >> HALF_BITS
        carry0 = t[0] >> HALF_BITS            # low half is 0 by choice of m
        t = torch.cat([(t[1] + carry0)[None], t[2:],
                       torch.zeros_like(t[:1])], dim=0)
    out = []
    c = 0
    for j in range(L):
        s = t[j] + c
        out.append(s & HALF_MASK)
        c = s >> HALF_BITS
    top = t[L] + c
    return pack(_cond_sub_p(out, top, field))


def mont_sqr(x, field: Field) -> torch.Tensor:
    return mont_mul(x, x, field)


def mont_pow(x, exponent: int, field: Field) -> torch.Tensor:
    """x^exponent (Montgomery form in and out) by square-and-multiply over
    a Python exponent."""
    result = None
    base = x
    e = int(exponent)
    while e > 0:
        if e & 1:
            result = base if result is None else mont_mul(result, base, field)
        e >>= 1
        if e:
            base = mont_sqr(base, field)
    if result is None:
        one = const_planes(field.R, field, ndim=x.dim() - 1, device=x.device)
        return (one + torch.zeros_like(x, dtype=_I64)).to(torch.uint32)
    return result


def mont_reduce_wide(halves: list, field: Field, iters: int) -> torch.Tensor:
    """Montgomery-reduce a wide value given as a list of int64 half-limb
    planes (little-endian base 2^16; entries may be lazy): returns
    ``value * 2^(-16*iters) mod p`` as canonical uint32 word planes.

    Precondition: value < 2^(16*iters) * p."""
    L = field.n_halves
    p_h = field.p_halves
    t = [h.to(_I64) for h in halves]
    zero = torch.zeros_like(t[0])
    for _ in range(iters):
        m = (t[0] * field.np0) & HALF_MASK
        add_lo = [(m * p_h[j]) & HALF_MASK for j in range(L)]
        add_hi = [(m * p_h[j]) >> HALF_BITS for j in range(L)]
        carry0 = (t[0] + add_lo[0]) >> HALF_BITS
        nt = []
        for j in range(1, max(len(t), L + 1)):
            v = t[j] if j < len(t) else zero
            if j < L:
                v = v + add_lo[j]
            if j - 1 < L:
                v = v + add_hi[j - 1]
            if j == 1:
                v = v + carry0
            nt.append(v)
        t = nt
    out = []
    c = 0
    for j in range(L):
        s = t[j] + c
        out.append(s & HALF_MASK)
        c = s >> HALF_BITS
    top = c
    for j in range(L, len(t)):
        top = top + t[j]
    return pack(_cond_sub_p(out, top, field))


def to_mont(x, field: Field) -> torch.Tensor:
    """Standard -> Montgomery form: x*R mod p = mont_mul(x, R^2)."""
    r2 = const_planes(field.R2, field, ndim=x.dim() - 1, device=x.device)
    return mont_mul(x, r2, field)


def from_mont(x, field: Field) -> torch.Tensor:
    """Montgomery -> standard form: mont_mul(x, 1)."""
    one = const_planes(1, field, ndim=x.dim() - 1, device=x.device)
    return mont_mul(x, one, field)


def eq(x, y) -> torch.Tensor:
    """Elementwise equality over all word planes (CGBN cgbn_equals analog,
    cgbn.h:156-159), compared as int64: PyTorch compares no uint32 on the
    CPU."""
    return torch.all(x.to(_I64) == y.to(_I64), dim=0)


def is_canonical(x, field: Field) -> torch.Tensor:
    """Elementwise check: every element < p."""
    _, brw = _sub_halves(unpack(x), list(field.p_halves))
    return brw != 0


#: elements :func:`debug_check` tests at once (bounds the int64 halves)
DEBUG_CHUNK = 1 << 22


def debug_check(x, field: Field, where: str):
    """NTT_DEBUG=1 (read live) tripwire: ValueError naming the count of
    elements >= p in ``x`` (uint32[W, ...]); ``x`` itself otherwise, and
    nothing is computed unless the variable is set."""
    if os.environ.get("NTT_DEBUG", "0") != "1":
        return x
    flat = x.reshape(x.shape[0], -1)
    bad = sum(int((~is_canonical(flat[:, i:i + DEBUG_CHUNK], field)).sum())
              for i in range(0, flat.shape[1], DEBUG_CHUNK))
    if bad:
        raise ValueError(f"NTT_DEBUG: {bad} non-canonical element(s) (>= p) "
                         f"at {where} [{field.name}]")
    return x

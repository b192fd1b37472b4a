"""Plain prime-field arithmetic for the benchmark's reference, in PyTorch.

An element is held as 16-bit half-limbs on int64 planes, ``int64[L, *batch]``
with L = 2W halves for a field of W 32-bit words, least significant first.
Products are Montgomery products with R = 2^(16 L): the schoolbook product
of the halves, then L reduction steps (separated operand scanning), then one
conditional subtraction of p. Every operation takes canonical values (< p)
and returns canonical values, unless the field was made with ``lazy=True``:
then the product skips its final subtraction, the one step an optimised
implementation is tempted to drop, and returns values that may lie in
[p, 2p) (cut to L halves). That field is the benchmark's control.

Nothing here imports the program under test: the prime and its generator
come from the benchmark's configuration file.
"""

from __future__ import annotations

import torch

HALF = 16
MASK = (1 << HALF) - 1
_I64 = torch.int64

class PrimeField:
    """Montgomery arithmetic modulo an odd prime ``p`` whose multiplicative
    generator ``generator`` defines the roots of unity, ω_n =
    g^((p-1)/n)."""

    def __init__(self, p: int, generator: int, lazy: bool = False):
        if p < 3 or p % 2 == 0:
            raise ValueError(f"Montgomery arithmetic needs an odd prime, "
                             f"got {p}")
        self.p, self.generator, self.lazy = p, generator, lazy
        self.words = -(-self.p.bit_length() // 32)
        self.L = 2 * self.words
        self.R = (1 << (HALF * self.L)) % self.p
        self.np0 = (-pow(self.p, -1, 1 << HALF)) % (1 << HALF)
        self.p_ints = [(self.p >> (HALF * j)) & MASK for j in range(self.L)]

    # -- conversions ---------------------------------------------------------

    def halves(self, words: torch.Tensor) -> torch.Tensor:
        """uint32[W, *b] words -> int64[L, *b] halves."""
        w = words.to(_I64)
        h = torch.stack([w & MASK, w >> HALF], dim=1)
        return h.reshape((self.L,) + tuple(w.shape[1:]))

    def words_of(self, h: torch.Tensor) -> torch.Tensor:
        """int64[L, *b] canonical halves -> uint32[W, *b] words."""
        pairs = h.reshape((self.words, 2) + tuple(h.shape[1:]))
        return (pairs[:, 0] | (pairs[:, 1] << HALF)).to(torch.uint32)

    def const(self, value: int, device, ndim: int = 1) -> torch.Tensor:
        """The Montgomery form of ``value`` as halves int64[L, 1, ..., 1]."""
        m = (value % self.p) * self.R % self.p
        return torch.tensor([(m >> (HALF * j)) & MASK for j in range(self.L)],
                            dtype=_I64, device=device).reshape(
                                (self.L,) + (1,) * ndim)

    def _p(self, like: torch.Tensor) -> torch.Tensor:
        return torch.tensor(self.p_ints, dtype=_I64, device=like.device
                            ).reshape((self.L,) + (1,) * (like.dim() - 1))

    # -- carries -------------------------------------------------------------

    @staticmethod
    def _normalise(t: torch.Tensor):
        """Lazy limbs of a non-negative value, each limb possibly negative
        -> (16-bit limbs, carry out of the top); the shift is arithmetic, so
        a negative limb borrows from the next."""
        out = torch.empty_like(t)
        c = torch.zeros_like(t[0])
        for j in range(t.shape[0]):
            s = t[j] + c
            out[j] = s & MASK
            c = s >> HALF
        return out, c

    def _reduce_once(self, t: torch.Tensor, top: torch.Tensor) -> torch.Tensor:
        """(t + top·2^(16L)) - p where that is >= 0, else t; t canonical
        16-bit limbs, the value below 2p."""
        d = t - self._p(t)
        borrow = torch.zeros_like(t[0])
        for j in range(self.L):
            s = d[j] - borrow
            d[j] = s & MASK
            borrow = (s < 0).to(_I64)
        keep = (top - borrow) < 0          # value < p: no subtraction
        return torch.where(keep, t, d)

    # -- arithmetic ----------------------------------------------------------

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        t, top = self._normalise(a + b)
        return self._reduce_once(t, top)

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a - b mod p, as a + (p - b): below 2p, so one subtraction."""
        nb, _ = self._normalise(self._p(b) - b)
        return self.add(a, nb)

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Montgomery product a·b·R^-1 mod p (b may broadcast over a)."""
        L = self.L
        shape = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
        t = torch.zeros((2 * L,) + tuple(shape), dtype=_I64, device=a.device)
        for i in range(L):                 # schoolbook, lazy columns < 2^37
            t[i:i + L] += a[i] * b
        p = self._p(t[:L])
        for i in range(L):                 # one half-limb of reduction a step
            m = (t[i] * self.np0) & MASK
            t[i:i + L] += m * p
            t[i + 1] += t[i] >> HALF
        low, top = self._normalise(t[L:])
        if self.lazy:
            return low
        return self._reduce_once(low, top)

    def pow_table(self, base: int, count: int, device) -> torch.Tensor:
        """base^0 .. base^(count-1) in Montgomery form, int64[L, count]:
        each step doubles the table by one product with base^len."""
        out = self.const(1, device)
        while out.shape[1] < count:
            k = out.shape[1]
            step = self.const(pow(base, k, self.p), device)
            out = torch.cat([out, self.mul(out[:, :count - k], step)], dim=1)
        return out[:, :count]

    def root_of_unity(self, n: int) -> int:
        """ω_n = g^((p-1)/n)."""
        if n & (n - 1) or (self.p - 1) % n:
            raise ValueError(f"p = {self.p:#x} has no {n}-point domain")
        return pow(self.generator, (self.p - 1) // n, self.p)

"""The traffic's operations computed plainly: the benchmark's reference.

:class:`Reference` takes and returns Montgomery-form words, uint32[W, n]
(with a trailing batch axis or more), as the program does with
``mont_io=True``; the transforms give the same words on standard-form
input, being linear over the field. The transform is the textbook one:
the bit-reversal permutation, then log2 n radix-2 stages of Cooley-Tukey
butterflies over a table of powers of ω_n (ω_n = g^((p-1)/n), g the field's
generator), X[k] = Σ_i x[i]·ω_n^(ik); the inverse runs on ω_n^-1 and scales
by n^-1; the coset forms multiply by shift^i before the forward transform
and by shift^-i after the inverse one. :meth:`Reference.ntt_residue` gives
the forward transform at the indices r + S·t alone, from the input in
natural-order blocks (the check of a vector sharded over several cards);
:meth:`Reference.ntt_twiddled` is the column step of a plain four-step (the
control of a sharded transform).

Nothing here imports the program under test or takes a table it made.
``lazy=True`` gives the control (see :mod:`gpubench.reference.field`).
"""

from __future__ import annotations

import torch

from ..workload import load_op
from .field import PrimeField


def bit_reverse(n: int, device) -> torch.Tensor:
    """The bit-reversal permutation of range(n), n a power of two."""
    bits = n.bit_length() - 1
    i = torch.arange(n, device=device)
    r = torch.zeros_like(i)
    for b in range(bits):
        r |= ((i >> b) & 1) << (bits - 1 - b)
    return r


class Reference:
    """Plain primitives over which every operation of ``gpubench/ops/`` has
    its reference form, for one prime field and coset shift. Vectors are
    uint32[W, n, *batch]: every operation acts along axis 1, on its
    input's device (``device`` names the first)."""

    def __init__(self, p: int, generator: int, shift: int, device,
                 lazy: bool = False):
        self.f = PrimeField(p, generator, lazy=lazy)
        self.shift, self.device = shift, torch.device(device)
        self._tables: dict = {}

    def call(self, op: str, *xs):
        """Operation ``op`` (``gpubench/ops/<op>.py``) done plainly."""
        return load_op(op).reference(self, *xs)

    def _powers(self, base: int, count: int, ndim: int,
                device) -> torch.Tensor:
        """base^0 .. base^(count-1), int64[L, count, 1, ...] over ``ndim``
        axes after the limbs, on ``device``."""
        key = (base, count, str(device))
        if key not in self._tables:
            self._tables[key] = self.f.pow_table(base, count, device)
        t = self._tables[key]
        return t.reshape(tuple(t.shape) + (1,) * (ndim - 1))

    def _transform(self, h: torch.Tensor, inverse: bool) -> torch.Tensor:
        f, n, L = self.f, h.shape[1], self.f.L
        rest = tuple(h.shape[2:])
        w = f.root_of_unity(n)
        if inverse:
            w = pow(w, -1, f.p)
        tw = self._powers(w, max(n // 2, 1), 1, h.device)
        x = h[:, bit_reverse(n, h.device)]
        half = 1
        while half < n:
            x = x.reshape((L, n // (2 * half), 2, half) + rest)
            u, v = x[:, :, 0], x[:, :, 1]
            t = tw[:, ::n // (2 * half)][:, :half]
            vw = f.mul(v, t.reshape((L, 1, half) + (1,) * len(rest)))
            x = torch.stack([f.add(u, vw), f.sub(u, vw)], dim=2)
            half *= 2
        x = x.reshape((L, n) + rest)
        if inverse:
            x = f.mul(x, f.const(pow(n, -1, f.p), x.device, x.dim() - 1))
        return x

    # -- the primitives, on Montgomery-form words ----------------------------

    def ntt(self, x):
        return self.f.words_of(self._transform(self.f.halves(x), False))

    def intt(self, x):
        return self.f.words_of(self._transform(self.f.halves(x), True))

    def coset_ntt(self, x):
        h = self.f.mul(self.f.halves(x),
                       self._powers(self.shift, x.shape[1], x.dim() - 1,
                                    x.device))
        return self.f.words_of(self._transform(h, False))

    def coset_intt(self, x):
        h = self._transform(self.f.halves(x), True)
        inv = pow(self.shift, -1, self.f.p)
        return self.f.words_of(
            self.f.mul(h, self._powers(inv, x.shape[1], x.dim() - 1,
                                       x.device)))

    def ntt_residue(self, blocks, n: int, S: int, r: int):
        """X[r + S·t] for t < M = n/S, of the forward transform of an
        n-element x given as its S natural-order blocks x[M·b : M·(b+1)]
        (uint32[W, M] each, in order b = 0 .. S-1). With i = a + M·b:

            X[r + S·t] = Σ_{a<M} ω_M^{a·t} · ω_n^{a·r}
                         · Σ_{b<S} x[a + M·b] · ω_S^{b·r}

        a fold of the blocks, each times one constant, one M-entry
        twiddle product and one M-point transform. Every input element
        enters every output. Raises unless exactly S blocks of M came."""
        f, M = self.f, n // S
        w_s = f.root_of_unity(S)
        acc, seen = None, 0
        for b, block in enumerate(blocks):
            if block.shape[1] != M:
                raise ValueError(f"block {b} holds {block.shape[1]} "
                                 f"elements, not {M}")
            term = f.mul(f.halves(block),
                         f.const(pow(w_s, b * r, f.p), block.device))
            acc = term if acc is None else f.add(acc, term)
            seen += 1
        if seen != S:
            raise ValueError(f"{seen} blocks of {M}, not {S}")
        w_r = pow(f.root_of_unity(n), r, f.p)
        acc = f.mul(acc, f.pow_table(w_r, M, acc.device))
        return f.words_of(self._transform(acc, False))

    def ntt_twiddled(self, x, n: int, off: int):
        """The column step of a four-step n-point transform on columns
        off .. off + c − 1 of A[i1, i2]: x uint32[W, n1, c], each column's
        n1-point forward transform, times ω_n^{k1·(off + j)} at [k1, j]."""
        f = self.f
        n1, c = x.shape[1], x.shape[2]
        y = self._transform(f.halves(x), False)
        w = f.root_of_unity(n)
        base = f.mul(f.pow_table(w, c, x.device),
                     f.const(pow(w, off, f.p), x.device))      # ω^(off+j)
        tw, step = f.const(1, x.device, 2), base[:, None, :]
        while tw.shape[1] < n1:         # rows k1 .. 2·k1 − 1 from 0 .. k1 − 1
            tw = torch.cat([tw.expand(-1, -1, c),
                            f.mul(tw, step)], dim=1)
            if tw.shape[1] < n1:
                step = f.mul(step, step)
        return f.words_of(f.mul(y, tw))

    def mont_mul(self, a, b):
        return self.f.words_of(self.f.mul(self.f.halves(a), self.f.halves(b)))

    def sub_mod(self, a, b):
        return self.f.words_of(self.f.sub(self.f.halves(a), self.f.halves(b)))

    def scale(self, x, c: int):
        """x·c mod p."""
        k = self.f.const(c, x.device, x.dim() - 1)
        return self.f.words_of(self.f.mul(self.f.halves(x), k))


def field_of(config: dict, lazy: bool = False) -> PrimeField:
    """The field a configuration file states: its modulus and generator."""
    return PrimeField(int(config["modulus"], 16), config["generator"], lazy)


def for_config(config: dict, device, lazy: bool = False) -> Reference:
    """The reference for a configuration file's field and coset shift."""
    f = field_of(config)
    return Reference(f.p, f.generator, config["coset_shift"], device,
                     lazy=lazy)

"""Host-exact golden NTT models (pure Python integers): the port's own copy
of the executable specification that ``ntt_tpu.oracle`` is (the port
imports nothing of ``ntt_tpu``), the same names, signatures and words.

They mirror the CPU golden models of the reference CUDA programs:

- :func:`ntt_golden` — bit-reverse + radix-2 decimation-in-time, the golden
  ``NTT()`` of GZKP-NTT.cu:30-48 (identical copies in all four reference
  programs).
- :func:`ntt_dif` — decimation-in-frequency variant with the bit-reversal at
  the end (self-sort-in-place.cu:53-77).
- :func:`ntt_pro1` / :func:`ntt_pro2` — the two-phase self-sort-in-place
  (SSIP) CPU model (self-sort-in-place.cu:79-128), the algorithm spec of
  the flagship GPU transform: pro1 runs DIF rounds for the top half of the
  stages; pro2 runs the bottom half as *paired* butterflies at mirror
  positions so the output lands in natural order with no global
  bit-reversal pass.
- :func:`intt_golden` — inverse transform by ω^{-1} plus scaling by n^{-1},
  the convention of the reference's commented-out roundtrip check
  (GZKP-NTT.cu:1725-1732).
- :func:`ramp` — the de-facto reference test vector: the reference's
  "random" init is a discarded statement, so its inputs are always the ramp
  0,1,2,...,n-1 (GZKP-NTT.cu:1586-1589; big-num.cu:400).

All functions take and return lists of Python ints (canonical, < p) and are
O(n log n) with big-int cost — use them at small n, or the C++ host library
(:mod:`ntt_tpu_torch.hostlib`) at large n.
"""

from __future__ import annotations

from .fields import Field, inv_mod, pow_mod


def bit_reverse(i: int, bits: int) -> int:
    out = 0
    for _ in range(bits):
        out = (out << 1) | (i & 1)
        i >>= 1
    return out


def bit_reverse_table(n: int) -> list:
    """Bit-reversal permutation table (reference builds this in main(),
    GZKP-NTT.cu:1580-1582)."""
    bits = n.bit_length() - 1
    return [bit_reverse(i, bits) for i in range(n)]


def ramp(n: int, field: Field) -> list:
    """The de-facto reference input vector: data[i] = i (mod p)."""
    return [i % field.p for i in range(n)]


def ntt_golden(data: list, field: Field, omega: int | None = None) -> list:
    """Golden natural-order forward NTT: X[k] = sum_i x[i] ω_n^{ik} mod p.

    The semantics of the reference's ``NTT()`` (GZKP-NTT.cu:30-48):
    bit-reverse permute, then radix-2 DIT stages with per-stage twiddle
    gap = generator^((p-1)/(2*stride)).

    ``omega`` is the field *generator* to exponentiate from (reference passes
    ``root`` or ``inv(root)``), defaulting to ``field.generator``.
    """
    p = field.p
    n = len(data)
    assert n & (n - 1) == 0
    g = field.generator if omega is None else omega
    rev = bit_reverse_table(n)
    d = list(data)
    for i in range(n):
        if i < rev[i]:
            d[i], d[rev[i]] = d[rev[i]], d[i]
    stride = 1
    while stride < n:
        gap = pow_mod(g, (p - 1) // (stride << 1), p)
        for start in range(0, n, stride << 1):
            w = 1
            for offset in range(stride):
                a = d[start + offset]
                b = w * d[start + offset + stride] % p
                d[start + offset] = (a + b) % p
                d[start + offset + stride] = (a - b + p) % p
                w = (gap * w) % p
        stride <<= 1
    return d


def ntt_dif(data: list, field: Field, omega: int | None = None) -> list:
    """DIF variant: butterflies first, bit-reverse at the end
    (self-sort-in-place.cu:53-77). Same output as :func:`ntt_golden`."""
    p = field.p
    n = len(data)
    g = field.generator if omega is None else omega
    d = list(data)
    log_n = n.bit_length() - 1
    for i in range(log_n, 0, -1):
        stride = 1 << (i - 1)
        gap = pow_mod(g, (p - 1) // (stride << 1), p)
        for start in range(0, n, stride << 1):
            w = 1
            for offset in range(stride):
                a = d[start + offset]
                b = d[start + offset + stride]
                d[start + offset] = (a + b) % p
                d[start + offset + stride] = ((a - b + p) % p) * w % p
                w = (gap * w) % p
    rev = bit_reverse_table(n)
    for i in range(n):
        if i < rev[i]:
            d[i], d[rev[i]] = d[rev[i]], d[i]
    return d


def ntt_pro1(d: list, log_len: int, field: Field,
             omega: int | None = None) -> None:
    """SSIP phase 1 (in-place): DIF rounds for stages log_len .. log_len/2+1
    (self-sort-in-place.cu:79-94)."""
    p = field.p
    n = 1 << log_len
    g = field.generator if omega is None else omega
    for i in range(log_len, log_len // 2, -1):
        stride = 1 << (i - 1)
        gap = pow_mod(g, (p - 1) // (stride << 1), p)
        for start in range(0, n, stride << 1):
            w = 1
            for offset in range(stride):
                a = d[start + offset]
                b = d[start + offset + stride]
                d[start + offset] = (a + b) % p
                d[start + offset + stride] = ((a - b + p) % p) * w % p
                w = (gap * w) % p


def ntt_pro2(d: list, log_len: int, field: Field,
             omega: int | None = None) -> None:
    """SSIP phase 2 (in-place): paired butterflies at mirror offsets with
    cross-position writes, so the final output is natural-order without a
    bit-reversal pass (self-sort-in-place.cu:96-128)."""
    p = field.p
    n = 1 << log_len
    g = field.generator if omega is None else omega
    for i in range(log_len // 2, 0, -1):
        stride = 1 << (i - 1)
        pair_stride = 1 << (log_len - i)
        gap = pow_mod(g, (p - 1) // (stride << 1), p)
        for start in range(0, n, pair_stride << 1):
            for offset0 in range(0, pair_stride, stride << 1):
                w = 1
                for offset in range(stride):
                    base = start + offset0 + offset
                    a = d[base]
                    b = d[base + stride]
                    c = d[base + pair_stride]
                    e = d[base + pair_stride + stride]
                    d[base] = (a + b) % p
                    d[base + stride] = (c + e) % p
                    d[base + pair_stride] = ((a - b + p) % p) * w % p
                    d[base + pair_stride + stride] = ((c - e + p) % p) * w % p
                    w = (gap * w) % p


def ntt_ssip(data: list, field: Field, omega: int | None = None) -> list:
    """Full SSIP CPU model: pro1 then pro2 (self-sort-in-place.cu:462-467)."""
    d = list(data)
    log_len = len(d).bit_length() - 1
    ntt_pro1(d, log_len, field, omega)
    ntt_pro2(d, log_len, field, omega)
    return d


def intt_golden(data: list, field: Field) -> list:
    """Inverse NTT: forward with inv(generator), then scale by n^{-1}
    (the reference's roundtrip convention, GZKP-NTT.cu:1725-1732)."""
    n = len(data)
    p = field.p
    out = ntt_golden(data, field, omega=inv_mod(field.generator, p))
    n_inv = inv_mod(n, p)
    return [x * n_inv % p for x in out]


def coset_ntt_golden(data: list, field: Field, shift: int) -> list:
    """Coset NTT: evaluate on the coset shift·<ω_n> — pre-multiply x[i] by
    shift^i then forward NTT (not in the reference programs; the LDE and
    commitment workloads need it)."""
    p = field.p
    scaled = []
    s = 1
    for x in data:
        scaled.append(x * s % p)
        s = s * shift % p
    return ntt_golden(scaled, field)


def lde_golden(data: list, field: Field, blowup: int,
               shift: int | None = None) -> list:
    """Low-degree extension: interpolate (inverse NTT) then evaluate on the
    blowup·n-sized coset domain (zero-pad coefficients + coset NTT)."""
    n = len(data)
    shift = field.generator if shift is None else shift
    coeffs = intt_golden(data, field)
    coeffs = coeffs + [0] * (n * (blowup - 1))
    return coset_ntt_golden(coeffs, field, shift)


def naive_dft(data: list, field: Field, omega: int | None = None) -> list:
    """O(n^2) direct DFT — the independent cross-check for the golden model
    itself (used only at tiny n in tests)."""
    p = field.p
    n = len(data)
    g = field.generator if omega is None else omega
    w = pow_mod(g, (p - 1) // n, p)
    out = []
    for k in range(n):
        acc = 0
        wk = pow_mod(w, k, p)
        wik = 1
        for i in range(n):
            acc = (acc + data[i] * wik) % p
            wik = wik * wk % p
        out.append(acc)
    return out

"""Digit-plane codec: field elements <-> int8 digit planes for matmuls.

The port's counterpart of ``ntt_tpu.digits``, in two parts:

- the host-side constructors (numpy, byte-equal to the JAX package's):
  the digit convolution matrices that turn a modular linear map into ONE
  int8 matmul, and the Montgomery fold matrices;
- the plain arithmetic in PyTorch (``extract_digits``, ``recompose_reduce``,
  ``mont_mul_fold``, ``apply_matrix``) that the kernels' plain versions are
  built from.

A field element (Montgomery form, canonical) is cut into D = ceil(bits/7)
seven-bit digits. A map Y = M @ X (mod p) becomes Z = A @ d with
A[(e*m + k), (d2*m + i)] the digits of the pre-scaled entries
M̃ = M * R * 2^16 mod p (pre-folded mod p per digit row for wide fields), so
one Montgomery reduction by 2^(16*(L+1)) lands Z back on canonical words.

The plain matmul is a float64 ``torch.matmul`` of the digit values: every
product is < 2^14 and every sum < 2^25, so float64 holds it exactly in any
summation order, on the CPU and on the card alike.

The JAX package's ``NTT_MXU_FOLD`` knob is hard-wired on: wide fields take
the fold (matrix rows pre-folded mod p, D output planes, fold-matmul
reduction); narrow fields (n_halves < 12) take the unfolded banded matrices
(E = 2D-1 planes) and the plain wide Montgomery reduction.
"""

from __future__ import annotations

import numpy as np
import torch

from . import hostlib, limbs
from .fields import HALF_BITS, Field

DIGIT_BITS = 7
DIGIT_MASK = (1 << DIGIT_BITS) - 1

#: CIOS elimination steps remaining after the fold matmul (the folded value
#: V2 < 2^(7·(D-1) + 21) must satisfy V2 < 2^(16·tail)·p).
FOLD_TAIL_ITERS = 2


def n_digits(field: Field) -> int:
    """Digits per element (covers the full Montgomery width)."""
    return -(-field.mont_bits // DIGIT_BITS)


def fold_active(field: Field) -> bool:
    """The Montgomery fold applies to wide fields (n_halves >= 12)."""
    return field.n_halves >= 12


def out_planes(field: Field) -> int:
    """Digit planes a conv matmul emits: D when the matrix rows are
    pre-folded mod p (wide fields), else the full profile 2D-1."""
    D = n_digits(field)
    return D if fold_active(field) else 2 * D - 1


# ---------------------------------------------------------------------------
# Host-side constructors (numpy; byte-equal to ntt_tpu.digits)
# ---------------------------------------------------------------------------

def _digits_of_bytes(raw: np.ndarray, n_digits: int) -> np.ndarray:
    """Little-endian byte rows uint8[n, nbytes] -> int8[n, n_digits] 7-bit
    digits: digit d is bits 7d .. 7d+6, read from the two bytes that hold
    them (bytes past the row read as zero)."""
    nb = (7 * n_digits + 7) // 8 + 1
    wide = np.zeros((max(nb, raw.shape[1]), raw.shape[0]), dtype=np.uint16)
    wide[:raw.shape[1]] = raw.T                 # byte-major: rows gather
    pos = 7 * np.arange(n_digits)
    pair = wide[pos // 8] | (wide[pos // 8 + 1] << 8)
    shift = (pos % 8).astype(np.uint16)[:, None]
    return np.ascontiguousarray(((pair >> shift) & 0x7F).astype(np.int8).T)


def digits_of_ints(vals, n_digits: int) -> np.ndarray:
    """Python ints (each < 2^(7*n_digits)) -> int8[len(vals), n_digits]
    little-endian 7-bit digits."""
    nbytes = (7 * n_digits + 7) // 8
    buf = b"".join(v.to_bytes(nbytes, "little") for v in vals)
    return _digits_of_bytes(
        np.frombuffer(buf, np.uint8).reshape(len(vals), nbytes), n_digits)


def conv_matrix(entries, field: Field) -> np.ndarray:
    """Digit convolution matrix of the map M̃ (m x m nested list of ints,
    already pre-scaled by R*2^16 mod p): int8[E*m, D*m] with
    A[(e*m + k), (d2*m + i)] = digit_{e-d2}(M̃[k][i]). Wide fields get the
    pre-folded form (E = D); narrow fields the banded one (E = 2D-1)."""
    if fold_active(field):
        return conv_matrix_folded(entries, field)
    m = len(entries)
    D = n_digits(field)
    E = 2 * D - 1
    digs = digits_of_ints(
        [v for row in entries for v in row], D).reshape(m, m, D)
    A = np.zeros((E, m, D, m), dtype=np.int8)
    for d2 in range(D):
        A[d2:d2 + D, :, d2, :] = digs.transpose(2, 0, 1)
    return A.reshape(E * m, D * m)


def conv_matrix_folded(entries, field: Field) -> np.ndarray:
    """Pre-folded conv matrix: row (d2, i) holds the digits of
    M̃[k][i]·2^(7·d2) mod p, so the matmul emits D planes instead of 2D-1
    (residues preserved term by term). The D products an entry needs are
    one call of the hostlib's modular product on limb rows."""
    m = len(entries)
    D = n_digits(field)
    p = field.p
    ents = hostlib.ints_to_rows([v for row in entries for v in row])
    shifts = hostlib.ints_to_rows([pow(2, DIGIT_BITS * d, p)
                                   for d in range(D)])
    vals = hostlib.mul_mod_vec_np(np.repeat(ents, D, axis=0),
                                  np.tile(shifts, (m * m, 1)), field)
    digs = _digits_of_bytes(vals.view(np.uint8), D).reshape(m, m, D, D)
    A = digs.transpose(3, 0, 2, 1)                      # [t, k, d2, i]
    return np.ascontiguousarray(A).reshape(D * m, D * m)


def matrix_prescale(field: Field) -> int:
    """The factor baked into matrix entries: R * 2^16 mod p."""
    return (field.R << HALF_BITS) % field.p


def reduce_iters(field: Field) -> int:
    return field.n_halves + 1


def halves_info(P: int, zmax_bits: int) -> tuple:
    """(J half planes, max bits per half) of :func:`_planes_to_halves` for
    P digit planes < 2^zmax_bits."""
    total_bits = DIGIT_BITS * (P - 1) + zmax_bits
    J = -(-total_bits // HALF_BITS) + 1
    cnt = [0] * J
    for e in range(P):
        bitpos = DIGIT_BITS * e
        q, r = bitpos >> 4, bitpos & 15
        cnt[q] += 1
        cnt[q + 1] += 1
        if zmax_bits + r > 32:
            cnt[q + 2] += 1
    return J, (max(1, max(cnt)) * ((1 << HALF_BITS) - 1)).bit_length()


_fold_matrix_cache: dict = {}


def fold_reduce_matrix(field: Field, J: int, hbits: int,
                       zmax_bits: int, iters: int | None = None
                       ) -> np.ndarray:
    """int8 fold matrix F[e, j·nd + t] = digit_e((2^(7t + 16j)
    · 2^(16·FOLD_TAIL_ITERS − 16·iters)) mod p), contraction padded to a
    multiple of 32. ``iters``: total halves the fold+tail eliminates
    (reduce_iters for the conv-matmul reduction, n_halves for the twiddle
    product)."""
    if iters is None:
        iters = reduce_iters(field)
    key = (field.name, J, hbits, zmax_bits, iters)
    got = _fold_matrix_cache.get(key)
    if got is not None:
        return got
    p = field.p
    D = n_digits(field)
    nd = -(-hbits // DIGIT_BITS)
    sh = 16 * FOLD_TAIL_ITERS - 16 * iters
    scale = pow(2, sh, p) if sh >= 0 else pow(pow(2, -sh, p), p - 2, p)
    C = -(-(J * nd) // 32) * 32
    F = np.zeros((D, C), dtype=np.int8)
    for j in range(J):
        cj = (pow(2, 16 * j, p) * scale) % p
        for t in range(nd):
            v = (cj << (DIGIT_BITS * t)) % p
            for e in range(D):
                F[e, j * nd + t] = (v >> (DIGIT_BITS * e)) & DIGIT_MASK
    zmax2 = (J * nd * DIGIT_MASK ** 2).bit_length()
    v2_max = 1 << (DIGIT_BITS * (D - 1) + zmax2)
    assert v2_max < (1 << (16 * FOLD_TAIL_ITERS)) * p, \
        "fold tail window overflow — raise FOLD_TAIL_ITERS"
    assert J * nd * DIGIT_MASK ** 2 < (1 << 31), "fold matmul overflow"
    _fold_matrix_cache[key] = F
    return F


def mul_fold_info(field: Field) -> tuple:
    """(J, hbits) of the schoolbook half-product planes of
    :func:`mont_mul_fold`."""
    L = field.n_halves
    return 2 * L + 1, (2 * L * ((1 << HALF_BITS) - 1)).bit_length()


def fold_mul_matrix(field: Field) -> np.ndarray:
    """Fold matrix of the twiddle Montgomery product (eliminates R)."""
    J, hbits = mul_fold_info(field)
    return fold_reduce_matrix(field, J, hbits, 0, iters=field.n_halves)


# ---------------------------------------------------------------------------
# Plain arithmetic (PyTorch)
# ---------------------------------------------------------------------------

def matmul_exact(A, X) -> torch.Tensor:
    """int8[r, c] @ int8-valued[c, N] -> int64[r, N], exact (float64:
    every sum of the digit products stays far below 2^53)."""
    return torch.matmul(A.to(torch.float64),
                        X.to(torch.float64)).to(torch.int64)


def extract_digits(x, field: Field) -> torch.Tensor:
    """uint32[W, *b] word planes -> int8[D, *b] digit planes (little-endian
    base 2^7)."""
    x = x.to(torch.int64)
    W = field.n_words
    planes = []
    for d in range(n_digits(field)):
        bitpos = DIGIT_BITS * d
        w0, r = bitpos >> 5, bitpos & 31
        if w0 >= W:
            planes.append(torch.zeros_like(x[0]))
            continue
        v = x[w0] >> r
        if r + DIGIT_BITS > 32 and w0 + 1 < W:
            v = v | (x[w0 + 1] << (32 - r))
        planes.append(v & DIGIT_MASK)
    return torch.stack(planes, dim=0).to(torch.int8)


def _planes_to_halves(Z, zmax_bits: int):
    """int64[P, *b] digit-plane sums (non-negative, < 2^zmax_bits, plane e
    weighted 2^(7e)) -> (list of lazy int64 16-bit-half planes, max bits
    per half), matching :func:`halves_info`."""
    P = Z.shape[0]
    n_halves, hbits = halves_info(P, zmax_bits)
    acc = [None] * n_halves

    def _add(idx, val):
        acc[idx] = val if acc[idx] is None else acc[idx] + val

    M = 0xFFFF
    for e in range(P):
        bitpos = DIGIT_BITS * e
        q, r = bitpos >> 4, bitpos & 15
        z = Z[e]
        _add(q, ((z & M) << r) & M)
        _add(q + 1, (z >> (16 - r)) & M)
        if zmax_bits + r > 32:
            _add(q + 2, z >> (32 - r))
    zero = torch.zeros_like(Z[0])
    return [a if a is not None else zero for a in acc], hbits


def _fold_reduce(halves: list, hbits: int, field: Field, F) -> torch.Tensor:
    """Σ_j halves[j]·2^(16j), each < 2^hbits -> value·2^(-16·iters) mod p,
    canonical: 7-bit digit split, fold matmul against ``F`` (int8[D, C]),
    FOLD_TAIL_ITERS-step CIOS tail."""
    J = len(halves)
    nd = -(-hbits // DIGIT_BITS)
    D = n_digits(field)
    rest = halves[0].shape
    planes = [(h >> (DIGIT_BITS * t)) & DIGIT_MASK
              for h in halves for t in range(nd)]
    C = F.shape[1]
    planes += [torch.zeros_like(halves[0])] * (C - len(planes))
    Hd = torch.stack(planes, dim=0).reshape(C, -1)
    Z2 = matmul_exact(F.to(Hd.device), Hd).reshape((D,) + tuple(rest))
    zmax2 = (J * nd * DIGIT_MASK ** 2).bit_length()
    halves2, _ = _planes_to_halves(Z2, zmax2)
    return limbs.mont_reduce_wide(halves2, field, FOLD_TAIL_ITERS)


def recompose_reduce(Z, field: Field, zmax_bits: int,
                     fold_mat=None) -> torch.Tensor:
    """int64[E, m, *b] digit-plane sums (< 2^zmax_bits) -> canonical
    Montgomery uint32[W, m, *b]: re-base to 16-bit halves, then reduce by
    2^(16*(L+1)): the fold reduction for wide fields (``fold_mat`` defaults
    to the host-built :func:`fold_reduce_matrix`), the plain wide
    Montgomery reduction for narrow ones."""
    halves, hbits = _planes_to_halves(Z.to(torch.int64), zmax_bits)
    if not fold_active(field):
        return limbs.mont_reduce_wide(halves, field, reduce_iters(field))
    if fold_mat is None:
        fold_mat = torch.from_numpy(fold_reduce_matrix(
            field, len(halves), hbits, zmax_bits))
    return _fold_reduce(halves, hbits, field, fold_mat)


def mont_mul_fold(x, y, field: Field, F) -> torch.Tensor:
    """Montgomery product x·y·R^{-1} mod p via schoolbook half products,
    the fold matmul against ``F`` (:func:`fold_mul_matrix`) and the
    2-step tail (wide fields). Word-equal to limbs.mont_mul."""
    a = limbs.unpack(x)
    b = limbs.unpack(y)
    L = field.n_halves
    P = [None] * (2 * L + 1)

    def _add(k, v):
        P[k] = v if P[k] is None else P[k] + v

    for i in range(L):
        for j in range(L):
            prod = a[i] * b[j]               # exact: both < 2^16
            _add(i + j, prod & 0xFFFF)
            _add(i + j + 1, prod >> HALF_BITS)
    shp = torch.broadcast_shapes(*[t.shape for t in P if t is not None])
    halves = [torch.broadcast_to(t, shp) if t is not None
              else torch.zeros(shp, dtype=torch.int64, device=a[0].device)
              for t in P]
    _, hbits = mul_fold_info(field)
    return _fold_reduce(halves, hbits, field, F)


def apply_matrix(A, x, field: Field, m: int, zmax_bits: int,
                 fold_mat=None) -> torch.Tensor:
    """Apply a digit convolution matrix A (int8[E*m, D*m]) to Montgomery
    data x: uint32[W, m, *batch] -> uint32[W, m, *batch], the modular
    linear map mont(M @ x) along axis 1."""
    D = n_digits(field)
    E = out_planes(field)
    rest = tuple(x.shape[2:])
    d = extract_digits(x, field)                       # [D, m, *rest]
    Z = matmul_exact(A.to(x.device), d.reshape(D * m, -1))
    return recompose_reduce(Z.reshape((E, m) + rest), field, zmax_bits,
                            fold_mat=fold_mat)

"""The launch plan of the tensor-core levels K2 (``fused_level_stack``) and
K4 (``fused_level``), and a torch emulation of their tiled contraction, on
the CPU.

The CUDA kernels (``csrc/mxu_core.cuh``, ``tc::contract``) run only on the
card; what surrounds their arithmetic is held here: the plan the wrappers
pass to the C launcher (row chunks, padded depth and rows, column tiles,
shared bytes), and the block-by-block dataflow the kernels follow (a zero-
padded digit tile per column tile, the chunk's conv-matrix rows gathered in
GEMM row order e * kt + kk, the depth in 32-deep ring steps with int32
sums, one pass per stack entry with the other entries' columns zeroed).
The emulation must give the plain versions' canonical words: the tolerance
is exact equality.
"""

import numpy as np
import pytest
import torch

import ntt_tpu_torch.fields as tfields
from ntt_tpu_torch import digits as tdigits
from ntt_tpu_torch.kernels import mxu_level
from ntt_tpu_torch.transforms import mxu as tmxu

torch.set_num_threads(1)

FIELD_OF_WIDTH = {1: tfields.SMALL, 2: tfields.GOLDILOCKS,
                  8: tfields.BLS12_381_FR}


def _chunk_rows(E, m, plan, chunk):
    """The conv-matrix rows of a row chunk in the kernels' GEMM row order
    r = e * kt + kk: row e * m + chunk * kt + kk."""
    return [e * m + chunk * plan.kt + kk
            for e in range(E) for kk in range(plan.kt)]


def _words(field, shape, seed):
    """Canonical random elements as uint32[W, *shape] (top word < p's)."""
    rng = np.random.default_rng(seed)
    W = field.n_words
    x = rng.integers(0, 1 << 32, size=(W,) + shape, dtype=np.uint64)
    x[W - 1] = rng.integers(0, field.p >> (32 * (W - 1)), size=shape,
                            dtype=np.uint64)
    return torch.from_numpy(x.astype(np.uint32))


@pytest.mark.parametrize("m", [2, 4, 8, 16, 32])
@pytest.mark.parametrize("W", [1, 2, 8])
def test_plan_fits_the_block_and_covers_the_level(W, m):
    field = FIELD_OF_WIDTH[W]
    D, E = tdigits.n_digits(field), tdigits.out_planes(field)
    for B in (1, 37, 64, 300, 8192, 32768):
        plan = mxu_level.tc_plan(field, m, B)
        assert plan.smem_bytes <= 232448
        assert plan.k_pad >= D * m and plan.k_pad % 32 == 0
        assert plan.m_pad == mxu_level.TC_ROWS_PAD >= E * plan.kt
        assert plan.m_pad % 32 == 0     # two wgmma N halves, multiples of 16
        rows = [r for c in range(plan.chunks)
                for r in _chunk_rows(E, m, plan, c)]
        assert sorted(rows) == list(range(E * m))
        cols = mxu_level.TC_COLS
        assert (plan.col_tiles - 1) * cols < B <= plan.col_tiles * cols
        assert plan.blocks == plan.chunks * plan.col_tiles


def test_plan_refuses_what_the_kernel_cannot_take():
    bls = tfields.BLS12_381_FR
    four_words = tfields.Field("m127", (1 << 127) - 1, 3, 1)
    for field, m, B in ((four_words, 32, 64), (bls, 64, 64), (bls, 12, 64),
                        (bls, 32, 0)):
        with pytest.raises(ValueError):
            mxu_level.tc_plan(field, m, B)


def _emulated_z(x3, field, As, rep):
    """Z int64[E*m, B] formed block by block as the kernels form it."""
    W, m, B = x3.shape
    D, E = tdigits.n_digits(field), tdigits.out_planes(field)
    plan = mxu_level.tc_plan(field, m, B)
    N, BK = mxu_level.TC_COLS, mxu_level.TC_BK
    d = tdigits.extract_digits(x3, field).reshape(D * m, B).to(torch.int32)
    Z = torch.full((E * m, B), -1, dtype=torch.int64)
    for blk in range(plan.blocks):
        tile, chunk = divmod(blk, plan.chunks)
        cols = torch.arange(tile * N, tile * N + N)
        valid = cols < B
        dig = torch.zeros((N, plan.k_pad), dtype=torch.int32)
        dig[valid, :D * m] = d[:, cols[valid]].T
        rows = _chunk_rows(E, m, plan, chunk)
        acc = torch.zeros((plan.m_pad, N), dtype=torch.int32)
        last = int(cols[valid][-1])
        for s in range(int(cols[0]) // rep, last // rep + 1):
            ring = torch.zeros((plan.m_pad, plan.k_pad), dtype=torch.int32)
            ring[:len(rows), :D * m] = As[s][rows].to(torch.int32)
            frag = dig * (cols // rep == s)[:, None]
            for kb in range(plan.k_pad // BK):
                ks = slice(kb * BK, kb * BK + BK)
                acc += ring[:, ks] @ frag[:, ks].T
        Z[torch.tensor(rows)[:, None], cols[valid][None, :]] = \
            acc[:len(rows), valid].to(torch.int64)
    assert bool((Z >= 0).all()), "a (row, column) no block formed"
    return Z


def _emulated_level(x3, field, As, rep, F=None, T3=None, F2=None):
    W, m, B = x3.shape
    E = tdigits.out_planes(field)
    Z = _emulated_z(x3, field, As, rep).reshape(E, m, B)
    y = tdigits.recompose_reduce(Z, field, mxu_level._zmax_bits(field, m),
                                 fold_mat=F)
    if T3 is not None:
        y = mxu_level._twiddle_product(y, T3, field, F2)
    return y


def _stack(field, m, NT, seed):
    rng = np.random.default_rng(seed)
    tvals = [[int(v) % field.p for v in rng.integers(1, 1 << 62, size=m)]
             for _ in range(NT)]
    return torch.from_numpy(tmxu.twiddle_matrix_stack(field, m, tvals))


@pytest.mark.parametrize("W, m, NT, rep, with_t3", [
    (8, 4, 4, 7, True),      # depth 148 -> 160; one column tile, 4 entries
    (2, 32, 5, 16, False),   # two row chunks; a ragged second column tile
    (1, 2, 3, 16, True),     # depth 10 -> 32
])
def test_emulated_stack_level_equals_plain(W, m, NT, rep, with_t3):
    field = FIELD_OF_WIDTH[W]
    B = NT * rep
    x = _words(field, (m, B), 10 * W + m)
    As = _stack(field, m, NT, W + m)
    F = (torch.from_numpy(tmxu._fold_matrix(field, m))
         if tdigits.fold_active(field) else None)
    T3 = _words(field, (m, B), 7) if with_t3 else None
    want = mxu_level.fused_level_stack_plain(x, field, As, rep, F, T3)
    assert torch.equal(_emulated_level(x, field, As, rep, F, T3), want)


@pytest.mark.parametrize("W, m, B, transpose", [
    (8, 8, 100, True),       # depth 296 -> 320, ragged B
    (2, 4, 37, False),
])
def test_emulated_fused_level_equals_plain(W, m, B, transpose):
    field = FIELD_OF_WIDTH[W]
    x = _words(field, (m, B), 3 * m)
    T3 = _words(field, (m, B), 5)
    A = torch.from_numpy(tmxu._base_matrix(field, m))
    F = F2 = None
    if tdigits.fold_active(field):
        F = torch.from_numpy(tmxu._fold_matrix(field, m))
        F2 = torch.from_numpy(tdigits.fold_mul_matrix(field))
    want = mxu_level.fused_level_plain(x, field, A, T3, transpose, F, F2)
    got = _emulated_level(x, field, A[None], B, F, T3, F2)
    if transpose:
        got = got.transpose(1, 2).contiguous()
    assert torch.equal(got, want)

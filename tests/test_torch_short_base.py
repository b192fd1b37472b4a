"""K1's short form (``base_ntt_mxu_short_kernel``, ``csrc/mxu_level.cu``)
on the CPU: its launch plan (``mxu_level.base_plan``) and a torch emulation
of its block dataflow.

The short form is taken where one wgmma N half holds every GEMM row of the
level, E * m <= 160 (W = 8 at m = 2 and 4, W = 2 at m <= 8, W = 1 at
m <= 16). A block of two warpgroups stages the conv matrix once (160 GEMM
rows, zero past E * m rows and past D * m contraction bytes) and walks a
span of 128-column tiles; per tile it builds the digit tile from x (whole
words: at m = 2 the digits 2p, 2p + 1 of both rows, above digit j of four
rows), each warpgroup contracts its 64 columns against the whole matrix in
32-deep steps with int32 sums, and the epilogue reduces the E * m rows of
the valid columns. Two blocks share an SM. The emulation must give the
plain version's canonical words: the tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

import ntt_tpu_torch.fields as tfields
from ntt_tpu_torch import digits as tdigits
from ntt_tpu_torch.kernels import mxu_level, mxu_ntt
from ntt_tpu_torch.transforms import mxu as tmxu

torch.set_num_threads(1)

FIELD_OF_WIDTH = {1: tfields.SMALL, 2: tfields.GOLDILOCKS,
                  8: tfields.BLS12_381_FR}
#: (W, m) of every short-form launch
SHORT = [(8, 2), (8, 4), (2, 2), (2, 4), (2, 8), (1, 2), (1, 4), (1, 8),
         (1, 16)]
ROWS, COLS, BK = (mxu_level.TC_SHORT_ROWS, mxu_level.TC_COLS,
                  mxu_level.TC_BK)


def _words(field, shape, seed):
    """Canonical random elements as uint32[W, *shape] (top word < p's)."""
    rng = np.random.default_rng(seed)
    W = field.n_words
    x = rng.integers(0, 1 << 32, size=(W,) + shape, dtype=np.uint64)
    x[W - 1] = rng.integers(0, field.p >> (32 * (W - 1)), size=shape,
                            dtype=np.uint64)
    return torch.from_numpy(x.astype(np.uint32))


def _block_tiles(plan, blk):
    """The column tiles block ``blk`` walks: ceil(tiles / blocks) from
    blk * that, cut at the last tile (the kernel's t0, t1)."""
    span = -(-plan.col_tiles // plan.blocks)
    return range(blk * span, min((blk + 1) * span, plan.col_tiles))


@pytest.mark.parametrize("W", [1, 2, 8])
def test_short_form_exactly_where_one_row_half_holds_the_level(W):
    """The short form is K1's plan exactly where E * m <= 160; elsewhere
    K1 keeps ``tc_plan``'s form, and the other kernels take ``tc_plan``
    at every m."""
    field = FIELD_OF_WIDTH[W]
    E = tdigits.out_planes(field)
    for m in (2, 4, 8, 16, 32, 64):
        short = E * m <= ROWS
        assert mxu_level.short_form(field, m) == short
        for B in (1, 300, 1 << 20):
            plan = mxu_level.base_plan(field, m, B)
            assert (plan.m_pad == ROWS) == short
            if not short:
                assert plan == mxu_level.tc_plan(field, m, B)
            assert mxu_level.tc_plan(field, m, B).m_pad == \
                mxu_level.TC_ROWS_PAD
    want = {8: (2, 4), 2: (2, 4, 8), 1: (2, 4, 8, 16)}[W]
    assert tuple(m for w, m in SHORT if w == W) == want


@pytest.mark.parametrize("W, m", SHORT)
def test_short_plan_tile_span_blocks_and_shared_bytes(W, m):
    """One chunk of all m rows, the depth padded to 32, the rows to one N
    half; 128-column tiles; a span of ceil(tiles / (2 * SMs)) tiles a
    block, so that at most two blocks an SM run in one wave and no block is
    empty; the shared bytes of the matrix and of the digit tile or the Z
    tile that aliases it, twice within an SM; the C entry's arguments."""
    field = FIELD_OF_WIDTH[W]
    D, E = tdigits.n_digits(field), tdigits.out_planes(field)
    for sms in (132, 114, 4):
        for B in (1, 37, 127, 128, 129, 300, 2 * 132 * COLS + 1, 1 << 20,
                  (1 << 25) + 77):
            p = mxu_level.base_plan(field, m, B, sms)
            assert (p.kt, p.chunks, p.m_pad) == (m, 1, ROWS)
            assert p.k_pad == -(-D * m // BK) * BK and E * m <= p.m_pad
            tiles = -(-B // COLS)
            assert p.col_tiles == tiles
            assert p.span == -(-tiles // (mxu_level.TC_SHORT_BLOCKS * sms))
            assert p.blocks == -(-tiles // p.span)
            assert p.blocks <= mxu_level.TC_SHORT_BLOCKS * sms
            assert (p.blocks - 1) * p.span < tiles <= p.blocks * p.span
            # the kernel recomputes the span from the grid: the same one
            assert -(-tiles // p.blocks) == p.span
            assert p.smem_bytes == (mxu_level.TC_ALIGN + ROWS * p.k_pad
                                    + max(COLS * p.k_pad,
                                          E * m * mxu_level.TC_Z_STRIDE * 4))
            assert mxu_level.TC_SHORT_BLOCKS * p.smem_bytes <= \
                mxu_level.TC_MAX_SMEM
            assert mxu_level.base_plan_args(field, m, B, sms) == (
                p.kt, p.k_pad, p.m_pad, p.blocks, p.smem_bytes)


def _k1_launch_shapes(log_n: int, peel: int) -> set:
    """(m, B) of K1, the last base of an n-point four-step that peels
    ``peel`` points a level."""
    m = 1 << log_n
    while m > peel:
        m //= peel
    return {(m, (1 << log_n) // m)} if m >= 2 else set()


@pytest.mark.parametrize("W", [1, 2, 8])
def test_every_column_in_exactly_one_block(W):
    """The blocks' spans of tiles partition the column tiles (contiguous,
    none empty, none overlapping) at every short K1 launch of the
    transforms of 2^11 ... 2^28 points (peel 32 and 64; a tile holds
    columns 128 t .. 128 t + 127 below B); column by column at ragged B
    (the tail tile's columns past B masked)."""
    field = FIELD_OF_WIDTH[W]
    shapes = set()
    for log_n in range(11, 29):
        for peel in (32, 64):
            shapes |= _k1_launch_shapes(log_n, peel)
    short = {(m, B) for m, B in shapes if mxu_level.short_form(field, m)}
    assert short and all(B >= 1 << 9 for _, B in short)
    if W == 8:
        assert {(2, 1 << 25), (4, 1 << 20), (4, 1 << 25)} <= short
    for m, B in sorted(short):
        for sms in (132, 4):
            p = mxu_level.base_plan(field, m, B, sms)
            runs = [_block_tiles(p, blk) for blk in range(p.blocks)]
            assert all(len(r) > 0 for r in runs)
            starts = [0] + [r.stop for r in runs[:-1]]
            assert [r.start for r in runs] == starts
            assert runs[-1].stop == p.col_tiles
    for B in (1, 37, 127, 129, 1000, 2 * 4 * COLS - 1, 5 * 4 * COLS + 77):
        p = mxu_level.base_plan(field, 2, B, 4)
        seen = np.zeros(B, dtype=np.int64)
        for blk in range(p.blocks):
            for t in _block_tiles(p, blk):
                cols = np.arange(t * COLS, (t + 1) * COLS)
                np.add.at(seen, cols[cols < B], 1)
        assert (seen == 1).all()


def _short_digit_words(x, field, b0, k_pad):
    """The digit tile of the tile at columns b0 .. b0 + 127 as the kernel's
    tasks write it (``short_digits``), as int64[128, k_pad] bytes by
    contraction index: at m = 2 word p of a column holds the digits 2p,
    2p + 1 of rows 0 and 1 (the lower half of the block writes the first
    HALF words, the upper half the rest and the zero tail); above, as the
    other kernels' ``stage_tile`` writes it, digit j of rows i0 .. i0 + 3
    in the word at j * m + i0 and zeros past D * m; zero in the columns at
    or past B."""
    W, m, B = x.shape
    D = tdigits.n_digits(field)
    cols = torch.arange(b0, b0 + COLS)
    valid = cols < B
    d = torch.zeros((D, m, COLS), dtype=torch.int64)
    d[:, :, valid] = tdigits.extract_digits(
        x[:, :, cols[valid]], field).to(torch.int64)
    tile = torch.full((COLS, k_pad), -1, dtype=torch.int64)

    def put(c, four):               # one word: bytes c .. c + 3
        assert c % 4 == 0 and bool((tile[:, c:c + 4] == -1).all())
        tile[:, c:c + 4] = torch.stack(four, dim=1)
    zero = torch.zeros(COLS, dtype=torch.int64)
    if m == 2:
        pairs = (D + 1) // 2
        half = (pairs + 1) // 2
        for p in list(range(half)) + list(range(half, pairs)):
            j = 2 * p
            odd = [d[j + 1, 0], d[j + 1, 1]] if j + 1 < D else [zero, zero]
            put(4 * p, [d[j, 0], d[j, 1], *odd])
        for u in range(pairs, k_pad // 4):
            put(4 * u, [zero] * 4)
    else:
        for i0 in range(0, m, 4):
            for j in range(D):
                put(j * m + i0, [d[j, i0 + t] for t in range(4)])
        for c in range(D * m, k_pad, 4):
            put(c, [zero] * 4)
    assert bool((tile >= 0).all()), "a byte no task wrote"
    return tile


def emulated_short_base(x, field, A, sms=mxu_level.TC_SMS):
    """K1's short form, block by block as the kernel runs it: the matrix
    staged once a block as 160 GEMM rows (zero past E * m rows and D * m
    bytes), then for each tile of the block's span the digit tile of the
    tasks' words, each warpgroup's 64 columns contracted against the whole
    matrix in 32-deep steps with int32 sums, the E * m rows of the valid
    columns reduced. Every column is formed once."""
    W, m, B = x.shape
    D, E = tdigits.n_digits(field), tdigits.out_planes(field)
    p = mxu_level.base_plan(field, m, B, sms)
    assert p.m_pad == ROWS, "not a short-form shape"
    Z = torch.full((E * m, B), -1, dtype=torch.int64)
    for blk in range(p.blocks):
        mat = torch.zeros((ROWS, p.k_pad), dtype=torch.int32)
        mat[:E * m, :D * m] = A.to(torch.int32)
        for t in _block_tiles(p, blk):
            b0 = t * COLS
            dig = _short_digit_words(x, field, b0, p.k_pad).to(torch.int32)
            cols = torch.arange(b0, b0 + COLS)
            valid = cols < B
            acc = torch.zeros((COLS, ROWS), dtype=torch.int32)
            for g in range(COLS // 64):     # the warpgroups' column halves
                rows = slice(g * 64, (g + 1) * 64)
                for kb in range(p.k_pad // BK):
                    ks = slice(kb * BK, (kb + 1) * BK)
                    acc[rows] += dig[rows, ks] @ mat[:, ks].T
            assert bool((Z[:, cols[valid]] == -1).all())
            Z[:, cols[valid]] = acc[valid, :E * m].T.to(torch.int64)
    assert bool((Z >= 0).all()), "a (row, column) no block formed"
    F = (torch.from_numpy(tmxu._fold_matrix(field, m))
         if tdigits.fold_active(field) else None)
    return tdigits.recompose_reduce(Z.reshape(E, m, B), field,
                                    mxu_level._zmax_bits(field, m),
                                    fold_mat=F)


@pytest.mark.parametrize("W, m, B, sms", [
    (8, 2, 300, 132),        # depth 74 -> 96: three tiles, one a block
    (8, 2, 129, 1),          # one block of two tiles, the second one column
    (8, 4, 200, 1),          # depth 148 -> 160, a ragged second tile
    (2, 8, 1000, 2),         # spans of two tiles, the last block one
    (2, 2, 37, 132),
    (1, 16, 513, 1),         # depth 80 -> 96, five tiles in one block
    (1, 4, 257, 132),
])
def test_emulated_short_base_equals_plain(W, m, B, sms):
    field = FIELD_OF_WIDTH[W]
    x = _words(field, (m, B), 7 * m + W)
    mats = {k: torch.from_numpy(v)
            for k, v in tmxu._mats_for(field, {m}, False).items()}
    want = mxu_ntt.base_ntt_mxu_plain(x, field, mats[m], mats.get(-m))
    assert torch.equal(emulated_short_base(x, field, mats[m], sms), want)

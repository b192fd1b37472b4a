"""The persistent form of the 256-bit tensor-core level
(``csrc/mxu_persist.cu``; ``mxu_level.persist_plan``): W = 8 at m = 32, one
block an SM walking 128-column tiles grid-stride, the digit tile staged once
a tile for its eight row chunks of four rows, two warpgroups on the tile's
column halves, each chunk reduced from the accumulator registers while the
next chunk's wgmma steps run.

The kernel runs only on the card; what surrounds its arithmetic is held
here on the CPU: the plan the wrappers pass (the shapes it takes and the
ones it leaves to the present form, its shared-memory and register
budget), the grid-stride walk and the ring's step order, and a numpy/torch
emulation of the block's dataflow (the chunk's GEMM rows e * 4 + kk, the
m64n160k32 accumulator fragment of each thread, the lane-pair exchange of
the even and odd planes, the chunk order) against the plain versions of K1,
K2, K3 and K4, word for word. The plain versions are held against the JAX
entries in interpret mode by ``test_torch_tc_plan.py`` and the files it
names.
"""

import numpy as np
import pytest
import torch

import ntt_tpu_torch.fields as tfields
from ntt_tpu_torch import digits as tdigits
from ntt_tpu_torch.kernels import mxu_level, mxu_ntt
from ntt_tpu_torch.transforms import mxu as tmxu

torch.set_num_threads(1)

F8 = tfields.BLS12_381_FR
N, BK, NR = mxu_level.TC_COLS, mxu_level.TC_BK, mxu_level.TC_ROWS_PAD // 2
#: the kernel's threads: two warpgroups
THREADS = 2 * 128


def _words(field, shape, seed):
    """Canonical random elements as uint32[W, *shape] (top word < p's)."""
    rng = np.random.default_rng(seed)
    W = field.n_words
    x = rng.integers(0, 1 << 32, size=(W,) + shape, dtype=np.uint64)
    x[W - 1] = rng.integers(0, field.p >> (32 * (W - 1)), size=shape,
                            dtype=np.uint64)
    return torch.from_numpy(x.astype(np.uint32))


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B, sms", [(1 << 17, 132), (1 << 23, 132),
                                    (1 << 17, 114), (2048, 4)])
def test_plan_fits_the_sm(B, sms):
    """Shared bytes: the digit tile (128 columns x 1184), 4 ring stages of
    152 rows x 128 bytes (TMA boxes of four wgmma steps), the 8 rows the
    last stage's wgmma reads past its end, the slack that aligns the base
    to a 1 KB swizzle atom; with the 16 barriers within the block's
    232,448. Registers: 256 threads at one block an SM, two warps on each
    of the SM's four sub-partitions (16,384 registers each), get the 255
    a thread may hold, above the two accumulator sets and the epilogue's
    37 planes (a warp more would leave 168). Blocks: one an SM, never more
    than the tiles."""
    plan = mxu_level.persist_plan(F8, 32, B, sms=sms)
    D, E = tdigits.n_digits(F8), tdigits.out_planes(F8)
    swz = mxu_level.PERSIST_SWIZZLE
    assert (plan.kt, plan.k_pad, plan.stages) == (4, D * 32, 4) and swz == 128
    rows = -(-E * plan.kt // 8) * 8
    assert rows == 152 and E * plan.kt <= NR
    assert plan.smem_bytes == (8 * swz + N * D * 32 + 4 * rows * swz
                               + (NR - rows) * swz) == 231424
    assert 4 * rows * swz == mxu_level.PERSIST_RING_BYTES
    assert plan.smem_bytes + plan.stages * 8 <= mxu_level.TC_MAX_SMEM

    def regs(threads):      # a thread's registers, its warps dealt to 4
        per_part = -(-threads // 32 // 4)       # sub-partitions
        return min(255, 16384 // (per_part * 32) // 8 * 8)
    assert regs(THREADS) == 255 and regs(THREADS + 32) == 168
    assert 2 * NR // 2 + E <= regs(THREADS)
    assert plan.col_tiles == -(-B // N)
    assert plan.blocks == min(sms, plan.col_tiles)
    assert plan.col_tiles > mxu_level.PERSIST_WAVES * sms


@pytest.mark.parametrize("field, m, B, rep, transpose", [
    (tfields.GOLDILOCKS, 32, 1 << 20, None, False),   # W = 2
    (tfields.SMALL, 32, 1 << 20, None, False),        # W = 1
    (F8, 64, 1 << 20, None, False),                   # m = 64 (BASE_LOG 6)
    (F8, 16, 1 << 20, None, False),
    (F8, 32, 1 << 20, None, True),                    # the transposed store
    (F8, 32, 1 << 20, 64, False),                     # an entry of half a tile
    (F8, 32, 1 << 14, None, False),                   # 128 tiles: one wave
    (F8, 32, 8192, 256, False),                       # 64 tiles: 2^18's levels
])
def test_plan_leaves_the_rest_to_the_present_form(field, m, B, rep,
                                                  transpose):
    assert mxu_level.persist_plan(field, m, B, rep, transpose) is None


def test_plan_takes_the_cells_levels():
    """Every m = 32 level of the 2^22 transform (K2 levels 0, 2, 3 with
    their stacks of 32, 128, 4 entries, K3 level 1 on the merged table),
    of the 2^20 one (256 tiles, two waves) and the 2^30 local step's K3
    launches on one of four cards take the persistent form; the 2^22 base
    (m = 4, K1's short form) and the 2^18 levels (64 tiles) do not."""
    plan = tmxu.matfold_plan(F8, 1 << 22)
    assert plan == [("stack", (1 << 22, 32, 1 << 17)),
                    ("batch", (1 << 17, 32, 4096)),
                    ("stack", (4096, 32, 128)), ("stack", (128, 32, 4))]
    for rep in (4096, None, 1024, 32768):   # level 0's s0, then n / m_l
        assert mxu_level.persist_plan(F8, 32, 1 << 17, rep) is not None
    assert mxu_level.persist_plan(F8, 32, 1 << 23) is not None
    for _, (m_l, n1, n2) in tmxu.matfold_plan(F8, 1 << 20):
        assert mxu_level.persist_plan(F8, n1, (1 << 20) // n1) is not None
    assert mxu_level.persist_plan(F8, 4, 1 << 20) is None
    for _, (m_l, n1, n2) in tmxu.matfold_plan(F8, 1 << 18):
        assert mxu_level.persist_plan(F8, n1, (1 << 18) // n1) is None


# ---------------------------------------------------------------------------
# The walk
# ---------------------------------------------------------------------------

def _walk(tiles: int, blocks: int):
    """(block, local tile index, tile) in the order each block walks them."""
    return [(blk, li, t) for blk in range(blocks)
            for li, t in enumerate(range(blk, tiles, blocks))]


NB = -(-37 // (mxu_level.PERSIST_SWIZZLE // BK))     # boxes a chunk


def _box(g: int):
    """(li, c, q) of the block's ring box g as ``Ring.issue`` decodes it."""
    return g // (8 * NB), g % (8 * NB) // NB, g % NB


@pytest.mark.parametrize("tiles, blocks", [(1024, 132), (8192, 132),
                                           (1000, 114), (9, 4)])
def test_walk_covers_every_tile_and_chunk_once(tiles, blocks):
    """Grid-stride: every column tile by one block, neighbouring tiles on
    neighbouring blocks at the same time; the row chunks of a tile in
    order, each by both warpgroups (a column half each); the ring's boxes
    g = 0, 1, 2, ... in that order, NB of 4 wgmma steps a chunk (the last
    one step, zero-filled past the depth), so that a warpgroup waiting on
    box g waits on stage g % 4 for phase g / 4, the block done with box
    g - 4, whose last warp loaded box g."""
    chunks, nk, spb = 32 // mxu_level.PERSIST_KT, 37, 4
    assert NB == 10 and nk - (NB - 1) * spb == 1
    walk = _walk(tiles, blocks)
    seen = {}
    for blk, li, t in walk:
        for c in range(chunks):
            assert (t, c) not in seen
            seen[t, c] = blk
    assert len(seen) == tiles * chunks
    assert all(seen[t, 0] == t % blocks for t in range(tiles))
    mine = {}
    for blk, li, _ in walk:
        mine.setdefault(blk, []).append(li)
    for lis in mine.values():
        order = [(li, c, q) for li in lis for c in range(chunks)
                 for q in range(NB)]
        assert [_box(g) for g in range(len(order))] == order
        steps = [q * spb + j for li, c, q in order[:NB]
                 for j in range(min(spb, nk - q * spb))]
        assert steps == list(range(nk))


# ---------------------------------------------------------------------------
# The block's dataflow
# ---------------------------------------------------------------------------

def _fragment(Zc):
    """The accumulators of the 128 threads of a consumer warpgroup for one
    column half of a chunk's sums Zc [160, 64] (GEMM row, column): register
    i of thread (warp w4, lane) holds row 8 (i / 4) + 2 (lane % 4) + i % 2,
    column w4 * 16 + lane / 4 + 8 ((i / 2) % 2), the wgmma m64nNk32 D
    fragment with the digits on the M side."""
    t = np.arange(128)[:, None]
    i = np.arange(NR // 2)[None, :]
    lane, w4 = t % 32, t // 32
    row = 8 * (i // 4) + 2 * (lane % 4) + i % 2
    col = w4 * 16 + lane // 4 + 8 * ((i // 2) % 2)
    return Zc[row, col]


def _exchange(regs, E: int):
    """The epilogue's planes from one column half's registers [128, 80]:
    for each thread and row h, lanes l and l ^ 2 swap the planes of the
    column the other keeps (the even-plane lanes keep column + 0, the odd
    ones column + 8); returns z [128, 2, E] and each thread's (kk, column
    in the half) for h = 0, 1."""
    t = np.arange(128)
    lane = t % 32
    par = (lane >> 1) & 1
    z = np.zeros((128, 2, E), dtype=np.int64)
    for h in range(2):
        for j in range((E + 1) // 2):
            a0, a1 = regs[:, 4 * j + h], regs[:, 4 * j + 2 + h]
            sent = np.where(par == 1, a0, a1)
            got = sent[t ^ 2]
            z[:, h, 2 * j] = np.where(par == 1, got, a0)
            if 2 * j + 1 < E:
                z[:, h, 2 * j + 1] = np.where(par == 1, a1, got)
    kk = 2 * (lane & 1)[:, None] + np.arange(2)[None, :]
    col = ((t // 32) * 16 + lane // 4 + 8 * par)[:, None].repeat(2, 1)
    return z, kk, col


def _emulated_planes(x3, As, rep: int, blocks: int = 3, seed: int = 0):
    """The 37 planes of every output [E, 32, B] as the persistent block
    forms them: tiles walked by ``blocks`` blocks, per tile the digit tile
    (zero past B), per chunk c (in order) its 148 GEMM rows e * 4 + kk of
    the tile's stack entry b0 / rep (garbage in the 12 padding rows), the
    sums of 37 wgmma steps in 10 boxes in int32, then for each column half
    (a warpgroup) each thread's fragment, the lane-pair exchange and the
    planes placed at (kk, b)."""
    W, m, B = x3.shape
    D, E, kt = tdigits.n_digits(F8), tdigits.out_planes(F8), 4
    rng = np.random.default_rng(seed)
    d = tdigits.extract_digits(x3, F8).reshape(D * m, B).numpy()
    out = np.full((E, m, B), -1, dtype=np.int64)
    tiles = -(-B // N)
    for _, _, t in _walk(tiles, blocks):
        b0 = t * N
        cols = np.arange(b0, b0 + N)
        dig = np.zeros((N, D * m), dtype=np.int64)
        dig[cols < B] = d[:, cols[cols < B]].T
        A = As[b0 // rep].numpy().astype(np.int64)
        for c in range(m // kt):
            ring = rng.integers(0, 128, size=(NR, D * m))
            rows = [e * m + c * kt + kk for e in range(E)
                    for kk in range(kt)]
            ring[:E * kt] = A[rows]
            Zc = np.zeros((NR, N), dtype=np.int64)
            for q in range(NB):             # the chunk's boxes of 4 steps
                for k in range(q * 4, min(q * 4 + 4, D * m // BK)):
                    Zc += (ring[:, k * BK:(k + 1) * BK]
                           @ dig[:, k * BK:(k + 1) * BK].T)
            assert Zc.max() < 1 << 31
            for h2 in range(2):
                z, kk, col = _exchange(_fragment(Zc[:, h2 * 64:h2 * 64 + 64]),
                                       E)
                b = b0 + h2 * 64 + col
                keep = b < B
                k = c * kt + kk
                assert (out[:, k[keep], b[keep]] == -1).all()
                out[:, k[keep], b[keep]] = z[keep].T
    assert (out >= 0).all(), "an output no thread formed"
    return torch.from_numpy(out)


def _emulated(x3, As, rep, F, T3=None, F2=None):
    """The emulated block's words: its planes, then the reduction and the
    twiddle product of the plain versions (the kernel's reduce<8> and
    mont_mul<8> reach the same canonical words, mxu_core.cuh)."""
    y = tdigits.recompose_reduce(_emulated_planes(x3, As, rep), F8,
                                 mxu_level._zmax_bits(F8, 32), fold_mat=F)
    return y if T3 is None else mxu_level._twiddle_product(y, T3, F8, F2)


def _stack(NT, seed):
    rng = np.random.default_rng(seed)
    tvals = [[int(v) % F8.p for v in rng.integers(1, 1 << 62, size=32)]
             for _ in range(NT)]
    return torch.from_numpy(tmxu.twiddle_matrix_stack(F8, 32, False, tvals))


def _mats():
    return {k: torch.from_numpy(v)
            for k, v in tmxu._mats_for(F8, {32}, False).items()}


@pytest.mark.parametrize("NT, rep, t3", [(2, 128, None), (2, 256, "periodic"),
                                         (1, 300, "batch")])
def test_emulated_stack_equals_plain(NT, rep, t3):
    """K2: an entry of one or two tiles, no T3, the periodic residual
    [8, 32, 128] read at b mod 128, or a batch-resolution T3 with a
    ragged last tile."""
    B = NT * rep
    x = _words(F8, (32, B), NT + rep)
    As = _stack(NT, rep)
    F = torch.from_numpy(tmxu._fold_matrix(F8, 32))
    T3 = (None if t3 is None else
          _words(F8, (32, 128 if t3 == "periodic" else B), 9))
    want = mxu_level.fused_level_stack_plain(x, F8, As, rep, F, T3)
    full = None if T3 is None else T3[:, :, torch.arange(B) % T3.shape[2]]
    assert torch.equal(_emulated(x, As, rep, F, full), want)


def _twiddle_at(T3, rep: int, B: int):
    """K3's twiddle as the epilogue reads it (``load_twiddle``): word q of
    (k, b) at (q * 32 + k) * B + b for rep 1, at (q * (B / rep) + b / rep)
    * 32 + k for rep > 1."""
    flat = T3.reshape(-1)
    q = torch.arange(8)[:, None, None]
    k = torch.arange(32)[None, :, None]
    b = torch.arange(B)[None, None, :]
    return flat[(q * 32 + k) * B + b if rep == 1
                else (q * (B // rep) + b // rep) * 32 + k]


@pytest.mark.parametrize("B, rep", [(256, 1), (384, 8)])
def test_emulated_subntt_equals_plain(B, rep):
    """K3 single-level: the merged batch-resolution table (rep 1) and an
    i2-resolution table (rep > 1), as at the 2^22 and the 2^30 levels."""
    x = _words(F8, (32, B), B + rep)
    mats = _mats()
    T3 = _words(F8, (32, B) if rep == 1 else (B // rep, 32), rep)
    want = mxu_level.fused_subntt_plain(x, F8, False, mats, T3, rep=rep)
    got = _emulated(x, mats[32][None], B, mats[-32], _twiddle_at(T3, rep, B),
                    mats[-1])
    assert torch.equal(got, want)


def test_emulated_level_and_base_equal_plain():
    """K4 (T3 at batch resolution, the direct store) and K1's long form
    (no twiddle) from the same body."""
    B = 200
    x = _words(F8, (32, B), 4)
    T3 = _words(F8, (32, B), 5)
    mats = _mats()
    A = mats[32]
    want = mxu_level.fused_level_plain(x, F8, A, T3, False, mats[-32],
                                       mats[-1])
    assert torch.equal(_emulated(x, A[None], B, mats[-32], T3, mats[-1]),
                       want)
    assert torch.equal(_emulated(x, A[None], B, mats[-32]),
                       mxu_ntt.base_ntt_mxu_plain(x, F8, A, mats[-32]))

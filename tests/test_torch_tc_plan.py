"""The launch plan of the tensor-core levels K1 (``base_ntt_mxu``), K2
(``fused_level_stack``), K3 single-level (``fused_subntt``, m <= 64), K4
(``fused_level``) and K7 (``fused_level_probe``), and a torch emulation of
their tiled contraction, of the epilogue's twiddle read and of K7's five
stages read from the swizzled digit tile and the Z tile, on the CPU; the
launch plan of the multi-level K3 (m = 64 .. 512: every (k1, b) of level A
and every (k2, k1, b) of level B formed by exactly one block, the shared
tiles within the block).

The CUDA kernels (``csrc/mxu_core.cuh``, ``tc::contract``) run only on the
card; what surrounds their arithmetic is held here: the plan the wrappers
pass to the C launcher (row chunks, padded depth and rows, column tiles,
shared bytes), and the block-by-block dataflow the kernels follow (a zero-
padded digit tile per column tile, the chunk's conv-matrix rows gathered in
GEMM row order e * kt + kk, the depth in 32-deep ring steps with int32
sums, one pass per stack entry with the other entries' columns zeroed;
at m = 64 the digit tile streamed over the depth in two passes of 32 rows,
the ring's steps taken in the passes' order and the sums carried from one
pass to the next; K3's twiddle read at (b / rep) * m + k of the table
[W, B / rep, m] for rep > 1). The emulation must give the plain versions'
canonical words: the tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

import ntt_tpu_torch.fields as tfields
from ntt_tpu_torch import digits as tdigits
from ntt_tpu_torch.kernels import mxu_level, mxu_ntt
from ntt_tpu_torch.transforms import core as tcore
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


@pytest.mark.parametrize("m", [2, 4, 8, 16, 32, 64])
@pytest.mark.parametrize("W", [1, 2, 8])
def test_plan_fits_the_block_and_covers_the_level(W, m):
    field = FIELD_OF_WIDTH[W]
    D, E = tdigits.n_digits(field), tdigits.out_planes(field)
    P = mxu_level.tc_passes(m)
    for B in (1, 37, 64, 300, 8192, 32768):
        plan = mxu_level.tc_plan(field, m, B)
        assert plan.smem_bytes <= 232448
        assert plan.k_pad >= D * m and plan.k_pad % 32 == 0
        if P > 1:   # streamed: unpadded depth, a row chunk in one pass
            assert plan.k_pad == D * m and 32 % plan.kt == 0
            assert plan.smem_bytes == mxu_level.tc_plan(field, 32,
                                                        B).smem_bytes
        assert plan.m_pad == mxu_level.TC_ROWS_PAD >= E * plan.kt
        assert plan.m_pad % 32 == 0     # two wgmma N halves, multiples of 16
        rows = [r for c in range(plan.chunks)
                for r in _chunk_rows(E, m, plan, c)]
        assert sorted(rows) == list(range(E * m))
        cols = mxu_level.TC_COLS
        assert (plan.col_tiles - 1) * cols < B <= plan.col_tiles * cols
        assert plan.blocks == plan.chunks * plan.col_tiles


def _k1_k3_shapes(n: int, base_max: int) -> set:
    """(m, B) of every single-level K1 / K3 launch of an n-point four-step
    that peels ``base_max`` points a level: each level's column transform
    of base_max (when that is at most 64) over n / base_max columns, and
    the last base."""
    shapes = set()
    m = n
    while m > base_max:
        if base_max <= 64:
            shapes.add((base_max, n // base_max))
        m //= base_max
    if 2 <= m <= 64:
        shapes.add((m, n // m))
    return shapes


@pytest.mark.parametrize("W", [1, 2, 8])
def test_plan_at_the_k1_k3_launch_shapes(W):
    """Every single-level K1 / K3 launch of the transforms from 2^14 to
    2^24 (``mxu_chunked`` peels 32 points a level, 64 under
    NTT_MXU_BASE_LOG=6, ``mxu_sub`` 512 on the narrow fields; the local
    transforms of n1 and n2 points of a dist transform on 2, 4 or 8
    shards), and batches below one column tile, have a plan that fits the
    block and that the launcher's checks accept."""
    field = FIELD_OF_WIDTH[W]
    D, E = tdigits.n_digits(field), tdigits.out_planes(field)
    shapes = set()
    for log_n in range(14, 25):
        n = 1 << log_n
        shapes |= _k1_k3_shapes(n, 32)
        shapes |= _k1_k3_shapes(n, 64)
        shapes |= _k1_k3_shapes(n, tmxu.effective_subbase(field))
        for part in tcore.split_log(n):     # a shard's local transforms
            for shards in (2, 4, 8):
                shapes |= {(m, Bp * (n // part) // shards)
                           for m, Bp in _k1_k3_shapes(part, 32)}
    shapes |= {(m, B) for m in (2, 4, 8, 16, 32, 64)
               for B in (1, 2, 100, 127)}
    assert (8, 32768) in shapes and (32, 1 << 19) in shapes
    assert (16, 1 << 20) in shapes and (4, 1 << 20) in shapes
    assert (64, 1 << 18) in shapes
    N = mxu_level.TC_COLS
    for m, B in sorted(shapes):
        plan = mxu_level.tc_plan(field, m, B)
        assert plan.kt == min(m, mxu_level.TC_KT[W])
        assert plan.chunks * plan.kt == m
        assert plan.blocks == -(-B // N) * (m // plan.kt) <= 0x7FFFFFFF
        assert plan.k_pad >= D * m and plan.k_pad % mxu_level.TC_BK == 0
        assert m <= 32 or plan.k_pad == D * m
        assert E * plan.kt <= plan.m_pad == mxu_level.TC_ROWS_PAD
        assert plan.smem_bytes <= mxu_level.TC_MAX_SMEM
        assert mxu_level.plan_args(field, m, B) == (
            plan.kt, plan.k_pad, plan.m_pad, plan.blocks, plan.smem_bytes)


def test_plan_refuses_what_the_kernel_cannot_take():
    bls = tfields.BLS12_381_FR
    four_words = tfields.Field("m127", (1 << 127) - 1, 3, 1)
    for field, m, B in ((four_words, 32, 64), (bls, 128, 64), (bls, 12, 64),
                        (bls, 32, 0)):
        with pytest.raises(ValueError):
            mxu_level.tc_plan(field, m, B)


def _pass_digits(d, h, P):
    """The operand of pass h of P (``tc::stage_digits``): digit j of row
    h * m/P + i at contraction index j * m/P + i; d: [D, m, B]."""
    D, m, B = d.shape
    rp = m // P
    return d[:, h * rp:(h + 1) * rp].reshape(D * rp, B)


def _emulated_z(x3, field, As, rep):
    """Z int64[E*m, B] formed block by block as the kernels form it: per
    stack entry and pass, the pass's digit tile, then its ring steps j at
    contraction bytes (j * P + h) * 32, the sums carried in int32."""
    W, m, B = x3.shape
    D, E = tdigits.n_digits(field), tdigits.out_planes(field)
    plan = mxu_level.tc_plan(field, m, B)
    N, BK = mxu_level.TC_COLS, mxu_level.TC_BK
    P = mxu_level.tc_passes(m)
    nk = plan.k_pad // BK // P              # ring steps a pass
    d = tdigits.extract_digits(x3, field).to(torch.int32)
    Z = torch.full((E * m, B), -1, dtype=torch.int64)
    for blk in range(plan.blocks):
        tile, chunk = divmod(blk, plan.chunks)
        cols = torch.arange(tile * N, tile * N + N)
        valid = cols < B
        rows = _chunk_rows(E, m, plan, chunk)
        acc = torch.zeros((plan.m_pad, N), dtype=torch.int32)
        last = int(cols[valid][-1])
        for s in range(int(cols[0]) // rep, last // rep + 1):
            ring = torch.zeros((plan.m_pad, plan.k_pad), dtype=torch.int32)
            ring[:len(rows), :D * m] = As[s][rows].to(torch.int32)
            for h in range(P):
                dp = _pass_digits(d, h, P)
                dig = torch.zeros((N, nk * BK), dtype=torch.int32)
                dig[valid, :dp.shape[0]] = dp[:, cols[valid]].T
                frag = dig * (cols // rep == s)[:, None]
                for j in range(nk):
                    c0 = (j * P + h) * BK
                    acc += (ring[:, c0:c0 + BK]
                            @ frag[:, j * BK:(j + 1) * BK].T)
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
    return torch.from_numpy(tmxu.twiddle_matrix_stack(field, m, False, tvals))


@pytest.mark.parametrize("W, m, NT, rep, with_t3", [
    (8, 4, 4, 7, True),      # depth 148 -> 160; one column tile, 4 entries
    (2, 32, 5, 16, False),   # two row chunks; a ragged second column tile
    (1, 2, 3, 16, True),     # depth 10 -> 32
    (8, 64, 2, 70, True),    # streamed depth: 2 passes x 37 steps, 8 chunks
    (2, 64, 3, 48, False),   # 2 passes x 10 steps, 4 chunks
    (1, 64, 2, 100, True),   # 2 passes x 5 steps, 2 chunks
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
    (8, 64, 130, True),      # two passes, two column tiles
    (1, 64, 37, False),
    (2, 64, 200, True),
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


def _emulated_twiddle(T3, rep: int, m: int, B: int):
    """The twiddle at [W, m, B] read element by element as the epilogue
    reads it: word q of (k, b) at flat index (q * m + k) * B + b of the
    table for rep == 1, at (q * (B / rep) + b / rep) * m + k for rep > 1."""
    W = T3.shape[0]
    flat = T3.reshape(-1)
    q = torch.arange(W)[:, None, None]
    k = torch.arange(m)[None, :, None]
    b = torch.arange(B)[None, None, :]
    if rep == 1:
        at = (q * m + k) * B + b
    else:
        at = (q * (B // rep) + b // rep) * m + k
    return flat[at]


@pytest.mark.parametrize("W, m, B, rep", [
    (8, 32, 512, 32),        # 2^14 level 1: four column tiles of 16 rows
    (8, 8, 300, 1),          # ragged B, the whole chunk by cp.async
    (2, 16, 300, 25),        # a rep that divides no column tile
    (1, 4, 256, 128),        # one table row a column tile
    (8, 64, 256, 64),        # BASE 64: 2^14 level 1, two passes
    (2, 64, 300, 1),
    (1, 64, 200, 25),
])
def test_emulated_subntt_equals_plain(W, m, B, rep):
    """K3 single-level: the tiled contraction, the reduction and the
    epilogue's twiddle read give ``fused_subntt_plain``'s words, for the
    batch-resolution table (rep 1) and the i2-resolution one (rep > 1)."""
    field = FIELD_OF_WIDTH[W]
    x = _words(field, (m, B), 11 * m + W)
    T3 = _words(field, (m, B) if rep == 1 else (B // rep, m), rep)
    mats = {k: torch.from_numpy(v)
            for k, v in tmxu._mats_for(field, {m}, False).items()}
    want = mxu_level.fused_subntt_plain(x, field, mats, T3, rep=rep)
    got = _emulated_level(x, field, mats[m][None], B, mats.get(-m),
                          _emulated_twiddle(T3, rep, m, B), mats.get(-1))
    assert torch.equal(got, want)


@pytest.mark.parametrize("W, m, B", [(8, 4, 200), (2, 32, 130),
                                     (8, 64, 129), (2, 64, 64), (1, 64, 300)])
def test_emulated_base_equals_plain(W, m, B):
    """K1: the tensor-core level with no twiddle gives
    ``base_ntt_mxu_plain``'s words."""
    field = FIELD_OF_WIDTH[W]
    x = _words(field, (m, B), 5 * m + W)
    mats = {k: torch.from_numpy(v)
            for k, v in tmxu._mats_for(field, {m}, False).items()}
    want = mxu_ntt.base_ntt_mxu_plain(x, field, mats[m], mats.get(-m))
    got = _emulated_level(x, field, mats[m][None], B, mats.get(-m))
    assert torch.equal(got, want)


#: the multi-level K3's plans (``sub_plan`` at B = 300, W = 1, 2, 8) as they
#: were before the single-level kernels took m = 64: its launches stay as
#: they were
SUB_PLANS_300 = {
    (1, 64): (32, 2, 64, 160, 32, 320, 1, 5, 5, 2048, 152064, 168704),
    (1, 128): (32, 4, 32, 160, 32, 320, 1, 10, 10, 1024, 152064, 168704),
    (1, 256): (32, 8, 16, 160, 64, 320, 1, 19, 19, 528, 152064, 169216),
    (1, 512): (32, 16, 8, 160, 96, 320, 1, 38, 38, 264, 152064, 169216),
    (2, 64): (16, 2, 64, 320, 32, 320, 2, 5, 10, 1024, 160512, 177152),
    (2, 128): (16, 4, 32, 320, 64, 320, 2, 10, 20, 512, 160512, 177152),
    (2, 256): (16, 8, 16, 320, 96, 320, 2, 19, 38, 272, 160512, 178176),
    (2, 512): (16, 16, 8, 320, 160, 320, 2, 38, 76, 136, 160512, 178176),
    (8, 64): (4, 2, 64, 1184, 96, 320, 8, 5, 40, 256, 180736, 197376),
    (8, 128): (4, 4, 32, 1184, 160, 320, 8, 10, 80, 128, 180736, 197376),
    (8, 256): (4, 8, 16, 1184, 320, 320, 8, 19, 152, 80, 180736, 201472),
    (8, 512): (4, 8, 8, 1184, 608, 320, 8, 38, 304, 40, 180736, 201472),
}


def test_sub_plan_unchanged_at_m_64_to_512():
    for (W, m), want in SUB_PLANS_300.items():
        assert tuple(mxu_level.sub_plan(FIELD_OF_WIDTH[W], m, 300)) == want


def test_single_level_takes_m_64_where_the_plan_has_its_matrix(monkeypatch):
    """K3 at m = 64 is the single-level kernel exactly where the plan's
    mats hold the 64-point matrix: under NTT_MXU_BASE_LOG=6 (as the JAX
    package's kernel, which contracts m <= BASE as one matrix), and the
    multi-level kernel (peel 32) at the default BASE, whose plans read the
    32- and 2-point matrices."""
    bls = tfields.BLS12_381_FR
    assert mxu_level.single_level(32, {}) and not mxu_level.single_level(
        64, {32: 0, 2: 0}) and mxu_level.single_level(64, {64: 0})
    assert not mxu_level.single_level(128, {128: 0})
    for base, one in ((16, 32), (32, 32), (64, 64), (128, 64)):
        monkeypatch.setattr(tmxu, "BASE", base)
        assert tmxu.single_level_max() == one
        sizes = tmxu.kernel_sizes({64, 512})
        assert sizes == ({64, 32, 16} if one == 64 else {32, 2, 16})
        assert mxu_level.single_level(64, dict.fromkeys(sizes)) == (
            one == 64)
    monkeypatch.setattr(tmxu, "BASE", 64)
    assert 64 in tmxu.base_mats(bls, 1 << 12)
    assert tmxu.sub_mats(bls, 1 << 12).keys() == {64, -64, -1}


def test_plan_refuses_what_the_kernel_cannot_take_multi():
    """``sub_plan`` refuses what ``launch_sub`` refuses: widths without
    kernels, m outside 64 .. 512 or not a power of two, B < 1."""
    gold = tfields.GOLDILOCKS
    four_words = tfields.Field("m127", (1 << 127) - 1, 3, 1)
    for field, m, B in ((four_words, 64, 64), (gold, 32, 64),
                        (gold, 1024, 64), (gold, 96, 64), (gold, 64, 0)):
        with pytest.raises(ValueError):
            mxu_level.sub_plan(field, m, B)


@pytest.mark.parametrize("m", [64, 128, 256, 512])
@pytest.mark.parametrize("W", [1, 2, 8])
def test_sub_plan_fits_the_block_and_covers_both_levels(W, m):
    """The multi-level K3: level A's 128 virtual columns are the block's bt
    batch columns x m2 rows i2; its row chunks of kt rows k1 and level B's
    row passes of kt2 rows k2 fit the 320 GEMM rows; the contractions and
    the tile Y (after both, rows i2 ``ys`` words apart) fit 227 KiB. Level A
    of the blocks forms every (k1, i2, b) once, level B every (k2, k1, b)
    once, walked as the kernel walks them (ragged B included)."""
    field = FIELD_OF_WIDTH[W]
    D, E = tdigits.n_digits(field), tdigits.out_planes(field)
    m2, N = m // 32, mxu_level.TC_COLS
    for B in (1, 37, 300, 512, 8192, 1 << 18):
        p = mxu_level.sub_plan(field, m, B)
        assert p.bt * m2 == N and p.chunks * p.kt == 32
        assert max(E * p.kt, E * p.kt2) <= p.m_pad == mxu_level.TC_ROWS_PAD
        assert m2 % p.kt2 == 0
        assert p.ka_pad >= D * 32 and p.kb_pad >= D * m2
        assert p.ka_pad % 32 == 0 and p.kb_pad % 32 == 0
        assert p.ys >= p.kt * p.bt and p.y_off % 16 == 0
        assert p.y_off >= max(mxu_level._contract_bytes(D, E, 32, p.kt,
                                                        p.ka_pad),
                              mxu_level._contract_bytes(D, E, m2, p.kt2,
                                                        p.kb_pad))
        assert p.smem_bytes == (mxu_level.TC_ALIGN + p.y_off
                                + W * m2 * p.ys * 4) <= 227 * 1024
        assert (p.col_tiles - 1) * p.bt < B <= p.col_tiles * p.bt
        assert p.blocks == p.chunks * p.col_tiles <= 0x7FFFFFFF
        assert mxu_level.sub_plan_args(field, m, B) == (
            p.kt, p.kt2, p.ka_pad, p.kb_pad, p.m_pad, p.ys, p.y_off,
            p.blocks, p.smem_bytes)
        if B > 300:
            continue
        seen_a = np.zeros((32, m2, B), dtype=np.int64)
        seen_b = np.zeros((m2, 32, B), dtype=np.int64)
        for blk in range(p.blocks):
            tile, chunk = divmod(blk, p.chunks)
            b0, k0 = tile * p.bt, chunk * p.kt
            v = np.arange(N)                      # level A: (i2, bl)
            b = b0 + v % p.bt
            ok = b < B
            for kk in range(p.kt):
                np.add.at(seen_a, (k0 + kk, v[ok] // p.bt, b[ok]), 1)
            for u0 in range(0, p.kt * p.bt, N):   # level B: (k1, bl)
                u = u0 + np.arange(N)
                b = b0 + u % p.bt
                ok = (u < p.kt * p.bt) & (b < B)
                for k2 in range(0, m2, p.kt2):
                    for kk2 in range(p.kt2):
                        np.add.at(seen_b, (k2 + kk2, k0 + u[ok] // p.bt,
                                           b[ok]), 1)
        assert (seen_a == 1).all() and (seen_b == 1).all()


def _digit_tile(d, b0, k_pad):
    """The swizzled digit tile of columns b0 .. b0+127 as the kernels lay it
    out: byte c of column bl at (c / 32) * 4096 + bl * 32 + ((c % 32) ^
    (((bl >> 2) & 1) << 4)); d: int8[K, B], the operand of one pass."""
    K, B = d.shape
    N = mxu_level.TC_COLS
    tile = torch.zeros(k_pad * N, dtype=torch.int64)
    bl = torch.arange(N)[:, None]
    c = torch.arange(K)[None, :]
    at = (c // 32) * (N * 32) + bl * 32 + ((c % 32) ^ (((bl >> 2) & 1) << 4))
    cols = b0 + torch.arange(N)
    valid = cols < B
    vals = torch.zeros((N, K), dtype=torch.int64)
    vals[valid] = d[:, cols[valid]].T.to(torch.int64)
    assert len(set(at.reshape(-1).tolist())) == N * K      # a bijection
    tile[at.reshape(-1)] = vals.reshape(-1)
    return tile, at


@pytest.mark.parametrize("W, m, B", [(8, 32, 200), (2, 8, 300), (1, 2, 37),
                                     (8, 64, 130), (2, 64, 37), (1, 64, 300)])
def test_emulated_probe_stages_equal_plain(W, m, B):
    """K7 on the tensor-core block: ``digits`` read back from the swizzled
    digit tile (at m = 64 the pass that holds the chunk's rows, at
    j * 32 + i - 32h), ``matmul`` the Z tile's rows e * kt + kk for e < W,
    ``reduce`` and ``tw`` (T3 at rep 1) through the same tiled contraction
    give ``fused_level_probe_plain``'s words at every stage."""
    field = FIELD_OF_WIDTH[W]
    D, E = tdigits.n_digits(field), tdigits.out_planes(field)
    x = _words(field, (m, B), 13 * m + W)
    T3 = _words(field, (m, B), 17)
    A = torch.from_numpy(tmxu._base_matrix(field, m))
    plan = mxu_level.tc_plan(field, m, B)
    N = mxu_level.TC_COLS
    P = mxu_level.tc_passes(m)
    rp = m // P
    d = tdigits.extract_digits(x, field)
    sums = torch.full((m, B), -1, dtype=torch.int64)
    for blk in range(plan.blocks):
        tile_i, chunk = divmod(blk, plan.chunks)
        b0 = tile_i * N
        h = chunk * plan.kt // rp              # the pass of the chunk's rows
        tile, at = _digit_tile(_pass_digits(d, h, P), b0, plan.k_pad // P)
        cols = b0 + torch.arange(N)
        valid = cols < B
        for kk in range(plan.kt):
            i = chunk * plan.kt + kk
            got = tile[at[:, [j * rp + i - h * rp
                              for j in range(D)]]].sum(dim=1)
            sums[i, cols[valid]] = got[valid]
    assert bool((sums >= 0).all())
    emulated = {"stream": x.clone(),
                "digits": sums[None].expand(W, m, B).to(torch.uint32)}
    Z = _emulated_z(x, field, A[None], B).reshape(E, m, B)
    emulated["matmul"] = Z[:W].to(torch.uint32)
    F = (torch.from_numpy(tmxu._fold_matrix(field, m))
         if tdigits.fold_active(field) else None)
    y = tdigits.recompose_reduce(Z, field, mxu_level._zmax_bits(field, m),
                                 fold_mat=F)
    emulated["reduce"] = y
    emulated["tw"] = mxu_level._twiddle_product(y, T3, field)
    for stage in mxu_level.PROBE_STAGES:
        want = mxu_level.fused_level_probe_plain(
            x, field, A, stage, T3 if stage == "tw" else None)
        assert torch.equal(emulated[stage], want), stage

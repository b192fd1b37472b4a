"""The wide form of the multi-level K3 (``fused_subntt_wide_kernel`` in
``csrc/mxu_sub.cu``), which the narrow fields' launches of more than one
wave of blocks take:

- its launch plan (``mxu_level.sub_wide_plan``) for every m from 64 to 512
  on W = 1 and 2 (W = 8 has none and keeps the present form), for 132, 114
  and 4 SMs: it fits the SM, one wave of blocks, none empty, every column
  tile and row chunk in exactly one block, the span edges where the C
  launcher puts them;
- which launches take it (``mxu_level.sub_wide``): the single-wave launches
  of Goldilocks 2^18 keep the present form, those of 2^24 take the wide one;
- a torch emulation of its blocks (the matrices staged once, the slot-major
  GEMM rows, level A's result tile Y, level B's block-diagonal matrix and
  stacked columns, the tiles of each block's span) against the plain
  version ``fused_subntt_plain`` and the JAX package's ``fused_subntt`` in
  interpret mode.

Canonical words: the tolerance is exact equality.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ntt_tpu.fields as jfields
from ntt_tpu.kernels.mxu_level import fused_subntt as j_subntt
from ntt_tpu.transforms import mxu as jmxu
import ntt_tpu_torch.fields as tfields
from ntt_tpu_torch import digits as tdigits
from ntt_tpu_torch import limbs as tlimbs
from ntt_tpu_torch.kernels import mxu_level
from ntt_tpu_torch.transforms import mxu as tmxu

torch.set_num_threads(1)

NARROW = ["goldilocks", "small-proth"]
MS = [64, 128, 256, 512]
ROWS = mxu_level.TC_SHORT_ROWS      # GEMM rows of one wgmma N half


def _words(field, shape, seed):
    """Canonical random elements as uint32[W, *shape] (top word < p's)."""
    rng = np.random.default_rng(seed)
    W = field.n_words
    x = rng.integers(0, 1 << 32, size=(W,) + shape, dtype=np.uint64)
    x[W - 1] = rng.integers(0, field.p >> (32 * (W - 1)), size=shape,
                            dtype=np.uint64)
    return x.astype(np.uint32)


def _spans(p):
    """{(chunk, tile): block} as the kernel walks them: block blk is row
    chunk blk % chunks and tiles span * (blk // chunks) onwards."""
    got = {}
    for blk in range(p.blocks):
        chunk, pair = blk % p.chunks, blk // p.chunks
        tiles = range(pair * p.span, min((pair + 1) * p.span, p.col_tiles))
        assert len(tiles) >= 1, f"block {blk} is empty"
        for t in tiles:
            assert (chunk, t) not in got, f"tile {t} twice"
            got[chunk, t] = blk
    return got


@pytest.mark.parametrize("name", NARROW + ["bls12-381-fr"])
@pytest.mark.parametrize("m", MS)
def test_wide_plan_fits_and_covers_every_tile_once(name, m):
    f = tfields.get_field(name)
    W, D, E = f.n_words, tdigits.n_digits(f), tdigits.out_planes(f)
    if W not in mxu_level.SUB_WIDE_WORDS:
        with pytest.raises(ValueError, match="no wide"):
            mxu_level.sub_wide_plan(f, m, 1 << 20)
        assert not mxu_level.sub_wide(f, m, 1 << 20)
        return
    m2 = m // 32
    for sms in (132, 114, 4):
        for B in (1, 7, 127, 128, 129, 2047, 1 << 15, (1 << 18) + 3):
            p = mxu_level.sub_wide_plan(f, m, B, sms)
            # the slots: every plane of a slot group within its rows, the
            # groups within one N half, two row units of slots a block
            assert 8 * E <= p.group_rows and ROWS % p.group_rows == 0
            assert p.slots == 8 * (ROWS // p.group_rows)
            assert p.kt == 2 * p.slots and p.chunks * p.kt == 32
            assert p.bt * m2 == mxu_level.TC_COLS
            assert p.lb == max(p.slots, m2) and p.lb % m2 == 0
            # four wgmma units a level: 2 column halves x 2 row units at
            # level A, (columns / 64) x (lb / slots) at level B
            assert (p.kt * mxu_level.TC_COLS // p.lb // 64
                    * (p.lb // p.slots)) == 4
            assert p.ka_pad == D * 32 and p.ka_pad % 32 == 0
            assert p.kb_pad >= D * p.lb and p.kb_pad % 32 == 0
            assert p.kb_pad - D * p.lb < 32
            assert p.smem_bytes <= mxu_level.TC_MAX_SMEM
            # one wave, none empty, every (chunk, tile) once
            assert p.col_tiles == -(-B // p.bt)
            assert p.blocks <= max(sms, p.chunks)
            got = _spans(p)
            assert len(got) == p.chunks * p.col_tiles
            # the C launcher's check of the same plan
            assert -(-p.col_tiles // p.span) == p.blocks // p.chunks
            assert mxu_level.sub_wide_args(f, m, B, sms) == (
                p.kt, p.lb, p.ka_pad, p.kb_pad, p.span, p.blocks,
                p.smem_bytes)


def test_wide_plan_shared_bytes_by_region():
    """Goldilocks at m = 512: A1's two row units (10 steps of 320 GEMM
    rows), A2's two (5 steps of 320 rows), the digit tile of level A, Y
    [2][16][132] words and the tile's twiddle [2][16][128]; at m = 64 A2
    is one unit of 3 steps."""
    f = tfields.GOLDILOCKS
    p = mxu_level.sub_wide_plan(f, 512, 1 << 15)
    assert p.smem_bytes == 256 + 10 * 320 * 32 + 5 * 320 * 32 + 128 * 320 \
        + 2 * 16 * 132 * 4 + 2 * 16 * 128 * 4
    p = mxu_level.sub_wide_plan(f, 64, 1 << 18)
    assert p.smem_bytes == 256 + 10 * 320 * 32 + 3 * 160 * 32 + 128 * 320 \
        + 2 * 16 * 132 * 4 + 2 * 16 * 128 * 4
    assert (p.span, p.blocks) == (63, 132)


@pytest.mark.parametrize("name, log_n", [("goldilocks", 18),
                                         ("goldilocks", 24),
                                         ("small-proth", 22)])
def test_wide_form_taken_above_one_wave(name, log_n):
    """The transforms' K3 multi launches: Goldilocks 2^18's two launches
    (128 blocks of the present form) keep it, 2^24's three and small-proth
    2^22's two take the wide form; W = 8 never does."""
    f = tfields.get_field(name)
    n, launches = 1 << log_n, []
    m = n
    while m > 32:
        s = min(m, tmxu.effective_subbase(f))
        launches.append((s, n // s))
        m //= s
    wide = [mxu_level.sub_wide(f, s, B) for s, B in launches if s > 32]
    assert wide == [log_n > 18] * len(wide) and len(wide) >= 2
    assert not mxu_level.sub_wide(tfields.BLS12_381_FR, 512, 1 << 20)


def _exact(A, d):
    """A int64[r, c] @ d int64[c, N], exact."""
    return tdigits.matmul_exact(A, d)


def _digit_tile(elems, field, k_pad):
    """The digit tile int64[cols, k_pad] of elems uint32-valued
    int64[W, rows, cols]: digit j of row i at contraction index
    j * rows + i, zeros beyond."""
    D, rows = tdigits.n_digits(field), elems.shape[1]
    d = tdigits.extract_digits(elems.to(torch.uint32), field).reshape(
        D * rows, -1).T
    out = torch.zeros((d.shape[0], k_pad), dtype=torch.int64)
    out[:, :D * rows] = d.to(torch.int64)
    return out


def _slot_planes(Z, p, E):
    """The planes of a unit's GEMM rows Z int64[160, cols] by slot:
    [E, slots, cols], plane e of slot sg * 8 + s at row sg * GS + e * 8 + s
    (as each thread's registers hold them)."""
    gw = ROWS // p.group_rows
    out = torch.empty((E, 8 * gw, Z.shape[1]), dtype=torch.int64)
    for sg in range(gw):
        for e in range(E):
            base = sg * p.group_rows + e * 8
            out[e, sg * 8:(sg + 1) * 8] = Z[base:base + 8]
    return out


def _emulated_wide(x3, field, mats, T3, rep, inverse, sms):
    """The wide form block by block as ``csrc/mxu_sub.cu`` runs it (plan
    ``sub_wide_plan`` for ``sms`` SMs): A1's chunk rows and the
    block-diagonal A2 staged once a block in slot-major GEMM row order;
    per tile of the block's span, level A's four units (column half,
    row unit) reduced from the slots, times Tin, into Y[w][kk][v]; level
    B's digit tile of Y (column (kk, bh), rows (r, i2)), its four units
    reduced from the slots, times T3, stored at row k2 * 32 + k1, column
    b0 + bh * R + r."""
    W, m, B = x3.shape
    D, E = tdigits.n_digits(field), tdigits.out_planes(field)
    p = mxu_level.sub_wide_plan(field, m, B, sms)
    m2, bt, kt, S, lb = m // 32, p.bt, p.kt, p.slots, p.lb
    gw, R, cpk = ROWS // p.group_rows, lb // m2, 128 // lb
    cb = kt * cpk
    A1, A2 = mats[32].to(torch.int64), mats[m2].to(torch.int64)
    Tin = mxu_level.inner_twiddle(field, m, inverse, "cpu").to(torch.int64)
    flat = None if T3 is None else T3.reshape(W, -1).to(torch.int64)
    xv = x3.reshape(W, 32, m2, B).to(torch.int64)
    out = torch.full((W, m, B), -1, dtype=torch.int64)

    def unit_rows(n):
        return [(sg, e, s) for sg in range(gw) for e in range(E)
                for s in range(8) if sg * p.group_rows + e * 8 + s == n]

    A2s = torch.zeros((lb // S * ROWS, p.kb_pad), dtype=torch.int64)
    for ub in range(lb // S):
        for n in range(ROWS):
            for sg, e, s in unit_rows(n):
                sigma = (ub * gw + sg) * 8 + s
                r, k2 = divmod(sigma, m2)
                for j in range(D):
                    cols = j * lb + r * m2 + torch.arange(m2)
                    A2s[ub * ROWS + n, cols] = A2[e * m2 + k2,
                                                  j * m2:(j + 1) * m2]
    for blk in range(p.blocks):
        chunk, pair = blk % p.chunks, blk // p.chunks
        k0 = chunk * kt
        A1s = torch.zeros((2 * ROWS, p.ka_pad), dtype=torch.int64)
        for ua in range(2):
            for n in range(ROWS):
                for sg, e, s in unit_rows(n):
                    A1s[ua * ROWS + n] = A1[e * 32 + k0 + ua * S + sg * 8 + s]
        for t in range(pair * p.span, min((pair + 1) * p.span, p.col_tiles)):
            b0 = t * bt
            v = torch.arange(128)
            i2, b = v // bt, b0 + v % bt
            ok = b < B
            xa = torch.zeros((W, 32, 128), dtype=torch.int64)
            xa[:, :, ok] = xv[:, :, i2[ok], b[ok]]
            dig = _digit_tile(xa, field, p.ka_pad)
            Y = torch.zeros((W, kt, 128), dtype=torch.int64)
            for g in range(4):
                mh, ua = g & 1, g >> 1
                cols = slice(mh * 64, mh * 64 + 64)
                Z = _slot_planes(_exact(A1s[ua * ROWS:(ua + 1) * ROWS],
                                        dig[cols].T), p, E)
                y = tdigits.recompose_reduce(
                    Z, field, mxu_level._zmax_bits(field, 32))
                kk = ua * S + torch.arange(S)
                tw = Tin[:, k0 + kk][:, :, i2[cols]]
                Y[:, kk, cols] = tlimbs.mont_mul(
                    y, tw.to(torch.uint32), field).to(torch.int64)
            col = torch.arange(cb)
            kk, bh = col // cpk, col % cpk
            rho = torch.arange(lb)
            r, i2b = rho // m2, rho % m2
            vb = i2b[:, None] * bt + bh[None, :] * R + r[:, None]
            dig = _digit_tile(Y[:, kk[None, :].expand(lb, cb), vb], field,
                              p.kb_pad)
            ncol = cb // 64
            for g in range(4):
                cg, ub = g % ncol, g // ncol
                cols = slice(cg * 64, cg * 64 + 64)
                Z = _slot_planes(_exact(A2s[ub * ROWS:(ub + 1) * ROWS],
                                        dig[cols].T), p, E)
                y = tdigits.recompose_reduce(
                    Z, field, mxu_level._zmax_bits(field, m2))
                sigma = ub * S + torch.arange(S)
                k2, rr = sigma % m2, sigma // m2
                kkc, bhc = kk[cols], bh[cols]
                bb = b0 + bhc[None, :] * R + rr[:, None]         # [S, 64]
                row = k2[:, None] * 32 + k0 + kkc[None, :]
                keep = bb < B
                val = y[:, keep]
                if T3 is not None:
                    at = (row * B + bb if rep == 1
                          else (bb // rep) * m + row)[keep]
                    val = tlimbs.mont_mul(val, flat[:, at].to(torch.uint32),
                                          field)
                assert bool((out[:, row[keep], bb[keep]] < 0).all()), \
                    "an output two blocks stored"
                out[:, row[keep], bb[keep]] = val.to(torch.int64)
    assert bool((out >= 0).all()), "an output no block stored"
    return out.to(torch.uint32)


def _operands(name, m, B, tw, inverse, seed):
    f = tfields.get_field(name)
    x = torch.from_numpy(_words(f, (m, B), seed))
    T3, rep = None, 1
    if tw == "rep1":
        T3 = torch.from_numpy(_words(f, (m, B), seed + 1))
    elif tw is not None:
        rep = tw
        T3 = torch.from_numpy(_words(f, (B // rep, m), seed + 1))
    mats = {k: torch.from_numpy(v)
            for k, v in tmxu._mats_for(f, {32, m // 32}, inverse).items()}
    return f, x, T3, rep, mats


@pytest.mark.parametrize("name, m, B, tw, inverse, sms", [
    # m = 64 (lb = 8 at W = 2: four vectors a level-B column), three tiles
    # of bt = 64 a block, the last ragged
    ("goldilocks", 64, 300, None, False, 2),
    ("goldilocks", 128, 100, "rep1", True, 2),     # spans of 2, ragged
    ("goldilocks", 256, 80, 5, False, 4),          # a rep across tiles
    ("goldilocks", 512, 37, "rep1", False, 4),     # lb = 16: two row units
    ("small-proth", 64, 130, "rep1", True, 3),     # lb = 16, R = 8
    ("small-proth", 128, 64, 16, False, 2),
    ("small-proth", 256, 40, None, True, 5),
    ("small-proth", 512, 24, 8, True, 1),          # one block, three tiles
])
def test_emulated_wide_equals_plain(name, m, B, tw, inverse, sms):
    f, x, T3, rep, mats = _operands(name, m, B, tw, inverse, m + B)
    got = _emulated_wide(x, f, mats, T3, rep, inverse, sms)
    assert torch.equal(got, mxu_level.fused_subntt_plain(
        x, f, inverse, mats, T3, rep=rep))


@functools.cache
def _jax_words(name, m, tw, inverse):
    """The JAX package's ``fused_subntt`` at B = 16 (one batch tile of the
    JAX kernel, interpret mode) on the operands of :func:`_operands`."""
    jf = jfields.get_field(name)
    _, x, T3, rep, _ = _operands(name, m, 16, tw, inverse, m)
    want = j_subntt(jnp.asarray(x.numpy()), jf, inverse,
                    jmxu.sub_mats(jf, m, inverse),
                    None if T3 is None else jnp.asarray(T3.numpy()),
                    transpose_out=False, batch_tile=16, rep=rep)
    return np.asarray(want)


@pytest.mark.parametrize("name, m, tw, inverse", [
    ("goldilocks", 64, None, False),
    ("goldilocks", 512, "rep1", True),
    ("small-proth", 512, 8, False),
    ("small-proth", 128, "rep1", True),
])
def test_emulated_wide_equals_pallas(name, m, tw, inverse):
    """B = 16 under a plan for one SM: one block walks every tile."""
    f, x, T3, rep, mats = _operands(name, m, 16, tw, inverse, m)
    got = _emulated_wide(x, f, mats, T3, rep, inverse, 1)
    assert np.array_equal(got.numpy(), _jax_words(name, m, tw, inverse))

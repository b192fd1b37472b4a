"""The launch plan of the butterfly-ladder kernels K5 (``stage_ntt``) and K6
(``fused_stage_level``), and a torch emulation of their register-pass
dataflow, on the CPU.

The CUDA kernels (``csrc/vmem_ntt.cu``) run only on the card; what
surrounds their arithmetic is held here: the plan the wrappers pass to the
C launcher (elements a thread, column tile, threads, grid, shared bytes),
the passes' index maps (every butterfly of every stage formed exactly once,
with the twiddle index the kernel reads), and the block-by-block dataflow:
pass 0 reading natural rows bitrev(p), the stages of a pass in registers
(the products by w^0 left out), the exchange through the
tile between passes, T3 on the natural output rows, the direct or
transposed store, zero columns past B in the last tile. The emulation must
give the plain versions' canonical words and, where the JAX entries run
(Pallas interpret mode, one small call a field: both kernels and both
directions over the four), the JAX package's: the tolerance is exact
equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ntt_tpu as nt
from ntt_tpu.kernels.vmem_ntt import fused_stage_level as j_fused_stage_level
from ntt_tpu.kernels.vmem_ntt import ntt_along_axis_pallas as j_stage_ntt
import ntt_tpu_torch.fields as tfields
from ntt_tpu_torch import limbs as tlimbs
from ntt_tpu_torch.kernels import vmem_ntt
from ntt_tpu_torch.transforms import core as tcore

torch.set_num_threads(1)

FIELD_OF_WIDTH = {1: tfields.SMALL, 2: tfields.GOLDILOCKS,
                  8: tfields.BLS12_381_FR}
MS = [2, 4, 8, 16, 32, 64, 128, 256]


def _words(field, shape, seed):
    """Canonical random elements as uint32[W, *shape] (top word < p's)."""
    rng = np.random.default_rng(seed)
    W = field.n_words
    x = rng.integers(0, 1 << 32, size=(W,) + shape, dtype=np.uint64)
    x[W - 1] = rng.integers(0, field.p >> (32 * (W - 1)), size=shape,
                            dtype=np.uint64)
    return x.astype(np.uint32)


def _bitrev(p, L):
    return int(format(p, f"0{L}b")[::-1], 2) if L else 0


# --- the plan ----------------------------------------------------------------

@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("W", [1, 2, 8])
def test_stage_plan_fits_the_block_and_covers_the_columns(W, m):
    for B in (1, 37, 300, 4096, 16384):
        plan = vmem_ntt.stage_plan(W, m, B)
        assert plan.r == min(vmem_ntt.R_MAX[W], m) and plan.r == 1 << plan.k
        assert plan.col_threads * plan.r == m
        assert plan.bt & (plan.bt - 1) == 0
        assert plan.threads == plan.col_threads * plan.bt
        assert plan.threads <= vmem_ntt.max_threads(W, plan.r)
        # the exchange tile [W][m][bt + 1] and the element-major twiddles
        assert plan.tw_words >= W * (m // 2) and plan.tw_words % 4 == 0
        assert plan.smem_bytes == 4 * (plan.tw_words
                                       + W * m * (plan.bt + 1))
        assert plan.smem_bytes <= 227 * 1024
        # the grid-stride loop walks every column tile exactly once, and
        # the tiles hold every column once
        assert 1 <= plan.grid <= plan.tiles
        walked = sorted(t for blk in range(plan.grid)
                        for t in range(blk, plan.tiles, plan.grid))
        assert walked == list(range(plan.tiles))
        cols = [t * plan.bt + c for t in range(plan.tiles)
                for c in range(plan.bt) if t * plan.bt + c < B]
        assert cols == list(range(B))
        # log2 m stages in passes of k, the passes the launcher runs
        L = m.bit_length() - 1
        assert plan.passes == -(-L // plan.k)
        schedule = vmem_ntt.passes(m, plan.r)
        assert len(schedule) == plan.passes
        # the block's threads are every (t, column) once; a warp's threads
        # share t's bits below log2(warps), so the branch around a product
        # by w^0 (t mod 2^s0 = 0) is uniform across the warp in the passes
        # whose s0 is no higher
        ranks = [vmem_ntt.thread_rank(i, plan.col_threads, plan.bt)
                 for i in range(plan.threads)]
        assert sorted(ranks) == [(t, c) for t in range(plan.col_threads)
                                 for c in range(plan.bt)]
        warps = plan.threads // 32
        for w in range(0, plan.threads, 32):
            ts = {t for t, _ in ranks[w:w + 32]}
            assert len(ts) == 1 or len({t % warps for t in ts}) == 1


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("r_max", [8, 16])
def test_passes_form_every_butterfly_once(r_max, m):
    """Over all threads of a column and all passes, each stage's m/2
    butterflies (p, p + 2^s) are formed exactly once, in stage order, with
    the twiddle index the kernel reads (pos << (L-1-s), pos = p mod 2^s);
    in every pass the threads' rows partition the column."""
    r = min(r_max, m)
    L, K = m.bit_length() - 1, r.bit_length() - 1
    seen = {s: [] for s in range(L)}
    last_stage = -1
    for P, (s0, u0) in enumerate(vmem_ntt.passes(m, r)):
        stages = [s0 + u for u in range(u0, K)]
        assert stages and stages[0] == last_stage + 1
        last_stage = stages[-1]
        rows = []
        for t in range(m // r):
            base = vmem_ntt.pass_base(t, s0, K) if P else t << K
            tlow = t & ((1 << s0) - 1) if P else 0
            assert base % (1 << s0) == tlow
            rows += [base + (j << s0) for j in range(r)]
            for u in range(u0, K):
                s = s0 + u
                for j in range(r):
                    if j & (1 << u):
                        continue
                    pa, pb = base + (j << s0), base + ((j | 1 << u) << s0)
                    assert pb - pa == 1 << s and not pa & (1 << s)
                    jl = j & ((1 << u) - 1)
                    pos = jl if P == 0 else tlow + (jl << s0)
                    assert pos == pa % (1 << s)
                    assert pos << (L - 1 - s) == pos * (m // 2) // (1 << s)
                    seen[s].append(pa)
        assert sorted(rows) == list(range(m))
    assert last_stage == L - 1
    for s in range(L):
        assert sorted(seen[s]) == [p for p in range(m) if not p & (1 << s)]


def test_stage_plan_refuses_what_the_kernel_cannot_take():
    for W, m, B in ((4, 64, 8), (3, 64, 8), (8, 1, 8), (8, 3, 8),
                    (2, 512, 8), (1, 96, 8), (8, 64, 0)):
        with pytest.raises(ValueError):
            vmem_ntt.stage_plan(W, m, B)


# --- the dataflow ----------------------------------------------------------

def _run_pass(v, field, tws, L, s0, u0, tlow, first):
    """The stages of one pass on every thread's elements: v[j] [W, T, N]
    holds element j of each thread t of a column, for every column n; the
    stages run as ``run_pass`` runs them. tlow [T]: the threads' row bits
    below s0."""
    r = len(v)
    K = r.bit_length() - 1
    for u in range(u0, K):
        sh = L - 1 - (s0 + u)
        ja = [j for j in range(r) if not j & (1 << u)]
        jb = [j | 1 << u for j in ja]
        jl = torch.tensor([j & ((1 << u) - 1) for j in ja])
        a = torch.stack([v[j] for j in ja], 2)         # [W, T, r/2, N]
        b = torch.stack([v[j] for j in jb], 2)
        T = a.shape[1]
        pos = (jl[None, :] if first
               else tlow[:, None] + (jl[None, :] << s0)).expand(T, -1)
        w = tws[pos << sh].permute(2, 0, 1)[..., None]   # [W, T, r/2, 1]
        # the products by w^0 are left out (pos = 0)
        b = torch.where((pos != 0)[None, :, :, None],
                        tlimbs.mont_mul(b, w, field), b)
        lo, hi = tlimbs.add_mod(a, b, field), tlimbs.sub_mod(a, b, field)
        for i in range(len(ja)):
            v[ja[i]], v[jb[i]] = lo[:, :, i], hi[:, :, i]


def _emulate(x, field, inverse=False, T3=None, transpose=False):
    """K5 (T3 None, transpose False) or K6 as the kernel computes it: the
    columns of every column tile at once, zero past B; thread t of a
    column holds its r registers at rows[t, j] of the tile."""
    W, m, B = x.shape
    plan = vmem_ntt.stage_plan(W, m, B)
    r, K = plan.r, plan.k
    L, T, N = m.bit_length() - 1, m // r, plan.tiles * plan.bt
    # the master table staged element-major: tws[k] = words of w^k
    tws = torch.from_numpy(tcore.twiddle_master(field, m, inverse)).T
    xp = torch.zeros((W, m, N), dtype=torch.uint32)
    xp[:, :, :B] = x
    t, j = torch.arange(T), torch.arange(r)

    def regs(src, rows):            # the tile's rows into the registers
        g = src[:, rows.flatten()].reshape(W, T, r, N)
        return [g[:, :, i] for i in range(r)]

    def to_tile(v, rows):           # the registers out to their rows
        return torch.stack(v, 2).reshape(W, m, N)[:, torch.argsort(
            rows.flatten())]

    # pass 0: thread t reads rows p = (t << K) + j at natural row bitrev(p)
    rows = (t[:, None] << K) + j[None, :]
    nat = torch.tensor([_bitrev(p, L) for p in rows.flatten().tolist()])
    v = regs(xp, nat.reshape(T, r))
    _run_pass(v, field, tws, L, 0, 0, None, True)
    for s1, u0 in vmem_ntt.passes(m, r)[1:]:
        tile = to_tile(v, rows)                        # out, barrier, in
        rows = torch.tensor([vmem_ntt.pass_base(i, s1, K)
                             for i in range(T)])[:, None] + (j[None, :] << s1)
        v = regs(tile, rows)
        _run_pass(v, field, tws, L, s1, u0, t & ((1 << s1) - 1), False)
    if T3 is not None:              # at the natural output rows ``rows``
        tp = torch.zeros((W, m, N), dtype=torch.uint32)
        tp[:, :, :B] = T3
        v = [tlimbs.mont_mul(y, w, field) for y, w in zip(v, regs(tp, rows))]
    tile = to_tile(v, rows)
    if transpose:                   # row-fastest out of the tile: [W, B, m]
        return tile.transpose(1, 2)[:, :B].contiguous()
    return tile[:, :, :B].contiguous()


# every m of each width, B alternating between one short tile (the last
# tile's columns masked) and several tiles with a ragged last one
CASES = [(W, m, Bs[i % 2]) for W, ms, Bs in (
    (1, MS, (37, 300)), (2, MS, (300, 5)), (8, MS[:6], (3, 40)))
    for i, m in enumerate(ms)]


@pytest.mark.parametrize("W, m, B", CASES)
def test_emulated_stage_ntt_equals_plain(W, m, B):
    field = FIELD_OF_WIDTH[W]
    x = torch.from_numpy(_words(field, (m, B), m + B))
    inverse = bool(B % 2)
    assert torch.equal(_emulate(x, field, inverse),
                       vmem_ntt.stage_ntt_plain(x, field, inverse))


@pytest.mark.parametrize("W, m, B", CASES)
def test_emulated_fused_stage_level_equals_plain(W, m, B):
    field = FIELD_OF_WIDTH[W]
    x = torch.from_numpy(_words(field, (m, B), m + B))
    T = torch.from_numpy(_words(field, (m, B), m + B + 1))
    inverse = not B % 2
    for T3, tr in ((T, True), (None, False), (T, False)):
        assert torch.equal(
            _emulate(x, field, inverse, T3, tr),
            vmem_ntt.fused_stage_level_plain(x, field, inverse, T3, tr))


# one JAX call a field: K5 and K6, forward and inverse, across the four
@pytest.mark.parametrize("name, m, B, inverse, fused", [
    ("small-proth", 64, 8, False, True), ("goldilocks", 8, 8, True, False),
    ("bn254-fr", 2, 4, False, False), ("bls12-381-fr", 2, 4, True, True)])
def test_emulated_ladder_equals_jax(name, m, B, inverse, fused):
    jf, tf = nt.get_field(name), tfields.get_field(name)
    x = _words(tf, (m, B), 7 * m + B)
    if fused:
        T = _words(tf, (m, B), 7 * m + B + 1)
        got = _emulate(torch.from_numpy(x), tf, inverse,
                       torch.from_numpy(T), True)
        want = j_fused_stage_level(jnp.asarray(x), jf, inverse,
                                   jnp.asarray(T), True)
    else:
        got = _emulate(torch.from_numpy(x), tf, inverse)
        want = j_stage_ntt(jnp.asarray(x), jf, inverse=inverse)
    assert np.array_equal(got.numpy(), np.asarray(want))

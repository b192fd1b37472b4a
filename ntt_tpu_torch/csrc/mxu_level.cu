// K1, K2, K3 (single-level), K4 and K7: one m-point digit-matmul level on
// uint32[W, m, B] (W = 8, 2 or 1 words per element; m <= 64, MAX_LEVEL_M).
//
// K1 mxu_base_ntt replaces ntt_tpu/kernels/mxu_ntt.py::_kernel (entry
// base_ntt_mxu_pallas): the base transform, one conv matrix and the
// Montgomery reduction, with no twiddle. Where one wgmma N half holds every
// GEMM row of the level, E*m <= 160 (W = 8 at m = 2 and 4, the last base of
// the 256-bit transforms of 2^(5k+1) and 2^(5k+2) points; W = 2 at m <= 8;
// W = 1 at m <= 16), it takes a short form of its own,
// base_ntt_mxu_short_kernel (the plan's m_pad = 160 names it): in the block
// below half the warpgroups would multiply padding rows, a block would hold
// 128 columns and stage the conv matrix for them alone, and half its threads
// would idle in the epilogue at m = 2. A short-form block is two warpgroups,
// both on columns (64 each, one wgmma m64n160k32 against the whole matrix a
// step), that stage the matrix once and walk a span of 128-column tiles:
// per tile the digit tile straight from x (whole words: at m = 2 the digits
// 2p, 2p+1 of both rows, two tasks a column), the k_pad / 32 steps, Z, and
// the epilogue, m items a column (one a thread at m = 2). Two blocks share an
// SM (128 registers a thread, at most 104,000 shared bytes a block), so one
// block's loads and tensor-core steps can run under the other's epilogue;
// the grid is one wave of them, span = ceil(tiles / (2 SMs)) tiles a block.
// Its bounds on an H100 (BLS12-381 Fr): [8,2,2^25] (the 2^26 base) 4.29 GB
// of data in and out, 1.28 ms at 3.35 TB/s, 184 G int8 MACs, 0.19 ms: bytes
// bound it; [8,4,2^20] (the 2^22 base) 268 MB, 0.080 ms, 23 G MACs, 0.023 ms:
// bytes. The Montgomery reduction of each element (W + 1 word steps on the
// CUDA cores) takes more than either: the epilogue is the largest of its
// phases (tc_knockout.py).
//
// K2 mxu_fused_level_stack replaces ntt_tpu/kernels/mxu_level.py::_kernel_stack
// (entry fused_level_stack): the twiddle is folded into a stack of conv
// matrices As[NT, E*m, D*m] and batch column b uses As[b / rep]; an optional
// residual twiddle is multiplied into the output, at batch resolution
// T3[W, m, B] or periodic T3[W, m, s0], column b reading column b mod s0 (s0 a
// power of two dividing B): level 0 above 2^24, whose residual the JAX package
// tiles to each chunk's width, reads its compact [W, 32, s0] table here. The
// store is transposed to [W, B, m] on request (transpose_out of the JAX entry),
// through K4's tile.
//
// K3 mxu_fused_subntt replaces the single-level form (m <= 64) of
// ntt_tpu/kernels/mxu_level.py::_kernel_sub (entry fused_subntt): one conv matrix,
// then the decomposition twiddle by a Montgomery product, read from T3[W, m, B]
// (rep == 1) or from the i2-resolution table T3[W, B / rep, m] (rep > 1; a warp
// reads one row of it, mostly as broadcasts); the store transposed on request,
// as K2's.
//
// K4 mxu_fused_level replaces ntt_tpu/kernels/mxu_level.py::_kernel_level (entry
// fused_level): one conv matrix, an optional product with a full-resolution
// twiddle T3[W, m, B], and the store, transposed to [W, B, m] on request: the
// four-step transpose rides the level's own pass over the data.
//
// K7 mxu_fused_level_probe replaces ntt_tpu/kernels/mxu_level.py::_kernel_probe
// (entry fused_level_probe): K4's level without the transposed store (the
// fused flat-peel level; K3's at rep = 1 computes the same) cut off after one
// of five stages, to attribute its time. Outputs
// uint32[W, m, B]: "stream" x itself; "digits" the sum of an element's D digits,
// on every word plane, read back from the staged digit tile; "matmul" the planes
// 0 .. W-1 of the E accumulator planes, cast to uint32, from the Z tile;
// "reduce" the reduced y; "tw" y * T3, which is the whole level.
//
// All five are one block body (tc_level) on the int8 tensor cores
// (mxu_core.cuh, tc::contract), each under a kernel name of its own,
// instantiated for W and for the passes of the digit tile (two at m = 64, one
// below, so that the kernels up to m = 32 compile as they did before): a block
// owns a chunk of kt output rows and 128 batch columns; TMA streams the chunk's
// conv-matrix rows (gathered by a 4-D box over [NT][E][m][D*m]) through a
// six-stage ring, the digit tile is built in shared memory (once up to
// m = 32; at m = 64 in two passes of 32 rows, the sums carried in registers
// from one to the next: tc::contract), and four warpgroups run wgmma
// m64n160k32 s8 on it (two column halves x two row halves); the sums go
// through a shared Z tile to the epilogue: reduce<W>,
// then T3 by mont_mul, then the store (for the transposed store of K2, K3 and
// K4 through a [w][column][row | 1] tile, so that the writes run along m). The
// epilogue takes the probe's stage as an argument; the other kernels pass TW, which the
// compiler folds away. Blocks are numbered column tile by column tile, the row
// chunks of one tile together, so the blocks of one stack entry run together
// and read its matrix from L2. K3's multi-level form (m = 64 .. 1024, peel 32) is
// mxu_sub.cu, on the same contraction; which form a launch of m = 64 takes is
// the caller's plan (the single-level one under NTT_MXU_BASE_LOG=6).
//
// Bounds on an H100 at the 256-bit main path's shapes (W = 8, n = 2^18, m = 32,
// B = 8192, 11.5 G int8 MACs = 11.6 us at the 1,979 TOPS int8 tensor peak):
//   K2 level 0 (NT = 32): 61.7 MB (data in and out, the 44.9 MB stack), 18.4 us at
//      3.35 TB/s: bytes bound it. Level 2 (NT = 8): 28.0 MB, 8.4 us: MACs bound it,
//      11.6 us. The two launches: 30.0 us.
//   K3 level 1 (rep = 1): 26.6 MB (data, the 8.4 MB twiddle table, A), 7.9 us:
//      MACs bound it, 11.6 us.
//   K1 (m = 8, B = 32768, A = int8[296, 296]): 16.9 MB (data in and out, A),
//      5.0 us; 2.9 G MACs, 2.9 us: bytes bound it. (Its short form above.)
//   K4 (W = 8, n = 2^18 under mxu_fused: three launches of m = 32, B = 8192 with
//      T3 and one of m = 8, B = 32768 without): 26.6 MB and 11.5 G MACs, 11.6 us:
//      MACs bound it; the m = 8 launch 16.9 MB, 5.0 us: bytes bound it. The four
//      launches: 39.8 us.
// A tensor-core block runs its phases in turn (the digit staging, the TMA
// stream with the wgmma steps, the epilogue on the CUDA cores), one block an
// SM; at the main path's shapes each phase takes a comparable share of a
// launch, and the wgmma steps themselves run at about 70% of the int8 peak
// (PERF.md, tc_knockout.py).
#include "mxu_core.cuh"

// Stages of the probe (K7) in pipeline order; TW runs the whole level, and is
// what K1-K4 pass.
enum ProbeStage { STREAM = 0, DIGITS = 1, MATMUL = 2, REDUCE = 3, TW = 4 };

// The epilogue of the tensor-core levels for output rows k0 .. k0+kt-1 and the block's columns:
// Z from shared memory, reduce (MATMUL: the first W planes as they are), T3, store.
template <int W>
__device__ __forceinline__ void tc_epilogue(const mxu::tc::Level& L, long long b0, int k0,
                                            uint8_t* smem, int stage) {
  using namespace mxu;
  constexpr int E = Geo<W>::E, N = tc::N;
  const int m = L.m, kt = L.kt, ts = kt | 1;
  const int* Z = reinterpret_cast<const int*>(smem);
  uint32_t* tile = reinterpret_cast<uint32_t*>(smem + E * kt * tc::ZS * 4);
  for (int idx = threadIdx.x; idx < kt * N; idx += tc::THREADS) {
    const int kk = idx / N, bl = idx % N;
    const long long b = b0 + bl;
    uint32_t t[W];  // the twiddle's load runs under the reduction
    if (L.T3 != nullptr && b < L.B)
      load_twiddle<W>(L.T3, L.t_rep, L.t_period, m, L.B, k0 + kk, b, t);
    int z[E];
#pragma unroll
    for (int e = 0; e < E; ++e) z[e] = Z[(e * kt + kk) * tc::ZS + bl];
    uint32_t y[W];
    if (stage == MATMUL) {
#pragma unroll
      for (int q = 0; q < W; ++q) y[q] = (uint32_t)z[q];
    } else {
      reduce<W>(z, L.fc, y);
    }
    if (b >= L.B) continue;
    if (L.T3 != nullptr) {
      uint32_t r[W];
      mont_mul<W>(y, t, L.fc, r);
#pragma unroll
      for (int q = 0; q < W; ++q) y[q] = r[q];
    }
    if (L.transpose) {
#pragma unroll
      for (int q = 0; q < W; ++q) tile[(q * N + bl) * ts + kk] = y[q];
    } else {
#pragma unroll
      for (int q = 0; q < W; ++q) L.out[((long long)q * m + k0 + kk) * L.B + b] = y[q];
    }
  }
  if (!L.transpose) return;
  __syncthreads();
  for (int idx = threadIdx.x; idx < kt * N; idx += tc::THREADS) {
    const int bl = idx / kt, kk = idx % kt;
    const long long b = b0 + bl;
    if (b >= L.B) continue;
#pragma unroll
    for (int q = 0; q < W; ++q)
      L.out[((long long)q * L.B + b) * m + k0 + kk] = tile[(q * N + bl) * ts + kk];
  }
}

// K7's first two stages for rows k0 .. k0+kt-1 of the block's columns: x
// itself, or the digit sums read back from the staged digit tile at `smem`
// (the pass that holds the chunk's rows: a chunk lies within one pass).
template <int W, int P>
__device__ __forceinline__ void probe_early(const mxu::tc::Level& L, long long b0, int k0,
                                            uint8_t* smem, int stage) {
  using namespace mxu;
  constexpr int N = tc::N;
  const int rows = L.m / P, h = k0 / rows;
  if (stage == DIGITS) {
    tc::stage_digits<W, P>(L, b0, 0, L.B, h, smem);
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < L.kt * N; idx += tc::THREADS) {
    const int i = k0 + idx / N, bl = idx % N;
    const long long b = b0 + bl;
    if (b >= L.B) continue;
    if (stage == STREAM) {
#pragma unroll
      for (int q = 0; q < W; ++q) {
        const long long at = ((long long)q * L.m + i) * L.B + b;
        L.out[at] = L.x[at];
      }
    } else {
      uint32_t acc = 0u;
#pragma unroll
      for (int j = 0; j < Geo<W>::D; ++j) acc += smem[tc::dig_at(bl, j * rows + i - h * rows)];
#pragma unroll
      for (int q = 0; q < W; ++q) L.out[((long long)q * L.m + i) * L.B + b] = acc;
    }
  }
}

// One tensor-core block: column tile blockIdx.x / (m / kt), row chunk blockIdx.x % (m / kt);
// the digit tile in P passes (tc::contract).
template <int W, int P>
__device__ __forceinline__ void tc_level(const CUtensorMap* map, const mxu::tc::Level& L,
                                         int stage) {
  extern __shared__ uint8_t tc_smem_raw[];
  __shared__ __align__(8) uint64_t full[mxu::tc::STAGES];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      ((uintptr_t)tc_smem_raw + mxu::tc::ALIGN - 1) & ~(uintptr_t)(mxu::tc::ALIGN - 1));
  const int chunks = L.m / L.kt;
  const long long b0 = (long long)(blockIdx.x / chunks) * mxu::tc::N;
  const int k0 = (blockIdx.x % chunks) * L.kt;
  if (stage < MATMUL) {
    probe_early<W, P>(L, b0, k0, smem, stage);
    return;
  }
  mxu::tc::contract<W, P>(L, map, b0, k0, smem, full,
                          [&](long long lo, long long hi, int h, uint8_t* dig) {
                            mxu::tc::stage_digits<W, P>(L, b0, lo, hi, h, dig);
                          });
  tc_epilogue<W>(L, b0, k0, smem, stage);
}

template <int W, int P>
__global__ void __launch_bounds__(mxu::tc::THREADS, 1)
    fused_level_stack_kernel(const __grid_constant__ CUtensorMap map, mxu::tc::Level L) {
  tc_level<W, P>(&map, L, TW);
}

template <int W, int P>
__global__ void __launch_bounds__(mxu::tc::THREADS, 1)
    fused_level_kernel(const __grid_constant__ CUtensorMap map, mxu::tc::Level L) {
  tc_level<W, P>(&map, L, TW);
}

template <int W, int P>
__global__ void __launch_bounds__(mxu::tc::THREADS, 1)
    fused_subntt_kernel(const __grid_constant__ CUtensorMap map, mxu::tc::Level L) {
  tc_level<W, P>(&map, L, TW);
}

template <int W, int P>
__global__ void __launch_bounds__(mxu::tc::THREADS, 1)
    base_ntt_mxu_kernel(const __grid_constant__ CUtensorMap map, mxu::tc::Level L) {
  tc_level<W, P>(&map, L, TW);
}

template <int W, int P>
__global__ void __launch_bounds__(mxu::tc::THREADS, 1)
    fused_level_probe_kernel(const __grid_constant__ CUtensorMap map, mxu::tc::Level L) {
  tc_level<W, P>(&map, L, L.stage);
}

// ---------------------------------------------------------------------------
// K1's short form, where one wgmma N half holds every GEMM row of the level
// (E*m <= NR: W = 8 at m = 2 and 4, W = 2 at m <= 8, W = 1 at m <= 16).
// ---------------------------------------------------------------------------

// The digit tile of the short-form tile at columns b0 .. b0+N-1 of x: digit j
// of element (i, bl) at contraction byte c = j*m + i of column bl, sub-tile
// c / BK of N rows; zero for c >= D*m and for the columns at or past B. Each
// task writes whole words: at m = 2 the digits 2p, 2p+1 of rows 0 and 1 of
// one column (bytes 4p .. 4p+3), two tasks a column (the lower half of the
// block the first HALF words, the upper half the rest and the zero tail);
// above, digit j of the four rows i0 .. i0+3 of one column (as put_digits), a
// warp on 8 columns x 4 row groups. Ends with the proxy fence of the writes.
template <int W>
__device__ __forceinline__ void short_digits(const mxu::tc::Level& L, long long b0,
                                             uint8_t* dig) {
  using namespace mxu;
  using namespace mxu::tc;
  constexpr int D = Geo<W>::D;
  const int m = L.m, words = L.k_pad / 4;  // words a column
  auto at = [&](int bl, int c) {
    return reinterpret_cast<uint32_t*>(dig + (c / BK) * (N * BK) + swz(bl, c % BK));
  };
  auto word = [&](int q, int i, int bl, bool in) {
    return in ? L.x[((long long)q * m + i) * L.B + b0 + bl] : 0u;
  };
  if (m == 2) {
    constexpr int PAIRS = (D + 1) / 2, HALF = (PAIRS + 1) / 2;
    static_assert(SHORT_THREADS == 2 * N, "two tasks a column");
    const int bl = threadIdx.x % N;
    const bool in = b0 + bl < L.B;
    uint32_t w0[W], w1[W];  // (only the words a half's digits read are loaded)
#pragma unroll
    for (int q = 0; q < W; ++q) {
      w0[q] = word(q, 0, bl, in);
      w1[q] = word(q, 1, bl, in);
    }
    auto put = [&](int p) {
      const int j = 2 * p, j1 = j + 1 < D ? j + 1 : j;
      const uint32_t odd = j + 1 < D ? 0xFFFFFFFFu : 0u;
      *at(bl, 4 * p) = pack_digits(digit_hi<W>(w0, j), digit_hi<W>(w1, j),
                                   digit_hi<W>(w0, j1) & odd, digit_hi<W>(w1, j1) & odd);
    };
    if (threadIdx.x < N) {
#pragma unroll
      for (int p = 0; p < HALF; ++p) put(p);
    } else {
#pragma unroll
      for (int p = HALF; p < PAIRS; ++p) put(p);
      for (int u = PAIRS; u < words; ++u) *at(bl, 4 * u) = 0u;
    }
  } else {
    const int G = m / 4, K = D * m;
    for (int idx = threadIdx.x; idx < N * G; idx += SHORT_THREADS) {
      const int bl = (idx >> 3) / G * 8 + (idx & 7), i0 = 4 * ((idx >> 3) % G);
      const bool in = b0 + bl < L.B;
      uint32_t w[4][W];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int q = 0; q < W; ++q) w[t][q] = word(q, i0 + t, bl, in);
#pragma unroll
      for (int j = 0; j < D; ++j)
        *at(bl, j * m + i0) = pack_digits(digit_hi<W>(w[0], j), digit_hi<W>(w[1], j),
                                          digit_hi<W>(w[2], j), digit_hi<W>(w[3], j));
    }
    for (int idx = threadIdx.x; idx < N * (words - K / 4); idx += SHORT_THREADS)
      *at(idx % N, K + 4 * (idx / N)) = 0u;
  }
  fence_async_shared();
}

// The conv matrix whole, the N side of every step: step kb holds contraction
// bytes kb*BK .. kb*BK+BK-1 of GEMM rows 0 .. NR-1 (row r is matrix row r:
// the block owns every output row), zero past E*m rows and D*m bytes. The
// proxy fence of these writes is the first digit staging's.
template <int W>
__device__ __forceinline__ void short_matrix(const int8_t* A, int m, int k_pad, uint8_t* mat) {
  using namespace mxu;
  using namespace mxu::tc;
  const int K = Geo<W>::D * m, R = Geo<W>::E * m;
  for (int idx = threadIdx.x; idx < NR * k_pad; idx += SHORT_THREADS) {
    const int r = idx / k_pad, c = idx % k_pad;
    mat[(c / BK) * (NR * BK) + swz(r, c % BK)] =
        r < R && c < K ? (uint8_t)__ldg(A + r * K + c) : (uint8_t)0;
  }
}

// The short form's epilogue: every (k, column) of the tile, m * N items (one
// a thread at m = 2), reduced from Z and stored along b.
template <int W>
__device__ __forceinline__ void short_epilogue(const mxu::tc::Level& L, long long b0,
                                               const int* Z) {
  using namespace mxu;
  using namespace mxu::tc;
  constexpr int E = Geo<W>::E;
  const int m = L.m;
  for (int idx = threadIdx.x; idx < m * N; idx += SHORT_THREADS) {
    const int kk = idx / N, bl = idx % N;
    const long long b = b0 + bl;
    if (b >= L.B) continue;
    int z[E];
#pragma unroll
    for (int e = 0; e < E; ++e) z[e] = Z[(e * m + kk) * ZS + bl];
    uint32_t y[W];
    reduce<W>(z, L.fc, y);
#pragma unroll
    for (int q = 0; q < W; ++q) L.out[((long long)q * m + kk) * L.B + b] = y[q];
  }
}

// K1's short form: a block of two warpgroups stages the conv matrix once and
// walks its span of ceil(tiles / gridDim.x) tiles of N columns. Per tile:
// the digit tile from x; warpgroup g runs the k_pad / BK wgmma steps of
// columns g*NM .. g*NM+NM-1 against the one row half (m64n160k32, E*m rows
// used); the sums go through Z to the epilogue. SHORT_BLOCKS blocks share an
// SM (128 registers a thread), so that one block's loads and tensor-core
// steps run under another's epilogue.
template <int W>
__global__ void __launch_bounds__(mxu::tc::SHORT_THREADS, mxu::tc::SHORT_BLOCKS)
    base_ntt_mxu_short_kernel(mxu::tc::Level L) {
  using namespace mxu;
  using namespace mxu::tc;
  extern __shared__ uint8_t short_smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(((uintptr_t)short_smem_raw + ALIGN - 1) &
                                             ~(uintptr_t)(ALIGN - 1));
  const int m = L.m, R = Geo<W>::E * m, nk = L.k_pad / BK;
  const long long tiles = (L.B + N - 1) / N, span = (tiles + gridDim.x - 1) / gridDim.x;
  const long long t0 = (long long)blockIdx.x * span;
  const long long t1 = t0 + span < tiles ? t0 + span : tiles;
  uint8_t* mat = smem;
  uint8_t* dig = smem + NR * L.k_pad;
  int* Z = reinterpret_cast<int*>(dig);
  const int g = threadIdx.x >> 7, w4 = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;

  short_matrix<W>(L.A, m, L.k_pad, mat);
  for (long long t = t0; t < t1; ++t) {
    const long long b0 = t * N;
    __syncthreads();  // the last tile's epilogue is done with Z
    short_digits<W>(L, b0, dig);
    __syncthreads();  // the digit tile (and the matrix) is visible to wgmma
    int acc[NR / 2];  // the first step overwrites it
    wgmma_fence();
    for (int kb = 0; kb < nk; ++kb)
      wgmma_s8(acc, desc(dig + kb * (N * BK) + g * NM * BK), desc(mat + kb * (NR * BK)), kb > 0);
    wgmma_commit();
    wgmma_wait<0>();
    __syncthreads();  // both warpgroups are done with the digit tile, which Z overwrites
    // thread (warp w4 of warpgroup g, lane) holds columns g*NM + w4*16 + lane/4
    // (+8) and GEMM rows 8j + 2*(lane%4) (+1)
    const int col = g * NM + w4 * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < NR / 8; ++j) {
      const int row = j * 8 + (lane & 3) * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (row + h < R) {
          Z[(row + h) * ZS + col] = acc[4 * j + h];
          Z[(row + h) * ZS + col + 8] = acc[4 * j + 2 + h];
        }
      }
    }
    __syncthreads();
    short_epilogue<W>(L, b0, Z);
  }
}

// The tensor-core kernels, one name each, instantiated for W and for the
// passes of the digit tile (P = 2 only at m = 64).
enum TcKind { TC_BASE, TC_STACK, TC_SUBNTT, TC_LEVEL, TC_PROBE };
using TcKernel = void (*)(const CUtensorMap, mxu::tc::Level);

template <int W, int P>
static TcKernel tc_kernel(TcKind kind) {
  switch (kind) {
    case TC_BASE: return base_ntt_mxu_kernel<W, P>;
    case TC_STACK: return fused_level_stack_kernel<W, P>;
    case TC_SUBNTT: return fused_subntt_kernel<W, P>;
    case TC_PROBE: return fused_level_probe_kernel<W, P>;
    default: return fused_level_kernel<W, P>;
  }
}

// K1 / K2 / K3 / K4 / K7: checks the launch plan (kt, k_pad, m_pad, blocks, smem)
// against the operands and launches it; cudaErrorInvalidValue for a plan the
// kernel cannot take. Above m = 32 the depth is streamed in passes of 32 rows
// (tc::contract): it must be unpadded, and a row chunk must lie in one pass.
template <int W>
static int launch_tc(TcKind kind, mxu::tc::Level& L, long long NT, long long blocks, int smem,
                     void* stream) {
  using namespace mxu;
  constexpr int D = Geo<W>::D, E = Geo<W>::E;
  const int m = L.m, kt = L.kt, K = D * m;
  const bool ok = m >= 2 && m <= MAX_LEVEL_M && !(m & (m - 1)) && L.B >= 1 && kt >= 1 &&
                  kt <= m && !(kt & (kt - 1)) && L.k_pad >= K && L.k_pad % tc::BK == 0 &&
                  (m <= tc::BK || (L.k_pad == K && tc::BK % kt == 0)) &&
                  L.m_pad == tc::ROWS && E * kt <= tc::ROWS &&
                  (kind != TC_BASE || E * m > tc::NR) &&
                  blocks == (L.B + tc::N - 1) / tc::N * (m / kt) && blocks <= 0x7fffffffLL &&
                  smem >= tc::smem_bytes(W, D, E, m, kt, L.k_pad) && smem <= tc::MAX_SMEM &&
                  (L.a_stride == 0 || L.a_rep >= 1) && NT >= 1 && L.t_rep >= 1 &&
                  L.B % L.t_rep == 0 &&
                  (L.t_period == L.B || (L.t_rep == 1 && L.t_period >= 1 &&
                                         L.B % L.t_period == 0 &&
                                         !(L.t_period & (L.t_period - 1))));
  if (!ok) return (int)cudaErrorInvalidValue;
  CUtensorMap map{};
  L.tma = K % 16 == 0;
  if (L.tma && !tc::stack_map(&map, L.A, E, m, K, NT, kt)) return (int)cudaErrorInvalidValue;
  const TcKernel kernel = tc::passes(m) == 2 ? tc_kernel<W, 2>(kind) : tc_kernel<W, 1>(kind);
  cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  kernel<<<(unsigned)blocks, tc::THREADS, smem, (cudaStream_t)stream>>>(map, L);
  return (int)cudaGetLastError();
}

// K1's short form: checks its plan (kt = m, the padded depth, m_pad = NR,
// blocks that each cover ceil(tiles / blocks) column tiles, none empty, smem
// for SHORT_BLOCKS blocks an SM) against the operands and launches it;
// cudaErrorInvalidValue for a plan the kernel cannot take.
template <int W>
static int launch_short(mxu::tc::Level& L, long long blocks, int smem, void* stream) {
  using namespace mxu;
  constexpr int D = Geo<W>::D, E = Geo<W>::E;
  const int m = L.m;
  const long long tiles = (L.B + tc::N - 1) / tc::N;
  const long long span = blocks >= 1 ? (tiles + blocks - 1) / blocks : 1;
  const bool ok = m >= 2 && !(m & (m - 1)) && E * m <= tc::NR && L.B >= 1 && L.kt == m &&
                  L.k_pad == (D * m + tc::BK - 1) / tc::BK * tc::BK && L.m_pad == tc::NR &&
                  blocks >= 1 && blocks <= 0x7fffffffLL && (tiles + span - 1) / span == blocks &&
                  smem >= tc::short_smem_bytes(E, m, L.k_pad) &&
                  tc::SHORT_BLOCKS * smem <= tc::MAX_SMEM;
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaError_t rc = cudaFuncSetAttribute(base_ntt_mxu_short_kernel<W>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  base_ntt_mxu_short_kernel<W><<<(unsigned)blocks, tc::SHORT_THREADS, smem,
                                  (cudaStream_t)stream>>>(L);
  return (int)cudaGetLastError();
}

// The form a plan names: K1's short form where its m_pad is one row half
// (NR), else the tensor-core block of launch_tc.
template <int W>
static int launch(TcKind kind, mxu::tc::Level& L, long long NT, long long blocks, int smem,
                  void* stream) {
  if (kind == TC_BASE && L.m_pad == mxu::tc::NR) return launch_short<W>(L, blocks, smem, stream);
  return launch_tc<W>(kind, L, NT, blocks, smem, stream);
}

// Fills in the plan and the field, and launches the instantiation for n_words.
static int tc_entry(TcKind kind, mxu::tc::Level& L, long long NT, const uint32_t* p,
                    uint32_t np0, int n_words, int kt, int k_pad, int m_pad, long long blocks,
                    int smem, void* stream) {
  L.kt = kt;
  L.k_pad = k_pad;
  L.m_pad = m_pad;
  L.fc = mxu::field_const(p, np0);
  switch (n_words) {
    case 8: return launch<8>(kind, L, NT, blocks, smem, stream);
    case 2: return launch<2>(kind, L, NT, blocks, smem, stream);
    case 1: return launch<1>(kind, L, NT, blocks, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The operands every tensor-core level takes; T3, if any, at batch resolution.
static mxu::tc::Level tc_operands(const void* x, const void* A, const void* T3, void* out, int m,
                                  long long B) {
  mxu::tc::Level L{};
  L.x = static_cast<const uint32_t*>(x);
  L.A = static_cast<const int8_t*>(A);
  L.T3 = static_cast<const uint32_t*>(T3);
  L.t_rep = 1;
  L.t_period = B;
  L.out = static_cast<uint32_t*>(out);
  L.m = m;
  L.B = B;
  return L;
}

extern "C" int mxu_base_ntt(const void* x, const void* A, void* out, int m, long long B,
                            const uint32_t* p, uint32_t np0, int n_words, int kt, int k_pad,
                            int m_pad, long long blocks, int smem, void* stream) {
  mxu::tc::Level L = tc_operands(x, A, nullptr, out, m, B);
  return tc_entry(TC_BASE, L, 1, p, np0, n_words, kt, k_pad, m_pad, blocks, smem, stream);
}

extern "C" int mxu_fused_level(const void* x, const void* A, const void* T3, void* out,
                               int transpose, int m, long long B, const uint32_t* p,
                               uint32_t np0, int n_words, int kt, int k_pad, int m_pad,
                               long long blocks, int smem, void* stream) {
  mxu::tc::Level L = tc_operands(x, A, T3, out, m, B);
  L.transpose = transpose;
  return tc_entry(TC_LEVEL, L, 1, p, np0, n_words, kt, k_pad, m_pad, blocks, smem, stream);
}

// Bytes of one stack entry int8[E*m, D*m] of a W-word field.
template <int W>
constexpr long long entry_bytes(int m) {
  return (long long)(mxu::Geo<W>::E * m) * (mxu::Geo<W>::D * m);
}

static long long stack_stride(int n_words, int m) {
  return n_words == 8 ? entry_bytes<8>(m) : n_words == 2 ? entry_bytes<2>(m) : entry_bytes<1>(m);
}

// t_period: T3's columns, B or the period s0 of a periodic T3[W, m, s0].
// transpose: the output is [W, B, m] (else [W, m, B]).
extern "C" int mxu_fused_level_stack(const void* x, const void* As, long long rep,
                                     const void* T3, long long t_period, void* out,
                                     int transpose, int m, long long B, const uint32_t* p,
                                     uint32_t np0, int n_words, int kt, int k_pad, int m_pad,
                                     long long blocks, int smem, void* stream) {
  if (rep < 1 || B % rep) return (int)cudaErrorInvalidValue;
  mxu::tc::Level L = tc_operands(x, As, T3, out, m, B);
  L.transpose = transpose;
  L.t_period = t_period;
  L.a_stride = stack_stride(n_words, m);
  L.a_rep = rep;
  return tc_entry(TC_STACK, L, B / rep, p, np0, n_words, kt, k_pad, m_pad, blocks, smem, stream);
}

extern "C" int mxu_fused_subntt(const void* x, const void* A, const void* T3, long long rep,
                                void* out, int transpose, int m, long long B,
                                const uint32_t* p, uint32_t np0, int n_words, int kt, int k_pad,
                                int m_pad, long long blocks, int smem, void* stream) {
  mxu::tc::Level L = tc_operands(x, A, T3, out, m, B);
  L.transpose = transpose;
  L.t_rep = rep;
  return tc_entry(TC_SUBNTT, L, 1, p, np0, n_words, kt, k_pad, m_pad, blocks, smem, stream);
}

extern "C" int mxu_fused_level_probe(const void* x, const void* A, const void* T3, void* out,
                                     int stage, int m, long long B, const uint32_t* p,
                                     uint32_t np0, int n_words, int kt, int k_pad, int m_pad,
                                     long long blocks, int smem, void* stream) {
  if (stage < STREAM || stage > TW || (T3 != nullptr) != (stage == TW))
    return (int)cudaErrorInvalidValue;
  mxu::tc::Level L = tc_operands(x, A, T3, out, m, B);
  L.stage = stage;
  return tc_entry(TC_PROBE, L, 1, p, np0, n_words, kt, k_pad, m_pad, blocks, smem, stream);
}

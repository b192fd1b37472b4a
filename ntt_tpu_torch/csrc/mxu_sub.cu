// K3, multi-level: a whole m-point sub-NTT (m = 64 .. 1024) with its decomposition
// twiddle in one launch, on uint32[W, m, B] (W = 8, 2 or 1 words per element),
// stored as [W, m, B] or, on request (transpose_out of the JAX entry), as
// [W, B, m].
//
// mxu_fused_subntt_multi and, on the narrow fields above one wave of blocks,
// mxu_fused_subntt_wide (its wide form, below) replace the multi-level form of
// ntt_tpu/kernels/mxu_level.py::_kernel_sub (made by _build_sub, entered through fused_subntt):
// the peel-32 recursion of the m-point transform on one resident tile. With
// m2 = m / 32 and a column viewed as x[i1 * m2 + i2]:
//   level A  32-point transforms over i1, one digit matmul against the conv matrix
//            A1[E*32, D*32], then the inner twiddle w_m^(k1 * i2) from
//            Tin[W, 32, m2] (Montgomery form; the inverse root for an inverse
//            transform: the wrapper passes the table for its direction);
//   level B  m2-point transforms over i2, a second digit matmul against
//            A2[E*m2, D*m2]; the element for (k2, k1) is output row k2 * 32 + k1;
//   then the optional decomposition twiddle T3, indexed by that row: T3[W, m, B]
//   for rep == 1, the i2-resolution table T3[W, B / rep, m] for rep > 1 (read
//   directly at [w, b / rep, row]); the word stored at [w, row, b], or at
//   [w, b, row] for the transposed store (out_at: each thread writes its own
//   words, a chunk's kt rows k1 of one k2 contiguous there).
// At m = 1024 (m2 = 32, the small Proth prime's peel under
// NTT_MXU_SUBBASE_LOG=10) level B is a 32-point contraction like level A's: A2
// is A1's shape, bt = 4 columns a block, and the wide form's A2 two row units
// (W = 1; at W = 2 its block-diagonal A2 alone exceeds a block, and the
// present form takes every launch).
//
// Both levels contract on the int8 tensor cores with the core of K1-K4
// (mxu_core.cuh, tc::contract: the TMA ring or the cp.async chunk, the 32-byte
// swizzle, wgmma m64n160k32 s8, the Z tile, reduce<W> and mont_mul<W>). In
// x[W, m, B] = x[W, 32, m2 * B], level A is a 32-point level over the virtual
// columns (i2, b). A block owns a chunk of kt output rows k1 and bt = 128 / m2
// batch columns, so its level-A output is all the input its level B needs, and
// both contractions stay inside the block:
//   level A  one contraction of the chunk's rows of A1 (GEMM rows e * kt + kk)
//            against the digit tile of the 128 virtual columns v = i2 * bt + bl
//            (a warp stages 8 consecutive columns, consecutive b of one x row);
//            then reduce, times Tin, into the shared tile Y[w][i2][kk * bt + bl],
//            which aliases neither the ring, the digit tile nor the Z tile;
//   level B  for each 128 of the kt * bt virtual columns u = kk * bt + bl and each
//            kt2 rows k2 of A2 (more than one row pass only at W = 8, whose
//            E * m2 rows exceed a block's 320), one contraction against the digit
//            tile staged from Y; then reduce, T3, and the store at row
//            k2 * 32 + k1, b.
// A1's rows always come through the TMA ring (D * 32 is a 16-byte multiple); A2's
// where D * m2 is one (W = 2 and m2 >= 8, W = 1 and m2 = 16, W = 8 and m2 = 16),
// else by cp.async of the whole chunk. The launch plan (kt, kt2, the padded
// depths, Y's row stride and offset, the grid, shared bytes) is computed by the
// Python wrapper (mxu_level.sub_plan), which owns Y's layout; the launcher only
// checks that the plan is safe.
//
// Bound on an H100 at the narrow main path's shape (Goldilocks, W = 2, n = 2^18:
// two launches of m = 512, B = 512): a launch moves the data in and out, the
// twiddle table and the two matrices, 6.5 MB with T3 and 4.4 MB without, 1.95 us
// and 1.33 us at 3.35 TB/s; it needs 1.26 G int8 MACs (the band of the
// narrow-field matrices: D of each E = 2D - 1 digit blocks of a row; A1 over
// 16 * B virtual columns, A2 over 32 * B), 1.27 us at the 1,979 TOPS int8 tensor
// peak: bytes bound both launches. The kernel contracts the banded matrices
// densely (2.4 G MACs, the zero blocks included). At B = 512 a launch is 2 row
// chunks x 64 column tiles = 128 blocks, one wave on 132 SMs, so it takes about
// one block's time: two contractions (10 and 5 steps of 32) and two epilogues in
// series. The wide launches of Goldilocks 2^24 are bound by bytes too: its
// levels [2,512,32768] with T3 at rep 1 move 403 MB (0.120 ms), its base
// [2,64,2^18] 268 MB (0.080 ms); the present form takes 32x and 12x that (62
// waves of its blocks), the wide form below is made for them. The small Proth
// prime's launches at m = 1024 (NTT_MXU_SUBBASE_LOG=10: [1,1024,1024] at 2^20)
// are bound by bytes as well: 12.6 MB with T3 at rep 1 (3.8 us) against 1.68 G
// banded MACs (1.7 us).
#include "mxu_core.cuh"

namespace mxu {

// Level A's transform length, the peel of the recursion: 32 whatever the
// single-level kernels' largest m (MAX_LEVEL_M) and NTT_MXU_BASE_LOG are; and
// the longest sub-NTT (level B at most PEEL points too)
constexpr int PEEL = 32;
constexpr int MAX_SUB = PEEL * PEEL;

struct SubLevel {
  tc::Level a;          // level A: A1 (m = 32), kt rows k1 a block, padded depth, TMA
  tc::Level b;          // level B: A2 (m = m2), kt2 rows k2 a row pass, padded depth, TMA
  const uint32_t* x;    // [W, m, B]
  const uint32_t* Tin;  // inner twiddle [W, 32, m2]
  const uint32_t* T3;   // decomposition twiddle, or nullptr
  long long t_rep;      // 1: T3 is [W, m, B]; > 1: T3 is [W, B / t_rep, m]
  uint32_t* out;        // [W, m, B], or [W, B, m] when transpose
  int transpose;
  int m, m2;
  int lbt;              // log2 of bt, the batch columns a block owns (bt * m2 = 128)
  int ys;               // words between the rows i2 of Y (the plan's)
  int y_off;            // bytes from the aligned shared base to Y (the plan's)
  long long B;
  FieldConst fc;
};

// Where word q of output (row, b) goes: [W, m, B], or [W, B, m] when transpose.
__device__ __forceinline__ long long out_at(int transpose, int q, int m, long long B, int row,
                                            long long b) {
  return transpose ? ((long long)q * B + b) * m + row : ((long long)q * m + row) * B + b;
}

// Level A's epilogue: Z of the block's rows k1 = k0 + kk over the virtual columns
// v = i2 * bt + bl, reduced and multiplied by Tin[w, k1, i2], into Y.
template <int W>
__device__ __forceinline__ void epilogue_a(const SubLevel& S, int k0, const uint8_t* smem,
                                           uint32_t* Y) {
  constexpr int E = Geo<W>::E, N = tc::N;
  const int kt = S.a.kt, bt = 1 << S.lbt;
  const int* Z = reinterpret_cast<const int*>(smem);
  for (int idx = threadIdx.x; idx < kt * N; idx += tc::THREADS) {
    const int kk = idx / N, v = idx % N, i2 = v >> S.lbt, bl = v & (bt - 1);
    uint32_t t[W];  // the twiddle's load runs under the reduction
#pragma unroll
    for (int q = 0; q < W; ++q) t[q] = __ldg(S.Tin + (q * PEEL + k0 + kk) * S.m2 + i2);
    int z[E];
#pragma unroll
    for (int e = 0; e < E; ++e) z[e] = Z[(e * kt + kk) * tc::ZS + v];
    uint32_t y[W], r[W];
    reduce<W>(z, S.fc, y);
    mont_mul<W>(y, t, S.fc, r);
#pragma unroll
    for (int q = 0; q < W; ++q) Y[(q * S.m2 + i2) * S.ys + kk * bt + bl] = r[q];
  }
}

// Level B's epilogue for the virtual columns u0 .. u0+N-1 (u = kk * bt + bl) and
// rows k2 = k2_0 .. k2_0+kt2-1: reduce, T3 at row k2 * 32 + k1, the store.
template <int W>
__device__ __forceinline__ void epilogue_b(const SubLevel& S, long long b0, int k0, int u0,
                                           int k2_0, const uint8_t* smem) {
  constexpr int E = Geo<W>::E, N = tc::N;
  const int kt2 = S.b.kt, bt = 1 << S.lbt, V = S.a.kt * bt;
  const int* Z = reinterpret_cast<const int*>(smem);
  for (int idx = threadIdx.x; idx < kt2 * N; idx += tc::THREADS) {
    const int kk2 = idx / N, col = idx % N, u = u0 + col;
    const long long b = b0 + (u & (bt - 1));
    if (u >= V || b >= S.B) continue;
    const int row = (k2_0 + kk2) * PEEL + k0 + (u >> S.lbt);
    uint32_t t[W];  // the twiddle's load runs under the reduction
    if (S.T3 != nullptr) load_twiddle<W>(S.T3, S.t_rep, S.B, S.m, S.B, row, b, t);
    int z[E];
#pragma unroll
    for (int e = 0; e < E; ++e) z[e] = Z[(e * kt2 + kk2) * tc::ZS + col];
    uint32_t y[W];
    reduce<W>(z, S.fc, y);
    if (S.T3 != nullptr) {
      uint32_t r[W];
      mont_mul<W>(y, t, S.fc, r);
#pragma unroll
      for (int q = 0; q < W; ++q) y[q] = r[q];
    }
#pragma unroll
    for (int q = 0; q < W; ++q) S.out[out_at(S.transpose, q, S.m, S.B, row, b)] = y[q];
  }
}

// One block: column tile blockIdx.x / (32 / kt), row chunk blockIdx.x % (32 / kt).
template <int W>
__global__ void __launch_bounds__(tc::THREADS, 1)
    fused_subntt_multi_kernel(const __grid_constant__ CUtensorMap map_a,
                              const __grid_constant__ CUtensorMap map_b, SubLevel S) {
  extern __shared__ uint8_t sub_smem_raw[];
  __shared__ __align__(8) uint64_t full[tc::STAGES];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      ((uintptr_t)sub_smem_raw + tc::ALIGN - 1) & ~(uintptr_t)(tc::ALIGN - 1));
  uint32_t* Y = reinterpret_cast<uint32_t*>(smem + S.y_off);
  const int kt = S.a.kt, chunks = PEEL / kt, bt = 1 << S.lbt;
  const long long b0 = (long long)(blockIdx.x / chunks) * bt;
  const int k0 = (blockIdx.x % chunks) * kt;

  // level A: x[w, i1 * m2 + i2, b] is element (i1, v = i2 * bt + bl) of a 32-row operand
  tc::contract<W, 1>(S.a, &map_a, 0, k0, smem, full, [&](long long, long long, int, uint8_t* dig) {
    tc::stage_tile<W>(PEEL, S.a.k_pad, [&](int i1, int v, uint32_t (&w)[W]) {
      const long long b = b0 + (v & (bt - 1));
      const long long row = (long long)i1 * S.m2 + (v >> S.lbt);
#pragma unroll
      for (int q = 0; q < W; ++q) w[q] = b < S.B ? S.x[(q * S.m + row) * S.B + b] : 0u;
    }, dig);
  });
  epilogue_a<W>(S, k0, smem, Y);

  // level B: Y[w][i2][u0 + col] is element (i2, col) of an m2-row operand
  const int V = kt * bt;
  for (int u0 = 0; u0 < V; u0 += tc::N) {
    for (int k2 = 0; k2 < S.m2; k2 += S.b.kt) {
      tc::fence_async_shared();
      __syncthreads();  // Y is written and Z read: the ring may refill
      auto stage_y = [&](long long, long long, int, uint8_t* dig) {
        tc::stage_tile<W>(S.m2, S.b.k_pad, [&](int i2, int col, uint32_t (&w)[W]) {
          const int u = u0 + col;
#pragma unroll
          for (int q = 0; q < W; ++q) w[q] = u < V ? Y[(q * S.m2 + i2) * S.ys + u] : 0u;
        }, dig);
      };
      tc::contract<W, 1>(S.b, &map_b, 0, k2, smem, full, stage_y);
      epilogue_b<W>(S, b0, k0, u0, k2, smem);
    }
  }
}

// Checks the launch plan (kt, kt2, the padded depths and rows, Y's stride and
// offset, blocks, smem) against the operands and launches it: Y must hold the
// block's kt * bt columns a row and lie past both contractions' bytes.
// cudaErrorInvalidValue for a plan the kernel cannot take.
template <int W>
static int launch_sub(SubLevel& S, long long blocks, int smem, void* stream) {
  constexpr int D = Geo<W>::D, E = Geo<W>::E;
  const int m2 = S.m2, kt = S.a.kt, kt2 = S.b.kt, bt = tc::N / m2;
  S.a.tma = (D * PEEL) % 16 == 0;
  S.b.tma = (D * m2) % 16 == 0;
  const int ca = tc::contract_bytes(D, E, PEEL, kt, S.a.k_pad);
  const int cb = tc::contract_bytes(D, E, m2, kt2, S.b.k_pad);
  const bool ok = kt >= 1 && kt <= PEEL && !(kt & (kt - 1)) && E * kt <= tc::ROWS &&
                  kt2 >= 1 && kt2 <= m2 && !(kt2 & (kt2 - 1)) && E * kt2 <= tc::ROWS &&
                  S.a.k_pad >= D * PEEL && S.a.k_pad % tc::BK == 0 && S.b.k_pad >= D * m2 &&
                  S.b.k_pad % tc::BK == 0 && S.a.m_pad == tc::ROWS && S.b.m_pad == tc::ROWS &&
                  blocks == (S.B + bt - 1) / bt * (PEEL / kt) && blocks <= 0x7fffffffLL &&
                  smem >= tc::ALIGN + S.y_off + W * m2 * S.ys * 4 && smem <= tc::MAX_SMEM &&
                  S.ys >= kt * bt && S.y_off >= ca && S.y_off >= cb && S.y_off % 16 == 0 &&
                  S.t_rep >= 1 && S.B % S.t_rep == 0;
  if (!ok) return (int)cudaErrorInvalidValue;
  CUtensorMap map_a{}, map_b{};
  if (!tc::stack_map(&map_a, S.a.A, E, PEEL, D * PEEL, 1, kt)) return (int)cudaErrorInvalidValue;
  if (S.b.tma && !tc::stack_map(&map_b, S.b.A, E, m2, D * m2, 1, kt2))
    return (int)cudaErrorInvalidValue;
  cudaError_t rc = cudaFuncSetAttribute(fused_subntt_multi_kernel<W>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  fused_subntt_multi_kernel<W>
      <<<(unsigned)blocks, tc::THREADS, smem, (cudaStream_t)stream>>>(map_a, map_b, S);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The wide form (W = 1, 2): launches of more than one wave of the blocks above.
// ---------------------------------------------------------------------------
//
// Above one wave the blocks above run their phases in series, one block an SM,
// each staging its conv-matrix rows again (97 KB of A1 a block at W = 2), and
// at m2 <= 8 level B runs in V / 128 short passes of one wgmma step each, most
// of its 320 GEMM rows padding. fused_subntt_wide_kernel computes the same
// words in persistent blocks, one an SM, each owning a row chunk of kt rows k1
// and walking a span of column tiles (bt = 128 / m2 batch columns, the 128
// virtual columns (i2, b) of level A):
//   - both matrices are staged once a block and stay resident: A1's rows of
//     the chunk, and A2 as a block-diagonal matrix of lb / m2 copies of itself
//     (lb = max(S, m2) GEMM rows a level-B column, S below), so that level B
//     contracts lb / m2 of its m2-point vectors in one column and runs as one
//     pass: one wgmma N half for every m2 <= 8 at W = 2 and every m2 <= 16 at
//     W = 1 (two at m2 = 32);
//   - the GEMM rows of each wgmma N half are slot-major, plane e of output slot
//     s at row e * 8 + s (groups of 8 slots GS rows apart, GW groups a half: GS
//     = 160 at W = 2, 80 at W = 1), so that the accumulator registers of a
//     thread hold every plane of its outputs (slots 2 (lane % 4) + {0, 1} of
//     each group, two columns): both epilogues reduce from registers, with no
//     Z tile. A block's four warpgroups each run one wgmma series a level
//     (level A: two column halves x two row units of S rows k1; level B:
//     cb / 64 column groups x lb / S row units, cb = kt * 128 / lb columns).
//     The reductions add each plane into its 64-bit lane by one mad.wide
//     (reduce<W, true>), and level B's epilogue issues the twiddle loads of
//     all its outputs before the first reduction.
// Per tile: the digit tile of x (tc::stage_tile), level A's NKA steps, its
// epilogue into the shared tile Y[w][kk][v] (reduce, times Tin), the digit
// tile of Y (column (kk, bl / R), rows (bl % R, i2), R = lb / m2), level B's
// steps, its epilogue (reduce, T3, the store at row k2 * 32 + k1). Three
// barriers a tile. At W = 2 the two row chunks of a tile are two blocks, each
// turning the tile into digits: A1 whole (608 GEMM rows, 194,560 bytes) and
// the digit tile (40,960) exceed the 232,448 bytes of a block. The plan
// (mxu_level.sub_wide_plan) puts the chunks of one span of tiles in
// neighbouring blocks, so that the second read of a tile comes from L2.
// The present form stays for one wave or less (Goldilocks 2^18: 128 blocks),
// for W = 8 (its K3 multi runs only under NTT_MXU_SUB256_LOG) and for W = 2 at
// m = 1024 (A1's two units and the block-diagonal A2's four exceed a block).
namespace wide {

constexpr int YS = tc::N + 4;  // words between Y's rows kk (conflict-free stores)
constexpr int LOG_N = 7;       // log2 of the columns of a tile of level A
static_assert(1 << LOG_N == tc::N, "LOG_N");

// The slot geometry of a W-word field.
template <int W>
struct G {
  static constexpr int D = Geo<W>::D, E = Geo<W>::E;
  static constexpr int GS = (8 * E + 15) / 16 * 16;  // GEMM rows of a group of 8 slots
  static constexpr int GW = tc::NR / GS;             // groups a wgmma N half holds
  static constexpr int S = 8 * GW;                   // output rows (slots) a wgmma holds
  static constexpr int KT = 2 * S;                   // rows k1 a block owns: two row units
  static constexpr int KA = D * PEEL;                // level A's depth
  static constexpr int NKA = KA / tc::BK;
  static_assert(KA % tc::BK == 0 && GW >= 1 && PEEL % KT == 0, "the slot geometry");
};

// Shared bytes of a block (past the ALIGN slack): A1's two row units, A2's lb /
// S row units, the digit tile of either level and Y. Python's
// mxu_level.sub_wide_plan computes the same.
template <int W>
__host__ __device__ inline int a1_bytes() {
  return G<W>::NKA * 2 * tc::NR * tc::BK;
}
template <int W>
__host__ __device__ inline int a2_bytes(int lb, int kb_pad) {
  return kb_pad / tc::BK * (lb / G<W>::S) * tc::NR * tc::BK;
}
template <int W>
__host__ __device__ inline int dig_bytes(int lb, int kb_pad) {
  const int a = tc::N * G<W>::KA, b = G<W>::KT * tc::N / lb * kb_pad;
  return a > b ? a : b;
}
template <int W>
__host__ __device__ inline int smem_bytes(int lb, int kb_pad) {
  return a1_bytes<W>() + a2_bytes<W>(lb, kb_pad) + dig_bytes<W>(lb, kb_pad) +
         W * G<W>::KT * YS * 4;
}

}  // namespace wide

// Keeps the reads of the accumulators after the wait for the wgmma that
// writes them (an empty asm that the compiler takes to write every one).
__device__ __forceinline__ void fence_acc(int (&acc)[tc::NR / 2]) {
#pragma unroll
  for (int i = 0; i < tc::NR / 2; ++i) asm volatile("" : "+r"(acc[i])::"memory");
}

struct SubWide {
  const uint32_t* x;    // [W, m, B]
  const int8_t* A1;     // [E*32, D*32]
  const int8_t* A2;     // [E*m2, D*m2]
  const uint32_t* Tin;  // [W, 32, m2]
  const uint32_t* T3;   // as SubLevel's, or nullptr
  long long t_rep;
  uint32_t* out;        // [W, m, B], or [W, B, m] when transpose
  int transpose;
  int m, m2, lm2;       // lm2 = log2 m2
  int lbt;              // log2 bt
  int lb, llb;          // level B's rows a column and its log2
  int kb_pad;           // level B's depth, padded
  long long B;
  long long span;       // column tiles a block walks
  FieldConst fc;
};

// Both matrices into shared memory, once a block. A1: GEMM row n of row unit
// ua (n = sg * GS + e * 8 + s) is matrix row e * 32 + k0 + ua * S + sg * 8 + s,
// 16 bytes a load. A2 block-diagonal: slot sigma = (ub * GW + sg) * 8 + s of
// unit ub is row k2 = sigma % m2 of vector r = sigma / m2; contraction byte
// c = j * lb + rho (digit j of row rho = r' * m2 + i2) holds digit j of A2's
// entry (k2, i2) where r' == r, else zero. Zero past E planes and past the
// depth. The proxy fence of these writes is the first digit staging's.
template <int W>
__device__ __forceinline__ void wide_matrices(const SubWide& S, int k0, uint8_t* a1,
                                              uint8_t* a2) {
  using namespace tc;
  using Gw = wide::G<W>;
  constexpr int E = Gw::E, GS = Gw::GS, GW = Gw::GW, KA = Gw::KA, CH = KA / 16;
  for (int idx = threadIdx.x; idx < 2 * NR * CH; idx += THREADS) {
    const int rho = idx / CH, c = (idx % CH) * 16;
    const int ua = rho / NR, n = rho % NR, sg = n / GS, e = (n % GS) >> 3, s = n & 7;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (sg < GW && e < E)
      v = __ldg(reinterpret_cast<const uint4*>(
          S.A1 + (long long)(e * PEEL + k0 + ua * Gw::S + sg * 8 + s) * KA + c));
    *reinterpret_cast<uint4*>(a1 + ((c / BK) * 2 + ua) * (NR * BK) + swz(n, c % BK)) = v;
  }
  const int units = S.lb / Gw::S, K2 = Gw::D * S.m2, mask = S.m2 - 1;
  for (int kb = 0; kb < S.kb_pad / BK; ++kb) {
    for (int idx = threadIdx.x; idx < units * NR * BK; idx += THREADS) {
      const int rho = idx / BK, c = kb * BK + idx % BK;
      const int ub = rho / NR, n = rho % NR, sg = n / GS, e = (n % GS) >> 3, s = n & 7;
      const int sigma = (ub * GW + sg) * 8 + s, j = c >> S.llb, rho2 = c & (S.lb - 1);
      uint8_t v = 0;
      if (sg < GW && e < E && j < Gw::D && (rho2 >> S.lm2) == (sigma >> S.lm2))
        v = (uint8_t)__ldg(S.A2 + (long long)(e * S.m2 + (sigma & mask)) * K2 + j * S.m2 +
                           (rho2 & mask));
      a2[(kb * units + ub) * (NR * BK) + swz(n, idx % BK)] = v;
    }
  }
}

// Level A's epilogue from the registers of row unit ua, column half mh: for
// each slot (kk = ua * S + sg * 8 + 2 (lane % 4) + h) and column (v), the
// planes acc[4 (sg * GS / 8 + e) + 2c + h], reduced, times Tin[w, k0 + kk, i2],
// into Y[w][kk][v].
template <int W>
__device__ __forceinline__ void wide_epilogue_a(const SubWide& S, int k0, int mh, int ua,
                                                const int (&acc)[tc::NR / 2], uint32_t* Y) {
  using Gw = wide::G<W>;
  constexpr int E = Gw::E;
  const int lane = threadIdx.x & 31;
  const int col = mh * tc::NM + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int sg = 0; sg < Gw::GW; ++sg) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kk = ua * Gw::S + sg * 8 + (lane & 3) * 2 + h;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int v = col + 8 * c, i2 = v >> S.lbt;
        uint32_t t[W];  // the twiddle's load runs under the reduction
#pragma unroll
        for (int q = 0; q < W; ++q) t[q] = __ldg(S.Tin + (q * PEEL + k0 + kk) * S.m2 + i2);
        int z[E];
#pragma unroll
        for (int e = 0; e < E; ++e) z[e] = acc[4 * (sg * (Gw::GS / 8) + e) + 2 * c + h];
        uint32_t y[W], r[W];
        reduce<W, true>(z, S.fc, y);
        mont_mul<W>(y, t, S.fc, r);
#pragma unroll
        for (int q = 0; q < W; ++q) Y[(q * Gw::KT + kk) * wide::YS + v] = r[q];
      }
    }
  }
}

// Level B's digit tile from Y: column col = kk * (128 / lb) + bh holds the
// rows rho = r * m2 + i2 (r < lb / m2), element Y[w][kk][i2 * bt + bh * (lb /
// m2) + r], digit j at contraction byte j * lb + rho; zero past D * lb. A task
// is four rows of one column (whole words); a warp takes 8 consecutive columns
// x 4 row groups. Ends with the proxy fence of the writes.
template <int W>
__device__ __forceinline__ void wide_stage_b(const SubWide& S, const uint32_t* Y, uint8_t* dig) {
  using namespace tc;
  using Gw = wide::G<W>;
  constexpr int D = Gw::D;
  const int lb = S.lb, lcpk = wide::LOG_N - S.llb, cb = Gw::KT << lcpk, lg = S.llb - 2;
  const int K = D * lb;
  const int lr = S.llb - S.lm2, mask = S.m2 - 1;
  auto at = [&](int col, int c) {
    return reinterpret_cast<uint32_t*>(dig + (c / BK) * (cb * BK) + swz(col, c % BK));
  };
  for (int idx = threadIdx.x; idx < cb << lg; idx += THREADS) {
    const int col = (idx >> 3 >> lg << 3) + (idx & 7), rho0 = 4 * ((idx >> 3) & ((1 << lg) - 1));
    const int kk = col >> lcpk, bh = col & ((1 << lcpk) - 1);
    uint32_t w[4][W];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int rho = rho0 + t, v = ((rho & mask) << S.lbt) + (bh << lr) + (rho >> S.lm2);
#pragma unroll
      for (int q = 0; q < W; ++q) w[t][q] = Y[(q * Gw::KT + kk) * wide::YS + v];
    }
#pragma unroll
    for (int j = 0; j < D; ++j)
      *at(col, j * lb + rho0) = pack_digits(digit_hi<W>(w[0], j), digit_hi<W>(w[1], j),
                                            digit_hi<W>(w[2], j), digit_hi<W>(w[3], j));
  }
  for (int idx = threadIdx.x; idx < cb * ((S.kb_pad - K) / 4); idx += THREADS)
    *at(idx % cb, K + 4 * (idx / cb)) = 0u;
  fence_async_shared();
}

// Level B's epilogue from the registers of row unit ub, column group cg: slot
// sigma = (ub * GW + sg) * 8 + 2 (lane % 4) + h is row k2 = sigma % m2 of vector
// r = sigma / m2; column col = kk * (128 / lb) + bh is batch column
// b0 + bh * (lb / m2) + r. The twiddles of all the thread's outputs are loaded
// first, so that their reads overlap; then for each output: reduce, times the
// twiddle of row k2 * 32 + k0 + kk, the store.
template <int W>
__device__ __forceinline__ void wide_epilogue_b(const SubWide& S, long long b0, int k0, int cg,
                                                int ub, const int (&acc)[tc::NR / 2]) {
  using Gw = wide::G<W>;
  constexpr int E = Gw::E, OUTS = Gw::GW * 4;  // outputs a thread: (sg, h, c)
  const int lane = threadIdx.x & 31, lcpk = wide::LOG_N - S.llb, lr = S.llb - S.lm2;
  const int col0 = cg * tc::NM + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  // output o: batch column b0 + bl, row k2 * 32 + k0 + kk
  auto at = [&](int o, int& bl, int& row) {
    const int sigma = (ub * Gw::GW + (o >> 2)) * 8 + (lane & 3) * 2 + ((o >> 1) & 1);
    const int col = col0 + 8 * (o & 1);
    bl = ((col & ((1 << lcpk) - 1)) << lr) + (sigma >> S.lm2);
    row = (sigma & (S.m2 - 1)) * PEEL + k0 + (col >> lcpk);
  };
  uint32_t t[OUTS][W];
  if (S.T3 != nullptr) {
#pragma unroll
    for (int o = 0; o < OUTS; ++o) {
      int bl, row;
      at(o, bl, row);
      if (b0 + bl < S.B) load_twiddle<W>(S.T3, S.t_rep, S.B, S.m, S.B, row, b0 + bl, t[o]);
    }
  }
#pragma unroll
  for (int o = 0; o < OUTS; ++o) {
    int bl, row;
    at(o, bl, row);
    const long long b = b0 + bl;
    if (b >= S.B) continue;
    int z[E];
#pragma unroll
    for (int e = 0; e < E; ++e)
      z[e] = acc[4 * ((o >> 2) * (Gw::GS / 8) + e) + 2 * (o & 1) + ((o >> 1) & 1)];
    uint32_t y[W];
    reduce<W, true>(z, S.fc, y);
    if (S.T3 != nullptr) {
      uint32_t r[W];
      mont_mul<W>(y, t[o], S.fc, r);
#pragma unroll
      for (int q = 0; q < W; ++q) y[q] = r[q];
    }
#pragma unroll
    for (int q = 0; q < W; ++q) S.out[out_at(S.transpose, q, S.m, S.B, row, b)] = y[q];
  }
}

// One block: row chunk blockIdx.x % chunks, column tiles span * (blockIdx.x /
// chunks) onwards (span of them, fewer in the last block).
template <int W>
__global__ void __launch_bounds__(tc::THREADS, 1) fused_subntt_wide_kernel(SubWide S) {
  using namespace tc;
  using Gw = wide::G<W>;
  extern __shared__ uint8_t wide_smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(((uintptr_t)wide_smem_raw + ALIGN - 1) &
                                             ~(uintptr_t)(ALIGN - 1));
  const int lb = S.lb, units = lb / Gw::S, cb = Gw::KT * (N >> S.llb), ncol = cb / NM;
  const int nkb = S.kb_pad / BK, bt = 1 << S.lbt;
  uint8_t* a1 = smem;
  uint8_t* a2 = a1 + wide::a1_bytes<W>();
  uint8_t* dig = a2 + wide::a2_bytes<W>(lb, S.kb_pad);
  uint32_t* Y = reinterpret_cast<uint32_t*>(dig + wide::dig_bytes<W>(lb, S.kb_pad));
  constexpr int chunks = PEEL / Gw::KT;
  const int k0 = (blockIdx.x % chunks) * Gw::KT;
  const long long tiles = (S.B + bt - 1) / bt, t0 = (long long)(blockIdx.x / chunks) * S.span;
  const long long t1 = t0 + S.span < tiles ? t0 + S.span : tiles;
  const int g = threadIdx.x >> 7;

  wide_matrices<W>(S, k0, a1, a2);
  for (long long t = t0; t < t1; ++t) {
    const long long b0 = t * bt;
    __syncthreads();  // the last tile's level-B steps are done with the digit tile
    // level A: x[w, i1 * m2 + i2, b] is element (i1, v = i2 * bt + bl) of a 32-row operand
    tc::stage_tile<W>(PEEL, Gw::KA, [&](int i1, int v, uint32_t (&w)[W]) {
      const long long b = b0 + (v & (bt - 1));
      const long long row = (long long)i1 * S.m2 + (v >> S.lbt);
#pragma unroll
      for (int q = 0; q < W; ++q) w[q] = b < S.B ? S.x[(q * S.m + row) * S.B + b] : 0u;
    }, dig);
    __syncthreads();  // the digit tile (and the matrices) are visible to wgmma
    int acc[NR / 2];  // the first step of each level overwrites it
    {
      const int mh = g & 1, ua = g >> 1;
      wgmma_fence();
#pragma unroll 1
      for (int kb = 0; kb < Gw::NKA; ++kb)
        wgmma_s8(acc, desc(dig + (kb * N + mh * NM) * BK), desc(a1 + (kb * 2 + ua) * NR * BK),
                 kb > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
      wide_epilogue_a<W>(S, k0, mh, ua, acc, Y);
    }
    __syncthreads();  // Y is whole and every level-A step is done with the digit tile
    wide_stage_b<W>(S, Y, dig);
    __syncthreads();
    {
      const int cg = g % ncol, ub = g / ncol;
      wgmma_fence();
#pragma unroll 1
      for (int kb = 0; kb < nkb; ++kb)
        wgmma_s8(acc, desc(dig + (kb * cb + cg * NM) * BK), desc(a2 + (kb * units + ub) * NR * BK),
                 kb > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
      wide_epilogue_b<W>(S, b0, k0, cg, ub, acc);
    }
  }
}

// Checks the wide plan (kt, lb, the padded depths, span and blocks: the row
// chunks of ceil(tiles / span) spans, none empty; smem) against the operands
// and launches it; cudaErrorInvalidValue for a plan the kernel cannot take.
template <int W>
static int launch_wide(SubWide& S, int kt, int ka_pad, long long blocks, int smem, void* stream) {
  using Gw = wide::G<W>;
  constexpr int chunks = PEEL / Gw::KT;
  const int bt = tc::N / S.m2, lb = S.m2 > Gw::S ? S.m2 : Gw::S;
  const long long tiles = (S.B + bt - 1) / bt;
  const bool ok = kt == Gw::KT && S.lb == lb && ka_pad == Gw::KA &&
                  S.kb_pad == (Gw::D * lb + tc::BK - 1) / tc::BK * tc::BK && S.span >= 1 &&
                  blocks >= chunks && blocks % chunks == 0 && blocks <= 0x7fffffffLL &&
                  (tiles + S.span - 1) / S.span == blocks / chunks &&
                  smem >= tc::ALIGN + wide::smem_bytes<W>(lb, S.kb_pad) &&
                  smem <= tc::MAX_SMEM && S.t_rep >= 1 && S.B % S.t_rep == 0;
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaError_t rc = cudaFuncSetAttribute(fused_subntt_wide_kernel<W>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  fused_subntt_wide_kernel<W><<<(unsigned)blocks, tc::THREADS, smem, (cudaStream_t)stream>>>(S);
  return (int)cudaGetLastError();
}

}  // namespace mxu

// transpose (both entries): the output is [W, B, m] (else [W, m, B]).
extern "C" int mxu_fused_subntt_wide(const void* x, const void* A1, const void* A2,
                                     const void* Tin, const void* T3, long long rep,
                                     void* out, int transpose, int m, long long B,
                                     const uint32_t* p, uint32_t np0, int n_words, int kt,
                                     int lb, int ka_pad, int kb_pad, long long span,
                                     long long blocks, int smem, void* stream) {
  if (m < 64 || m > mxu::MAX_SUB || (m & (m - 1)) || B < 1 || lb < 1 || (lb & (lb - 1)))
    return (int)cudaErrorInvalidValue;
  mxu::SubWide S{};
  S.x = static_cast<const uint32_t*>(x);
  S.A1 = static_cast<const int8_t*>(A1);
  S.A2 = static_cast<const int8_t*>(A2);
  S.Tin = static_cast<const uint32_t*>(Tin);
  S.T3 = static_cast<const uint32_t*>(T3);
  S.t_rep = rep;
  S.out = static_cast<uint32_t*>(out);
  S.transpose = transpose;
  S.m = m;
  S.m2 = m / mxu::PEEL;
  S.lm2 = __builtin_ctz(S.m2);
  S.lbt = __builtin_ctz(mxu::tc::N / S.m2);
  S.lb = lb;
  S.llb = __builtin_ctz(lb);
  S.kb_pad = kb_pad;
  S.B = B;
  S.span = span;
  S.fc = mxu::field_const(p, np0);
  switch (n_words) {
    case 2: return mxu::launch_wide<2>(S, kt, ka_pad, blocks, smem, stream);
    case 1: return mxu::launch_wide<1>(S, kt, ka_pad, blocks, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int mxu_fused_subntt_multi(const void* x, const void* A1, const void* A2,
                                      const void* Tin, const void* T3, long long rep,
                                      void* out, int transpose, int m, long long B,
                                      const uint32_t* p, uint32_t np0, int n_words, int kt,
                                      int kt2, int ka_pad, int kb_pad, int m_pad, int ys,
                                      int y_off, long long blocks, int smem, void* stream) {
  if (m < 64 || m > mxu::MAX_SUB || (m & (m - 1)) || B < 1) return (int)cudaErrorInvalidValue;
  mxu::SubLevel S{};
  S.m = m;
  S.m2 = m / mxu::PEEL;
  S.lbt = __builtin_ctz(mxu::tc::N / S.m2);
  S.ys = ys;
  S.y_off = y_off;
  S.B = B;
  S.a.A = static_cast<const int8_t*>(A1);
  S.a.m = mxu::PEEL;
  S.a.B = B;
  S.a.kt = kt;
  S.a.k_pad = ka_pad;
  S.a.m_pad = m_pad;
  S.b.A = static_cast<const int8_t*>(A2);
  S.b.m = S.m2;
  S.b.B = B;
  S.b.kt = kt2;
  S.b.k_pad = kb_pad;
  S.b.m_pad = m_pad;
  S.x = static_cast<const uint32_t*>(x);
  S.Tin = static_cast<const uint32_t*>(Tin);
  S.T3 = static_cast<const uint32_t*>(T3);
  S.t_rep = rep;
  S.out = static_cast<uint32_t*>(out);
  S.transpose = transpose;
  S.fc = mxu::field_const(p, np0);
  switch (n_words) {
    case 8: return mxu::launch_sub<8>(S, blocks, smem, stream);
    case 2: return mxu::launch_sub<2>(S, blocks, smem, stream);
    case 1: return mxu::launch_sub<1>(S, blocks, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

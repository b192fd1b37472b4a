// Shared device core of the port's digit-matmul kernels:
//
//   mxu_level.cu  mxu_base_ntt           K1, replaces ntt_tpu/kernels/mxu_ntt.py::_kernel
//                 mxu_fused_level_stack  K2, replaces ntt_tpu/kernels/mxu_level.py::_kernel_stack
//                 mxu_fused_subntt       K3, replaces ntt_tpu/kernels/mxu_level.py::_kernel_sub
//                                            in its single-level form, m <= 64
//                 mxu_fused_level        K4, replaces ntt_tpu/kernels/mxu_level.py::_kernel_level
//                 mxu_fused_level_probe  K7, replaces ntt_tpu/kernels/mxu_level.py::_kernel_probe
//   mxu_sub.cu    mxu_fused_subntt_multi K3 in its multi-level form, m = 64 .. 512
//                                            (a peel of 32 points, PEEL)
//
// (vmem_ntt.cu, the butterfly-stage kernels K5 and K6, takes only the field
// arithmetic from here: FieldConst, the carry-chain primitives, cond_sub_p,
// mont_mul.)
//
// Every kernel is a template over W, the 32-bit words per element: 8 for the
// 256-bit fields, 2 for Goldilocks, 1 for the small Proth prime.
//
// All compute levels of the peel-32 (or peel-64) four-step on data x = uint32[W, m, B]
// (limb-major word planes of canonical Montgomery-form elements): an m-point
// modular linear map along axis 1, as ONE digit matmul against a host-built conv
// matrix A[(e*m + k), (j*m + i)] (int8; D = ceil(32 W / 7) seven-bit digits per
// element; E output digit planes per output row: E = D = 37 for W = 8, whose
// matrices are pre-folded mod p, and the full banded profile E = 2D - 1 for the
// narrow fields), followed by a Montgomery reduction and, for K2/K3/K4, a
// twiddle product. Every digit and matrix entry is in [0, 127] and every plane
// sum is at most m * D * 127^2: below 2^25 up to m = 32, below 2^26 at m = 64
// (64 * 37 * 127^2 = 38,193,472 for W = 8), so int8 products with int32 sums
// compute the matmul exactly.
//
// One contraction computes Z[e*m + k, b] = sum_c A[e*m + k, c] * d[c, b] for
// every kernel: tc::contract, on the int8 tensor cores.
//
//   1. A block owns a chunk of kt output rows and 128 (virtual) batch columns;
//      its GEMM rows are {e*m + k : e < E, k in the chunk}, E*kt of them
//      (about 300), zero-padded to 320, and the contraction depth D*m is
//      zero-padded to a multiple of 32 (k_pad). The block builds the digit
//      tile of its columns in shared memory (stage_tile), K-contiguous per
//      column with the 32-byte swizzle, from whatever operand its kernel
//      names: x itself for K1-K4 and K7, the (i2, b) columns of x and then
//      level A's shared result tile for the multi-level K3. Up to m = 32 the
//      tile holds the whole depth and is built once. At m = 64 it is streamed
//      over the depth in passes of 32 rows (passes(m) = m / 32): the depth
//      c = j*m + i of digit j of row i splits into 32-deep steps (j, h) that
//      each hold rows 32h .. 32h+31 of one digit, so pass h stages the digits
//      of rows 32h .. 32h+31 alone (the m = 32 tile, D sub-tiles) and runs the
//      steps (0, h) .. (D-1, h); the int32 sums stay in the warpgroups'
//      registers from one pass to the next. The tile is then the m = 32 one
//      (151,552 bytes at W = 8 where the whole would be 303,104), and each
//      block keeps its 128 columns, so one conv-matrix byte still serves 128;
//   2. TMA brings the chunk's conv-matrix rows 32 contraction bytes a step
//      through a six-stage ring, in the order the passes run (step (j, h) at
//      contraction byte (j * passes + h) * 32; the box gathers the rows; where
//      D*m % 16 != 0, at m <= 8, cp.async loads the whole chunk instead);
//   3. per step, four warpgroups run one wgmma.m64n160k32.s32.s8.s8 each: the
//      digits are the M side (64 columns), the conv-matrix rows the N side
//      (160 GEMM rows), so one conv-matrix byte serves 128 columns. A K2 block
//      whose columns span several stack entries contracts once per entry with
//      a digit tile holding only that entry's columns. The sums go to a shared
//      int32 Z tile [E*kt, 128] that aliases the digit tile and the ring, and
//      the epilogue reads them back by (k, b). A block may contract again
//      (the multi-level K3 does, for its level B) once every thread is done
//      with Z.
// The launch plans (kt, k_pad, m_pad, shared bytes, grid) are computed by the
// Python wrappers and checked by the launchers. At the 256-bit main path's
// shapes (W = 8, m = 32, B = 8192) a level is 11.5 G int8 MACs, 11.6 us at the
// H100's 1,979 TOPS int8 tensor peak; K2's level 0 is bound by its 61.7 MB of
// data and stack (18.4 us at 3.35 TB/s), the other levels by their MACs or,
// at m = 8, their bytes (mxu_level.cu and mxu_sub.cu give each launch's bound).
//
// Then the epilogue on the CUDA cores:
//   4. reduce V = sum_e Z[e] * 2^(7e) to canonical words. The matrices are
//      prescaled by R * 2^16 (R = 2^(32 W)), so the result is
//      V * 2^-(32 W + 16) mod p. The kernel takes it as W + 1 32-bit Montgomery
//      steps on V * 2^16 (2^16 * 2^-(32 (W + 1))), which end below 2p, one
//      conditional subtraction from canonical, while the window
//      V * 2^16 < 2^(32 (W + 1)) * p holds. It holds for every field up to
//      m = 64:
//        W = 8 (folded rows, E = 37 planes, sums below 2^26 at m = 64):
//          V < 2^26 * 2^(7 * 36) * 128/127 < 2^279, so V * 2^16 < 2^295,
//          far below 2^288 * p (p > 2^253); the lanes hold it (a plane
//          shifted by up to 31 bits is below 2^57, and the NT = 18 words of
//          the window hold 2^576);
//        the banded matrices (W = 1, 2): V is the exact sum of m products of
//          a matrix entry and an element, both below p, so V < m p^2 and,
//          at m = 64, V * 2^16 < 2^22 p^2, below 2^(32 (W + 1)) * p where
//          p * 2^22 < 2^(32 (W + 1)): p < 2^42 for W = 1 (the small Proth
//          prime is below 2^32), p < 2^74 for W = 2 (Goldilocks is below
//          2^64).
//      The JAX package reaches the same canonical value through its fold
//      matmul and a 16-bit tail (W = 8) or a 16-bit wide reduction (narrow
//      fields), at m = 64 as at 32;
//   5. optionally multiply by a Montgomery twiddle (32-bit CIOS, R = 2^(32 W));
//   6. store the words at [w, k, b], coalesced over b (K4: or at [w, b, k]).
#pragma once

#include <cstdint>

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

namespace mxu {

constexpr int MAX_LEVEL_M = 64;  // the longest transform one conv matrix computes (K1-K4, K7)
constexpr int MAX_W = 8;

// Digit geometry of a W-word field.
template <int W>
struct Geo {
  static constexpr int D = (32 * W + 6) / 7;          // 7-bit digits per element
  static constexpr int E = W >= 6 ? D : 2 * D - 1;    // output digit planes
  // 64-bit lanes that collect V * 2^16: plane e lands in lanes q, q + 1 with
  // q = (7e + 16) / 32
  static constexpr int NS = ((7 * (E - 1) + 16) >> 5) + 2;
  // words of the Montgomery window: the W + 1 eliminated words, W result
  // words and the top word, or NS if the lanes reach further
  static constexpr int NT = NS > 2 * W + 2 ? NS : 2 * W + 2;
};

struct FieldConst {
  uint32_t p[MAX_W];
  uint32_t np0;  // -p^-1 mod 2^32
};

// ---------------------------------------------------------------------------
// The contraction on the int8 tensor cores (every digit-matmul kernel).
// ---------------------------------------------------------------------------
namespace tc {

constexpr int N = 128;            // batch columns a block owns
constexpr int NM = 64;            // columns a warpgroup owns: the wgmma M
constexpr int NR = 160;           // GEMM rows a warpgroup owns: the wgmma N
constexpr int WGS = 4;            // warpgroups: 2 column halves x 2 row halves
constexpr int THREADS = 128 * WGS;
constexpr int ROWS = 2 * NR;      // GEMM rows of a block, padded (m_pad)
constexpr int BK = 32;            // contraction depth of one step (wgmma K)
constexpr int STAGES = 6;         // ring stages of the conv-matrix rows (TMA)
constexpr int ZS = N + 4;         // Z row stride in words (conflict-free)
constexpr int ALIGN = 256;        // the shared base is aligned up to the swizzle atom
constexpr int MAX_SMEM = 232448;  // dynamic shared bytes a block may use

// Rows a stage holds: the E*kt GEMM rows, rounded up to the 8-row swizzle atom.
__host__ __device__ inline int stage_rows(int E, int kt) { return (E * kt + 7) & ~7; }

// The digit tile of an m-row operand is built in passes(m) passes of m /
// passes(m) rows each: the whole operand up to m = BK, BK rows a pass above.
__host__ __device__ inline int passes(int m) { return m > BK ? m / BK : 1; }

// Shared bytes of one contraction. The conv-matrix rows: STAGES ring stages
// when TMA feeds them (D*m % 16 == 0), else the whole chunk, k_pad / BK stages.
// Then the digit tile of one pass (k_pad / BK / passes(m) sub-tiles of N x BK
// bytes), at least as large as the rows the last stage's wgmma reads past its
// end (ROWS are read, the unused ones multiply into accumulators nobody
// stores). The Z tile [E*kt, ZS] aliases both after the main loop.
__host__ __device__ inline int contract_bytes(int D, int E, int m, int kt, int k_pad) {
  const int rows = stage_rows(E, kt);
  const int stages = (D * m) % 16 == 0 ? STAGES : k_pad / BK;
  const int tile = N * (k_pad / passes(m));
  const int dig = tile > (ROWS - rows) * BK ? tile : (ROWS - rows) * BK;
  const int main_loop = stages * rows * BK + dig;
  const int z = E * kt * ZS * 4;
  return main_loop > z ? main_loop : z;
}

// Dynamic shared bytes of a one-level block: the contraction, which the Z tile
// and the transposed-store tile alias after the main loop, and ALIGN bytes of
// slack. Python's mxu_level.tc_plan computes the same.
__host__ __device__ inline int smem_bytes(int W, int D, int E, int m, int kt, int k_pad) {
  const int main_loop = contract_bytes(D, E, m, kt, k_pad);
  const int epilogue = E * kt * ZS * 4 + W * N * (kt | 1) * 4;
  return ALIGN + (main_loop > epilogue ? main_loop : epilogue);
}

// One level's operands and its launch plan.
struct Level {
  const uint32_t* x;     // [W, m, B]
  const int8_t* A;       // conv matrix [E*m, D*m], or the first of a stack
  long long a_stride;    // bytes between stack entries; 0 for one matrix
  long long a_rep;       // batch columns per stack entry
  const uint32_t* T3;    // twiddle, or nullptr
  long long t_rep;       // 1: T3 is [W, m, B]; > 1: T3 is [W, B / t_rep, m]
  long long t_period;    // t_rep == 1: T3 is [W, m, t_period], column b read at
                         // b mod t_period (B, or a power of two dividing B)
  uint32_t* out;         // [W, m, B], or [W, B, m] when transpose
  int m;
  long long B;
  int transpose;
  int stage;             // K7: the stage the probe stops after
  int kt, k_pad, m_pad;  // rows a chunk, padded depth, padded GEMM rows (ROWS)
  int tma;               // 1: a ring fed by TMA (D*m % 16 == 0); 0: the whole chunk by cp.async
  FieldConst fc;
};

// Both operands lie in shared memory K-major with the 32-byte swizzle: a row
// (a batch column of the digit tile, a GEMM row of the conv matrix) holds
// BK = 32 bytes of contraction, rows 32 bytes apart, and byte c of row r sits
// at r * 32 + (c ^ (((r >> 2) & 1) << 4)). TMA's CU_TENSOR_MAP_SWIZZLE_32B
// writes this layout, wgmma's 32B-swizzle descriptors read it.
__device__ __forceinline__ int swz(int r, int c) { return r * BK + (c ^ (((r >> 2) & 1) << 4)); }

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor: K-major, 32-byte swizzle, 8-row groups 256 bytes apart.
__device__ __forceinline__ uint64_t desc(const void* p) {
  return (uint64_t)((saddr(p) & 0x3FFFF) >> 4) | (uint64_t)1 << 16 | (uint64_t)(256 >> 4) << 32 |
         (uint64_t)3 << 62;
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(saddr(dst)), "l"(src),
               "n"(BYTES));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// Orders this thread's generic-proxy shared writes before async-proxy reads (wgmma).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(saddr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_inval(uint64_t* bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(saddr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(saddr(bar)), "r"(parity)
        : "memory");
  }
}

// TMA: the box {BK, kt, E, 1} of the conv-matrix stack viewed as [NT][E][m][D*m]
// at (c0, k0, 0, s) into `dst`, completing on `bar` (which expects `bytes`).
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int bytes, int c0, int k0, int s) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(saddr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(k0), "r"(0), "r"(s), "r"(saddr(bar))
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}

// d = A (64 x 32, K-major, shared) * B (32 x NR, K-major, shared) (+ d when
// `accumulate`); s8 in, s32 sums.
__device__ __forceinline__ void wgmma_s8(int (&d)[NR / 2], uint64_t da, uint64_t db,
                                         int accumulate) {
  static_assert(NR == 160, "the instruction below is m64n160k32");
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %82, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n160k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, %80, %81, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79])
      : "l"(da), "l"(db), "r"(accumulate));
}

// Seven-bit digit j of a W-word element, in bits 0..6 (higher bits: garbage).
template <int W>
__device__ __forceinline__ uint32_t digit_hi(const uint32_t (&w)[W], int j) {
  const int bit = 7 * j, w0 = bit >> 5, r = bit & 31;
  if (r + 7 > 32 && w0 + 1 < W) return __funnelshift_r(w[w0], w[w0 + 1], r);
  return w[w0] >> r;
}

// Byte c of batch column bl in the digit tile: sub-tile c / BK, row bl.
__device__ __forceinline__ int dig_at(int bl, int c) {
  return (c / BK) * (N * BK) + swz(bl, c % BK);
}

// Rows i0 .. i0+3 of column bl: digit j of the four elements w as one word at
// contraction index j*m + i0. M: m where it is known at compile time (the
// addresses then fold into immediates), else 0.
template <int W, int M>
__device__ __forceinline__ void put_digits(const uint32_t (&w)[4][W], int m, int bl, int i0,
                                           uint8_t* dig) {
  constexpr int D = Geo<W>::D;
  uint8_t* at0 = dig + dig_at(bl, i0);
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const uint32_t lo2 = __byte_perm(digit_hi<W>(w[0], j), digit_hi<W>(w[1], j), 0x0040);
    const uint32_t hi2 = __byte_perm(digit_hi<W>(w[2], j), digit_hi<W>(w[3], j), 0x0040);
    uint8_t* at = M == BK ? at0 + j * (N * BK) : dig + dig_at(bl, j * m + i0);
    *reinterpret_cast<uint32_t*>(at) = __byte_perm(lo2, hi2, 0x5410) & 0x7F7F7F7Fu;
  }
}

// The digit tile of N columns of an m-row operand: digit j of element (i, col)
// at contraction index c = j*m + i, zero for c >= D*m. load(i, col, w) gives the
// W words of the element (zeros for a masked column). Ends with the proxy fence
// of the writes.
template <int W, class Load>
__device__ __forceinline__ void stage_tile(int m, int k_pad, Load load, uint8_t* dig) {
  constexpr int D = Geo<W>::D;
  const int K = D * m, tail = k_pad - K;
  for (int idx = threadIdx.x; idx < N * tail; idx += THREADS)
    dig[dig_at(idx / tail, K + idx % tail)] = 0u;
  if (m % 4 == 0) {
    // a task: four consecutive rows i0 .. i0+3 of one column, D packed words;
    // a warp takes 8 consecutive columns x 4 row groups (conflict-free stores)
    const int G = m / 4;
    for (int idx = threadIdx.x; idx < N * G; idx += THREADS) {
      const int bl = (idx >> 3) / G * 8 + (idx & 7), i0 = 4 * ((idx >> 3) % G);
      uint32_t w[4][W];
#pragma unroll
      for (int t = 0; t < 4; ++t) load(i0 + t, bl, w[t]);
      if (m == BK) {
        put_digits<W, BK>(w, m, bl, i0, dig);
      } else {
        put_digits<W, 0>(w, m, bl, i0, dig);
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < N * m; idx += THREADS) {
      const int bl = idx % N, i = idx / N;
      uint32_t w[W];
      load(i, bl, w);
#pragma unroll
      for (int j = 0; j < D; ++j) dig[dig_at(bl, j * m + i)] = (uint8_t)(digit_hi<W>(w, j) & 127u);
    }
  }
  fence_async_shared();
}

// The digit tile of pass h of P (P = passes(L.m)) of a level's columns
// b0 .. b0+N-1 of x (rows h * m / P onwards), zero for the columns outside
// [lo, hi).
template <int W, int P>
__device__ __forceinline__ void stage_digits(const Level& L, long long b0, long long lo,
                                             long long hi, int h, uint8_t* dig) {
  const int rows = L.m / P, i0 = h * rows;
  stage_tile<W>(rows, L.k_pad / P, [&](int i, int bl, uint32_t (&w)[W]) {
    const long long b = b0 + bl;
    const bool in = b >= lo && b < hi;
#pragma unroll
    for (int q = 0; q < W; ++q) w[q] = in ? L.x[((long long)q * L.m + i0 + i) * L.B + b] : 0u;
  }, dig);
}

// Without TMA (D*m % 16 != 0, only at m <= 8): the chunk's conv-matrix rows
// whole (GEMM row r = e*kt + kk is matrix row e*m + k0 + kk), stage kb holding
// contraction columns kb*BK .. kb*BK+BK-1 below D*m, VEC bytes a cp.async
// (single bytes by plain loads); a warp reads along the rows.
template <int W, int VEC>
__device__ __forceinline__ void load_whole(const int8_t* A, int m, int kt, int k0,
                                           int stage_bytes, uint8_t* dst) {
  constexpr int D = Geo<W>::D, E = Geo<W>::E;
  const int K = D * m, per_row = K / VEC;
  for (int idx = threadIdx.x; idx < E * kt * per_row; idx += THREADS) {
    const int r = idx / per_row, c = (idx % per_row) * VEC;
    const int8_t* src = A + (long long)((r / kt) * m + k0 + r % kt) * K + c;
    uint8_t* d = dst + (c / BK) * stage_bytes + swz(r, c % BK);
    if constexpr (VEC == 1) {
      *d = (uint8_t)__ldg(src);
    } else {
      cp_async<VEC>(d, src);
    }
  }
}

template <int W>
__device__ __forceinline__ void load_chunk(const int8_t* A, int m, int kt, int k0,
                                           int stage_bytes, uint8_t* dst) {
  const int K = Geo<W>::D * m;
  if (K % 8 == 0) {
    load_whole<W, 8>(A, m, kt, k0, stage_bytes, dst);
  } else if (K % 4 == 0) {
    load_whole<W, 4>(A, m, kt, k0, stage_bytes, dst);
  } else {
    load_whole<W, 1>(A, m, kt, k0, stage_bytes, dst);
  }
  cp_async_commit();
  cp_async_wait_all();
  fence_async_shared();
}

// Z[r, bl] for the block's E*kt GEMM rows (r = e*kt + kk) and N columns, into
// shared memory at `smem` (row stride ZS words): per step, warpgroup g runs
// one wgmma of columns (g & 1)*NM .. +NM-1 of the digit sub-tile (the M side)
// against GEMM rows (g >> 1)*NR .. +NR-1 of the stage (the N side). Every
// conv-matrix byte brought in serves N = 128 columns. The stages come through a ring
// fed by TMA (the `full` barriers) or, without TMA, hold the whole chunk.
// P is passes(L.m), a template argument: the kernels that take m = 64 are
// instantiated for it apart, so that the one-pass contraction (every m up
// to 32, and the multi-level K3) compiles as it did before the passes.
// stage_cols(lo, hi, h, dig) writes the digit tile of pass h (each
// k_pad / BK / P steps deep) of the columns in [lo, hi) (all of them for one
// matrix); the steps of pass h read contraction bytes (j * P + h) * BK. A K2
// block whose columns span several stack entries runs the contraction once
// per entry, each time with a digit tile that holds only that entry's
// columns. The sums accumulate over the entries and the passes. Ends with a
// barrier: Z is readable by every thread, and the barriers are invalidated,
// so that a block may contract again once every thread is done with Z.
template <int W, int P, class Stage>
__device__ __forceinline__ void contract(const Level& L, const CUtensorMap* map, long long b0,
                                         int k0, uint8_t* smem, uint64_t* full,
                                         Stage stage_cols) {
  constexpr int E = Geo<W>::E;
  const int kt = L.kt, R = E * kt, nk = L.k_pad / BK / P;  // nk: steps a pass
  const int stage_bytes = stage_rows(E, kt) * BK;
  uint8_t* rows = smem;
  uint8_t* dig = smem + (L.tma ? STAGES : nk) * stage_bytes;
  const int mh = (threadIdx.x >> 7) & 1, nh = threadIdx.x >> 8;

  // the stack entries the block's columns touch
  long long s_lo = 0;
  int n_entries = 1;
  if (L.a_stride) {
    const long long last = (b0 + N < L.B ? b0 + N : L.B) - 1;
    s_lo = b0 / L.a_rep;
    n_entries = (int)(last / L.a_rep - s_lo) + 1;
  }
  const int steps = n_entries * P * nk;
  auto issue = [&](int t) {  // TMA: step t (entry, pass h, step j) into ring stage t % STAGES
    const int j = t % nk, h = (t / nk) % P;
    tma_load(rows + (t % STAGES) * stage_bytes, map, &full[t % STAGES], R * BK, (j * P + h) * BK,
             k0, (int)(s_lo + t / (nk * P)));
  };
  if (L.tma && threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int t = 0; t < STAGES && t < steps; ++t) issue(t);
  }

  int acc[NR / 2];  // the first step overwrites it

  for (int ep = 0; ep < n_entries * P; ++ep) {
    const int e = ep / P, h = ep % P;
    long long lo = 0, hi = L.B;
    if (L.a_stride) {
      lo = (s_lo + e) * L.a_rep;
      hi = lo + L.a_rep < L.B ? lo + L.a_rep : L.B;
    }
    wgmma_wait<0>();
    __syncthreads();  // the digit tile and the whole chunk are free
    stage_cols(lo, hi, h, dig);
    // (without TMA, m <= 8: one pass)
    if (!L.tma) load_chunk<W>(L.A + (s_lo + e) * L.a_stride, L.m, kt, k0, stage_bytes, rows);
    __syncthreads();
    for (int kb = 0; kb < nk; ++kb) {
      const int t = ep * nk + kb;
      if (L.tma) mbar_wait(&full[t % STAGES], (t / STAGES) & 1);
      const uint8_t* stage = rows + (L.tma ? t % STAGES : kb) * stage_bytes;
      wgmma_fence();
      wgmma_s8(acc, desc(dig + kb * (N * BK) + mh * NM * BK), desc(stage + nh * NR * BK), t > 0);
      wgmma_commit();
      wgmma_wait<1>();  // this warpgroup's step t - 1 is done
      if (L.tma) {
        __syncthreads();  // every warpgroup is done with stage (t - 1) % STAGES
        if (threadIdx.x == 0 && t >= 1 && t - 1 + STAGES < steps) issue(t - 1 + STAGES);
      }
    }
  }
  wgmma_wait<0>();
  __syncthreads();
  if (L.tma && threadIdx.x == 0)
    for (int i = 0; i < STAGES; ++i) mbar_inval(&full[i]);

  // Z: thread (warp w4 of its warpgroup, lane) holds columns mh*NM + w4*16 +
  // lane/4 (+8) and GEMM rows nh*NR + 8j + 2*(lane%4) (+1), j < NR / 8
  int* Z = reinterpret_cast<int*>(smem);
  const int w4 = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int col = mh * NM + w4 * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < NR / 8; ++j) {
    const int row = nh * NR + j * 8 + (lane & 3) * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (row + h < R) {
        Z[(row + h) * ZS + col] = acc[4 * j + h];
        Z[(row + h) * ZS + col + 8] = acc[4 * j + 2 + h];
      }
    }
  }
  __syncthreads();
}

// cuTensorMapEncodeTiled from the driver, found through the runtime.
static inline PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &got) ==
            cudaSuccess &&
        got == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// The TMA map of the conv-matrix stack int8[NT][E][m][K] (NT = 1 for one
// matrix): boxes of {BK, kt, E, 1} bytes, 32-byte swizzle, zeros beyond K.
static inline bool stack_map(CUtensorMap* map, const int8_t* A, int E, int m, int K,
                             long long NT, int kt) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)K, (cuuint64_t)m, (cuuint64_t)E, (cuuint64_t)NT};
  const cuuint64_t strides[3] = {(cuuint64_t)K, (cuuint64_t)m * K, (cuuint64_t)E * m * K};
  const cuuint32_t box[4] = {(cuuint32_t)BK, (cuuint32_t)kt, (cuuint32_t)E, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<int8_t*>(A), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tc

// The carry chain: PTX add/sub/multiply-add with carry in (c) and out (.cc),
// one instruction each, in asm statements kept in order (volatile) so that
// nothing that touches the carry flag comes between two links of a chain.
__device__ __forceinline__ uint32_t mul_lo(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("mul.lo.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t mad_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t sub_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// y = r mod p for r = r[0..W) + top * 2^(32 W) < 2p.
template <int W>
__device__ __forceinline__ void cond_sub_p(const uint32_t (&r)[W], uint32_t top,
                                           const FieldConst& fc, uint32_t (&y)[W]) {
  uint32_t u[W];
  u[0] = sub_cc(r[0], fc.p[0]);
#pragma unroll
  for (int j = 1; j < W; ++j) u[j] = subc_cc(r[j], fc.p[j]);
  const uint32_t lt = subc(top, 0u);  // all ones exactly where r < p
#pragma unroll
  for (int j = 0; j < W; ++j) y[j] = lt == 0xFFFFFFFFu ? r[j] : u[j];
}

// y = V * 2^-(32 W + 16) mod p for V = sum_e z[e] * 2^(7e), each
// 0 <= z[e] < 2^26 (m <= 64) and V * 2^16 < 2^(32 (W + 1)) * p (the windows
// at the top of this file).
template <int W>
__device__ __forceinline__ void reduce(const int (&z)[Geo<W>::E], const FieldConst& fc,
                                       uint32_t (&y)[W]) {
  constexpr int E = Geo<W>::E, NS = Geo<W>::NS, NT = Geo<W>::NT;
  // T = V * 2^16, accumulated lazily in 64-bit lanes
  uint64_t s[NS];
#pragma unroll
  for (int q = 0; q < NS; ++q) s[q] = 0u;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int bit = 7 * e + 16, q = bit >> 5, r = bit & 31;
    const uint64_t v = (uint64_t)(uint32_t)z[e] << r;
    s[q] += (uint32_t)v;
    s[q + 1] += v >> 32;
  }
  uint32_t t[NT];
  uint64_t c = 0u;
#pragma unroll
  for (int q = 0; q < NS; ++q) {
    c += s[q];
    t[q] = (uint32_t)c;
    c >>= 32;
  }
#pragma unroll
  for (int q = NS; q < NT; ++q) t[q] = 0u;
  // W + 1 Montgomery steps: add q*p*2^(32i) so that word i becomes zero
#pragma unroll
  for (int i = 0; i < W + 1; ++i) {
    const uint32_t q = t[i] * fc.np0;
    uint64_t cc = 0u;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      cc += (uint64_t)q * fc.p[j] + t[i + j];
      t[i + j] = (uint32_t)cc;
      cc >>= 32;
    }
#pragma unroll
    for (int j = i + W; j < NT; ++j) {
      cc += t[j];
      t[j] = (uint32_t)cc;
      cc >>= 32;
    }
  }
  // (T + Q*p) / 2^(32 (W + 1)) < 2p: words W+1 .. 2W, word 2W+1 is the top
  uint32_t r[W];
#pragma unroll
  for (int j = 0; j < W; ++j) r[j] = t[W + 1 + j];
  cond_sub_p<W>(r, t[2 * W + 1], fc, y);
}

// y = a * b * 2^-(32 W) mod p (CIOS, 32-bit words), canonical in and out. Each
// step i adds a * b[i] and then q * p (q = t[0] * np0): the low halves of the
// partial products on one carry chain, the high halves on a second one a word
// up, so every 32 x 32 product costs one multiply for each half and its carry
// rides in the flag; then t shifts down a word.
template <int W>
__device__ __forceinline__ void mont_mul(const uint32_t (&a)[W], const uint32_t (&b)[W],
                                         const FieldConst& fc, uint32_t (&y)[W]) {
  uint32_t t[W + 2];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const uint32_t bi = b[i];
    if (i == 0) {
#pragma unroll
      for (int j = 0; j < W; ++j) t[j] = mul_lo(a[j], bi);
      t[W] = 0u;
      t[1] = mad_hi_cc(a[0], bi, t[1]);
#pragma unroll
      for (int j = 1; j < W; ++j) t[j + 1] = madc_hi_cc(a[j], bi, t[j + 1]);
      t[W + 1] = 0u;
    } else {
      t[0] = mad_lo_cc(a[0], bi, t[0]);
#pragma unroll
      for (int j = 1; j < W; ++j) t[j] = madc_lo_cc(a[j], bi, t[j]);
      t[W] = addc_cc(t[W], 0u);
      t[W + 1] = addc(0u, 0u);
      t[1] = mad_hi_cc(a[0], bi, t[1]);
#pragma unroll
      for (int j = 1; j < W; ++j) t[j + 1] = madc_hi_cc(a[j], bi, t[j + 1]);
      t[W + 1] = addc(t[W + 1], 0u);
    }
    const uint32_t q = mul_lo(t[0], fc.np0);
    t[0] = mad_lo_cc(q, fc.p[0], t[0]);
#pragma unroll
    for (int j = 1; j < W; ++j) t[j] = madc_lo_cc(q, fc.p[j], t[j]);
    t[W] = addc_cc(t[W], 0u);
    t[W + 1] = addc(t[W + 1], 0u);
    t[1] = mad_hi_cc(q, fc.p[0], t[1]);
#pragma unroll
    for (int j = 1; j < W; ++j) t[j + 1] = madc_hi_cc(q, fc.p[j], t[j + 1]);
    t[W + 1] = addc(t[W + 1], 0u);
#pragma unroll
    for (int j = 0; j <= W; ++j) t[j] = t[j + 1];
  }
  uint32_t r[W];
#pragma unroll
  for (int j = 0; j < W; ++j) r[j] = t[j];
  cond_sub_p<W>(r, t[W], fc, y);
}

// The decomposition twiddle of output row k, batch column b (m rows in all):
// at batch resolution (t_rep == 1) from column b mod t_period of T3[W, m,
// t_period], where t_period is B or a power of two dividing it (the periodic
// residual of level 0, TwStackResid, read compact); else from the
// i2-resolution table T3[W, B / t_rep, m].
template <int W>
__device__ __forceinline__ void load_twiddle(const uint32_t* T3, long long t_rep,
                                             long long t_period, int m, long long B, int k,
                                             long long b, uint32_t (&t)[W]) {
  if (t_rep == 1) {
    const long long c = t_period == B ? b : (b & (t_period - 1));
#pragma unroll
    for (int q = 0; q < W; ++q) t[q] = T3[((long long)q * m + k) * t_period + c];
  } else {
    const long long rows = B / t_rep;
#pragma unroll
    for (int q = 0; q < W; ++q) t[q] = T3[((long long)q * rows + b / t_rep) * m + k];
  }
}

inline FieldConst field_const(const uint32_t* p, uint32_t np0) {
  FieldConst fc;
  for (int j = 0; j < MAX_W; ++j) fc.p[j] = p[j];
  fc.np0 = np0;
  return fc;
}

}  // namespace mxu

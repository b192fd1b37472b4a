// K1, K2, K3 (single-level), K4 and K7: one m-point digit-matmul level on
// uint32[W, m, B] (W = 8, 2 or 1 words per element; m <= 64, MAX_LEVEL_M).
//
// K1 mxu_base_ntt replaces ntt_tpu/kernels/mxu_ntt.py::_kernel (entry
// base_ntt_mxu_pallas): the base transform, one conv matrix and the
// Montgomery reduction, with no twiddle.
//
// K2 mxu_fused_level_stack replaces ntt_tpu/kernels/mxu_level.py::_kernel_stack
// (entry fused_level_stack): the twiddle is folded into a stack of conv
// matrices As[NT, E*m, D*m] and batch column b uses As[b / rep]; an optional
// residual twiddle is multiplied into the output, at batch resolution
// T3[W, m, B] or periodic T3[W, m, s0], column b reading column b mod s0 (s0 a
// power of two dividing B): level 0 above 2^24, whose residual the JAX package
// tiles to each chunk's width, reads its compact [W, 32, s0] table here.
//
// K3 mxu_fused_subntt replaces the single-level form (m <= 64) of
// ntt_tpu/kernels/mxu_level.py::_kernel_sub (entry fused_subntt): one conv matrix,
// then the decomposition twiddle by a Montgomery product, read from T3[W, m, B]
// (rep == 1) or from the i2-resolution table T3[W, B / rep, m] (rep > 1; a warp
// reads one row of it, mostly as broadcasts).
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
// then T3 by mont_mul, then the store (for K4's transposed store through a
// [w][column][row | 1] tile, so that the writes run along m). The epilogue
// takes the probe's stage as an argument; the other kernels pass TW, which the
// compiler folds away. Blocks are numbered column tile by column tile, the row
// chunks of one tile together, so the blocks of one stack entry run together
// and read its matrix from L2. K3's multi-level form (m = 64 .. 512, peel 32) is
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
//      5.0 us; 2.9 G MACs, 2.9 us: bytes bound it.
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

// Fills in the plan and the field, and launches the instantiation for n_words.
static int tc_entry(TcKind kind, mxu::tc::Level& L, long long NT, const uint32_t* p,
                    uint32_t np0, int n_words, int kt, int k_pad, int m_pad, long long blocks,
                    int smem, void* stream) {
  L.kt = kt;
  L.k_pad = k_pad;
  L.m_pad = m_pad;
  L.fc = mxu::field_const(p, np0);
  switch (n_words) {
    case 8: return launch_tc<8>(kind, L, NT, blocks, smem, stream);
    case 2: return launch_tc<2>(kind, L, NT, blocks, smem, stream);
    case 1: return launch_tc<1>(kind, L, NT, blocks, smem, stream);
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
extern "C" int mxu_fused_level_stack(const void* x, const void* As, long long rep,
                                     const void* T3, long long t_period, void* out, int m,
                                     long long B, const uint32_t* p, uint32_t np0, int n_words,
                                     int kt, int k_pad, int m_pad, long long blocks, int smem,
                                     void* stream) {
  if (rep < 1 || B % rep) return (int)cudaErrorInvalidValue;
  mxu::tc::Level L = tc_operands(x, As, T3, out, m, B);
  L.t_period = t_period;
  L.a_stride = stack_stride(n_words, m);
  L.a_rep = rep;
  return tc_entry(TC_STACK, L, B / rep, p, np0, n_words, kt, k_pad, m_pad, blocks, smem, stream);
}

extern "C" int mxu_fused_subntt(const void* x, const void* A, const void* T3, long long rep,
                                void* out, int m, long long B, const uint32_t* p,
                                uint32_t np0, int n_words, int kt, int k_pad, int m_pad,
                                long long blocks, int smem, void* stream) {
  mxu::tc::Level L = tc_operands(x, A, T3, out, m, B);
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

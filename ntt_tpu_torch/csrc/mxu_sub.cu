// K3, multi-level: a whole m-point sub-NTT (m = 64 .. 512) with its decomposition
// twiddle in one launch, on uint32[W, m, B] (W = 8, 2 or 1 words per element).
//
// mxu_fused_subntt_multi replaces the multi-level form of
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
//   directly at [w, b / rep, row]).
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
// series.
#include "mxu_core.cuh"

namespace mxu {

struct SubLevel {
  tc::Level a;          // level A: A1 (m = 32), kt rows k1 a block, padded depth, TMA
  tc::Level b;          // level B: A2 (m = m2), kt2 rows k2 a row pass, padded depth, TMA
  const uint32_t* x;    // [W, m, B]
  const uint32_t* Tin;  // inner twiddle [W, 32, m2]
  const uint32_t* T3;   // decomposition twiddle, or nullptr
  long long t_rep;      // 1: T3 is [W, m, B]; > 1: T3 is [W, B / t_rep, m]
  uint32_t* out;        // [W, m, B]
  int m, m2;
  int lbt;              // log2 of bt, the batch columns a block owns (bt * m2 = 128)
  int ys;               // words between the rows i2 of Y (the plan's)
  int y_off;            // bytes from the aligned shared base to Y (the plan's)
  long long B;
  FieldConst fc;
};

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
    for (int q = 0; q < W; ++q) t[q] = __ldg(S.Tin + (q * MAX_M + k0 + kk) * S.m2 + i2);
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
    const int row = (k2_0 + kk2) * MAX_M + k0 + (u >> S.lbt);
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
    for (int q = 0; q < W; ++q) S.out[((long long)q * S.m + row) * S.B + b] = y[q];
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
  const int kt = S.a.kt, chunks = MAX_M / kt, bt = 1 << S.lbt;
  const long long b0 = (long long)(blockIdx.x / chunks) * bt;
  const int k0 = (blockIdx.x % chunks) * kt;

  // level A: x[w, i1 * m2 + i2, b] is element (i1, v = i2 * bt + bl) of a 32-row operand
  tc::contract<W>(S.a, &map_a, 0, k0, smem, full, [&](long long, long long, uint8_t* dig) {
    tc::stage_tile<W>(MAX_M, S.a.k_pad, [&](int i1, int v, uint32_t (&w)[W]) {
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
      tc::contract<W>(S.b, &map_b, 0, k2, smem, full, [&](long long, long long, uint8_t* dig) {
        tc::stage_tile<W>(S.m2, S.b.k_pad, [&](int i2, int col, uint32_t (&w)[W]) {
          const int u = u0 + col;
#pragma unroll
          for (int q = 0; q < W; ++q) w[q] = u < V ? Y[(q * S.m2 + i2) * S.ys + u] : 0u;
        }, dig);
      });
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
  S.a.tma = (D * MAX_M) % 16 == 0;
  S.b.tma = (D * m2) % 16 == 0;
  const int ca = tc::contract_bytes(D, E, MAX_M, kt, S.a.k_pad);
  const int cb = tc::contract_bytes(D, E, m2, kt2, S.b.k_pad);
  const bool ok = kt >= 1 && kt <= MAX_M && !(kt & (kt - 1)) && E * kt <= tc::ROWS &&
                  kt2 >= 1 && kt2 <= m2 && !(kt2 & (kt2 - 1)) && E * kt2 <= tc::ROWS &&
                  S.a.k_pad >= D * MAX_M && S.a.k_pad % tc::BK == 0 && S.b.k_pad >= D * m2 &&
                  S.b.k_pad % tc::BK == 0 && S.a.m_pad == tc::ROWS && S.b.m_pad == tc::ROWS &&
                  blocks == (S.B + bt - 1) / bt * (MAX_M / kt) && blocks <= 0x7fffffffLL &&
                  smem >= tc::ALIGN + S.y_off + W * m2 * S.ys * 4 && smem <= tc::MAX_SMEM &&
                  S.ys >= kt * bt && S.y_off >= ca && S.y_off >= cb && S.y_off % 16 == 0 &&
                  S.t_rep >= 1 && S.B % S.t_rep == 0;
  if (!ok) return (int)cudaErrorInvalidValue;
  CUtensorMap map_a{}, map_b{};
  if (!tc::stack_map(&map_a, S.a.A, E, MAX_M, D * MAX_M, 1, kt)) return (int)cudaErrorInvalidValue;
  if (S.b.tma && !tc::stack_map(&map_b, S.b.A, E, m2, D * m2, 1, kt2))
    return (int)cudaErrorInvalidValue;
  cudaError_t rc = cudaFuncSetAttribute(fused_subntt_multi_kernel<W>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  fused_subntt_multi_kernel<W>
      <<<(unsigned)blocks, tc::THREADS, smem, (cudaStream_t)stream>>>(map_a, map_b, S);
  return (int)cudaGetLastError();
}

}  // namespace mxu

extern "C" int mxu_fused_subntt_multi(const void* x, const void* A1, const void* A2,
                                      const void* Tin, const void* T3, long long rep,
                                      void* out, int m, long long B, const uint32_t* p,
                                      uint32_t np0, int n_words, int kt, int kt2, int ka_pad,
                                      int kb_pad, int m_pad, int ys, int y_off,
                                      long long blocks, int smem, void* stream) {
  if (m < 64 || m > 512 || (m & (m - 1)) || B < 1) return (int)cudaErrorInvalidValue;
  mxu::SubLevel S{};
  S.m = m;
  S.m2 = m / mxu::MAX_M;
  S.lbt = __builtin_ctz(mxu::tc::N / S.m2);
  S.ys = ys;
  S.y_off = y_off;
  S.B = B;
  S.a.A = static_cast<const int8_t*>(A1);
  S.a.m = mxu::MAX_M;
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
  S.fc = mxu::field_const(p, np0);
  switch (n_words) {
    case 8: return mxu::launch_sub<8>(S, blocks, smem, stream);
    case 2: return mxu::launch_sub<2>(S, blocks, smem, stream);
    case 1: return mxu::launch_sub<1>(S, blocks, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

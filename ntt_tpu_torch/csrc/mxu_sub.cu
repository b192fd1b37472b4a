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
// One block owns bt batch columns (4 to 32, chosen by the launcher) and all m rows.
// Level A reads x from device memory once and leaves its result in shared memory
// (W * m * bt words, laid out [w][i2 * 32 + k1][column] so that level B reads
// consecutive words); level B reads that tile and writes the output once. Each
// level walks its "virtual columns" (i2, column) resp. (k1, column) in chunks of
// one digit tile and runs the shared core (mxu_core.cuh) on each chunk: stage
// digits, __dp4a contraction, W + 1 word Montgomery steps, CIOS twiddle product.
// Columns beyond B are masked. Dynamic shared memory: the tile plus one digit
// tile, 26 KiB (Goldilocks, m = 512, bt = 4) to 101 KiB (W = 8, m = 512, bt = 4).
//
// Bound on an H100 at the narrow main path's shape (Goldilocks, W = 2, n = 2^18:
// two launches of m = 512, B = 512): a launch moves the data in and out, the
// twiddle table and the two matrices, 6.5 MB with T3 and 4.4 MB without, 1.9 us
// and 1.3 us at 3.35 TB/s, and does 2.4 G dense int8 MACs (A1 over 16 * B
// virtual columns, A2 over 32 * B), 2.4 us at the 1,979 TOPS int8 tensor peak:
// operations bound it. This first version runs its MACs as __dp4a on the CUDA
// cores and contracts the banded narrow-field matrices densely (half their
// entries are zero), so it sits well above the bound.
#include "mxu_core.cuh"

namespace mxu {

struct SubLevel {
  const uint32_t* x;    // [W, m, B]
  const int8_t* A1;     // conv matrix of the 32-point transform [E*32, D*32]
  const int8_t* A2;     // conv matrix of the (m/32)-point transform
  const uint32_t* Tin;  // inner twiddle [W, 32, m/32]
  const uint32_t* T3;   // decomposition twiddle, or nullptr
  long long t_rep;      // 1: T3 is [W, m, B]; > 1: T3 is [W, B / t_rep, m]
  uint32_t* out;        // [W, m, B]
  int m;
  int bt;               // batch columns per block, a power of two
  long long B;
  FieldConst fc;
};

template <int W>
__global__ void __launch_bounds__(THREADS, 2) fused_subntt_multi_kernel(SubLevel L) {
  extern __shared__ uint32_t smem[];
  const int m = L.m, m2 = m / MAX_M, bt = L.bt;
  uint32_t* ysm = smem;               // level A's result [W][i2 * 32 + k1][bt]
  uint32_t* dsm = smem + W * m * bt;  // digit tile of one chunk
  const long long b0 = (long long)blockIdx.x * bt;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // level A: virtual column v = i2 * bt + bl, chunks of 32; warp w does rows
  // k1 = w, w + 8, ...
  {
    const int V = m2 * bt;
    for (int c0 = 0; c0 < V; c0 += 32) {
      __syncthreads();
      stage_digits<W>(MAX_M, 32, dsm, [&](int i1, int vl, uint32_t(&w)[W]) {
        const int v = c0 + vl, i2 = v / bt;
        const long long b = b0 + v % bt;
        const bool ok = v < V && b < L.B;
#pragma unroll
        for (int q = 0; q < W; ++q)
          w[q] = ok ? L.x[((long long)q * m + i1 * m2 + i2) * L.B + b] : 0u;
      });
      __syncthreads();
      const int v = c0 + lane, i2 = v / bt, bl = v % bt;
      for (int k1 = warp; k1 < MAX_M; k1 += WARPS) {
        int z[Geo<W>::E];
        contract_row<W>(L.A1, MAX_M, k1, dsm, 32, lane, z);
        uint32_t y[W];
        reduce<W>(z, L.fc, y);
        if (v >= V) continue;
        uint32_t t[W], r[W];
#pragma unroll
        for (int q = 0; q < W; ++q) t[q] = __ldg(L.Tin + (q * MAX_M + k1) * m2 + i2);
        mont_mul<W>(y, t, L.fc, r);
#pragma unroll
        for (int q = 0; q < W; ++q) ysm[(q * m + i2 * MAX_M + k1) * bt + bl] = r[q];
      }
    }
  }

  // level B: virtual column v = k1 * bt + bl, chunks of one digit tile; the tile
  // [w][i2 * 32 + k1][bl] is [w][i2][v]
  {
    const int V = MAX_M * bt;
    const int kw = warps_per_group(m2), ch = block_cols(m2);
    for (int c0 = 0; c0 < V; c0 += ch) {
      __syncthreads();
      stage_digits<W>(m2, ch, dsm, [&](int i2, int vl, uint32_t(&w)[W]) {
        const int v = c0 + vl;
#pragma unroll
        for (int q = 0; q < W; ++q) w[q] = v < V ? ysm[(q * m + i2 * MAX_M) * bt + v] : 0u;
      });
      __syncthreads();
      const int vl = (warp / kw) * 32 + lane;
      const int v = c0 + vl, k1 = v / bt;
      const long long b = b0 + v % bt;
      for (int k2 = warp % kw; k2 < m2; k2 += kw) {
        int z[Geo<W>::E];
        contract_row<W>(L.A2, m2, k2, dsm, ch, vl, z);
        uint32_t y[W];
        reduce<W>(z, L.fc, y);
        if (v >= V || b >= L.B) continue;
        const int row = k2 * MAX_M + k1;
        if (L.T3 != nullptr) {
          uint32_t t[W], r[W];
          load_twiddle<W>(L.T3, L.t_rep, m, L.B, row, b, t);
          mont_mul<W>(y, t, L.fc, r);
#pragma unroll
          for (int q = 0; q < W; ++q) y[q] = r[q];
        }
#pragma unroll
        for (int q = 0; q < W; ++q) L.out[((long long)q * m + row) * L.B + b] = y[q];
      }
    }
  }
}

constexpr long long SMEM_MAX = 227 * 1024;       // dynamic shared memory a block may take
constexpr long long SMEM_PREFERRED = 100 * 1024; // leaves room for two blocks on an SM
constexpr long long BLOCKS_WANTED = 2 * 132;     // two blocks for each SM of an H100

template <int W>
int launch_sub(SubLevel L, void* stream) {
  auto smem = [&](int bt) {
    return (long long)(W * L.m * bt + Geo<W>::SMEM_WORDS) * 4;
  };
  int bt = 32;
  while (bt > 4 && (smem(bt) > SMEM_PREFERRED || (L.B + bt - 1) / bt < BLOCKS_WANTED)) bt /= 2;
  if (smem(bt) > SMEM_MAX) return (int)cudaErrorInvalidValue;
  L.bt = bt;
  cudaError_t rc = cudaFuncSetAttribute(fused_subntt_multi_kernel<W>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)smem(bt));
  if (rc != cudaSuccess) return (int)rc;
  const long long blocks = (L.B + bt - 1) / bt;
  fused_subntt_multi_kernel<W>
      <<<(unsigned)blocks, THREADS, (size_t)smem(bt), (cudaStream_t)stream>>>(L);
  return (int)cudaGetLastError();
}

}  // namespace mxu

extern "C" int mxu_fused_subntt_multi(const void* x, const void* A1, const void* A2,
                                      const void* Tin, const void* T3, long long rep,
                                      void* out, int m, long long B, const uint32_t* p,
                                      uint32_t np0, int n_words, void* stream) {
  if (m < 64 || m > 512 || (m & (m - 1))) return (int)cudaErrorInvalidValue;
  mxu::SubLevel L{};
  L.x = static_cast<const uint32_t*>(x);
  L.A1 = static_cast<const int8_t*>(A1);
  L.A2 = static_cast<const int8_t*>(A2);
  L.Tin = static_cast<const uint32_t*>(Tin);
  L.T3 = static_cast<const uint32_t*>(T3);
  L.t_rep = rep;
  L.out = static_cast<uint32_t*>(out);
  L.m = m;
  L.B = B;
  L.fc = mxu::field_const(p, np0);
  switch (n_words) {
    case 8: return mxu::launch_sub<8>(L, stream);
    case 2: return mxu::launch_sub<2>(L, stream);
    case 1: return mxu::launch_sub<1>(L, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

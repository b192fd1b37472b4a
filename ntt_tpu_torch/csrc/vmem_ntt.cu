// K5 and K6: every radix-2 butterfly stage of an m-point NTT on a shared-memory
// tile, on uint32[W, m, B] (W = 8, 2 or 1 words per element, Montgomery form,
// natural order in and out, m a power of two from 2 to 256).
//
// K5 vmem_stage_ntt replaces ntt_tpu/kernels/vmem_ntt.py::_kernel (entry
// ntt_along_axis_pallas): the ladder alone.
// K6 vmem_fused_stage_level replaces ntt_tpu/kernels/vmem_ntt.py::_kernel_fused
// (entry fused_stage_level): the ladder, then an optional product with a
// full-resolution twiddle T3[W, m, B], then the store, transposed to [W, B, m] on
// request: one four-step level of the butterfly path in one pass over the data.
//
// One block owns bt batch columns (8 to 32, chosen by the launcher so that the
// card's SMs have two blocks each where B allows) and all m rows, as a tile
// [w][row][column] in dynamic shared memory with a row stride of bt + 1 words.
//   load    row i of the input lands at tile row bitrev(i): the reference's
//           separate gather pass is folded into the load. Consecutive threads read
//           consecutive columns.
//   stages  s = 1, 2, .. m/2: butterfly j (group j / s, position j % s) pairs rows
//           i0 = (j / s) * 2s + j % s and i0 + s; b is multiplied by the stage
//           twiddle w_m^((j % s) * (m/2)/s), read from the master table
//           tw[W, m/2] (stage 1 has none), then (a + b, a - b) mod p go back in
//           place. A thread owns whole butterflies, so a stage needs one
//           __syncthreads() and no second buffer.
//   epilogue K6 multiplies by T3 where the read is coalesced over columns; the
//           transposed store then walks the tile row-fastest, so that a block
//           writes bt * m consecutive words per word plane (the odd row stride
//           keeps those reads off one bank).
//
// Bound on an H100 at the 256-bit ladder's shape (W = 8, m = 64, B = 4096, one of
// three launches of a 2^18 transform): the function moves 16.8 MB (x in, out;
// 25.2 MB with T3), 5.0 us (7.5 us) at 3.35 TB/s, and does (log2 m - 1) * m/2 * B
// Montgomery products (+ m * B for T3) of 2 W^2 + W 32-bit multiply-adds each,
// 0.089 G (0.125 G) multiply-adds, 5.3 us (7.5 us) at 16.7 T multiply-adds/s (132
// SMs x 64 int32 lanes x 1.98 GHz): operations and bytes are level. This first
// version keeps the tile resident, so device memory sees each word once; its
// products run as 64-bit multiply-adds (two or more int32 operations each) and
// a stage's threads sit idle while others finish, so it sits above the bound.
#include "mxu_core.cuh"

namespace vmem {

using mxu::FieldConst;

constexpr int THREADS = 256;
constexpr int MAX_M = 256;

struct Stages {
  const uint32_t* x;   // [W, m, B]
  const uint32_t* tw;  // master twiddles [W, m/2]
  const uint32_t* T3;  // [W, m, B], or nullptr
  uint32_t* out;       // [W, m, B], or [W, B, m] when transposed
  int m;
  int log_m;
  int bt;              // batch columns per block, a power of two
  int transpose;
  long long B;
  FieldConst fc;
};

// y = (a + b) mod p, canonical in and out; the carry out of the top word counts.
template <int W>
__device__ __forceinline__ void add_mod(const uint32_t (&a)[W], const uint32_t (&b)[W],
                                        const FieldConst& fc, uint32_t (&y)[W]) {
  uint32_t r[W];
  uint64_t c = 0u;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    c += (uint64_t)a[j] + b[j];
    r[j] = (uint32_t)c;
    c >>= 32;
  }
  mxu::cond_sub_p<W>(r, (uint32_t)c, fc, y);
}

// y = (a - b) mod p, canonical in and out.
template <int W>
__device__ __forceinline__ void sub_mod(const uint32_t (&a)[W], const uint32_t (&b)[W],
                                        const FieldConst& fc, uint32_t (&y)[W]) {
  uint32_t d[W];
  uint32_t borrow = 0u;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const uint64_t t = (uint64_t)a[j] - b[j] - borrow;
    d[j] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
  uint64_t c = 0u;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    c += (uint64_t)d[j] + fc.p[j];
    y[j] = borrow ? (uint32_t)c : d[j];
    c >>= 32;
  }
}

// Load (bit-reversed), run every stage, apply T3 and store, for this block's columns.
template <int W>
__device__ __forceinline__ void run_stages(const Stages& S) {
  extern __shared__ uint32_t tile[];  // [W][m][bt + 1]
  const int m = S.m, bt = S.bt, rs = bt + 1;
  const long long b0 = (long long)blockIdx.x * bt;
  const long long plane = (long long)m * rs;

  for (int idx = threadIdx.x; idx < m * bt; idx += THREADS) {
    const int i = idx / bt, bl = idx % bt;
    const long long b = b0 + bl;
    const int r = (int)(__brev((unsigned)i) >> (32 - S.log_m));
#pragma unroll
    for (int q = 0; q < W; ++q)
      tile[q * plane + r * rs + bl] = b < S.B ? S.x[((long long)q * m + i) * S.B + b] : 0u;
  }
  __syncthreads();

  const int half = m / 2;
  for (int s = 1; s < m; s <<= 1) {
    const int step = half / s;
    for (int idx = threadIdx.x; idx < half * bt; idx += THREADS) {
      const int j = idx / bt, bl = idx % bt;
      const int pos = j & (s - 1);
      const int i0 = ((j - pos) << 1) + pos, i1 = i0 + s;
      uint32_t a[W], b[W], lo[W], hi[W];
#pragma unroll
      for (int q = 0; q < W; ++q) {
        a[q] = tile[q * plane + i0 * rs + bl];
        b[q] = tile[q * plane + i1 * rs + bl];
      }
      if (s > 1) {
        uint32_t t[W], r[W];
#pragma unroll
        for (int q = 0; q < W; ++q) t[q] = __ldg(S.tw + q * half + pos * step);
        mxu::mont_mul<W>(b, t, S.fc, r);
#pragma unroll
        for (int q = 0; q < W; ++q) b[q] = r[q];
      }
      add_mod<W>(a, b, S.fc, lo);
      sub_mod<W>(a, b, S.fc, hi);
#pragma unroll
      for (int q = 0; q < W; ++q) {
        tile[q * plane + i0 * rs + bl] = lo[q];
        tile[q * plane + i1 * rs + bl] = hi[q];
      }
    }
    __syncthreads();
  }

  // epilogue: the twiddle product where T3 reads are coalesced over columns
  const bool direct = !S.transpose;
  if (S.T3 != nullptr || direct) {
    for (int idx = threadIdx.x; idx < m * bt; idx += THREADS) {
      const int k = idx / bt, bl = idx % bt;
      const long long b = b0 + bl;
      if (b >= S.B) continue;
      uint32_t y[W];
#pragma unroll
      for (int q = 0; q < W; ++q) y[q] = tile[q * plane + k * rs + bl];
      if (S.T3 != nullptr) {
        uint32_t t[W], r[W];
#pragma unroll
        for (int q = 0; q < W; ++q) t[q] = S.T3[((long long)q * m + k) * S.B + b];
        mxu::mont_mul<W>(y, t, S.fc, r);
#pragma unroll
        for (int q = 0; q < W; ++q) y[q] = r[q];
      }
      if (direct) {
#pragma unroll
        for (int q = 0; q < W; ++q) S.out[((long long)q * m + k) * S.B + b] = y[q];
      } else {
#pragma unroll
        for (int q = 0; q < W; ++q) tile[q * plane + k * rs + bl] = y[q];
      }
    }
  }
  if (direct) return;
  __syncthreads();
  // transposed store: out[w, b, k], row-fastest
  for (int idx = threadIdx.x; idx < m * bt; idx += THREADS) {
    const int bl = idx / m, k = idx % m;
    const long long b = b0 + bl;
    if (b >= S.B) continue;
#pragma unroll
    for (int q = 0; q < W; ++q)
      S.out[((long long)q * S.B + b) * m + k] = tile[q * plane + k * rs + bl];
  }
}

template <int W>
__global__ void __launch_bounds__(THREADS, 2) stage_ntt_kernel(Stages S) {
  run_stages<W>(S);
}

template <int W>
__global__ void __launch_bounds__(THREADS, 2) fused_stage_level_kernel(Stages S) {
  run_stages<W>(S);
}

constexpr long long SMEM_MAX = 227 * 1024;    // dynamic shared memory a block may take
constexpr long long BLOCKS_WANTED = 2 * 132;  // two blocks for each SM of an H100

template <int W>
int launch(void (*kernel)(Stages), Stages S, void* stream) {
  auto smem = [&](int bt) { return (long long)W * S.m * (bt + 1) * 4; };
  int bt = 32;
  while (bt > 8 && (S.B + bt - 1) / bt < BLOCKS_WANTED) bt /= 2;
  while (bt > 1 && smem(bt) > SMEM_MAX) bt /= 2;
  if (smem(bt) > SMEM_MAX) return (int)cudaErrorInvalidValue;
  S.bt = bt;
  cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)smem(bt));
  if (rc != cudaSuccess) return (int)rc;
  const long long blocks = (S.B + bt - 1) / bt;
  kernel<<<(unsigned)blocks, THREADS, (size_t)smem(bt), (cudaStream_t)stream>>>(S);
  return (int)cudaGetLastError();
}

static int log2_of(int m) {
  int l = 0;
  while ((1 << l) < m) ++l;
  return l;
}

static bool fill(Stages& S, const void* x, const void* tw, const void* T3, void* out,
                 int transpose, int m, long long B, const uint32_t* p, uint32_t np0) {
  if (m < 2 || m > MAX_M || (m & (m - 1)) || B < 1) return false;
  S.x = static_cast<const uint32_t*>(x);
  S.tw = static_cast<const uint32_t*>(tw);
  S.T3 = static_cast<const uint32_t*>(T3);
  S.out = static_cast<uint32_t*>(out);
  S.m = m;
  S.log_m = log2_of(m);
  S.transpose = transpose;
  S.B = B;
  S.fc = mxu::field_const(p, np0);
  return true;
}

}  // namespace vmem

extern "C" int vmem_stage_ntt(const void* x, const void* tw, void* out, int m, long long B,
                              const uint32_t* p, uint32_t np0, int n_words, void* stream) {
  vmem::Stages S{};
  if (!vmem::fill(S, x, tw, nullptr, out, 0, m, B, p, np0)) return (int)cudaErrorInvalidValue;
  switch (n_words) {
    case 8: return vmem::launch<8>(vmem::stage_ntt_kernel<8>, S, stream);
    case 2: return vmem::launch<2>(vmem::stage_ntt_kernel<2>, S, stream);
    case 1: return vmem::launch<1>(vmem::stage_ntt_kernel<1>, S, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int vmem_fused_stage_level(const void* x, const void* tw, const void* T3, void* out,
                                      int transpose, int m, long long B, const uint32_t* p,
                                      uint32_t np0, int n_words, void* stream) {
  vmem::Stages S{};
  if (!vmem::fill(S, x, tw, T3, out, transpose, m, B, p, np0))
    return (int)cudaErrorInvalidValue;
  switch (n_words) {
    case 8: return vmem::launch<8>(vmem::fused_stage_level_kernel<8>, S, stream);
    case 2: return vmem::launch<2>(vmem::fused_stage_level_kernel<2>, S, stream);
    case 1: return vmem::launch<1>(vmem::fused_stage_level_kernel<1>, S, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

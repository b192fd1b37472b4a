// K2, K3 (single-level), K4 and K7: one four-step level with its decomposition
// twiddle, on uint32[W, m, B] (W = 8, 2 or 1 words per element).
//
// K2 mxu_fused_level_stack replaces ntt_tpu/kernels/mxu_level.py::_kernel_stack
// (entry fused_level_stack): the twiddle is folded into a stack of conv matrices
// As[NT, E*m, D*m] and batch column b uses As[b / rep]; an optional batch-
// resolution residual twiddle T3[W, m, B] is multiplied into the output.
//
// K3 mxu_fused_subntt replaces the single-level form (m <= 32) of
// ntt_tpu/kernels/mxu_level.py::_kernel_sub (entry fused_subntt): one conv matrix,
// then the decomposition twiddle by a Montgomery product, read from T3[W, m, B]
// (rep == 1) or from the i2-resolution table T3[W, B / rep, m] (rep > 1). Its
// multi-level form (m > 32) is mxu_sub.cu.
//
// K4 mxu_fused_level replaces ntt_tpu/kernels/mxu_level.py::_kernel_level (entry
// fused_level): one conv matrix, an optional product with a full-resolution
// twiddle T3[W, m, B], and the store, transposed to [W, B, m] on request: the
// four-step transpose rides the level's own pass over the data. The block's
// results go through a shared-memory tile [w][column][row] (row stride m | 1) so
// that the transposed writes run along m: a block writes bt * m consecutive words
// per word plane.
//
// K7 mxu_fused_level_probe replaces ntt_tpu/kernels/mxu_level.py::_kernel_probe
// (entry fused_level_probe): K4's level cut off after one of five stages, to
// attribute its time. Outputs uint32[W, m, B]: "stream" x itself; "digits" the sum
// of an element's D digits, on every word plane; "matmul" the planes 0 .. W-1 of
// the E accumulator planes, cast to uint32; "reduce" the reduced y; "tw" y * T3,
// which is K4 with T3 and no transpose. K4 and K7 are one kernel template with a
// stage argument.
//
// All four run the shared core in mxu_core.cuh. Bounds on an H100 at the 256-bit main
// path's shapes (W = 8, n = 2^18, m = 32, B = 8192, 11.5 G int8 MACs = 11.6 us at the 1,979 TOPS
// int8 tensor peak):
//   K2 level 0 (NT = 32): 61.7 MB (data in and out, the 44.9 MB stack), 18.4 us at
//      3.35 TB/s: bytes bound it. Level 2 (NT = 8): 28.0 MB, 8.4 us: MACs bound it.
//   K3 level 1 (rep = 1): 26.6 MB (data, the 8.4 MB twiddle table, A), 7.9 us:
//      MACs bound it.
//   K4 (W = 8, n = 2^18 under mxu_fused: three launches of m = 32, B = 8192 with
//      T3 and one of m = 8, B = 32768 without): 26.6 MB and 11.5 G MACs, 11.6 us:
//      MACs bound it; the m = 8 launch 16.9 MB, 5.0 us: bytes bound it.
// This first version streams each operand once per block: a block reads the
// matrix rows of its columns' stack entry as warp-uniform loads (the largest stack
// fits the 50 MB L2) and keeps the digit tile in shared memory; its MACs run as
// __dp4a on the CUDA cores, not on the tensor cores, so it sits well above the
// bound.
#include "mxu_core.cuh"

template <int W>
__global__ void __launch_bounds__(mxu::THREADS, 2) fused_level_stack_kernel(mxu::Level L) {
  mxu::run_level<W>(L);
}

template <int W>
__global__ void __launch_bounds__(mxu::THREADS, 2) fused_subntt_kernel(mxu::Level L) {
  mxu::run_level<W>(L);
}

// K4 / K7. Stages of the probe in pipeline order; K4 itself runs to the end.
enum ProbeStage { STREAM = 0, DIGITS = 1, MATMUL = 2, REDUCE = 3, TW = 4 };

// Words of the transposed-store tile: W planes of bt columns x (m | 1) words; bt * m
// is 1024 at most (m = 32), 1056 with the odd stride.
constexpr int TILE_WORDS = 1056;

template <int W>
__global__ void __launch_bounds__(mxu::THREADS, 2) fused_level_kernel(mxu::Level L, int stage,
                                                                       int transpose) {
  using namespace mxu;
  extern __shared__ uint32_t smem[];
  uint32_t* dsm = smem;                       // digit tile
  uint32_t* tile = smem + Geo<W>::SMEM_WORDS; // results for the transposed store
  const int m = L.m;
  const int kw = warps_per_group(m);
  const int bt = block_cols(m);
  const long long b0 = (long long)blockIdx.x * bt;

  if (stage == STREAM) {
    for (int idx = threadIdx.x; idx < m * bt; idx += THREADS) {
      const int i = idx / bt;
      const long long b = b0 + idx % bt;
      if (b >= L.B) continue;
#pragma unroll
      for (int q = 0; q < W; ++q) {
        const long long at = ((long long)q * m + i) * L.B + b;
        L.out[at] = L.x[at];
      }
    }
    return;
  }

  stage_digits<W>(m, bt, dsm, [&](int i, int bl, uint32_t(&w)[W]) {
    const long long b = b0 + bl;
#pragma unroll
    for (int q = 0; q < W; ++q) w[q] = b < L.B ? L.x[((long long)q * m + i) * L.B + b] : 0u;
  });
  __syncthreads();

  if (stage == DIGITS) {
    const uint8_t* d8 = reinterpret_cast<const uint8_t*>(dsm);
    for (int idx = threadIdx.x; idx < m * bt; idx += THREADS) {
      const int i = idx / bt, bl = idx % bt;
      const long long b = b0 + bl;
      if (b >= L.B) continue;
      uint32_t acc = 0u;
      for (int j = 0; j < Geo<W>::D; ++j) {
        const int c = j * m + i;
        acc += d8[((c >> 2) * bt + bl) * 4 + (c & 3)];
      }
#pragma unroll
      for (int q = 0; q < W; ++q) L.out[((long long)q * m + i) * L.B + b] = acc;
    }
    return;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bl = (warp / kw) * 32 + lane;
  const long long b = b0 + bl;
  const int ms = m | 1;
  for (int k = warp % kw; k < m; k += kw) {
    int z[Geo<W>::E];
    contract_row<W>(L.A, m, k, dsm, bt, bl, z);
    uint32_t y[W];
    if (stage == MATMUL) {
#pragma unroll
      for (int q = 0; q < W; ++q) y[q] = (uint32_t)z[q];
    } else {
      reduce<W>(z, L.fc, y);
    }
    if (b >= L.B) continue;
    if (stage == TW && L.T3 != nullptr) {
      uint32_t t[W], r[W];
      load_twiddle<W>(L.T3, 1, m, L.B, k, b, t);
      mont_mul<W>(y, t, L.fc, r);
#pragma unroll
      for (int q = 0; q < W; ++q) y[q] = r[q];
    }
    if (transpose) {
#pragma unroll
      for (int q = 0; q < W; ++q) tile[(q * bt + bl) * ms + k] = y[q];
    } else {
#pragma unroll
      for (int q = 0; q < W; ++q) L.out[((long long)q * m + k) * L.B + b] = y[q];
    }
  }
  if (!transpose) return;
  __syncthreads();
  for (int idx = threadIdx.x; idx < m * bt; idx += THREADS) {
    const int c = idx / m, k = idx % m;
    const long long bb = b0 + c;
    if (bb >= L.B) continue;
#pragma unroll
    for (int q = 0; q < W; ++q) L.out[((long long)q * L.B + bb) * m + k] = tile[(q * bt + c) * ms + k];
  }
}

template <int W>
static int launch_fused_level(const mxu::Level& L, int stage, int transpose, void* stream) {
  const size_t smem = (size_t)(mxu::Geo<W>::SMEM_WORDS + (transpose ? W * TILE_WORDS : 0)) * 4;
  cudaError_t rc = cudaFuncSetAttribute(fused_level_kernel<W>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  const long long bt = mxu::block_cols(L.m);
  const long long blocks = (L.B + bt - 1) / bt;
  fused_level_kernel<W><<<(unsigned)blocks, mxu::THREADS, smem, (cudaStream_t)stream>>>(
      L, stage, transpose);
  return (int)cudaGetLastError();
}

static int fused_level_entry(const void* x, const void* A, const void* T3, void* out, int stage,
                             int transpose, int m, long long B, const uint32_t* p,
                             uint32_t np0, int n_words, void* stream) {
  if (m < 2 || m > mxu::MAX_M || (m & (m - 1)) || B < 1) return (int)cudaErrorInvalidValue;
  mxu::Level L{};
  L.x = static_cast<const uint32_t*>(x);
  L.A = static_cast<const int8_t*>(A);
  L.T3 = static_cast<const uint32_t*>(T3);
  L.t_rep = 1;
  L.out = static_cast<uint32_t*>(out);
  L.m = m;
  L.B = B;
  L.fc = mxu::field_const(p, np0);
  switch (n_words) {
    case 8: return launch_fused_level<8>(L, stage, transpose, stream);
    case 2: return launch_fused_level<2>(L, stage, transpose, stream);
    case 1: return launch_fused_level<1>(L, stage, transpose, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int mxu_fused_level(const void* x, const void* A, const void* T3, void* out,
                               int transpose, int m, long long B, const uint32_t* p,
                               uint32_t np0, int n_words, void* stream) {
  return fused_level_entry(x, A, T3, out, TW, transpose, m, B, p, np0, n_words, stream);
}

extern "C" int mxu_fused_level_probe(const void* x, const void* A, const void* T3, void* out,
                                     int stage, int m, long long B, const uint32_t* p,
                                     uint32_t np0, int n_words, void* stream) {
  if (stage < STREAM || stage > TW) return (int)cudaErrorInvalidValue;
  return fused_level_entry(x, A, T3, out, stage, 0, m, B, p, np0, n_words, stream);
}

// Bytes of one stack entry int8[E*m, D*m] of a W-word field.
template <int W>
constexpr long long entry_bytes(int m) {
  return (long long)(mxu::Geo<W>::E * m) * (mxu::Geo<W>::D * m);
}

static long long stack_stride(int n_words, int m) {
  return n_words == 8 ? entry_bytes<8>(m) : n_words == 2 ? entry_bytes<2>(m) : entry_bytes<1>(m);
}

extern "C" int mxu_fused_level_stack(const void* x, const void* As, long long rep,
                                     const void* T3, void* out, int m, long long B,
                                     const uint32_t* p, uint32_t np0, int n_words,
                                     void* stream) {
  mxu::Level L{};
  L.x = static_cast<const uint32_t*>(x);
  L.A = static_cast<const int8_t*>(As);
  L.a_stride = stack_stride(n_words, m);
  L.a_rep = rep;
  L.T3 = static_cast<const uint32_t*>(T3);
  L.t_rep = 1;
  L.out = static_cast<uint32_t*>(out);
  L.m = m;
  L.B = B;
  L.fc = mxu::field_const(p, np0);
  return MXU_LAUNCH_FOR_WIDTH(fused_level_stack_kernel, n_words, L, stream);
}

extern "C" int mxu_fused_subntt(const void* x, const void* A, const void* T3, long long rep,
                                void* out, int m, long long B, const uint32_t* p,
                                uint32_t np0, int n_words, void* stream) {
  mxu::Level L{};
  L.x = static_cast<const uint32_t*>(x);
  L.A = static_cast<const int8_t*>(A);
  L.T3 = static_cast<const uint32_t*>(T3);
  L.t_rep = rep;
  L.out = static_cast<uint32_t*>(out);
  L.m = m;
  L.B = B;
  L.fc = mxu::field_const(p, np0);
  return MXU_LAUNCH_FOR_WIDTH(fused_subntt_kernel, n_words, L, stream);
}

// Shared device core of the port's digit-matmul kernels:
//
//   mxu_ntt.cu    mxu_base_ntt           K1, replaces ntt_tpu/kernels/mxu_ntt.py::_kernel
//   mxu_level.cu  mxu_fused_level_stack  K2, replaces ntt_tpu/kernels/mxu_level.py::_kernel_stack
//                 mxu_fused_subntt       K3, replaces ntt_tpu/kernels/mxu_level.py::_kernel_sub
//                                            in its single-level form, m <= 32
//                 mxu_fused_level        K4, replaces ntt_tpu/kernels/mxu_level.py::_kernel_level
//                 mxu_fused_level_probe  K7, replaces ntt_tpu/kernels/mxu_level.py::_kernel_probe
//   mxu_sub.cu    mxu_fused_subntt_multi K3 in its multi-level form, m = 64 .. 512
//
// (vmem_ntt.cu, the butterfly-stage kernels K5 and K6, takes only the field
// arithmetic from here: FieldConst, cond_sub_p, mont_mul.)
//
// Every kernel is a template over W, the 32-bit words per element: 8 for the
// 256-bit fields, 2 for Goldilocks, 1 for the small Proth prime.
//
// All compute levels of the peel-32 four-step on data x = uint32[W, m, B]
// (limb-major word planes of canonical Montgomery-form elements): an m-point
// modular linear map along axis 1, as ONE digit matmul against a host-built conv
// matrix A[(e*m + k), (j*m + i)] (int8; D = ceil(32 W / 7) seven-bit digits per
// element; E output digit planes per output row: E = D = 37 for W = 8, whose
// matrices are pre-folded mod p, and the full banded profile E = 2D - 1 for the
// narrow fields), followed by a Montgomery reduction and, for K2/K3, a twiddle
// product. They differ in which matrix a batch column uses, in the epilogue, and
// in how many such levels one launch runs.
//
// One block owns bt batch columns (32 per column group, one warp wide) and all
// m rows:
//   1. it stages the D seven-bit digits of its m x bt elements in shared
//      memory, four contraction indices c = j*m + i per 32-bit word:
//      dsm[g * bt + b] holds digits c = 4g .. 4g+3 of column b;
//   2. each thread, for its output row k and column b, forms the E digit-
//      plane sums Z[e] = sum_c A[e*m + k, c] * d[c, b] in int32 registers with
//      __dp4a. Every digit and matrix entry is in [0, 127] and every sum is
//      below 2^25. Lanes of a warp share k and, for one matrix, read the same
//      A word (one broadcast load), and read consecutive shared words;
//   3. it reduces V = sum_e Z[e] * 2^(7e) to canonical words. The matrices are
//      prescaled by R * 2^16 (R = 2^(32 W)), so the result is
//      V * 2^-(32 W + 16) mod p. The kernel takes it as W + 1 32-bit Montgomery
//      steps on V * 2^16 (2^16 * 2^-(32 (W + 1))). The window V * 2^16 <
//      2^(32 (W + 1)) * p holds for every field: V < 2^293 for W = 8 (folded
//      rows, sums below 2^25), and V < 32 p^2 for the banded matrices, where
//      p * 2^21 < 2^(32 (W + 1)). The JAX package reaches the same canonical
//      value through its fold matmul and a 16-bit tail (W = 8) or a 16-bit
//      wide reduction (narrow fields);
//   4. optionally multiplies by a Montgomery twiddle (32-bit CIOS, R = 2^(32 W));
//   5. stores the words at [w, k, b], coalesced over b.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace mxu {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_M = 32;
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
  // digit tile of one single-level block: ceil(D*m/4) words x bt columns,
  // with bt * m = 32 * max(m, 8)
  static constexpr int SMEM_WORDS = (D * MAX_M / 4) * 32;
};

struct FieldConst {
  uint32_t p[MAX_W];
  uint32_t np0;  // -p^-1 mod 2^32
};

// One level's operands.
struct Level {
  const uint32_t* x;   // [W, m, B]
  const int8_t* A;     // conv matrix [E*m, D*m], or the first of a stack
  long long a_stride;  // bytes between stack entries; 0 for one matrix
  long long a_rep;     // batch columns per stack entry
  const uint32_t* T3;  // twiddle, or nullptr
  long long t_rep;     // 1: T3 is [W, m, B]; > 1: T3 is [W, B / t_rep, m]
  uint32_t* out;       // [W, m, B]
  int m;
  long long B;
  FieldConst fc;
};

// Warps per column group and batch columns per tile, for transform length m.
__host__ __device__ inline int warps_per_group(int m) { return m < WARPS ? m : WARPS; }
__host__ __device__ inline int block_cols(int m) { return 32 * (WARPS / warps_per_group(m)); }

// Stages the digits of an m x bt tile: load(i, bl, w) gives the words of the
// element at row i, tile column bl (zeros for a masked column).
template <int W, class Load>
__device__ __forceinline__ void stage_digits(int m, int bt, uint32_t* dsm, Load load) {
  constexpr int D = Geo<W>::D;
  const int cols = D * m;
  const int G = (cols + 3) / 4;
  uint8_t* d8 = reinterpret_cast<uint8_t*>(dsm);
  if (cols & 3) {  // the last word group is padded: its tail multiplies zeros
    for (int b = threadIdx.x; b < bt; b += THREADS) dsm[(G - 1) * bt + b] = 0u;
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < m * bt; idx += THREADS) {
    const int i = idx / bt, bl = idx % bt;
    uint32_t w[W];
    load(i, bl, w);
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const int bit = 7 * j, w0 = bit >> 5, r = bit & 31;
      uint32_t v = w[w0] >> r;
      if (r + 7 > 32 && w0 + 1 < W) v |= w[w0 + 1] << (32 - r);
      const int c = j * m + i;
      d8[((c >> 2) * bt + bl) * 4 + (c & 3)] = (uint8_t)(v & 127u);
    }
  }
}

// z[e] = sum_c A[e*m + k, c] * d[c, bl]. VEC: bytes of A per load (16 when
// rows are 16-byte multiples, 4 when 4-byte multiples, else single bytes).
template <int W, int VEC>
__device__ __forceinline__ void contract(const int8_t* A, int m, int k, const uint32_t* dsm,
                                         int bt, int bl, int (&z)[Geo<W>::E]) {
  constexpr int D = Geo<W>::D, E = Geo<W>::E;
  const int cols = D * m;
  const int G = (cols + 3) / 4;
  const long long plane = (long long)m * cols;  // bytes from row e*m+k to (e+1)*m+k
  const int8_t* row = A + (long long)k * cols;
  if constexpr (VEC == 16) {
    for (int g = 0; g < G; g += 4) {
      const int d0 = (int)dsm[(g + 0) * bt + bl], d1 = (int)dsm[(g + 1) * bt + bl];
      const int d2 = (int)dsm[(g + 2) * bt + bl], d3 = (int)dsm[(g + 3) * bt + bl];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int4 a = __ldg(reinterpret_cast<const int4*>(row + e * plane) + (g >> 2));
        z[e] = __dp4a(a.x, d0, z[e]);
        z[e] = __dp4a(a.y, d1, z[e]);
        z[e] = __dp4a(a.z, d2, z[e]);
        z[e] = __dp4a(a.w, d3, z[e]);
      }
    }
  } else if constexpr (VEC == 4) {
    for (int g = 0; g < G; ++g) {
      const int dv = (int)dsm[g * bt + bl];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int a = __ldg(reinterpret_cast<const int*>(row + e * plane) + g);
        z[e] = __dp4a(a, dv, z[e]);
      }
    }
  } else {
    for (int g = 0; g < G; ++g) {
      const int dv = (int)dsm[g * bt + bl];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int8_t* r = row + e * plane + 4 * g;
        uint32_t a = 0u;
        for (int q = 0; q < 4; ++q)
          if (4 * g + q < cols) a |= (uint32_t)(uint8_t)__ldg(r + q) << (8 * q);
        z[e] = __dp4a((int)a, dv, z[e]);
      }
    }
  }
}

// The contraction for output row k, with the widest loads the row length allows.
template <int W>
__device__ __forceinline__ void contract_row(const int8_t* A, int m, int k, const uint32_t* dsm,
                                             int bt, int bl, int (&z)[Geo<W>::E]) {
  const int cols = Geo<W>::D * m;
#pragma unroll
  for (int e = 0; e < Geo<W>::E; ++e) z[e] = 0;
  if (cols % 16 == 0) {
    contract<W, 16>(A, m, k, dsm, bt, bl, z);
  } else if (cols % 4 == 0) {
    contract<W, 4>(A, m, k, dsm, bt, bl, z);
  } else {
    contract<W, 1>(A, m, k, dsm, bt, bl, z);
  }
}

// y = r mod p for r = r[0..W) + top * 2^(32 W) < 2p.
template <int W>
__device__ __forceinline__ void cond_sub_p(const uint32_t (&r)[W], uint32_t top,
                                           const FieldConst& fc, uint32_t (&y)[W]) {
  uint32_t u[W];
  uint32_t borrow = 0u;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const uint64_t d = (uint64_t)r[j] - fc.p[j] - borrow;
    u[j] = (uint32_t)d;
    borrow = (uint32_t)(d >> 63);
  }
  const bool ge = top != 0u || borrow == 0u;
#pragma unroll
  for (int j = 0; j < W; ++j) y[j] = ge ? u[j] : r[j];
}

// y = V * 2^-(32 W + 16) mod p for V = sum_e z[e] * 2^(7e), each
// 0 <= z[e] < 2^25 and V * 2^16 < 2^(32 (W + 1)) * p.
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

// y = a * b * 2^-(32 W) mod p (CIOS, 32-bit words), canonical in and out.
template <int W>
__device__ __forceinline__ void mont_mul(const uint32_t (&a)[W], const uint32_t (&b)[W],
                                         const FieldConst& fc, uint32_t (&y)[W]) {
  uint32_t t[W + 2];
#pragma unroll
  for (int j = 0; j < W + 2; ++j) t[j] = 0u;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    uint64_t c = 0u;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      c += (uint64_t)a[i] * b[j] + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[W];
    t[W] = (uint32_t)c;
    t[W + 1] = (uint32_t)(c >> 32);
    const uint32_t q = t[0] * fc.np0;
    c = ((uint64_t)q * fc.p[0] + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < W; ++j) {
      c += (uint64_t)q * fc.p[j] + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[W];
    t[W - 1] = (uint32_t)c;
    t[W] = t[W + 1] + (uint32_t)(c >> 32);
  }
  uint32_t r[W];
#pragma unroll
  for (int j = 0; j < W; ++j) r[j] = t[j];
  cond_sub_p<W>(r, t[W], fc, y);
}

// The decomposition twiddle of output row k, batch column b (m rows in all).
template <int W>
__device__ __forceinline__ void load_twiddle(const uint32_t* T3, long long t_rep, int m,
                                             long long B, int k, long long b, uint32_t (&t)[W]) {
  if (t_rep == 1) {
#pragma unroll
    for (int q = 0; q < W; ++q) t[q] = T3[((long long)q * m + k) * B + b];
  } else {
    const long long rows = B / t_rep;
#pragma unroll
    for (int q = 0; q < W; ++q) t[q] = T3[((long long)q * rows + b / t_rep) * m + k];
  }
}

// The whole single level for this block's columns. Warp w works on column group
// w / kw and on rows k = w % kw, w % kw + kw, ... (kw = min(m, 8)).
template <int W>
__device__ __forceinline__ void run_level(const Level& L) {
  __shared__ uint32_t dsm[Geo<W>::SMEM_WORDS];
  const int m = L.m;
  const int kw = warps_per_group(m);
  const int bt = block_cols(m);
  const long long b0 = (long long)blockIdx.x * bt;
  stage_digits<W>(m, bt, dsm, [&](int i, int bl, uint32_t(&w)[W]) {
    const long long b = b0 + bl;
#pragma unroll
    for (int q = 0; q < W; ++q) w[q] = b < L.B ? L.x[((long long)q * m + i) * L.B + b] : 0u;
  });
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bl = (warp / kw) * 32 + lane;
  const long long b = b0 + bl;
  const long long bc = b < L.B ? b : L.B - 1;  // operand index of a masked column
  const int8_t* A = L.A + (L.a_stride ? (bc / L.a_rep) * L.a_stride : 0);
  for (int k = warp % kw; k < m; k += kw) {
    int z[Geo<W>::E];
    contract_row<W>(A, m, k, dsm, bt, bl, z);
    uint32_t y[W];
    reduce<W>(z, L.fc, y);
    if (b >= L.B) continue;
    if (L.T3 != nullptr) {
      uint32_t t[W], r[W];
      load_twiddle<W>(L.T3, L.t_rep, m, L.B, k, b, t);
      mont_mul<W>(y, t, L.fc, r);
#pragma unroll
      for (int q = 0; q < W; ++q) y[q] = r[q];
    }
#pragma unroll
    for (int q = 0; q < W; ++q) L.out[((long long)q * m + k) * L.B + b] = y[q];
  }
}

inline FieldConst field_const(const uint32_t* p, uint32_t np0) {
  FieldConst fc;
  for (int j = 0; j < MAX_W; ++j) fc.p[j] = p[j];
  fc.np0 = np0;
  return fc;
}

// Launch one single level on `stream`; returns cudaGetLastError() as an int.
inline int launch(void (*kernel)(Level), const Level& L, void* stream) {
  const long long bt = block_cols(L.m);
  const long long blocks = (L.B + bt - 1) / bt;
  kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(L);
  return (int)cudaGetLastError();
}

// Launch the instantiation of a kernel template for a field of n_words words.
#define MXU_LAUNCH_FOR_WIDTH(kernel, n_words, L, stream)                           \
  ((n_words) == 8   ? mxu::launch(kernel<8>, (L), (stream))                        \
   : (n_words) == 2 ? mxu::launch(kernel<2>, (L), (stream))                        \
   : (n_words) == 1 ? mxu::launch(kernel<1>, (L), (stream))                        \
                    : (int)cudaErrorInvalidValue)

}  // namespace mxu

// K5 and K6: every radix-2 butterfly stage of an m-point NTT, on uint32[W, m, B]
// (W = 8, 2 or 1 words per element, Montgomery form, natural order in and out,
// m a power of two from 2 to 256).
//
// K5 vmem_stage_ntt replaces ntt_tpu/kernels/vmem_ntt.py::_kernel (entry
// ntt_along_axis_pallas): the ladder alone.
// K6 vmem_fused_stage_level replaces ntt_tpu/kernels/vmem_ntt.py::_kernel_fused
// (entry fused_stage_level): the ladder, then an optional product with a
// full-resolution twiddle T3[W, m, B], then the store, transposed to [W, B, m] on
// request: one four-step level of the butterfly path in one pass over the data.
//
// Register passes. A thread owns R = 2^K elements of one column (R = min(R_MAX, m);
// R_MAX = 4 for W = 8, 16 for the narrow fields) and runs K stages on them in
// registers; the column's T = m / R threads trade elements through a shared tile
// only between passes. With the rows indexed in bit-reversed order (p), the stage
// of half-size 2^s pairs p and p + 2^s; a pass owns K consecutive stage bits:
//   pass P < last: bits [K P, K P + K), the thread's R elements differ in
//                  exactly those bits of p;
//   last pass:     bits [L - K, L) of p (L = log2 m), running only the stages
//                  that the earlier passes left (from local stage u0 on),
// so every stage runs exactly once (m = 64, W = 8: three passes of two stages;
// m = 256, W = 2: two of four). The thread's other bits of p come from t. Pass
// 0 loads its elements straight from device memory at natural row bitrev(p): the
// bit reversal is folded into which rows a thread reads, and a warp reads whole
// 64- or 128-byte row segments of a word plane (16 or 32 consecutive columns).
// The last pass holds natural output rows: the direct store and the T3 read
// (issued at the start of the tile, in flight under the passes) are coalesced
// the same way. The transposed store goes through the tile and writes
// row-fastest, bt * m consecutive words a word plane (the tile's odd row stride
// bt + 1 keeps those reads off one bank).
//
// Twiddles. The block stages the master table [W, m/2] once, element-major, in
// shared memory; a stage's twiddle is w_{2^(s+1)}^pos = master[pos << (L-1-s)]
// with pos = p mod 2^s, read as vectors and broadcast across the warp. No device
// memory is read inside a stage. The products by w^0 = 1 are left out: in pass
// 0 at compile time (pos depends only on the register index), in the later ones
// by a branch on the thread's low bits of p, uniform across a warp (a warp's
// threads share those bits: thread_rank in vmem_ntt.py).
//
// Arithmetic: mxu::mont_mul (CIOS with its carries on the PTX carry chain),
// add_mod and sub_mod below on add.cc/addc/sub.cc/subc.
//
// Grid: the launch plan (vmem_ntt.stage_plan in Python: R, bt, threads, grid,
// shared bytes) is computed by the wrapper and checked here. A block of T * bt
// threads (256 where a thread holds 32 words or more, else up to 512) owns bt
// columns a tile and loops over column tiles with a stride of the grid, which is
// at most the blocks the card holds at once; the loads of one block overlap the
// products of the others on the same SM.
//
// Bound on an H100 at the 256-bit ladder's shape (W = 8, m = 64, B = 4096, one of
// three launches of a 2^18 transform): the function moves 16.8 MB (x in, out;
// 25.2 MB with T3), 5.0 us (7.5 us) at 3.35 TB/s. Its products, 129 a column at m =
// 64 (the stage twiddles other than 1) and m more with T3, need 4 W^2 + W = 264
// 32-bit multiply results each (a low and a high half of each of the 2 W^2
// partial products, and W quotient words), 0.140 G results, 8.3 us at 16.7 T a
// second (132 SMs x 64 a clock x 1.98 GHz): the ladder is bound by its products,
// and so is this kernel (ladder_knockout.py: products about two thirds of a
// launch).
#include "mxu_core.cuh"

namespace vmem {

using mxu::FieldConst;

constexpr int MAX_M = 256;
constexpr long long SMEM_MAX = 227 * 1024;  // dynamic shared memory a block may take

// The elements a thread owns, at most, and the threads a block may have
// (vmem_ntt.R_MAX and max_threads in Python).
__host__ __device__ constexpr int r_max(int W) { return W == 8 ? 4 : 16; }
__host__ __device__ constexpr int max_threads(int W, int R) { return W * R >= 32 ? 256 : 512; }
__host__ __device__ constexpr int ilog2(int v) { return v <= 1 ? 0 : 1 + ilog2(v >> 1); }

struct Stages {
  const uint32_t* x;   // [W, m, B]
  const uint32_t* tw;  // master twiddles [W, m/2]
  const uint32_t* T3;  // [W, m, B], or nullptr
  uint32_t* out;       // [W, m, B], or [W, B, m] when transposed
  int m;
  int log_m;
  int bt;              // columns a tile
  int tw_words;        // shared words of the staged twiddle table (16-byte multiple)
  int transpose;
  long long B;
  long long tiles;     // ceil(B / bt)
  FieldConst fc;
};

// y = (a + b) mod p, canonical in and out; the carry out of the top word counts.
template <int W>
__device__ __forceinline__ void add_mod(const uint32_t (&a)[W], const uint32_t (&b)[W],
                                        const FieldConst& fc, uint32_t (&y)[W]) {
  uint32_t r[W];
  r[0] = mxu::add_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < W; ++j) r[j] = mxu::addc_cc(a[j], b[j]);
  mxu::cond_sub_p<W>(r, mxu::addc(0u, 0u), fc, y);
}

// y = (a - b) mod p, canonical in and out: p is added back where a - b borrows.
template <int W>
__device__ __forceinline__ void sub_mod(const uint32_t (&a)[W], const uint32_t (&b)[W],
                                        const FieldConst& fc, uint32_t (&y)[W]) {
  uint32_t d[W];
  d[0] = mxu::sub_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < W; ++j) d[j] = mxu::subc_cc(a[j], b[j]);
  const uint32_t mask = mxu::subc(0u, 0u);  // all ones where a < b
  y[0] = mxu::add_cc(d[0], fc.p[0] & mask);
#pragma unroll
  for (int j = 1; j < W; ++j) y[j] = mxu::addc_cc(d[j], fc.p[j] & mask);
}

// W words from shared memory at a W-word-aligned address, as wide loads.
template <int W>
__device__ __forceinline__ void load_words(const uint32_t* src, uint32_t (&w)[W]) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int q = 0; q < W; q += 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(src + q);
      w[q] = v.x;
      w[q + 1] = v.y;
      w[q + 2] = v.z;
      w[q + 3] = v.w;
    }
  } else if constexpr (W == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(src);
    w[0] = v.x;
    w[1] = v.y;
  } else {
#pragma unroll
    for (int q = 0; q < W; ++q) w[q] = src[q];
  }
}

// The stages of one pass on the thread's R elements v[j], which sit at rows
// p = base + (j << s0) of the bit-reversed column: local stage u pairs j and
// j + 2^u (global half-size 2^(s0+u)), from u0 on. tlow = base mod 2^s0.
// FIRST: pass 0 (s0 = 0, u0 = 0, tlow = 0), whose twiddle indices are known at
// compile time up to a shift. A stage's products by w^0 = 1 are left out: at
// compile time in pass 0, where tlow = 0 elsewhere (a branch that is uniform
// across the warp where its threads share tlow).
template <int W, int R, bool FIRST>
__device__ __forceinline__ void run_pass(uint32_t (&v)[R][W], int L, int s0, int u0, int tlow,
                                         const uint32_t* tws, const FieldConst& fc) {
  constexpr int K = ilog2(R);
#pragma unroll
  for (int u = 0; u < K; ++u) {
    if (!FIRST && u < u0) continue;
    const int sh = L - 1 - (s0 + u);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (j & (1 << u)) continue;
      const int jl = j & ((1 << u) - 1);
      if (FIRST ? jl != 0 : jl != 0 || tlow != 0) {
        const int pos = FIRST ? jl : tlow + (jl << s0);
        uint32_t w[W], r[W];
        load_words<W>(tws + (pos << sh) * W, w);
        mxu::mont_mul<W>(v[j | (1 << u)], w, fc, r);
#pragma unroll
        for (int q = 0; q < W; ++q) v[j | (1 << u)][q] = r[q];
      }
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (j & (1 << u)) continue;
      uint32_t(&a)[W] = v[j];
      uint32_t(&b)[W] = v[j | (1 << u)];
      uint32_t lo[W], hi[W];
      add_mod<W>(a, b, fc, lo);
      sub_mod<W>(a, b, fc, hi);
#pragma unroll
      for (int q = 0; q < W; ++q) {
        a[q] = lo[q];
        b[q] = hi[q];
      }
    }
  }
}

// Between passes: the thread's elements out to the tile (column bl, the
// caller's offset) at rows base + (j << s0), and in at the next pass's rows
// base1 + (j << s1). Every thread reads and writes only its own rows of a pass,
// so one barrier orders the exchange.
template <int W, int R>
__device__ __forceinline__ void exchange(uint32_t (&v)[R][W], uint32_t* col, long long plane,
                                         int rs, int base, int s0, int base1, int s1) {
#pragma unroll
  for (int j = 0; j < R; ++j)
#pragma unroll
    for (int q = 0; q < W; ++q) col[q * plane + (base + (j << s0)) * rs] = v[j][q];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < R; ++j)
#pragma unroll
    for (int q = 0; q < W; ++q) v[j][q] = col[q * plane + (base1 + (j << s1)) * rs];
}

// The block's column tiles: load (bit-reversed), the passes, T3 and the store.
template <int W, int R, bool FUSED>
__device__ __forceinline__ void ladder(const Stages& S) {
  constexpr int K = ilog2(R);
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* tws = smem;                // [m/2][W]
  uint32_t* tile = smem + S.tw_words;  // [W][m][bt + 1]
  const int m = S.m, L = S.log_m, bt = S.bt, rs = bt + 1, half = m >> 1;
  const long long plane = (long long)m * rs;
  for (int idx = threadIdx.x; idx < W * half; idx += blockDim.x)
    tws[(idx % half) * W + idx / half] = __ldg(S.tw + idx);
  __syncthreads();

  // thread t of a column, column bl of the tile. A warp holds 32 columns of one
  // t where bt >= 32, else 32 / bt values of t that differ in their high bits
  // (so that they share tlow in every pass but the last)
  const int T = m / R, lane = threadIdx.x & 31;
  const int t = bt >= 32 ? threadIdx.x / bt : (threadIdx.x >> 5) + lane / bt * (T * bt / 32);
  const int bl = bt >= 32 ? threadIdx.x % bt : lane % bt;
  const int passes = (L + K - 1) / K;
  // the natural output rows of the last pass: base + (j << s_last)
  const int s_last = passes == 1 ? 0 : L - K, base_last = passes == 1 ? t << K : t;
  for (long long tile_i = blockIdx.x; tile_i < S.tiles; tile_i += gridDim.x) {
    const long long b0 = tile_i * bt, b = b0 + bl;
    const bool in = b < S.B;
    uint32_t v[R][W], t3[FUSED ? R : 1][W];
    if (FUSED && S.T3 != nullptr) {  // in flight under the passes
#pragma unroll
      for (int j = 0; j < (FUSED ? R : 1); ++j) {
        const int k = base_last + (j << s_last);
#pragma unroll
        for (int q = 0; q < W; ++q) t3[j][q] = in ? __ldg(S.T3 + ((long long)q * m + k) * S.B + b) : 0u;
      }
    }
    // pass 0: rows p = (t << K) + j of the bit-reversed column
    int base = t << K, s0 = 0;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int i = (int)(__brev((unsigned)(base + j)) >> (32 - L));
#pragma unroll
      for (int q = 0; q < W; ++q) v[j][q] = in ? __ldg(S.x + ((long long)q * m + i) * S.B + b) : 0u;
    }
    run_pass<W, R, true>(v, L, 0, 0, 0, tws, S.fc);
    for (int P = 1; P < passes; ++P) {
      const int s1 = P < passes - 1 ? K * P : L - K;
      const int tlow = t & ((1 << s1) - 1);
      const int base1 = tlow | ((t >> s1) << (s1 + K));
      exchange<W, R>(v, tile + bl, plane, rs, base, s0, base1, s1);
      run_pass<W, R, false>(v, L, s1, K * P - s1, tlow, tws, S.fc);
      base = base1;
      s0 = s1;
    }

    // the thread holds natural output rows k = base + (j << s0)
    if (FUSED && S.T3 != nullptr) {
#pragma unroll
      for (int j = 0; j < (FUSED ? R : 1); ++j) {
        uint32_t r[W];
        mxu::mont_mul<W>(v[j], t3[j], S.fc, r);
#pragma unroll
        for (int q = 0; q < W; ++q) v[j][q] = r[q];
      }
    }
    if (!FUSED || !S.transpose) {
      if (in) {
#pragma unroll
        for (int j = 0; j < R; ++j)
#pragma unroll
          for (int q = 0; q < W; ++q)
            S.out[((long long)q * m + base + (j << s0)) * S.B + b] = v[j][q];
      }
    } else {
      // transposed store out[w, b, k] through the tile, row-fastest
#pragma unroll
      for (int j = 0; j < R; ++j)
#pragma unroll
        for (int q = 0; q < W; ++q) tile[q * plane + (base + (j << s0)) * rs + bl] = v[j][q];
      __syncthreads();
      const int cols = S.B - b0 < bt ? (int)(S.B - b0) : bt;
      for (int idx = threadIdx.x; idx < cols * m; idx += blockDim.x) {
        const int c = idx / m, k = idx % m;
#pragma unroll
        for (int q = 0; q < W; ++q)
          S.out[((long long)q * S.B + b0 + c) * m + k] = tile[q * plane + k * rs + c];
      }
    }
    __syncthreads();  // the tile is free for the next column tile
  }
}

// At most 128 registers a thread: two blocks of 256 threads (one of 512) an SM.
template <int W, int R>
__global__ void __launch_bounds__(max_threads(W, R), 512 / max_threads(W, R))
    stage_ntt_kernel(const Stages S) {
  ladder<W, R, false>(S);
}

template <int W, int R>
__global__ void __launch_bounds__(max_threads(W, R), 512 / max_threads(W, R))
    fused_stage_level_kernel(const Stages S) {
  ladder<W, R, true>(S);
}

// Shared bytes of a block: the staged twiddles, then the tile. Python's
// vmem_ntt.stage_plan computes the same.
inline int tw_words(int W, int m) { return (W * (m / 2) + 3) / 4 * 4; }
inline long long smem_bytes(int W, int m, int bt) {
  return 4LL * (tw_words(W, m) + (long long)W * m * (bt + 1));
}

// Checks the plan of stage_plan (R elements a thread, bt columns a tile, threads
// a block, grid blocks, smem shared bytes): refuses what the kernels cannot take.
static bool plan_ok(int W, int m, long long B, int R, int bt, int threads, int grid, int smem) {
  auto pow2 = [](long long v) { return v >= 1 && (v & (v - 1)) == 0; };
  if (!pow2(m) || m < 2 || m > MAX_M || B < 1) return false;
  if (!pow2(R) || R < 2 || R > r_max(W) || R > m) return false;
  if (!pow2(bt) || threads != (m / R) * bt || threads > max_threads(W, R)) return false;
  const long long tiles = (B + bt - 1) / bt;
  if (grid < 1 || grid > tiles) return false;
  return smem == smem_bytes(W, m, bt) && smem <= SMEM_MAX;
}

template <int W, int R>
int launch_r(bool fused, const Stages& S, int threads, int grid, int smem, cudaStream_t stream) {
  void (*kernel)(const Stages) =
      fused ? fused_stage_level_kernel<W, R> : stage_ntt_kernel<W, R>;
  cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  kernel<<<grid, threads, (size_t)smem, stream>>>(S);
  return (int)cudaGetLastError();
}

// The instantiation for R elements a thread: 2, 4, .. R_MAX.
template <int W, int R = 2>
int launch_w(bool fused, const Stages& S, int r, int threads, int grid, int smem,
             cudaStream_t stream) {
  if (r == R) return launch_r<W, R>(fused, S, threads, grid, smem, stream);
  if constexpr (2 * R <= r_max(W))
    return launch_w<W, 2 * R>(fused, S, r, threads, grid, smem, stream);
  return (int)cudaErrorInvalidValue;
}

static int launch(bool fused, const void* x, const void* tw, const void* T3, void* out,
                  int transpose, int m, long long B, int R, int bt, int threads, int grid,
                  int smem, const uint32_t* p, uint32_t np0, int n_words, void* stream) {
  if (n_words != 8 && n_words != 2 && n_words != 1) return (int)cudaErrorInvalidValue;
  if (!plan_ok(n_words, m, B, R, bt, threads, grid, smem)) return (int)cudaErrorInvalidValue;
  Stages S{};
  S.x = static_cast<const uint32_t*>(x);
  S.tw = static_cast<const uint32_t*>(tw);
  S.T3 = static_cast<const uint32_t*>(T3);
  S.out = static_cast<uint32_t*>(out);
  S.m = m;
  S.log_m = ilog2(m);
  S.bt = bt;
  S.tw_words = tw_words(n_words, m);
  S.transpose = transpose;
  S.B = B;
  S.tiles = (B + bt - 1) / bt;
  S.fc = mxu::field_const(p, np0);
  cudaStream_t s = (cudaStream_t)stream;
  switch (n_words) {
    case 8: return launch_w<8>(fused, S, R, threads, grid, smem, s);
    case 2: return launch_w<2>(fused, S, R, threads, grid, smem, s);
    default: return launch_w<1>(fused, S, R, threads, grid, smem, s);
  }
}

}  // namespace vmem

extern "C" int vmem_stage_ntt(const void* x, const void* tw, void* out, int m, long long B, int R,
                              int bt, int threads, int grid, int smem, const uint32_t* p,
                              uint32_t np0, int n_words, void* stream) {
  return vmem::launch(false, x, tw, nullptr, out, 0, m, B, R, bt, threads, grid, smem, p, np0,
                      n_words, stream);
}

extern "C" int vmem_fused_stage_level(const void* x, const void* tw, const void* T3, void* out,
                                      int transpose, int m, long long B, int R, int bt,
                                      int threads, int grid, int smem, const uint32_t* p,
                                      uint32_t np0, int n_words, void* stream) {
  return vmem::launch(true, x, tw, T3, out, transpose, m, B, R, bt, threads, grid, smem, p, np0,
                      n_words, stream);
}

// The persistent form of the 256-bit tensor-core level: K1 (its long form), K2,
// K3 (single-level) and K4 at W = 8, m = 32 on uint32[8, 32, B], for launches
// whose 128-column tiles fill the card several times over
// (mxu_level.persist_plan). Same words as the one-level block of mxu_level.cu
// (tc_level), which keeps every other launch.
//
// It replaces, at those shapes, ntt_tpu/kernels/mxu_level.py::_kernel_stack (K2,
// fused_level_stack_persist_kernel), ::_kernel_sub in its single-level form (K3,
// fused_subntt_persist_kernel), ::_kernel_level (K4, fused_level_persist_kernel)
// and ntt_tpu/kernels/mxu_ntt.py::_kernel (K1, base_ntt_mxu_persist_kernel): the
// 32-point transform as one digit matmul against the folded conv matrix
// A[(e*32 + k), (j*32 + i)] (E = D = 37 planes and digits), the Montgomery
// reduction of each output's 37 planes, the optional twiddle product and the
// store along b (mxu_core.cuh has the arithmetic and its windows).
//
// Bound on an H100 at the 2^22 levels ([8, 32, 2^17]): 1184 x 1184 x 2^17 =
// 184 G int8 MACs, 0.186 ms at 1,979 TOPS; 268 MB of data in and out plus at
// most the 180 MB stack of level 2 (or the 128 MiB merged table of K3), 0.08 -
// 0.13 ms at 3.35 TB/s. MACs bound every such launch. The one-level block
// takes about 1.1 ms there: it runs its phases in series (the digit staging,
// the TMA stream, the wgmma steps, the epilogue through a shared Z tile of 156 KB,
// two thirds of the block's shared memory, tc_knockout.py), and the four row
// chunks of a column tile are four blocks that each stage the tile's digits
// again.
//
// The block here, one an SM, walks column tiles t = blockIdx.x, + gridDim.x, ...
// (grid-stride, so that the resident blocks sit on neighbouring tiles and read
// one stack entry from L2 together):
//   - the digit tile of a column tile (128 columns x 1184 bytes, 151,552 B) is
//     staged once and serves the tile's CHUNKS = 8 row chunks of KT = 4 rows;
//   - each chunk's conv-matrix rows (GEMM rows r = e * KT + kk, 148 of them)
//     stream through a ring of STAGES = 4 stages as TMA boxes {128, 4, 37, 1}
//     of the stack: 128 bytes of depth (four wgmma steps) in rows of 128
//     bytes with the 128-byte swizzle, NB = 10 boxes a chunk, the last one
//     zero-filled past the depth. (Boxes of one 32-byte step, 37 a chunk, kept
//     the TMA unit at a third of the rate: 1.49 ms a 2^22 level against 0.82.)
//     The warpgroup done with a box loads into its stage the box STAGES on,
//     whichever chunk that is;
//   - the block is two warpgroups that take the chunks in turn (warpgroup g
//     the chunks c = g, g + 2, ...): for a chunk, per step one wgmma
//     m64n160k32 on each of the tile's two 64-column halves against the same
//     box (so each conv-matrix byte brought from L2 serves 128 columns),
//     2 x 80 accumulator registers; then the chunk's epilogue from those
//     registers while the other warpgroup's steps run on the tensor cores.
//     Named barriers (ORDER) keep the two warpgroups' steps in chunk order,
//     so that each box's barrier is waited on in the order its phases
//     complete. There is no Z tile.
// The accumulator layout: thread (warp w4 of its warpgroup, lane) holds for
// column half h2 batch columns h2 * 64 + w4 * 16 + lane / 4 (+ 8) and GEMM rows
// 8j + 2 (lane % 4) + {0, 1}: with r = e * 4 + kk those are the even planes
// (lane % 4 < 2) or the odd planes (lane % 4 >= 2) of rows kk = 2 (lane % 2) +
// {0, 1}. Lanes l and l ^ 2 hold the two halves of the same four outputs: each
// keeps the two of its column (+ 8 for the odd lanes) and receives the other
// parity's planes of them by one __shfl_xor a plane; then the reduction of the
// 37 planes (redc), the twiddle, the store. Four outputs a thread a chunk.
// At the end of a tile the block stages the next tile's digits as soon as the
// last chunk's steps are done (each thread first asks L2 for one row of the
// next tile's x); warpgroup 1 runs that chunk's epilogue after the staging,
// under warpgroup 0's first steps of the new tile.
//
// Budget. Shared: the digit tile 151,552 B + 4 ring stages of 19,456 B +
// 1,024 B that the last stage's wgmma reads past its 152 rows (160 are read)
// + 1,024 B to align the base to the 1 KB swizzle atom = 231,424 B dynamic,
// and 32 B of barriers: 231,456 of 232,448. Registers: 256 threads, two warps
// on each SM sub-partition, so up to 255 a thread: 160 accumulators, and the
// epilogue's 37 planes, the reduction's lanes and the twiddle, or the
// staging's words. (A third warpgroup to feed the ring would leave 168 a
// thread, or 232 under setmaxnreg; the ring needs no thread of its own.) The
// digit staging of a tile, four tasks a thread, is the one phase left in
// series with the tensor cores.
//
// On an H100 at the 2^22 levels this block takes 0.79-0.81 ms (K2) and
// 1.05-1.08 ms (K3, with its twiddle product), 4.3x the MAC bound (the
// one-level block 6x): the staging in series (about 0.16 ms), the ring's four
// boxes against the L2 latency (the ring alone 0.25 ms, the wgmma steps alone
// 0.22), and the epilogue on one warpgroup at a time (0.21 and 0.64 ms alone)
// hold it there (tc_knockout.py --persist).
#include "mxu_core.cuh"

namespace mxu {
namespace persist {

constexpr int W = 8;
constexpr int D = Geo<W>::D, E = Geo<W>::E;
constexpr int M = 32;                         // the level's transform length
constexpr int KT = 4;                         // output rows a chunk
constexpr int CHUNKS = M / KT;
constexpr int K = D * M;                      // contraction depth, 1184 = 37 steps
constexpr int NK = K / tc::BK;
constexpr int STAGE_ROWS = (E * KT + 7) & ~7;  // 152: the 148 GEMM rows, whole swizzle atoms
constexpr int SWZ = 128;                      // bytes of depth a ring row holds: one TMA box
constexpr int SPB = SWZ / tc::BK;             // wgmma steps a box
constexpr int NB = (NK + SPB - 1) / SPB;      // boxes a chunk (the last one zero-filled past K)
constexpr int LAST = NK - (NB - 1) * SPB;     // steps of a chunk's last box
constexpr int ATOM = 8 * SWZ;                 // a swizzle atom: 8 rows
constexpr int STAGE_BYTES = STAGE_ROWS * SWZ;
constexpr int RING_BYTES = 16 * 4864;         // what the digit tile leaves of the block
constexpr int STAGES = RING_BYTES / STAGE_BYTES;
constexpr int DIG_BYTES = tc::N * K;
constexpr int OVERRUN = (tc::NR - STAGE_ROWS) * SWZ;  // read past the last stage
constexpr int SLACK = ATOM > tc::ALIGN ? ATOM : tc::ALIGN;  // the base aligned to an atom
constexpr int CONSUMERS = 2;                  // warpgroups: the whole block
constexpr int THREADS = CONSUMERS * 128;
constexpr int TILE_BOXES = CHUNKS * NB;       // ring boxes a column tile
static_assert(K % tc::BK == 0 && E * KT <= tc::NR && CHUNKS % CONSUMERS == 0 &&
                  STAGE_BYTES % ATOM == 0 && THREADS == W * M,
              "geometry");

// Dynamic shared bytes; Python's mxu_level.persist_plan computes the same.
__host__ __device__ constexpr int smem_bytes() {
  return SLACK + DIG_BYTES + STAGES * STAGE_BYTES + OVERRUN;
}
static_assert(smem_bytes() + STAGES * 8 <= tc::MAX_SMEM, "shared budget");

// Named barriers (0 is __syncthreads'): ORDER + g, warpgroup g's steps of a
// chunk are done (the other warpgroup's may start); RELEASE + g, every warp of
// warpgroup g is done with a box.
constexpr int ORDER = 1, RELEASE = 3;
template <int COUNT>
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(COUNT) : "memory");
}
template <int COUNT>
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(COUNT) : "memory");
}

// Keeps the reads of the accumulators after the wait for the wgmma that writes them.
__device__ __forceinline__ void fence_acc(int (&acc)[tc::NR / 2]) {
#pragma unroll
  for (int i = 0; i < tc::NR / 2; ++i) asm volatile("" : "+r"(acc[i])::"memory");
}

// wgmma descriptor of the ring's rows: K-major, 128-byte swizzle, 8-row atoms
// ATOM bytes apart. A step j of a box starts 32 j bytes into its rows (the
// swizzle is taken from the address bits, the stage aligned to an atom).
__device__ __forceinline__ uint64_t desc_ring(const void* p) {
  return (uint64_t)((tc::saddr(p) & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)(ATOM >> 4) << 32 | (uint64_t)1 << 62;
}

// The TMA map of the conv-matrix stack int8[NT][E][32][K]: boxes of {SWZ, KT,
// E, 1} bytes (a chunk's 148 GEMM rows, SWZ bytes of depth), 128-byte
// swizzle, zeros past K.
static inline bool ring_map(CUtensorMap* map, const int8_t* A, long long NT) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tc::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)K, (cuuint64_t)M, (cuuint64_t)E, (cuuint64_t)NT};
  const cuuint64_t strides[3] = {(cuuint64_t)K, (cuuint64_t)M * K, (cuuint64_t)E * M * K};
  const cuuint32_t box[4] = {(cuuint32_t)SWZ, (cuuint32_t)KT, (cuuint32_t)E, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<int8_t*>(A), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The block's ring of STAGES boxes, in the order the chunks' steps are
// contracted (chunk by chunk, the two warpgroups' chunks in turn: the ORDER
// barriers keep one warpgroup's steps after the other's, so each box's
// barrier is waited on in the order its phases complete). Box g = (li *
// CHUNKS + c) * NB + q (li the block's li-th tile, tile blockIdx.x + li *
// gridDim.x; chunk c; box q of its depth) lands in stage g % STAGES and
// completes phase g / STAGES of full[g % STAGES].
struct Ring {
  const CUtensorMap* map;
  uint8_t* stages;
  uint64_t* full;
  long long boxes;  // the block's boxes
  long long a_rep;  // columns a stack entry (B for one matrix)

  // TMA: box g into its stage (the conv-matrix rows e * 32 + c * KT + kk of
  // the tile's stack entry, depth bytes q * SWZ ..), if the block has it.
  __device__ __forceinline__ void issue(long long g) const {
    if (g >= boxes) return;
    const long long li = g / TILE_BOXES, t = blockIdx.x + li * gridDim.x;
    const int c = (int)(g % TILE_BOXES) / NB, q = (int)(g % NB), st = (int)(g % STAGES);
    tc::tma_load(stages + st * STAGE_BYTES, map, &full[st], E * KT * SWZ, q * SWZ, c * KT,
                 (int)(t * tc::N / a_rep));
  }
};

// The digit tile of columns b0 .. b0+127 of x (zero past B), by the block's
// threads: a task is four rows of one column (tc::put_digits), a warp 8
// consecutive columns x 4 row groups. Ends with the proxy fence of the writes.
__device__ __forceinline__ void stage(const tc::Level& L, long long b0, uint8_t* dig) {
  constexpr int G = M / 4;
  for (int idx = threadIdx.x; idx < tc::N * G; idx += THREADS) {
    const int bl = (idx >> 3) / G * 8 + (idx & 7), i0 = 4 * ((idx >> 3) % G);
    const long long b = b0 + bl;
    const bool in = b < L.B;
    uint32_t w[4][W];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int q = 0; q < W; ++q) w[t][q] = in ? L.x[((long long)q * M + i0 + t) * L.B + b] : 0u;
    tc::put_digits<W, M>(w, M, bl, i0, dig);
  }
  tc::fence_async_shared();
}

// The S wgmma steps k0 .. k0 + S - 1 of a box: each on the tile's two column
// halves against the box's rows (depth bytes 32 j .. of step j).
template <int S>
__device__ __forceinline__ void box_steps(int k0, const uint8_t* stage, const uint8_t* dig,
                                          int (&acc0)[tc::NR / 2], int (&acc1)[tc::NR / 2]) {
  using namespace tc;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int k = k0 + j;
    const uint64_t db = desc_ring(stage + j * BK);
    wgmma_s8(acc0, desc(dig + k * (N * BK)), db, k > 0);
    wgmma_s8(acc1, desc(dig + k * (N * BK) + NM * BK), db, k > 0);
  }
}

// One chunk's wgmma steps by warpgroup cw, the block's boxes g0 .. g0 + NB - 1:
// once every warp of the warpgroup is done with a box (named barrier RELEASE +
// cw), its stage takes the box STAGES further on, whichever chunk that is.
__device__ __forceinline__ void contract_chunk(const Ring& R, long long g0, int cw,
                                               const uint8_t* dig, int (&acc0)[tc::NR / 2],
                                               int (&acc1)[tc::NR / 2]) {
  const bool issuer = (threadIdx.x & 127) == 0;
#pragma unroll 1
  for (int q = 0; q < NB; ++q) {
    const long long g = g0 + q;
    const int st = (int)(g % STAGES);
    tc::mbar_wait(&R.full[st], (int)((g / STAGES) & 1));
    const uint8_t* stage = R.stages + st * STAGE_BYTES;
    tc::wgmma_fence();
    if (q < NB - 1) {
      box_steps<SPB>(q * SPB, stage, dig, acc0, acc1);
    } else {
      box_steps<LAST>(q * SPB, stage, dig, acc0, acc1);
    }
    tc::wgmma_commit();
    tc::wgmma_wait<1>();  // this warp's steps of box q - 1 are done
    if (q > 0) {
      bar_sync<128>(RELEASE + cw);
      if (issuer) R.issue(g - 1 + STAGES);
    }
  }
  tc::wgmma_wait<0>();
  bar_sync<128>(RELEASE + cw);
  if (issuer) R.issue(g0 + NB - 1 + STAGES);
  fence_acc(acc0);
  fence_acc(acc1);
}

// y = V * 2^-(32 W + 16) mod p for V = sum_e z[e] 2^(7e): reduce<8, true>
// (mxu_core.cuh, which has the windows), with the carry out of each Montgomery
// step's top word i + W taken into the next step's top word i + W + 1
// instead of along the whole window (the words above V's start at zero, and
// step i + 1 writes word i + W + 1 last): 9 words a step where reduce<8>
// carries through up to 18.
__device__ __forceinline__ void redc(const int (&z)[E], const FieldConst& fc, uint32_t (&y)[W]) {
  constexpr int NS = Geo<W>::NS;
  uint64_t s[NS];
#pragma unroll
  for (int q = 0; q < NS; ++q) s[q] = 0u;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int bit = 7 * e + 16, q = bit >> 5, r = bit & 31;
    asm("mad.wide.u32 %0, %1, %2, %0;" : "+l"(s[q]) : "r"((uint32_t)z[e]), "r"(1u << r));
  }
  uint32_t t[2 * W + 1];
  uint64_t c = 0u;
#pragma unroll
  for (int q = 0; q < NS; ++q) {
    c += s[q];
    t[q] = (uint32_t)c;
    c >>= 32;
  }
#pragma unroll
  for (int q = NS; q < 2 * W + 1; ++q) t[q] = 0u;
  uint32_t extra = 0u;  // the carry into word i + W
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
    cc += (uint64_t)t[i + W] + extra;
    t[i + W] = (uint32_t)cc;
    extra = (uint32_t)(cc >> 32);
  }
  // (T + Q p) / 2^(32 (W + 1)) < 2p: words W + 1 .. 2W and the carry above them
  uint32_t r[W];
#pragma unroll
  for (int j = 0; j < W; ++j) r[j] = t[W + 1 + j];
  cond_sub_p<W>(r, extra, fc, y);
}

// The epilogue of chunk c of the tile at b0 from this thread's accumulators
// of column half h2: for each row h, the planes of the two columns it holds
// (acc[4j + 2c' + h], plane 2j + parity, column + 8c'), the other parity's
// planes of its own column (+ 8 for the odd-plane lanes) from lane ^ 2,
// the reduction, the twiddle, the store.
__device__ __forceinline__ void epilogue_half(const tc::Level& L, long long b0, int c,
                                              const int (&acc)[tc::NR / 2], int h2) {
  const int lane = threadIdx.x & 31, par = (lane >> 1) & 1;
  const int bl = h2 * tc::NM + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2) + 8 * par;
  const long long b = b0 + bl;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int k = c * KT + 2 * (lane & 1) + h;
    uint32_t t[W];  // the twiddle's load runs under the reduction
    if (L.T3 != nullptr && b < L.B) load_twiddle<W>(L.T3, L.t_rep, L.t_period, M, L.B, k, b, t);
    int z[E];
#pragma unroll
    for (int j = 0; 2 * j < E; ++j) {
      const int a0 = acc[4 * j + h], a1 = acc[4 * j + 2 + h];
      const int got = __shfl_xor_sync(0xFFFFFFFFu, par ? a0 : a1, 2);
      z[2 * j] = par ? got : a0;
      if (2 * j + 1 < E) z[2 * j + 1] = par ? a1 : got;
    }
    uint32_t y[W];
    redc(z, L.fc, y);
    if (b >= L.B) continue;
    if (L.T3 != nullptr) {
      uint32_t r[W];
      mont_mul<W>(y, t, L.fc, r);
#pragma unroll
      for (int q = 0; q < W; ++q) y[q] = r[q];
    }
#pragma unroll
    for (int q = 0; q < W; ++q) L.out[((long long)q * M + k) * L.B + b] = y[q];
  }
}

__device__ __forceinline__ void epilogue(const tc::Level& L, long long b0, int c,
                                         const int (&acc0)[tc::NR / 2],
                                         const int (&acc1)[tc::NR / 2]) {
  epilogue_half(L, b0, c, acc0, 0);
  epilogue_half(L, b0, c, acc1, 1);
}

__device__ __forceinline__ void body(const CUtensorMap* map, const tc::Level& L) {
  using namespace tc;
  extern __shared__ uint8_t persist_smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];
  uint8_t* smem = reinterpret_cast<uint8_t*>(((uintptr_t)persist_smem_raw + SLACK - 1) &
                                             ~(uintptr_t)(SLACK - 1));
  uint8_t* dig = smem;
  const long long tiles = (L.B + N - 1) / N;
  const long long mine = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;  // this block's tiles
  const Ring R{map, smem + DIG_BYTES, full, mine * TILE_BOXES, L.a_stride ? L.a_rep : L.B};
  const int cw = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int g = 0; g < STAGES; ++g) R.issue(g);
  }
  int acc0[NR / 2], acc1[NR / 2];  // the first step of a chunk overwrites them
  long long pending = -1;          // the tile of a last chunk whose epilogue is still to run
  for (long long li = 0; li < mine; ++li) {
    const long long t = blockIdx.x + li * gridDim.x, b0 = t * N;
    __syncthreads();  // every step of the last tile is done with the digit tile
    if ((t + gridDim.x + 1) * N <= L.B && L.B % 4 == 0)  // L2, the next tile's x: a row a thread
      asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(
                       L.x + (long long)threadIdx.x * L.B + b0 + (long long)gridDim.x * N),
                   "r"(N * 4)
                   : "memory");
    stage(L, b0, dig);
    __syncthreads();  // the digit tile is visible to wgmma
    if (pending >= 0) {
      epilogue(L, pending, CHUNKS - 1, acc0, acc1);
      pending = -1;
    }
    for (int c = cw; c < CHUNKS; c += CONSUMERS) {
      if (li > 0 || c > 0) bar_sync<THREADS>(ORDER + 1 - cw);  // the other's chunk c - 1
      contract_chunk(R, (li * CHUNKS + c) * NB, cw, dig, acc0, acc1);
      if (li < mine - 1 || c < CHUNKS - 1) bar_arrive<THREADS>(ORDER + cw);
      if (c == CHUNKS - 1) {
        pending = b0;  // after the next tile's staging
      } else {
        epilogue(L, b0, c, acc0, acc1);
      }
    }
  }
  if (pending >= 0) epilogue(L, pending, CHUNKS - 1, acc0, acc1);
}

}  // namespace persist
}  // namespace mxu

// The four kernels, one name each (K1's long form, K2, K3, K4), instantiated
// for W = 8 alone: one body.
template <int W>
__global__ void __launch_bounds__(mxu::persist::THREADS, 1)
    base_ntt_mxu_persist_kernel(const __grid_constant__ CUtensorMap map, mxu::tc::Level L) {
  static_assert(W == mxu::persist::W, "W = 8 only");
  mxu::persist::body(&map, L);
}
template <int W>
__global__ void __launch_bounds__(mxu::persist::THREADS, 1)
    fused_level_stack_persist_kernel(const __grid_constant__ CUtensorMap map, mxu::tc::Level L) {
  static_assert(W == mxu::persist::W, "W = 8 only");
  mxu::persist::body(&map, L);
}
template <int W>
__global__ void __launch_bounds__(mxu::persist::THREADS, 1)
    fused_subntt_persist_kernel(const __grid_constant__ CUtensorMap map, mxu::tc::Level L) {
  static_assert(W == mxu::persist::W, "W = 8 only");
  mxu::persist::body(&map, L);
}
template <int W>
__global__ void __launch_bounds__(mxu::persist::THREADS, 1)
    fused_level_persist_kernel(const __grid_constant__ CUtensorMap map, mxu::tc::Level L) {
  static_assert(W == mxu::persist::W, "W = 8 only");
  mxu::persist::body(&map, L);
}

// kind: 0 K1, 1 K2 (a stack of B / a_rep entries), 2 K3, 3 K4. Checks the plan
// (W = 8, m = 32, kt, the depth, the stages, at most one block a tile, the
// shared bytes; a stack entry of whole tiles; T3's rep and period) and
// launches it; cudaErrorInvalidValue for a plan the kernel cannot take.
extern "C" int mxu_persist_level(int kind, const void* x, const void* A, long long a_rep,
                                 const void* T3, long long t_rep, long long t_period, void* out,
                                 int m, long long B, const uint32_t* p, uint32_t np0, int n_words,
                                 int kt, int k_pad, int stages, long long blocks, int smem,
                                 void* stream) {
  using namespace mxu;
  using namespace mxu::persist;
  const long long tiles = (B + tc::N - 1) / tc::N;
  const bool stack = kind == 1;
  const bool ok = kind >= 0 && kind <= 3 && n_words == W && m == M && kt == KT && k_pad == K &&
                  stages == STAGES && B >= 1 && blocks >= 1 && blocks <= tiles &&
                  blocks <= 0x7fffffffLL && smem >= smem_bytes() && smem <= tc::MAX_SMEM &&
                  (!stack || (a_rep >= 1 && a_rep % tc::N == 0 && B % a_rep == 0)) &&
                  (T3 == nullptr || kind != 0) && t_rep >= 1 && B % t_rep == 0 &&
                  (t_period == B || (t_rep == 1 && t_period >= 1 && B % t_period == 0 &&
                                     !(t_period & (t_period - 1))));
  if (!ok) return (int)cudaErrorInvalidValue;
  tc::Level L{};
  L.x = static_cast<const uint32_t*>(x);
  L.A = static_cast<const int8_t*>(A);
  L.a_stride = stack ? (long long)E * M * K : 0;
  L.a_rep = stack ? a_rep : B;
  L.T3 = static_cast<const uint32_t*>(T3);
  L.t_rep = t_rep;
  L.t_period = t_period;
  L.out = static_cast<uint32_t*>(out);
  L.m = M;
  L.B = B;
  L.kt = KT;
  L.k_pad = K;
  L.m_pad = tc::NR;
  L.tma = 1;
  L.fc = field_const(p, np0);
  CUtensorMap map{};
  if (!ring_map(&map, L.A, stack ? B / a_rep : 1)) return (int)cudaErrorInvalidValue;
  using Kernel = void (*)(const CUtensorMap, tc::Level);
  const Kernel kernels[4] = {base_ntt_mxu_persist_kernel<W>, fused_level_stack_persist_kernel<W>,
                             fused_subntt_persist_kernel<W>, fused_level_persist_kernel<W>};
  const Kernel kernel = kernels[kind];
  cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  kernel<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(map, L);
  return (int)cudaGetLastError();
}

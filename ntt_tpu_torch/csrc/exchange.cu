// K8: the four-step transpose exchange of the multi-device NTT, between D shards.
//
// Replaces ntt_tpu/kernels/exchange.py::_a2a_kernel (entry a2a_transpose): shard s
// holds C_s = uint32[W, n1, n2_loc] (its columns of the four-step matrix after the
// column NTTs and the twiddle); shard t receives
//
//     out_t[w, i, s * n2_loc + j] = C_s[w, t * n1_loc + i, j]      (n1_loc = n1 / D)
//
// i.e. all_to_all(split_axis=1, concat_axis=2, tiled=True), with the reshape and
// moveaxis that the JAX entry does outside its kernel written directly by the
// store. The TPU kernel pushes: every device starts one remote DMA per peer after a
// barrier. This one pulls: one launch per destination shard t, on t's device and
// stream, reads row block t of every source through the D source pointers (passed
// by value, so a launch needs no host-to-device copy). A source on another card is
// read over NVLink through peer access, which the wrapper enables once per ordered
// pair of cards; a mesh that names one card D times has only local sources, and the
// same code runs. The barrier of the TPU kernel (buffer liveness) is CUDA events in
// the wrapper: t's stream waits for every source's stream before the launch, and
// every source's stream waits for t's launch before the source memory can be reused.
//
// Grid: (chunk tiles, source s, word plane w). The chunk a source gives a
// destination is n1_loc * n2_loc contiguous words of each plane; it lands as
// n1_loc rows of n2_loc words, D * n2_loc words apart. A thread moves 16 bytes
// where n2_loc % 4 == 0 and every pointer is 16-byte aligned, one word otherwise.
//
// Bound on an H100: a launch reads W * n / D words and writes as many, 2 * W *
// (n / D) * 4 bytes: 64 MiB at BLS12-381 Fr n = 2^22, D = 4 (W = 8), 0.020 ms at
// 3.35 TB/s when the sources are on the same card. Across cards, the (D - 1) / D
// of it that is remote is read at 450 GB/s each way over NVLink.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_SHARDS = 16;
constexpr int THREADS = 256;
constexpr unsigned MAX_TILES = 4096;

struct Sources {
  const void* p[MAX_SHARDS];
};

// V is uint4 (four words) or uint32_t; every extent below is in units of V.
// The sources stay in the parameter space (__grid_constant__): indexed by
// blockIdx.y, a by-value copy would otherwise go to every thread's local memory.
template <typename V>
__global__ void __launch_bounds__(THREADS)
    a2a_pull_kernel(const __grid_constant__ Sources src, V* __restrict__ out, int t, int D,
                    long long n1, unsigned n1_loc, unsigned n2v) {
  const int s = blockIdx.y;
  const long long w = blockIdx.z;
  const unsigned chunk = n1_loc * n2v;
  const V* __restrict__ in =
      static_cast<const V*>(src.p[s]) + (w * n1 + (long long)t * n1_loc) * n2v;
  V* __restrict__ o = out + w * n1_loc * (long long)D * n2v + (long long)s * n2v;
  const unsigned row = (unsigned)D * n2v;
  for (unsigned e = blockIdx.x * THREADS + threadIdx.x; e < chunk; e += gridDim.x * THREADS) {
    const unsigned i = e / n2v;
    const unsigned j = e - i * n2v;
    o[(long long)i * row + j] = __ldg(in + e);
  }
}

template <typename V>
cudaError_t launch(const Sources& S, void* out, int t, int D, int W, long long n1,
                   unsigned n1_loc, unsigned n2v, cudaStream_t stream) {
  const unsigned long long chunk = (unsigned long long)n1_loc * n2v;
  unsigned tiles = (unsigned)((chunk + THREADS - 1) / THREADS);
  if (tiles > MAX_TILES) tiles = MAX_TILES;
  dim3 grid(tiles, D, W);
  a2a_pull_kernel<V><<<grid, THREADS, 0, stream>>>(S, static_cast<V*>(out), t, D, n1, n1_loc,
                                                   n2v);
  return cudaGetLastError();
}

}  // namespace

// Lets `device` read the memory of `peer` (two distinct cards). Returns
// cudaErrorPeerAccessUnsupported where the pair has no peer path.
extern "C" int exchange_enable_peer(int device, int peer) {
  int can = 0;
  cudaError_t rc = cudaDeviceCanAccessPeer(&can, device, peer);
  if (rc != cudaSuccess) return rc;
  if (!can) return cudaErrorPeerAccessUnsupported;
  int prev = 0;
  rc = cudaGetDevice(&prev);
  if (rc != cudaSuccess) return rc;
  rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return rc;
  rc = cudaDeviceEnablePeerAccess(peer, 0);
  if (rc == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    rc = cudaSuccess;
  }
  cudaError_t back = cudaSetDevice(prev);
  return rc != cudaSuccess ? rc : back;
}

// One destination shard t: out_t uint32[W, n1 / D, D * n2_loc] on `device`, from
// the D sources C_s uint32[W, n1, n2_loc]. `vec`: move 16 bytes a thread.
extern "C" int exchange_a2a_pull(const void* const* srcs, int D, void* out, int device, int t,
                                 int W, long long n1, long long n2_loc, int vec,
                                 void* stream) {
  if (D < 1 || D > MAX_SHARDS || t < 0 || t >= D || W < 1 || W > 65535 || n1 % D)
    return cudaErrorInvalidValue;
  const long long n1_loc = n1 / D;
  if (n1_loc * n2_loc >= (1LL << 31)) return cudaErrorInvalidValue;
  Sources S{};
  for (int s = 0; s < D; ++s) S.p[s] = srcs[s];
  int prev = 0;
  cudaError_t rc = cudaGetDevice(&prev);
  if (rc != cudaSuccess) return rc;
  rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  rc = vec ? launch<uint4>(S, out, t, D, W, n1, (unsigned)n1_loc, (unsigned)(n2_loc / 4), st)
           : launch<uint32_t>(S, out, t, D, W, n1, (unsigned)n1_loc, (unsigned)n2_loc, st);
  cudaError_t back = cudaSetDevice(prev);
  return rc != cudaSuccess ? rc : back;
}

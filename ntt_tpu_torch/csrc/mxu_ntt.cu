// K1: fused digit-matmul base NTT, m <= 32 points along axis 1 of uint32[W, m, B]
// (W = 8, 2 or 1 words per element).
//
// Replaces ntt_tpu/kernels/mxu_ntt.py::_kernel (entry base_ntt_mxu_pallas): digit
// extraction, one int8 matmul against the m-point DFT conv matrix A[E*m, D*m] and
// the Montgomery reduction, with only the input and output word planes in device
// memory. The arithmetic is the shared core in mxu_core.cuh.
//
// Bound on an H100 at the 256-bit main path's shape (W = 8, m = 8, B = 32768 at
// n = 2^18, A = int8[296, 296]): the
// function moves 16.9 MB (x in, y out, A once), 5.0 us at 3.35 TB/s, and does
// 2.9 G int8 MACs, 2.9 us at the 1,979 TOPS int8 tensor peak: bytes bound it.
// This first version reads each word plane once and writes it once, keeps the
// digit tile in shared memory and reads A as warp-uniform broadcast loads; its
// MACs run as __dp4a on the CUDA cores, not on the tensor cores, so it sits well
// above the bound.
#include "mxu_core.cuh"

template <int W>
__global__ void __launch_bounds__(mxu::THREADS, 2) base_ntt_mxu_kernel(mxu::Level L) {
  mxu::run_level<W>(L);
}

extern "C" int mxu_base_ntt(const void* x, const void* A, void* out, int m, long long B,
                            const uint32_t* p, uint32_t np0, int n_words, void* stream) {
  mxu::Level L{};
  L.x = static_cast<const uint32_t*>(x);
  L.A = static_cast<const int8_t*>(A);
  L.out = static_cast<uint32_t*>(out);
  L.m = m;
  L.B = B;
  L.fc = mxu::field_const(p, np0);
  return MXU_LAUNCH_FOR_WIDTH(base_ntt_mxu_kernel, n_words, L, stream);
}

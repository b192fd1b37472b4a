// K2 and K3 (single-level): one four-step level with its decomposition twiddle, on
// uint32[W, m, B] (W = 8, 2 or 1 words per element).
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
// Both run the shared core in mxu_core.cuh. Bounds on an H100 at the 256-bit main
// path's shapes (W = 8, n = 2^18, m = 32, B = 8192, 11.5 G int8 MACs = 11.6 us at the 1,979 TOPS
// int8 tensor peak):
//   K2 level 0 (NT = 32): 61.7 MB (data in and out, the 44.9 MB stack), 18.4 us at
//      3.35 TB/s: bytes bound it. Level 2 (NT = 8): 28.0 MB, 8.4 us: MACs bound it.
//   K3 level 1 (rep = 1): 26.6 MB (data, the 8.4 MB twiddle table, A), 7.9 us:
//      MACs bound it.
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

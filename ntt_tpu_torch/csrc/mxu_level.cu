// K2 and K3: one four-step level with its decomposition twiddle, on uint32[8, m, B].
//
// K2 mxu_fused_level_stack replaces ntt_tpu/kernels/mxu_level.py::_kernel_stack
// (entry fused_level_stack): the twiddle is folded into a stack of conv matrices
// As[NT, 37m, 37m] and batch column b uses As[b / rep]; an optional batch-
// resolution residual twiddle T3[8, m, B] is multiplied into the output.
//
// K3 mxu_fused_subntt replaces the single-level form (m <= 32) of
// ntt_tpu/kernels/mxu_level.py::_kernel_sub (entry fused_subntt): one conv matrix,
// then the decomposition twiddle by a Montgomery product, read from T3[8, m, B]
// (rep == 1) or from the i2-resolution table T3[8, B / rep, m] (rep > 1).
//
// Both run the shared core in mxu_core.cuh. Bounds on an H100 at the main path's
// shapes (n = 2^18, m = 32, B = 8192, 11.5 G int8 MACs = 11.6 us at the 1,979 TOPS
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

__global__ void __launch_bounds__(mxu::THREADS, 2) fused_level_stack_kernel(mxu::Level L) {
  mxu::run_level(L);
}

__global__ void __launch_bounds__(mxu::THREADS, 2) fused_subntt_kernel(mxu::Level L) {
  mxu::run_level(L);
}

extern "C" int mxu_fused_level_stack(const void* x, const void* As, long long rep,
                                     const void* T3, void* out, int m, long long B,
                                     const uint32_t* p, uint32_t np0, void* stream) {
  mxu::Level L{};
  L.x = static_cast<const uint32_t*>(x);
  L.A = static_cast<const int8_t*>(As);
  L.a_stride = (long long)(mxu::E * m) * (mxu::D * m);
  L.a_rep = rep;
  L.T3 = static_cast<const uint32_t*>(T3);
  L.t_rep = 1;
  L.out = static_cast<uint32_t*>(out);
  L.m = m;
  L.B = B;
  L.fc = mxu::field_const(p, np0);
  return mxu::launch(fused_level_stack_kernel, L, stream);
}

extern "C" int mxu_fused_subntt(const void* x, const void* A, const void* T3, long long rep,
                                void* out, int m, long long B, const uint32_t* p,
                                uint32_t np0, void* stream) {
  mxu::Level L{};
  L.x = static_cast<const uint32_t*>(x);
  L.A = static_cast<const int8_t*>(A);
  L.T3 = static_cast<const uint32_t*>(T3);
  L.t_rep = rep;
  L.out = static_cast<uint32_t*>(out);
  L.m = m;
  L.B = B;
  L.fc = mxu::field_const(p, np0);
  return mxu::launch(fused_subntt_kernel, L, stream);
}

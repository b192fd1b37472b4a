"""The port's hand-written CUDA kernels (K1 base_ntt_mxu, K2
fused_level_stack, K3 fused_subntt, single- and multi-level) with their
plain PyTorch versions."""

"""The port's hand-written CUDA kernels with their plain PyTorch versions:
K1 base_ntt_mxu (``mxu_ntt``, built into the level library); K2
fused_level_stack, K3 fused_subntt (single- and multi-level), K4
fused_level and K7 fused_level_probe (``mxu_level``); K5 stage_ntt and K6
fused_stage_level (``vmem_ntt``); K8 a2a_transpose, the exchange between
the shards of a mesh (``exchange``). ``ntt_along_axis_pallas`` is K5 under
the JAX package's name, as ``ntt_tpu.kernels`` exports it."""

from .vmem_ntt import ntt_along_axis_pallas, stage_ntt  # noqa: F401

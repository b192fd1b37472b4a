"""The benchmark of ntt_tpu_torch on the CUDA card: see ``run.py``."""

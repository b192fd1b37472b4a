"""ntt_tpu_torch — the PyTorch/CUDA port of ntt_tpu for an NVIDIA H100.

The forward NTT over the 256-bit fields (BN254 Fr, BLS12-381 Fr) on the
``mxu_chunked`` path, n up to 2^24, word-equal to ``ntt_tpu``. Its three
digit-matmul kernels are hand-written CUDA C++ for sm_90a
(``ntt_tpu_torch/csrc``); on the CPU (``device="cpu"``) the same functions
run as plain PyTorch. This package imports neither JAX nor ``ntt_tpu``.
"""

from .api import ntt, ramp_mont
from .fields import (BLS12_381_FR, BN254_FR, GOLDILOCKS, SMALL, Field,
                     get_field)
from .limbs import from_ints, to_ints

__all__ = ["ntt", "ramp_mont", "Field", "SMALL", "BN254_FR", "BLS12_381_FR",
           "GOLDILOCKS", "get_field", "from_ints", "to_ints"]

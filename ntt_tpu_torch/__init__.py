"""ntt_tpu_torch — the PyTorch/CUDA port of ntt_tpu for an NVIDIA H100.

Forward, inverse and coset NTT, low-degree extension and polynomial product
over BN254 Fr, BLS12-381 Fr, Goldilocks and the small Proth prime, under
every algorithm name of ``ntt_tpu`` (``auto``: ``mxu_chunked`` on the 256-bit
fields, ``mxu_sub`` on the narrow ones; n up to 2^two_adicity of the field),
word-equal to ``ntt_tpu``, under the same knobs (``ntt_tpu_torch.config``).
Its digit-matmul and butterfly-stage kernels are hand-written CUDA C++ for
sm_90a (``ntt_tpu_torch/csrc``); on the CPU (``device="cpu"``) the same
functions run as plain PyTorch. ``ntt_tpu_torch.bigint`` is the
general fixed-width big-integer layer (CGBN's breadth: division, square
root, gcd, inverses, Barrett, modular power, bit ops), plain PyTorch on
either device. This package imports neither JAX nor ``ntt_tpu``.
"""

from .api import (coset_intt, coset_ntt, intt, lde, ntt, polymul, ramp_mont)
from .fields import (BLS12_381_FR, BN254_FR, FIELDS, GOLDILOCKS, SMALL, Field,
                     get_field)
from . import bigint
from .limbs import from_ints, from_mont, to_ints, to_mont

__version__ = "0.1.0"

__all__ = ["ntt", "intt", "coset_ntt", "coset_intt", "lde", "polymul",
           "ramp_mont", "Field", "FIELDS", "SMALL", "BN254_FR",
           "BLS12_381_FR", "GOLDILOCKS", "get_field", "from_ints", "to_ints",
           "to_mont", "from_mont"]

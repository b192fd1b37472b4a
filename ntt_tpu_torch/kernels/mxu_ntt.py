"""Kernel K1: fused digit-matmul base NTT (port of ``ntt_tpu.kernels.mxu_ntt``).

``base_ntt_mxu`` runs an m-point NTT (m <= 64) along axis 1 of
uint32[W, m, B], Montgomery form in and out: digit extraction, one int8
matmul against the DFT conv matrix A, Montgomery reduction. On a CUDA tensor
it launches the hand-written kernel ``base_ntt_mxu_kernel`` (in the level
library, ``csrc/mxu_level.cu``: the tensor-core level of K2-K4 with no
twiddle, under the launch plan of ``mxu_level.tc_plan``); on a CPU tensor it
runs :func:`base_ntt_mxu_plain`, the same function in plain PyTorch.
"""

from __future__ import annotations

import torch

from .. import digits
from ..fields import Field
from . import _build, mxu_level


def base_ntt_mxu_plain(x, field: Field, A, F=None):
    """Plain PyTorch version of K1: ``digits.apply_matrix`` with the fold
    reduction (``F``: the fold matrix, built on the host when None)."""
    m = x.shape[1]
    zb = (m * digits.n_digits(field) * digits.DIGIT_MASK ** 2).bit_length()
    return digits.apply_matrix(A, x, field, m, zb, fold_mat=F)


def base_ntt_mxu(x, field: Field, A, F=None):
    """m-point NTT along axis 1 of uint32[W, m, B] (m <= 64): ``A`` is the
    int8[D*m, D*m] conv matrix; ``F`` the fold matrix, which only the plain
    version reads (the kernel reduces with word-level Montgomery steps)."""
    W, m, B = x.shape
    if m == 1:
        return x
    if x.device.type == "cpu":
        return base_ntt_mxu_plain(x, field, A, F)
    _build.check_level(x, field, mxu_level.LEVEL_MAX_M)
    D, E = digits.n_digits(field), digits.out_planes(field)
    _build.check_operand(A, "A", torch.int8, (E * m, D * m), x.device)
    out = torch.empty_like(x)
    rc = mxu_level._lib().mxu_base_ntt(
        _build.ptr(x), _build.ptr(A), _build.ptr(out), m, B,
        *_build.field_args(field), *mxu_level.plan_args(field, m, B),
        _build.stream(x))
    _build.check(rc, "base_ntt_mxu")
    _build.launches["base_ntt_mxu"] += 1
    return out

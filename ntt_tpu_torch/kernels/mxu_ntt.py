"""Kernel K1: fused digit-matmul base NTT (port of ``ntt_tpu.kernels.mxu_ntt``).

``base_ntt_mxu`` runs an m-point NTT (m <= 64) along axis 1 of
uint32[W, m, B], Montgomery form in and out: digit extraction, one int8
matmul against the DFT conv matrix A, Montgomery reduction. On a CUDA tensor
it launches a hand-written kernel of the level library
(``csrc/mxu_level.cu``) under the launch plan of ``mxu_level.base_plan``:
``base_ntt_mxu_short_kernel`` where one wgmma N half holds every GEMM row
of the level (``mxu_level.short_form``: E * m <= 160, so W = 8 at m = 2
and 4; blocks of two warpgroups on 128-column tiles, two an SM, each
walking a span of tiles with the matrix staged once), else
``base_ntt_mxu_kernel``, the tensor-core level of K2-K4 with no twiddle
(``mxu_level.tc_plan``). On a CPU tensor it runs
:func:`base_ntt_mxu_plain`, the same function in plain PyTorch.
``base_ntt_mxu_pallas`` is the same kernel under the JAX entry's name and
parameters (without its TPU batch tile), building the conv matrix where the
caller passes none.
"""

from __future__ import annotations

import torch

from .. import digits
from ..fields import Field
from ..tracing import span
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
    with span("ntt.launch.base_ntt_mxu"):
        _build.check_level(x, field, mxu_level.LEVEL_MAX_M)
        D, E = digits.n_digits(field), digits.out_planes(field)
        _build.check_operand(A, "A", torch.int8, (E * m, D * m), x.device)
        out = torch.empty_like(x)
        rc = mxu_level._lib().mxu_base_ntt(
            _build.ptr(x), _build.ptr(A), _build.ptr(out), m, B,
            *_build.field_args(field),
            *mxu_level.base_plan_args(field, m, B, _build.sm_count(x.device)),
            _build.stream(x))
        _build.check(rc, "base_ntt_mxu")
        _build.launches["base_ntt_mxu"] += 1
        return out


def base_ntt_mxu_pallas(x, field: Field, inverse: bool, A=None, F=None):
    """m-point NTT along axis 1 of uint32[W, m, B] (m <= 64; Montgomery
    form in and out) as :func:`base_ntt_mxu`, under the JAX package's
    entry name and parameters: where ``A`` is None the conv matrix of the
    direction ``inverse`` is built on the host and put on x's device."""
    m = x.shape[1]
    if m == 1:
        return x
    if A is None:
        from ..transforms.mxu import _base_matrix
        A = torch.from_numpy(_base_matrix(field, m, inverse)).to(x.device)
    return base_ntt_mxu(x, field, A, F)

"""The plain version of each ported kernel against the JAX package's Pallas
entry, run as the JAX package's own tests run it on the CPU (interpret
mode). Canonical Montgomery words out: the tolerance is exact equality.

K1 base_ntt_mxu      <- ntt_tpu.kernels.mxu_ntt.base_ntt_mxu_pallas
K2 fused_level_stack <- ntt_tpu.kernels.mxu_level.fused_level_stack
K3 fused_subntt      <- ntt_tpu.kernels.mxu_level.fused_subntt (m = 32)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ntt_tpu.fields as jfields
from ntt_tpu.kernels.mxu_level import fused_level_stack as j_stack
from ntt_tpu.kernels.mxu_level import fused_subntt as j_subntt
from ntt_tpu.kernels.mxu_ntt import base_ntt_mxu_pallas as j_base
import ntt_tpu_torch.fields as tfields
from ntt_tpu_torch import digits as tdigits
from ntt_tpu_torch import limbs as tlimbs
from ntt_tpu_torch.kernels import mxu_level, mxu_ntt
from ntt_tpu_torch.transforms import mxu as tmxu

torch.set_num_threads(1)

JF, TF = jfields.BLS12_381_FR, tfields.BLS12_381_FR


def _words(shape, seed):
    """Canonical random elements as uint32[W, *shape] (top word < p's)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 32, size=(8,) + shape, dtype=np.uint64)
    x[7] = rng.integers(0, TF.p >> 224, size=shape, dtype=np.uint64)
    return x.astype(np.uint32)


def _mats(m):
    return {m: tmxu._base_matrix(TF, m), -m: tmxu._fold_matrix(TF, m),
            -1: tdigits.fold_mul_matrix(TF)}


def _t(mats):
    return {k: torch.from_numpy(v) for k, v in mats.items()}


def _j(mats):
    return {k: jnp.asarray(v) for k, v in mats.items()}


@pytest.mark.parametrize("m", [2, 4, 8])
def test_base_ntt_mxu_plain_equals_pallas(m):
    """m = 2 and 4: the last bases of the 2^(5k+1) and 2^(5k+2) point
    transforms at peel 32 (K1's short form on the card); m = 8 the 2^18
    one."""
    B = 256
    x = _words((m, B), 1)
    mats = _mats(m)
    got = mxu_ntt.base_ntt_mxu(torch.from_numpy(x), TF,
                               torch.from_numpy(mats[m]),
                               torch.from_numpy(mats[-m]))
    want = j_base(jnp.asarray(x), JF, False, A=jnp.asarray(mats[m]),
                  F=jnp.asarray(mats[-m]))
    assert got.dtype == torch.uint32
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_fused_level_stack_plain_equals_pallas():
    """The residual-twiddle (T3) form is held against its plain version on
    the card by chip_smoke.py; its interpret-mode compile here costs 30 s."""
    m, NT, rep = 32, 2, 128
    B = NT * rep
    x = _words((m, B), 2)
    rng = np.random.default_rng(3)
    tvals = [[int(v) for v in rng.integers(1, 1 << 62, size=m)]
             for _ in range(NT)]
    As = tmxu.twiddle_matrix_stack(TF, m, False, tvals)
    F = tmxu._fold_matrix(TF, m)
    got = mxu_level.fused_level_stack(
        torch.from_numpy(x), TF, torch.from_numpy(As), rep,
        torch.from_numpy(F))
    want = j_stack(jnp.asarray(x), JF, jnp.asarray(As), rep=rep,
                   F=jnp.asarray(F))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_fused_level_stack_residual_is_a_twiddle_product():
    """K2's residual epilogue multiplies the stack level by T3 (Montgomery
    product), as limbs.mont_mul does."""
    m, NT, rep = 32, 2, 16
    B = NT * rep
    x = torch.from_numpy(_words((m, B), 8))
    T3 = torch.from_numpy(_words((m, B), 9))
    rng = np.random.default_rng(10)
    As = torch.from_numpy(rng.integers(0, 128, size=(NT, 37 * m, 37 * m),
                                       dtype=np.int8))
    level = mxu_level.fused_level_stack(x, TF, As, rep)
    got = mxu_level.fused_level_stack(x, TF, As, rep, T3=T3)
    assert np.array_equal(got.numpy(),
                          tlimbs.mont_mul(level, T3, TF).numpy())


@pytest.mark.parametrize("B, rep", [(256, 1), (512, 32)])
def test_fused_subntt_plain_equals_pallas(B, rep):
    """rep == 1: batch-resolution twiddle [W, m, B]; rep == 32: the
    i2-resolution table [W, B // rep, m] = [8, 16, 32]."""
    m = 32
    x = _words((m, B), 5)
    T3 = _words((m, B) if rep == 1 else (B // rep, m), 6)
    mats = _mats(m)
    got = mxu_level.fused_subntt(torch.from_numpy(x), TF, False, _t(mats),
                                 torch.from_numpy(T3), rep=rep)
    want = j_subntt(jnp.asarray(x), JF, False, _j(mats), jnp.asarray(T3),
                    transpose_out=False, rep=rep)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_wrappers_check_their_operands():
    x = torch.from_numpy(_words((32, 64), 7))
    mats = _t(_mats(32))
    with pytest.raises(ValueError):
        mxu_level.fused_subntt(x, TF, False, mats, x[:, :16])
    with pytest.raises(ValueError):
        mxu_level.fused_level_stack(x, TF, mats[32][None], 32, mats[-32])
    with pytest.raises(ValueError, match="CUDA"):
        mxu_ntt.base_ntt_mxu(x.to("meta"), TF, mats[32], mats[-32])

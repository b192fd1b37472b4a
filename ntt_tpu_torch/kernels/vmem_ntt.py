"""Kernels K5 and K6: all butterfly stages of a sub-NTT on a shared-memory
tile (port of ``ntt_tpu.kernels.vmem_ntt``).

- ``stage_ntt`` (K5): natural-order m-point NTT along axis 1 of
  uint32[W, m, B], Montgomery form in and out: the bit-reversal and all
  log2 m radix-2 decimation-in-time stages (``mont_mul`` by the stage
  twiddle, ``add_mod``, ``sub_mod``) in one launch.
- ``fused_stage_level`` (K6): the same, then an optional product with a
  full-resolution twiddle T3 [W, m, B] and an optional transposed store to
  [W, B, m]: one four-step level on the butterfly path.

The stage twiddles are read from the master table ω_m^0 .. ω_m^{m/2-1}
(``core.twiddle_master``) at stride (m/2)/s; the JAX kernel's per-stage
expanded tables are a TPU layout rule and have no counterpart here, and
the bit-reversal is folded into the kernel's load instead of a separate
gather pass. On a CUDA tensor each wrapper launches its hand-written
kernel (``csrc/vmem_ntt.cu``); on a CPU tensor it runs its plain PyTorch
version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import limbs
from ..fields import Field
from ..transforms.core import ntt_along_axis, twiddle_master_on
from . import _build

#: the largest transform length the kernels take: a column of W·m words
#: must fit a block's shared-memory tile
MAX_M = 256
#: bytes of one column of the tile at the sizes the transforms use: 32 columns
#: of this size are a 64 KiB tile (66 KiB with its padding)
COLUMN_BYTES = 2048


def max_m(field: Field) -> int:
    """The largest m whose column of W·m words stays within COLUMN_BYTES:
    64 for the 256-bit fields, 256 for the narrow ones (capped at MAX_M)."""
    return min(MAX_M, COLUMN_BYTES // (4 * field.n_words))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("vmem_ntt")
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.vmem_stage_ntt.argtypes = [
        vp, vp, vp, ctypes.c_int, ll, *_build.FIELD_ARGTYPES, vp]
    lib.vmem_stage_ntt.restype = ctypes.c_int
    lib.vmem_fused_stage_level.argtypes = [
        vp, vp, vp, vp, ctypes.c_int, ctypes.c_int, ll,
        *_build.FIELD_ARGTYPES, vp]
    lib.vmem_fused_stage_level.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# K5: the butterfly ladder alone
# ---------------------------------------------------------------------------

def stage_ntt_plain(x, field: Field, inverse: bool = False):
    """Plain PyTorch version of K5: ``core.ntt_along_axis``."""
    return ntt_along_axis(x, field, inverse=inverse)


def stage_ntt(x, field: Field, inverse: bool = False):
    """Natural-order NTT along axis 1 of uint32[W, m, B] (Montgomery form
    in and out, no 1/n scale), m a power of two up to 256, all stages in
    one launch."""
    W, m, B = x.shape
    if m == 1:
        return x
    if x.device.type == "cpu":
        return stage_ntt_plain(x, field, inverse)
    _build.check_level(x, field, max_m=MAX_M)
    tw = twiddle_master_on(field, m, inverse, x.device)
    out = torch.empty_like(x)
    rc = _lib().vmem_stage_ntt(
        _build.ptr(x), _build.ptr(tw), _build.ptr(out), m, B,
        *_build.field_args(field), _build.stream(x))
    _build.check(rc, "stage_ntt")
    _build.launches["stage_ntt"] += 1
    return out


# ---------------------------------------------------------------------------
# K6: the ladder, the decomposition twiddle and the transposed store
# ---------------------------------------------------------------------------

def fused_stage_level_plain(x, field: Field, inverse: bool = False, T3=None,
                            transpose_out: bool = True):
    """Plain PyTorch version of K6."""
    y = ntt_along_axis(x, field, inverse=inverse)
    if T3 is not None:
        y = limbs.mont_mul(y, T3, field)
    return y.transpose(1, 2).contiguous() if transpose_out else y


def fused_stage_level(x, field: Field, inverse: bool = False, T3=None,
                      transpose_out: bool = True):
    """One four-step level on uint32[W, m, B] with the butterfly ladder as
    its base: m-point NTT along axis 1, then the optional full-resolution
    twiddle ``T3`` [W, m, B], stored as [W, B, m] when ``transpose_out``
    (else [W, m, B])."""
    W, m, B = x.shape
    if T3 is not None and tuple(T3.shape) != (W, m, B):
        raise ValueError(f"T3 must be {(W, m, B)}, got {tuple(T3.shape)}")
    if m == 1:
        if T3 is not None:
            x = limbs.mont_mul(x, T3, field)
        return x.transpose(1, 2).contiguous() if transpose_out else x
    if x.device.type == "cpu":
        return fused_stage_level_plain(x, field, inverse, T3, transpose_out)
    _build.check_level(x, field, max_m=MAX_M)
    if T3 is not None:
        _build.check_operand(T3, "T3", torch.uint32, (W, m, B), x.device)
    tw = twiddle_master_on(field, m, inverse, x.device)
    out = torch.empty((W, B, m) if transpose_out else (W, m, B),
                      dtype=torch.uint32, device=x.device)
    rc = _lib().vmem_fused_stage_level(
        _build.ptr(x), _build.ptr(tw), _build.ptr(T3), _build.ptr(out),
        int(transpose_out), m, B,
        *_build.field_args(field), _build.stream(x))
    _build.check(rc, "fused_stage_level")
    _build.launches["fused_stage_level"] += 1
    return out

"""Build, load and call the port's CUDA kernels.

Each library under ``ntt_tpu_torch/csrc/`` is compiled at first use by
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface, in
``build/kernels/`` at the repository root (listed in ``.gitignore``). A
build is keyed by a hash of its sources and flags and published with an
atomic rename, so concurrent processes can build at once. Libraries are
loaded with ctypes; every C entry point returns ``cudaGetLastError()``.

``launches`` counts kernel launches per wrapper: each wrapper adds one where
it launches its kernel, and nowhere else.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

from .. import digits
from ..fields import Field

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

#: library -> its source; every library also includes the shared header
LIBRARIES = {"mxu_level": "mxu_level.cu", "mxu_sub": "mxu_sub.cu",
             "vmem_ntt": "vmem_ntt.cu", "exchange": "exchange.cu"}
_HEADERS = ("mxu_core.cuh",)

launches: collections.Counter = collections.Counter()

#: argtypes of the field constants every entry point takes: p's words
#: (padded to eight), np0_32, and the field's word count W
FIELD_ARGTYPES = [ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint32,
                  ctypes.c_int]

#: field widths (32-bit words per element) the kernels are instantiated for
KERNEL_WORDS = (1, 2, 8)


def _nvcc() -> str:
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _target(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (LIBRARIES[name],) + _HEADERS:
        with open(os.path.join(CSRC, src), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build_all(names=None, timeout: float = 900.0) -> dict:
    """Compile every library in ``names`` (default: all) that is not built
    yet, one nvcc process per source, all started together. Returns
    {name: compiler output} for the libraries it compiled."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = []
    try:
        for name in names or LIBRARIES:
            so = _target(name)
            if os.path.exists(so):
                continue
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC, LIBRARIES[name])]
            jobs.append((name, so, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, errors = {}, []
        for name, so, tmp, proc in jobs:
            logs[name], _ = proc.communicate(timeout=timeout)
            if proc.returncode == 0:
                os.replace(tmp, so)
            else:
                errors.append(f"{name}: nvcc exit {proc.returncode}\n"
                              f"{logs[name]}")
        if errors:
            raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
        return logs
    finally:
        for _, _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The library ``name``, built first if needed."""
    if not os.path.exists(_target(name)):
        build_all([name])
    return ctypes.CDLL(_target(name))


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else None)


def stream(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


@functools.cache
def sm_count(device) -> int:
    """The streaming multiprocessors of a CUDA device (read once a device:
    the wrappers of K1 and K3 plan for it at every launch)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def field_args(field: Field) -> tuple:
    words = field.int_to_words(field.p)
    return ((ctypes.c_uint32 * 8)(*(words + [0] * (8 - len(words)))),
            ctypes.c_uint32(field.np0_32), ctypes.c_int(field.n_words))


def check_level(x, field: Field, max_m: int) -> None:
    """Checks the data operand of a kernel: uint32[W, m, B] on a CUDA
    device, contiguous, m a power of two in [2, max_m], W one of the
    widths the kernels are built for, the matrices folded exactly for
    W = 8."""
    if x.device.type != "cuda":
        raise ValueError(
            f"the kernels run on a CUDA device and their plain versions on "
            f"the CPU; got a tensor on {x.device}")
    W = field.n_words
    if W not in KERNEL_WORDS or digits.fold_active(field) != (W == 8):
        raise NotImplementedError(
            f"{field.name}: the kernels are built for {KERNEL_WORDS}-word "
            "fields (folded matrices for 8 words, banded ones below)")
    if x.dim() != 3 or x.shape[0] != W:
        raise ValueError(f"x must be uint32[{W}, m, B], "
                         f"got {tuple(x.shape)}")
    check_operand(x, "x", torch.uint32, x.shape, x.device)
    m = x.shape[1]
    if m & (m - 1) or not 2 <= m <= max_m:
        raise ValueError(
            f"m = {m}: this kernel takes a power of two in [2, {max_m}]")


def check_operand(t, what: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, the data on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{what} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{what} must be 16-byte aligned")

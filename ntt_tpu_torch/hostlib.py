"""ctypes loader for the native host field library (csrc/hostfield.cpp).

The port's own loader for the repository's C++ host library: 256-bit CIOS
Montgomery arithmetic for fast twiddle powers and the golden NTT. It builds
on first use with ``g++`` into ``build/hostlib/`` at the repository root
(listed in ``.gitignore``), keyed by a hash of the source, and publishes the
library with an atomic rename so that concurrent processes can build it at
once.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile

import numpy as np

from .fields import Field

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_REPO, "csrc", "hostfield.cpp")
BUILD_DIR = os.path.join(_REPO, "build", "hostlib")


def _build() -> str:
    with open(_SRC, "rb") as f:
        key = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"libhostfield-{key}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


@functools.cache
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(_build())
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.hf_ntt.argtypes = [u64p, u64p, ctypes.c_uint64, u64p, ctypes.c_int,
                           u64p]
    lib.hf_ntt.restype = None
    lib.hf_powers.argtypes = [u64p, u64p, ctypes.c_uint64, ctypes.c_uint64,
                              u64p]
    lib.hf_powers.restype = None
    lib.hf_mul_mod_vec.argtypes = [u64p, u64p, u64p, ctypes.c_uint64, u64p]
    lib.hf_mul_mod_vec.restype = None
    return lib


def _fe(x: int) -> np.ndarray:
    return np.asarray([(x >> (64 * i)) & 0xFFFFFFFFFFFFFFFF
                       for i in range(4)], dtype=np.uint64)


def _p64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def _check_width(field: Field) -> None:
    if field.bits > 256:
        raise ValueError(
            f"hostfield elements are 4x64 bits — {field.name} is too wide")


def ntt_np(data: np.ndarray, field: Field,
           inverse: bool = False) -> np.ndarray:
    """Golden NTT (standard form in and out) on np.uint64[n, 4] limb rows;
    ``inverse`` runs the inverse roots and scales by 1/n."""
    _check_width(field)
    inp = np.ascontiguousarray(data, dtype=np.uint64)
    out = np.empty_like(inp)
    p, g = _fe(field.p), _fe(field.generator)
    _load().hf_ntt(_p64(p), _p64(inp), inp.shape[0], _p64(g),
                   1 if inverse else 0, _p64(out))
    return out


def mul_mod_vec_np(a: np.ndarray, b: np.ndarray, field: Field) -> np.ndarray:
    """Elementwise a*b mod p on np.uint64[n, 4] limb rows."""
    _check_width(field)
    aa = np.ascontiguousarray(a, dtype=np.uint64)
    ba = np.ascontiguousarray(b, dtype=np.uint64)
    out = np.empty_like(aa)
    p = _fe(field.p)
    _load().hf_mul_mod_vec(_p64(p), _p64(aa), _p64(ba), aa.shape[0],
                           _p64(out))
    return out


def ints_to_rows(vals) -> np.ndarray:
    """Python ints (each < 2^256) -> np.uint64[len(vals), 4] limb rows."""
    buf = b"".join(v.to_bytes(32, "little") for v in vals)
    return np.frombuffer(buf, np.uint64).reshape(len(vals), 4).copy()


def planes_to_rows(planes: np.ndarray) -> np.ndarray:
    """np.uint32[W, n] word planes (W <= 8) -> np.uint64[n, 4] limb rows."""
    W, n = planes.shape
    words = np.zeros((n, 8), dtype=np.uint32)
    words[:, :W] = planes.T
    return words.view(np.uint64)


def host_planes(rows: np.ndarray, n_words: int) -> np.ndarray:
    """np.uint64[n, 4] limb rows -> np.uint32[W, n] word planes."""
    words = np.ascontiguousarray(rows, dtype=np.uint64).view(
        np.uint32).reshape(rows.shape[0], 8)
    return np.ascontiguousarray(words[:, :n_words].T)


def ramp_np(n: int) -> np.ndarray:
    """The ramp 0..n-1 as np.uint64[n, 4] limb rows."""
    out = np.zeros((n, 4), dtype=np.uint64)
    out[:, 0] = np.arange(n, dtype=np.uint64)
    return out


def powers_np(base: int, count: int, field: Field,
              mont_form: bool = False) -> np.ndarray:
    """Powers base^0..base^{count-1} as word planes np.uint32[W, count]
    (in the field's Montgomery form when ``mont_form``)."""
    _check_width(field)
    out = np.empty((count, 4), dtype=np.uint64)
    p, b = _fe(field.p), _fe(base % field.p)
    _load().hf_powers(_p64(p), _p64(b), count,
                      field.mont_bits if mont_form else 0, _p64(out))
    return host_planes(out, field.n_words)

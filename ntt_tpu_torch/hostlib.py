"""ctypes loader for the native host field library (csrc/hostfield.cpp).

The port's own loader for the repository's C++ host library: 256-bit CIOS
Montgomery arithmetic for fast twiddle powers and the golden NTT, the port's
counterpart of ``ntt_tpu.hostlib``. It builds on first use with ``g++``
into ``build/hostlib/`` at the repository root (listed in ``.gitignore``),
keyed by a hash of the source, and publishes the library with an atomic
rename so that concurrent processes can build it at once. A failed build is
not remembered: the next call tries again.

The numpy forms (``*_np``) work on np.uint64[n, 4] limb rows or
np.uint32[W, n] word planes; the list forms (:func:`ntt`, :func:`powers`,
:func:`pow_mod`, :func:`mul_mod_vec`) on lists of Python ints, as
``ntt_tpu.oracle`` does. Every function that calls the library raises
when it cannot be built; :func:`available` says whether it can, for a
caller that picks its golden model.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile

import numpy as np

from . import limbs
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
    # functools.cache keeps no result when the call raises: a failed build
    # or load is tried again on the next call
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
    lib.hf_pow_mod.argtypes = [u64p, u64p, u64p, u64p]
    lib.hf_pow_mod.restype = None
    return lib


def available() -> bool:
    """True when the library builds and loads. A failure is not cached:
    a later call builds again."""
    try:
        _load()
    except (OSError, subprocess.SubprocessError):
        return False
    return True


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
    """Python ints (each < 2^256) -> np.uint64[len(vals), 4] limb rows (the
    port's ``ntt_tpu.hostlib._ints_to_arr``)."""
    buf = b"".join(v.to_bytes(32, "little") for v in vals)
    return np.frombuffer(buf, np.uint64).reshape(len(vals), 4).copy()


def rows_to_ints(rows: np.ndarray) -> list:
    """np.uint64[n, 4] limb rows -> Python ints, the inverse of
    :func:`ints_to_rows` (the port's ``ntt_tpu.hostlib._arr_to_ints``)."""
    buf = np.ascontiguousarray(rows, dtype=np.uint64).tobytes()
    return [int.from_bytes(buf[i:i + 32], "little")
            for i in range(0, len(buf), 32)]


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


# ---------------------------------------------------------------------------
# List forms (Python ints in and out, as ntt_tpu.oracle)
# ---------------------------------------------------------------------------

def ntt(data: list, field: Field, inverse: bool = False) -> list:
    """Golden NTT of a list of ints: the same words as
    ``oracle.ntt_golden`` (``oracle.intt_golden`` when ``inverse``)."""
    return rows_to_ints(ntt_np(ints_to_rows(data), field, inverse))


def powers(base: int, count: int, field: Field,
           mont_form: bool = False) -> list:
    """Powers base^0..base^{count-1} as ints; ``mont_form=True`` returns
    them in the field's Montgomery form (radix 2^field.mont_bits, the
    device limb layer's)."""
    _check_width(field)
    out = np.empty((count, 4), dtype=np.uint64)
    p, b = _fe(field.p), _fe(base % field.p)
    _load().hf_powers(_p64(p), _p64(b), count,
                      field.mont_bits if mont_form else 0, _p64(out))
    return rows_to_ints(out)


def pow_mod(x: int, e: int, field: Field) -> int:
    """x^e mod p (0 <= e < 2^256)."""
    _check_width(field)
    if not 0 <= e < 1 << 256:
        raise ValueError(f"exponent {e} is outside [0, 2^256)")
    out = np.empty(4, dtype=np.uint64)
    p, xa, ea = _fe(field.p), _fe(x % field.p), _fe(e)
    _load().hf_pow_mod(_p64(p), _p64(xa), _p64(ea), _p64(out))
    return rows_to_ints(out)[0]


def mul_mod_vec(a: list, b: list, field: Field) -> list:
    """Elementwise a*b mod p of two lists of ints (standard form)."""
    if len(a) != len(b):
        raise ValueError(f"operands differ in length: {len(a)}, {len(b)}")
    return rows_to_ints(mul_mod_vec_np(ints_to_rows(a), ints_to_rows(b),
                                       field))


def full_compare(y_mont, want_rows: np.ndarray, field: Field,
                 chunk_log: int = 18) -> bool:
    """Every output position of a Montgomery-form result against the
    golden rows: the reference's all-elements check (GZKP-NTT.cu:1627-1631).

    ``y_mont``: torch.uint32[W, n] on any device; ``want_rows``: the
    standard-form np.uint64[n, 4] rows (:func:`ntt_np`). Slices of
    2^chunk_log columns are taken out of Montgomery form on the tensor's
    own device, copied to the host and compared with the golden word
    planes; False at the first slice that differs. No Python-int round
    trip."""
    n = int(y_mont.shape[1])
    if want_rows.shape[0] != n:
        raise ValueError(f"{want_rows.shape[0]} golden rows for {n} columns")
    want = host_planes(want_rows, field.n_words)
    c = 1 << chunk_log
    for lo in range(0, n, c):
        got = limbs.from_mont(y_mont[:, lo:lo + c], field).cpu().numpy()
        if not np.array_equal(got, want[:, lo:lo + c]):
            return False
    return True

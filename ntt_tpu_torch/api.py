"""Public API of the port: forward, inverse and coset NTT, low-degree
extension and polynomial product on the two ``auto`` paths.

Conventions are ``ntt_tpu.api``'s: natural order in and out, limb-leading
``torch.uint32[W, n, *batch]``, forward ``X[k] = Σ_i x[i]·ω_n^{ik} mod p``
with ω_n = g^((p-1)/n); ``inverse=True`` runs the transform with ω^{-1} and
scales by n^{-1}; ``mont_io=True`` takes and returns Montgomery-form words.
Every entry point runs on the CUDA card unless ``device="cpu"`` is passed,
which runs the kernels' plain versions.

``algorithm="auto"`` resolves to ``mxu_chunked`` on the 256-bit fields
(BN254 Fr, BLS12-381 Fr) and to ``mxu_sub`` on the narrow ones (Goldilocks,
the small Proth prime), for n up to 2^24 on the 256-bit fields. The other
algorithms of the JAX package raise NotImplementedError pointing at
ROADMAP.md.
"""

from __future__ import annotations

import numpy as np
import torch

from . import limbs
from .fields import Field, get_field, inv_mod
from .transforms import fourstep as _fourstep
from .transforms import mxu as _mxu
from .transforms.core import host_powers_fast

#: the largest n of the 256-bit path: above it level 0 needs the periodic
#: residual
MAX_N = _mxu.TW_MERGED_MAX

#: every algorithm name of the JAX package; the port runs the two that
#: ``auto`` resolves to
ALGORITHMS = ("naive", "stockham", "fourstep", "fourstep_st", "pallas",
              "mxu", "mxu_pallas", "mxu_fused", "pallas_fused",
              "mxu_chunked", "mxu_sub")


def _device(device) -> torch.device:
    """``None`` means the CUDA card; without one, only an explicit
    ``device="cpu"`` runs (the plain versions)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain versions")
        return torch.device("cuda")
    return torch.device(device)


def resolve_algorithm(algorithm: str, field: Field, n: int) -> str:
    """'auto' picks ``mxu_chunked`` for the 256-bit fields and ``mxu_sub``
    for the narrow ones, as the JAX package does."""
    if algorithm != "auto":
        return algorithm
    return "mxu_chunked" if field.n_words >= 8 else "mxu_sub"


def _tw_tables(field: Field, n: int, inverse: bool, requests) -> list:
    """Plain decomposition-twiddle tables (numpy form), built on the
    host."""
    return [_mxu.plain_table(field, n, inverse, m, n1, n2)
            for (m, n1, n2) in requests]


def _prep_mxu_chunked(field: Field, n: int, inverse: bool = False):
    """(tws, mats) in numpy form (see :func:`aux_from_numpy`)."""
    tws = _mxu.matfold_tw_tables(field, n, inverse)
    if tws is None:
        tws = _tw_tables(field, n, inverse,
                         _fourstep.twiddle_requests(n, _mxu.BASE))
    return tws, _mxu.base_mats(field, n, inverse)


def _prep_mxu_sub(field: Field, n: int, inverse: bool = False):
    """(tws, mats) in numpy form for the narrow-field path: plain tables
    only (the matrix fold targets the 256-bit fields)."""
    sub = _mxu.effective_subbase(field)
    tws = _tw_tables(field, n, inverse, _fourstep.twiddle_requests(n, sub))
    return tws, _mxu.sub_mats(field, n, inverse)


def aux_from_numpy(tws, mats, device=None, first_mats=None, coset_col=None,
                   coset=None) -> dict:
    """The port's aux tables from their numpy form: ``tws`` a list of
    ``{"kind": "stack", "As": ndarray, "rep": int}`` (TwMatStack),
    ``{"kind": "batch", "T4": ndarray}`` (TwBatch), ``{"kind": "deep",
    "T": ndarray [W, n1, n2]}`` (a deep level's plain table, laid out here
    once as [W, n2, n1]) or plain ndarray tables; ``mats`` a dict
    {m: ndarray or None}; ``first_mats`` the top level's coset matrices,
    ``coset_col`` [W, n1] and ``coset`` [W, n] the coset vectors. Arrays
    may be tensors already. Returns {"tws": [...], "mats": {...}, ...} on
    ``device``."""
    dev = _device(device)

    def put(a):
        if isinstance(a, torch.Tensor):
            return a.to(dev)
        a = np.ascontiguousarray(a)
        if not a.flags.writeable:       # e.g. a view of a JAX array
            a = a.copy()
        return torch.from_numpy(a).to(dev)

    out = []
    for t in tws:
        kind = t["kind"] if isinstance(t, dict) else None
        if kind == "stack":
            out.append(_fourstep.TwMatStack(put(t["As"]), int(t["rep"])))
        elif kind == "batch":
            out.append(_fourstep.TwBatch(put(t["T4"])))
        elif kind == "deep":
            out.append(_fourstep.TwDeep(
                put(t["T"]).transpose(1, 2).contiguous()))
        else:
            out.append(put(t))
    aux = {"tws": out,
           "mats": {int(k): put(v) for k, v in mats.items() if v is not None}}
    if first_mats is not None:
        aux["first_mats"] = {int(k): put(v) for k, v in first_mats.items()}
    if coset_col is not None:
        aux["coset_col"] = put(coset_col)
    if coset is not None:
        aux["coset"] = put(coset)
    return aux


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported to ntt_tpu_torch yet; see ROADMAP.md")


def _first_level(algorithm: str, field: Field, n: int):
    """(n1, n2, index into tws) of the top four-step level, or None when n
    fits one base transform."""
    base_max = (_mxu.BASE if algorithm == "mxu_chunked"
                else _mxu.effective_subbase(field))
    if n <= base_max:
        return None
    n1, n2 = _fourstep._split(n, base_max)
    return n1, n2, len(_fourstep.twiddle_requests(n1, base_max))


def get_runner(field: Field, n: int, inverse: bool = False,
               algorithm: str = "auto", mont_io: bool = True,
               coset_shift=None, device=None):
    """(run, aux): ``run(x, aux)`` transforms uint32[W, n, *batch] on
    ``aux``'s device; ``aux`` holds the tables, resident on the device."""
    if n & (n - 1) or n < 1:
        raise ValueError(f"transform size must be a power of two, got {n}")
    algorithm = resolve_algorithm(algorithm, field, n)
    if algorithm not in ALGORITHMS:
        raise KeyError(algorithm)
    wide = field.n_words >= 8
    if algorithm != ("mxu_chunked" if wide else "mxu_sub"):
        raise _not_ported(f"algorithm {algorithm!r} ({field.name})")
    if wide and n > MAX_N:
        raise _not_ported(f"n = 2^{n.bit_length() - 1} (above 2^24)")
    dev = _device(device)
    p = field.p
    prep, fn = ((_prep_mxu_chunked, _mxu.ntt_mxu_chunked) if wide
                else (_prep_mxu_sub, _mxu.ntt_mxu_sub))
    tws, mats = prep(field, n, inverse)
    extra = {}
    fused_coset = False
    if coset_shift is not None:
        shift = (coset_shift if not inverse else inv_mod(coset_shift, p)) % p
        fl = _first_level(algorithm, field, n) if not inverse else None
        if fl is not None:
            # the forward coset premultiply c^{i1·n2 + i2} rides the top
            # level: c^{i2} goes into its twiddle table, c^{i1·n2} into its
            # conv matrix (or a pre-multiplied column where the level has
            # no single matrix)
            n1, n2, idx = fl
            T0 = tws[idx]
            if isinstance(T0, dict) and T0["kind"] == "stack":
                # matrix-folded level 0: rebuild the fold with the coset
                # absorbed; the coset NTT runs the plain NTT's launches
                tws = _mxu.matfold_tw_tables(field, n, inverse,
                                             coset_shift=shift)
            else:
                rowv = torch.from_numpy(
                    host_powers_fast(field, shift, n2)).to(dev)
                tws[idx] = limbs.mont_mul(
                    torch.from_numpy(T0).to(dev), rowv[:, None, :], field)
                col = pow(shift, n2, p)
                if n1 in mats:
                    extra["first_mats"] = {n1: _mxu.coset_base_matrix(
                        field, n1, inverse, col)}
                else:
                    extra["coset_col"] = host_powers_fast(field, col, n1)
            fused_coset = True
        else:
            extra["coset"] = host_powers_fast(field, shift, n)
    aux = aux_from_numpy(tws, mats, device=dev, **extra)
    ninv = field.to_mont_int(inv_mod(n, p))

    def one(c, aux):
        tail = (1,) * (c.dim() - 2)
        if not mont_io:
            c = limbs.to_mont(c, field)
        if coset_shift is not None and not inverse and not fused_coset:
            cs = aux["coset"]
            c = limbs.mont_mul(c, cs.reshape(tuple(cs.shape) + tail), field)
        y = fn(c, field, iter(aux["tws"]), aux["mats"], inverse=inverse,
               pre_col=aux.get("coset_col"),
               first_mats=aux.get("first_mats"))
        if inverse:
            y = limbs.mont_mul(y, limbs.const_planes(
                ninv, field, ndim=y.dim() - 1, device=y.device), field)
            if coset_shift is not None:
                cs = aux["coset"]
                y = limbs.mont_mul(y, cs.reshape(tuple(cs.shape) + tail),
                                   field)
        return y if mont_io else limbs.from_mont(y, field)

    def run(x, aux):
        if x.dim() == 2 or not wide:
            return one(x, aux)
        # 256-bit batch columns run one transform each: the level-0 matrix
        # fold is built for an unbatched suffix
        xs = x.reshape(field.n_words, n, -1)
        ys = [one(xs[:, :, j].contiguous(), aux) for j in range(xs.shape[2])]
        return torch.stack(ys, dim=2).reshape(x.shape)

    return run, aux


_runner_cache: dict = {}


def _as_field(field: Field | str) -> Field:
    return get_field(field) if isinstance(field, str) else field


def _as_tensor(x) -> torch.Tensor:
    """``x`` as a tensor; a read-only array (a view of a JAX array, say) is
    copied, since PyTorch shares memory with numpy and wants it writable."""
    if isinstance(x, np.ndarray) and not x.flags.writeable:
        x = x.copy()
    return torch.as_tensor(x)


def ntt(x, field: Field | str, inverse: bool = False,
        algorithm: str = "auto", mont_io: bool = False,
        coset_shift: int | None = None, device=None) -> torch.Tensor:
    """Number-theoretic transform of ``x`` (uint32[W, n] or batched
    uint32[W, n, *batch], a tensor or an array; transforms along axis 1,
    natural order) on ``device`` (default: the CUDA card)."""
    field = _as_field(field)
    dev = _device(device)
    x = _as_tensor(x)
    if x.dim() >= 2:
        n = x.shape[1]
        if n & (n - 1) or n < 1:
            raise ValueError(
                f"transform size must be a power of two, got {n}")
    if x.dtype != torch.uint32 or x.dim() < 2 or x.shape[0] != field.n_words:
        raise ValueError(
            f"expected limb-leading uint32[{field.n_words}, n, *batch], "
            f"got {x.dtype}{tuple(x.shape)}")
    x = x.to(dev)
    key = (field.name, n, inverse, algorithm, mont_io, coset_shift, str(dev))
    got = _runner_cache.get(key)
    if got is None:
        got = _runner_cache[key] = get_runner(
            field, n, inverse, algorithm, mont_io, coset_shift, dev)
    run, aux = got
    return run(x, aux)


def intt(x, field: Field | str, **kw) -> torch.Tensor:
    """Inverse NTT including the 1/n scaling."""
    return ntt(x, field, inverse=True, **kw)


def coset_ntt(x, field: Field | str, shift: int | None = None,
              **kw) -> torch.Tensor:
    """NTT over the coset shift·<ω_n> (default shift: the field's
    generator)."""
    field = _as_field(field)
    shift = field.generator if shift is None else shift
    return ntt(x, field, coset_shift=shift, **kw)


def coset_intt(x, field: Field | str, shift: int | None = None,
               **kw) -> torch.Tensor:
    """Inverse of :func:`coset_ntt`."""
    field = _as_field(field)
    shift = field.generator if shift is None else shift
    return ntt(x, field, inverse=True, coset_shift=shift, **kw)


def polymul(a, b, field: Field | str, algorithm: str = "auto",
            cyclic: bool = False, device=None) -> torch.Tensor:
    """Polynomial product via NTT. ``a``, ``b``: coefficient vectors
    uint32[W, n] (same n). With ``cyclic=True`` returns the length-n
    cyclic convolution; otherwise the full product of degree < 2n-1 on the
    2n-point domain (zero-padded), uint32[W, 2n]. The pipeline stays in
    Montgomery form: one conversion in, one out, one pointwise product."""
    field = _as_field(field)
    dev = _device(device)
    a = _as_tensor(a).to(dev)
    b = _as_tensor(b).to(dev)
    if b.shape != a.shape:
        raise ValueError(f"polymul operands differ in shape: "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if not cyclic:
        pad = torch.zeros_like(a)
        a = torch.cat([a, pad], dim=1)
        b = torch.cat([b, pad], dim=1)
    kw = dict(algorithm=algorithm, mont_io=True, device=dev)
    fa = ntt(limbs.to_mont(a, field), field, **kw)
    fb = ntt(limbs.to_mont(b, field), field, **kw)
    res = intt(limbs.mont_mul(fa, fb, field), field, **kw)
    return limbs.from_mont(res, field)


def lde(x, field: Field | str, blowup: int = 4, shift: int | None = None,
        algorithm: str = "auto", device=None) -> torch.Tensor:
    """Low-degree extension: interpolate the n evaluations, then evaluate
    on a coset domain of size blowup*n (zero-padded coefficients, coset
    NTT)."""
    field = _as_field(field)
    dev = _device(device)
    x = _as_tensor(x).to(dev)
    shift = field.generator if shift is None else shift
    coeffs = intt(x, field, algorithm=algorithm, device=dev)
    zshape = (x.shape[0], x.shape[1] * (blowup - 1)) + tuple(x.shape[2:])
    padded = torch.cat(
        [coeffs, torch.zeros(zshape, dtype=torch.uint32, device=dev)], dim=1)
    return coset_ntt(padded, field, shift=shift, algorithm=algorithm,
                     device=dev)


def ramp_mont(field: Field | str, n: int, device=None) -> torch.Tensor:
    """The ramp 0..n-1 in Montgomery form, uint32[W, n] on ``device``."""
    field = _as_field(field)
    planes = torch.zeros((field.n_words, n), dtype=torch.int64,
                         device=_device(device))
    planes[0] = torch.arange(n, device=planes.device)
    return limbs.to_mont(planes, field)

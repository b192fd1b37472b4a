"""Public API of the port: the forward NTT on the ``mxu_chunked`` path.

Conventions are ``ntt_tpu.api``'s: natural order in and out, limb-leading
``torch.uint32[W, n, *batch]``, forward ``X[k] = Σ_i x[i]·ω_n^{ik} mod p``
with ω_n = g^((p-1)/n); ``mont_io=True`` takes and returns Montgomery-form
words. Every entry point runs on the CUDA card unless ``device="cpu"`` is
passed, which runs the kernels' plain versions.

This slice covers the 256-bit fields (BN254 Fr, BLS12-381 Fr), forward, for
n up to 2^24. Anything else raises NotImplementedError pointing at
ROADMAP.md.
"""

from __future__ import annotations

import numpy as np
import torch

from . import limbs
from .fields import Field, get_field
from .transforms import fourstep as _fourstep
from .transforms import mxu as _mxu
from .transforms.core import host_power_matrix

#: the largest n of this slice: above it level 0 needs the periodic residual
MAX_N = _mxu.TW_MERGED_MAX


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


def _tw_tables(field: Field, n: int, requests) -> list:
    """Plain decomposition-twiddle tables (numpy), built on the host."""
    return [host_power_matrix(field, field.root_of_unity(m), n1, n2)
            for (m, n1, n2) in requests]


def _prep_mxu_chunked(field: Field, n: int):
    """(tws, mats) in numpy form (see :func:`aux_from_numpy`)."""
    tws = _mxu.matfold_tw_tables(field, n)
    if tws is None:
        tws = _tw_tables(field, n, _fourstep.twiddle_requests(n, _mxu.BASE))
    return tws, _mxu.base_mats(field, n)


def aux_from_numpy(tws, mats, device=None) -> dict:
    """The port's aux tables from their numpy form: ``tws`` a list of
    ``{"kind": "stack", "As": ndarray, "rep": int}`` (TwMatStack),
    ``{"kind": "batch", "T4": ndarray}`` (TwBatch) or plain ndarray tables;
    ``mats`` a dict {m: ndarray}. Returns {"tws": [...], "mats": {...}} on
    ``device``."""
    dev = _device(device)

    def put(a):
        a = np.ascontiguousarray(a)
        if not a.flags.writeable:       # e.g. a view of a JAX array
            a = a.copy()
        return torch.from_numpy(a).to(dev)

    out = []
    for t in tws:
        if isinstance(t, dict) and t["kind"] == "stack":
            out.append(_fourstep.TwMatStack(put(t["As"]), int(t["rep"])))
        elif isinstance(t, dict) and t["kind"] == "batch":
            out.append(_fourstep.TwBatch(put(t["T4"])))
        else:
            out.append(put(t))
    return {"tws": out, "mats": {int(k): put(v) for k, v in mats.items()}}


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported to ntt_tpu_torch yet; see ROADMAP.md")


def get_runner(field: Field, n: int, inverse: bool = False,
               algorithm: str = "auto", mont_io: bool = True,
               coset_shift=None, device=None):
    """(run, aux): ``run(x, aux)`` transforms uint32[W, n, *batch] on
    ``aux``'s device; ``aux`` holds the tables, resident on the device."""
    if inverse:
        raise _not_ported("the inverse NTT")
    if coset_shift is not None:
        raise _not_ported("the coset NTT")
    algorithm = resolve_algorithm(algorithm, field, n)
    if algorithm != "mxu_chunked":
        raise _not_ported(f"algorithm {algorithm!r} ({field.name})")
    if n & (n - 1) or n < 1:
        raise ValueError(f"transform size must be a power of two, got {n}")
    if n > MAX_N:
        raise _not_ported(f"n = 2^{n.bit_length() - 1} (above 2^24)")
    aux = aux_from_numpy(*_prep_mxu_chunked(field, n), device=device)

    def one(c, aux):
        if not mont_io:
            c = limbs.to_mont(c, field)
        y = _mxu.ntt_mxu_chunked(c, field, iter(aux["tws"]), aux["mats"])
        return y if mont_io else limbs.from_mont(y, field)

    def run(x, aux):
        if x.dim() == 2:
            return one(x, aux)
        # batch columns run one transform each: the level-0 matrix fold
        # is built for an unbatched suffix
        xs = x.reshape(field.n_words, n, -1)
        ys = [one(xs[:, :, j].contiguous(), aux) for j in range(xs.shape[2])]
        return torch.stack(ys, dim=2).reshape(x.shape)

    return run, aux


_runner_cache: dict = {}


def ntt(x, field: Field | str, inverse: bool = False,
        algorithm: str = "auto", mont_io: bool = False,
        coset_shift: int | None = None, device=None) -> torch.Tensor:
    """Forward NTT of ``x`` (uint32[W, n] or batched uint32[W, n, *batch],
    a tensor or an array; transforms along axis 1, natural order) on
    ``device`` (default: the CUDA card)."""
    if isinstance(field, str):
        field = get_field(field)
    dev = _device(device)
    x = torch.as_tensor(x).to(dev)
    if x.dtype != torch.uint32 or x.dim() < 2 or x.shape[0] != field.n_words:
        raise ValueError(
            f"expected limb-leading uint32[{field.n_words}, n, *batch], "
            f"got {x.dtype}{tuple(x.shape)}")
    n = x.shape[1]
    key = (field.name, n, inverse, algorithm, mont_io, coset_shift, str(dev))
    got = _runner_cache.get(key)
    if got is None:
        got = _runner_cache[key] = get_runner(
            field, n, inverse, algorithm, mont_io, coset_shift, dev)
    run, aux = got
    return run(x, aux)


def ramp_mont(field: Field | str, n: int, device=None) -> torch.Tensor:
    """The ramp 0..n-1 in Montgomery form, uint32[W, n] on ``device``."""
    if isinstance(field, str):
        field = get_field(field)
    planes = torch.zeros((field.n_words, n), dtype=torch.int64,
                         device=_device(device))
    planes[0] = torch.arange(n, device=planes.device)
    return limbs.to_mont(planes, field)

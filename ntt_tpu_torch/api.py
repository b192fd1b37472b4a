"""Public API of the port: forward, inverse and coset NTT, low-degree
extension and polynomial product, under every algorithm name of the JAX
package.

Conventions are ``ntt_tpu.api``'s: natural order in and out, limb-leading
``torch.uint32[W, n, *batch]``, forward ``X[k] = Σ_i x[i]·ω_n^{ik} mod p``
with ω_n = g^((p-1)/n); ``inverse=True`` runs the transform with ω^{-1} and
scales by n^{-1}; ``mont_io=True`` takes and returns Montgomery-form words.
Every entry point runs on the CUDA card unless ``device="cpu"`` is passed,
which runs the kernels' plain versions.

``algorithm="auto"`` resolves to ``mxu_chunked`` on the 256-bit fields
(BN254 Fr, BLS12-381 Fr) and to ``mxu_sub`` on the narrow ones (Goldilocks,
the small Proth prime). Every other name of :data:`ALGORITHMS` runs on all
four fields too: the butterfly ladders ``naive``, ``stockham``,
``fourstep``, ``fourstep_st`` (plain PyTorch), ``pallas`` and
``pallas_fused`` (the shared-memory stage kernels), and the digit-matmul
transforms ``mxu``, ``mxu_pallas`` and ``mxu_fused``. n may be any power
of two up to 2^two_adicity of the field (BN254 Fr 2^28, BLS12-381 Fr 2^32,
Goldilocks 2^32, the small Proth prime 2^26), within the card's memory;
above it the field's root of unity raises AssertionError, as in
``ntt_tpu``. On the 256-bit fields ``mxu_chunked`` and ``mxu_sub`` fold
level 0's twiddle into a conv-matrix stack with a merged level-1 table up
to 2^24 and with the periodic residual (``TwStackResid``) above, so that no
table has n entries. Tables of more than ``core.HOST_TW_LIMIT`` entries are
generated on the runner's device. ``mxu_fused`` and ``pallas_fused`` take
unbatched input only.

The JAX package's knobs are read from the environment under the same names
and defaults (``ntt_tpu_torch.config``); a runner is cached under
``config.config_key()``, so a knob flip builds a fresh one. A knob changes
the plan and the launches, never the output words.
"""

from __future__ import annotations

import numpy as np
import torch

from . import limbs
from .config import config_key, warn_plan_only_knobs
from .fields import Field, get_field, inv_mod
from .kernels import mxu_level
from .limbs import resolve_device
from .tracing import span
from .transforms import core as _core
from .transforms import fourstep as _fourstep
from .transforms import mxu as _mxu
from .transforms.core import (HOST_TW_LIMIT, geometric_outer_chunked,
                              host_powers_fast, power_table, scale_columns)
from .transforms.naive import ntt_naive

#: elements a plain elementwise pass (conversion, coset product, the n^-1
#: scale) takes at once along axis 1: bounds limbs' int64 temporaries
#: (about 0.6 KB an element at W = 8) at 2^26 and above
PASS_CHUNK = 1 << 22


def resolve_algorithm(algorithm: str, field: Field, n: int) -> str:
    """'auto' picks ``mxu_chunked`` for the 256-bit fields and ``mxu_sub``
    for the narrow ones, as the JAX package does."""
    if algorithm != "auto":
        return algorithm
    return "mxu_chunked" if field.n_words >= 8 else "mxu_sub"


def _tw_tables(field: Field, n: int, inverse: bool, requests,
               deep: bool = False, device=None) -> list:
    """Plain decomposition-twiddle tables ω_m^{k1·i2} [W, n1, n2]: numpy,
    built on the host, or, above HOST_TW_LIMIT entries with a ``device``,
    generated there. With ``deep`` the levels below the top come in the
    form the level kernels read (``mxu.plain_table``)."""
    if deep:
        return [_mxu.plain_table(field, n, inverse, m, n1, n2, device)
                for (m, n1, n2) in requests]
    return [power_table(field, field.inv_root_of_unity(m) if inverse
                        else field.root_of_unity(m), n1, n2, device)
            for (m, n1, n2) in requests]


def _prep_none(field: Field, n: int, inverse: bool = False, device=None):
    return [], {}


def _prep_fourstep(base_max):
    """``base_max``: an int, or a callable(field) -> int."""
    def prep(field: Field, n: int, inverse: bool = False, device=None):
        bm = base_max(field) if callable(base_max) else base_max
        return _tw_tables(field, n, inverse,
                          _fourstep.twiddle_requests(n, bm),
                          device=device), {}
    return prep


def _prep_mxu(field: Field, n: int, inverse: bool = False, device=None):
    return (_tw_tables(field, n, inverse, _mxu.twiddle_requests(n),
                       device=device),
            _mxu.base_mats(field, n, inverse))


def _prep_mxu_fused(field: Field, n: int, inverse: bool = False,
                    device=None):
    return (_mxu.expanded_twiddles(field, n, inverse, base=_mxu.BASE),
            _mxu.base_mats(field, n, inverse))


def _prep_pallas_fused(field: Field, n: int, inverse: bool = False,
                       device=None):
    return _mxu.expanded_twiddles(field, n, inverse,
                                  base=_fourstep.fused_m(field)), {}


def _matfold_on(field: Field, n: int, base_max: int) -> bool:
    """Whether the matrix fold applies: NTT_TW_MATFOLD on, a 256-bit field,
    the peel-BASE single-level transforms, and some level folds
    (``mxu.matfold_plan``)."""
    return (_mxu.TW_MATFOLD and field.n_words >= 8 and base_max == _mxu.BASE
            and _mxu.matfold_plan(field, n) is not None)


def _matfold_tws(field: Field, n: int, inverse: bool, base_max: int,
                 coset_shift=None, device=None):
    """The matrix-fold table list where it applies (:func:`_matfold_on`),
    else None."""
    if not _matfold_on(field, n, base_max):
        return None
    return _mxu.matfold_tw_tables(field, n, inverse, coset_shift=coset_shift,
                                  device=device)


def _prep_mxu_chunked(field: Field, n: int, inverse: bool = False,
                      device=None):
    """(tws, mats) in numpy form (see :func:`aux_from_numpy`); with a
    ``device``, the tables above HOST_TW_LIMIT entries generated there."""
    tws = _matfold_tws(field, n, inverse, _mxu.BASE, device=device)
    if tws is None:
        # deep levels in the level kernels' layout; NTT_FUSE_TW=0 runs
        # generic levels, which take the plain tables
        tws = _tw_tables(field, n, inverse,
                         _fourstep.twiddle_requests(n, _mxu.BASE),
                         deep=_mxu.FUSE_TW, device=device)
    return tws, _mxu.base_mats(field, n, inverse)


def _prep_mxu_sub(field: Field, n: int, inverse: bool = False, device=None):
    """(tws, mats) as :func:`_prep_mxu_chunked`: plain tables for the
    narrow fields, the matrix fold for the 256-bit ones when their peel is
    the single-level BASE."""
    sub = _mxu.effective_subbase(field)
    tws = _matfold_tws(field, n, inverse, sub, device=device)
    if tws is None:
        tws = _tw_tables(field, n, inverse,
                         _fourstep.twiddle_requests(n, sub), deep=True,
                         device=device)
    return tws, _mxu.sub_mats(field, n, inverse)


def _fourstep_run(fn):
    return lambda x, field, inverse, aux: fn(
        x, field, inverse, iter(aux["tws"]), pre_col=aux.get("coset_col"))


def _mxu_run(fn):
    return lambda x, field, inverse, aux: fn(
        x, field, iter(aux["tws"]), aux["mats"], **aux.get("plan", {}))


def _level_run(fn):
    return lambda x, field, inverse, aux: fn(
        x, field, inverse, iter(aux["tws"]), aux["mats"],
        pre_col=aux.get("coset_col"), first_mats=aux.get("first_mats"),
        **aux.get("plan", {}))


#: algorithm -> (fn(x, field, inverse, aux), prepare(field, n, inverse,
#: device=None) -> (tws, mats) in numpy form, the large tables generated on
#: ``device`` where one is given), every name of the JAX package's registry
ALGORITHMS = {
    "naive": (lambda x, field, inverse, aux: ntt_naive(
        x, field, inverse=inverse), _prep_none),
    "stockham": (lambda x, field, inverse, aux: _core.ntt_along_axis_stockham(
        x, field, inverse=inverse), _prep_none),
    "fourstep": (_fourstep_run(_fourstep.ntt_fourstep),
                 _prep_fourstep(_fourstep.BASE_MAX)),
    "fourstep_st": (_fourstep_run(_fourstep.ntt_fourstep_stockham),
                    _prep_fourstep(_fourstep.BASE_MAX)),
    "pallas": (_fourstep_run(_fourstep.ntt_fourstep_pallas),
               _prep_fourstep(_fourstep.pallas_base_max)),
    "mxu": (_mxu_run(_mxu.ntt_mxu), _prep_mxu),
    "mxu_pallas": (_mxu_run(_mxu.ntt_mxu_pallas), _prep_mxu),
    "mxu_fused": (_mxu_run(_mxu.ntt_mxu_fused), _prep_mxu_fused),
    "pallas_fused": (
        lambda x, field, inverse, aux: _fourstep.ntt_fourstep_pallas_fused(
            x, field, inverse, iter(aux["tws"])), _prep_pallas_fused),
    "mxu_chunked": (_level_run(_mxu.ntt_mxu_chunked), _prep_mxu_chunked),
    "mxu_sub": (_level_run(_mxu.ntt_mxu_sub), _prep_mxu_sub),
}

#: the algorithms whose table list may hold a matrix fold built for an
#: unbatched suffix (256-bit fields): a batch runs column by column
_MATFOLD_ALGORITHMS = ("mxu_chunked", "mxu_sub")


def aux_from_numpy(tws, mats, device=None, first_mats=None, coset_col=None,
                   coset=None) -> dict:
    """The port's aux tables from their numpy form: ``tws`` a list of
    ``{"kind": "stack", "As": ndarray, "rep": int}`` (TwMatStack),
    ``{"kind": "resid", "As": ndarray, "rep": int, "Tres": ndarray}``
    (TwStackResid), ``{"kind": "batch", "T4": ndarray}`` (TwBatch),
    ``{"kind": "deep", "T": ndarray [W, n1, n2]}`` (a deep level's plain
    table, laid out here once as [W, n2, n1]) or plain ndarray tables;
    ``mats`` a dict {m: ndarray or None}; ``first_mats`` the top level's
    coset matrices, ``coset_col`` [W, n1] and ``coset`` [W, n] the coset
    vectors. Arrays may be tensors already; ``mats`` may be empty (the
    ladder transforms have none). Returns {"tws": [...], "mats": {...},
    ...} on ``device``."""
    dev = resolve_device(device)

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
        elif kind == "resid":
            out.append(_fourstep.TwStackResid(put(t["As"]), int(t["rep"]),
                                              put(t["Tres"])))
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


def _first_level(algorithm: str, field: Field, n: int):
    """(n1, n2, index into tws) of the top four-step level for the
    algorithms whose table list follows ``fourstep.twiddle_requests``: the
    targets of the coset fusion. None for the others (the flat transforms,
    ``naive``, ``stockham``) and when n fits one base transform."""
    base_max = {"fourstep": _fourstep.BASE_MAX,
                "fourstep_st": _fourstep.BASE_MAX,
                "pallas": _fourstep.pallas_base_max(field),
                "mxu_chunked": _mxu.BASE,
                "mxu_sub": _mxu.effective_subbase(field)}.get(algorithm)
    if base_max is None or n <= base_max:
        return None
    n1, n2 = _fourstep._split(n, base_max)
    return n1, n2, len(_fourstep.twiddle_requests(n1, base_max))


def _plan(algorithm: str, field: Field) -> dict:
    """The knobs a digit-matmul driver reads when it runs, as keyword
    arguments: its peel and, for ``mxu_chunked``, whether the twiddle rides
    the level kernels. ``get_runner`` reads them when it builds the tables
    and keeps them in ``aux``, so a knob flip afterwards changes neither."""
    if algorithm in ("mxu", "mxu_pallas", "mxu_fused"):
        return {"base_max": _mxu.BASE}
    if algorithm == "mxu_chunked":
        return {"base_max": _mxu.BASE, "fuse": _mxu.FUSE_TW}
    if algorithm == "mxu_sub":
        return {"base_max": _mxu.effective_subbase(field)}
    return {}


def _row_powers(field: Field, base: int, count: int, dev):
    """base^0 .. base^{count-1} (Montgomery uint32[W, count]) on ``dev``:
    from the host up to HOST_TW_LIMIT entries, generated there above."""
    if count <= HOST_TW_LIMIT:
        return torch.from_numpy(host_powers_fast(field, base, count)).to(dev)
    return geometric_outer_chunked(field, base, count, dev)


def _chunked_pass(fn, x, *vs, name: str = "ntt.pass"):
    """``fn(x, *vs)`` for an elementwise ``fn``, PASS_CHUNK elements of
    axis 1 at a time: an operand as long as x along axis 1 is cut with it,
    a broadcast one is passed whole. Traced as the span ``name``."""
    with span(name):
        n = x.shape[1]
        step = max(1, PASS_CHUNK // max(x[0, :1].numel(), 1))
        if n <= step:
            return fn(x, *vs)
        out = torch.empty_like(x)
        for i in range(0, n, step):
            out[:, i:i + step] = fn(x[:, i:i + step], *[
                v[:, i:i + step] if v.shape[1] == n else v for v in vs])
        return out


def get_runner(field: Field, n: int, inverse: bool = False,
               algorithm: str = "auto", mont_io: bool = True,
               coset_shift=None, device=None):
    """(run, aux): ``run(x, aux)`` transforms uint32[W, n, *batch] on
    ``aux``'s device; ``aux`` holds the tables, resident on the device.
    AssertionError for n above the field's two-adicity, as in
    ``ntt_tpu``; a UserWarning under a plan-only knob of the JAX package
    (``config.warn_plan_only_knobs``)."""
    warn_plan_only_knobs()
    if n & (n - 1) or n < 1:
        raise ValueError(f"transform size must be a power of two, got {n}")
    field.root_of_unity(n)          # asserts n <= 2^two_adicity
    algorithm = resolve_algorithm(algorithm, field, n)
    fn, prepare = ALGORITHMS[algorithm]
    _check_knobs(field, n, algorithm)
    matfold = algorithm in _MATFOLD_ALGORITHMS and field.n_words >= 8
    dev = resolve_device(device)
    p = field.p
    tws, mats = prepare(field, n, inverse, dev)
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
            if isinstance(T0, dict) and T0["kind"] in ("stack", "resid"):
                # matrix-folded level 0: rebuild the fold with the coset
                # absorbed; the coset NTT runs the plain NTT's launches
                tws = _mxu.matfold_tw_tables(field, n, inverse,
                                             coset_shift=shift, device=dev)
            else:
                T0 = torch.as_tensor(T0).to(dev)
                tws[idx] = scale_columns(
                    T0, _row_powers(field, shift, n2, dev), field)
                col = pow(shift, n2, p)
                if n1 in mats:
                    extra["first_mats"] = {n1: _mxu.coset_base_matrix(
                        field, n1, inverse, col)}
                else:
                    extra["coset_col"] = host_powers_fast(field, col, n1)
            fused_coset = True
        else:
            extra["coset"] = _row_powers(field, shift, n, dev)
    aux = aux_from_numpy(tws, mats, device=dev, **extra)
    aux["plan"] = _plan(algorithm, field)
    del tws
    ninv = field.to_mont_int(inv_mod(n, p))

    def one(c, aux):
        tail = (1,) * (c.dim() - 2)
        cs = aux.get("coset")
        if cs is not None:
            cs = cs.reshape(tuple(cs.shape) + tail)
        c = limbs.debug_check(c, field, "ntt input")
        if not mont_io:
            c = _chunked_pass(lambda a: limbs.to_mont(a, field), c,
                              name="ntt.pass.to_mont")
        if coset_shift is not None and not inverse and not fused_coset:
            c = _chunked_pass(lambda a, v: limbs.mont_mul(a, v, field), c, cs,
                              name="ntt.pass.coset")
        y = limbs.debug_check(fn(c, field, inverse, aux), field,
                              "transform output")
        if inverse:
            scale = limbs.const_planes(ninv, field, ndim=y.dim() - 1,
                                       device=y.device)

            def post(a, *v):
                a = limbs.mont_mul(a, scale, field)
                return limbs.mont_mul(a, v[0], field) if v else a
            y = _chunked_pass(post, y, *([] if cs is None else [cs]),
                              name="ntt.pass.scale")
        if not mont_io:
            y = _chunked_pass(lambda a: limbs.from_mont(a, field), y,
                              name="ntt.pass.from_mont")
        return y

    def run(x, aux):
        if x.dim() == 2 or not matfold:
            return one(x, aux)
        # 256-bit batch columns run one transform each: the level-0 matrix
        # fold is built for an unbatched suffix
        xs = x.reshape(field.n_words, n, -1)
        ys = [one(xs[:, :, j].contiguous(), aux) for j in range(xs.shape[2])]
        return torch.stack(ys, dim=2).reshape(x.shape)

    return run, aux


def _check_knobs(field: Field, n: int, algorithm: str) -> None:
    """ValueError for the knob settings the port does not run:

    - NTT_FUSE_TW=0 with the matrix fold on: the folded tables ride the
      fused level kernels (the JAX package fails at trace time here; set
      NTT_TW_MATFOLD=0 too);
    - an NTT_MXU_BASE_LOG above 6 where a single-level kernel (K1-K4)
      would take m = BASE > 64 points: they contract one conv matrix of at
      most 64 points (``kernels/mxu_level.LEVEL_MAX_M``; at 128 points a
      256-bit conv matrix is 22 MB, and the JAX package's kernels do not
      take it either)."""
    if (algorithm == "mxu_chunked" and not _mxu.FUSE_TW
            and _matfold_on(field, n, _mxu.BASE)):
        raise ValueError(
            f"NTT_FUSE_TW=0 with NTT_TW_MATFOLD=1: the folded tables of "
            f"{field.name} 2^{n.bit_length() - 1} need the fused level "
            "kernels; set NTT_TW_MATFOLD=0 as well")
    single = mxu_level.LEVEL_MAX_M
    if _mxu.BASE <= single or n <= single:
        return
    if (algorithm in ("mxu_pallas", "mxu_fused", "mxu_chunked")
            or algorithm == "mxu_sub" and _matfold_on(
                field, n, _mxu.effective_subbase(field))):
        raise ValueError(
            f"NTT_MXU_BASE_LOG={_mxu.BASE_LOG}: {algorithm} would run a "
            f"single-level kernel at m = {_mxu.BASE}; the single-level "
            f"kernels take m <= {single} (NTT_MXU_BASE_LOG <= "
            f"{single.bit_length() - 1})")


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
        coset_shift: int | None = None, donate: bool = False,
        device=None) -> torch.Tensor:
    """Number-theoretic transform of ``x`` (uint32[W, n] or batched
    uint32[W, n, *batch], a tensor or an array; transforms along axis 1,
    natural order) on ``device`` (default: the CUDA card).

    ``donate=True`` hands ``x`` over, as the dist path's ``donate`` does:
    the output is written into its storage and returned, so the caller
    keeps one buffer instead of two, and the input's contents are gone."""
    with span("ntt.api"):
        field = _as_field(field)
        dev = resolve_device(device)
        x = _as_tensor(x)
        if x.dim() >= 2:
            n = x.shape[1]
            if n & (n - 1) or n < 1:
                raise ValueError(
                    f"transform size must be a power of two, got {n}")
        if (x.dtype != torch.uint32 or x.dim() < 2
                or x.shape[0] != field.n_words):
            raise ValueError(
                f"expected limb-leading uint32[{field.n_words}, n, *batch], "
                f"got {x.dtype}{tuple(x.shape)}")
        x = x.to(dev)
        # every knob is part of the key: a knob flip builds a fresh runner
        key = (field.name, n, inverse, algorithm, mont_io, coset_shift,
               str(dev), config_key())
        got = _runner_cache.get(key)
        if got is None:
            with span("ntt.runner.build"):
                got = _runner_cache[key] = get_runner(
                    field, n, inverse, algorithm, mont_io, coset_shift, dev)
        run, aux = got
        y = run(x, aux)
        if not donate:
            return y
        x.copy_(y)
        return x


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
    dev = resolve_device(device)
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
    dev = resolve_device(device)
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
                         device=resolve_device(device))
    planes[0] = torch.arange(n, device=planes.device)
    return limbs.to_mont(planes, field)

"""Multi-device four-step NTT (the port of ``ntt_tpu.parallel.dist_ntt``).

The four-step transform maps onto a 1-D mesh of D shards as:

    input  A[i1, i2]   sharded on i2   (columns distributed)
    1. column NTTs over i1             -> local
    2. decomposition-twiddle multiply  -> local: ω^{k1·(off + j)} with
                                          off = d·n2_loc, one table a shard
    3. the four-step transpose         -> the one exchange (kernel K8)
    4. local transpose + row NTTs      -> local
    output D'[k2, k1]  sharded on k1

One program drives every shard of the mesh (a single controller, as one
``jax.shard_map`` program sees the whole mesh). A sharded array is a list
with one tensor per device of the ``ntt`` axis: the input uint32[W, n1,
n2_loc] per shard, the output uint32[W, n2, n1_loc] per shard, holding
X[k2·n1 + k1]. The per-shard work runs on the shard's device; the
exchange is K8 (``exchange="pallas"``), its plain version
(``"all_to_all"``, which in JAX is XLA's collective, outside any kernel),
or D - 1 rotations of the buffers between devices (``"ring"``, plain). A
mesh may name one CUDA device several times (D logical shards on one card,
K8's sources all local) or D cards (K8 reads the other cards over peer
access). On a factored (replica, ntt) mesh every replica row computes the
whole transform, as ``shard_map`` does, and the first row's shards are the
result.

Limbs stay limb-major and unsharded; each shard holds contiguous columns
of every limb plane, so the exchange moves contiguous blocks.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .. import limbs
from ..api import _as_tensor, _tw_tables, aux_from_numpy
from ..config import config_key, warn_plan_only_knobs
from ..fields import Field, inv_mod
from ..kernels.exchange import MAX_SHARDS, a2a_transpose, a2a_transpose_plain
from ..tracing import span
from ..transforms import core, fourstep, mxu
from ..transforms.core import host_powers_fast, power_table, split_log

AXIS = "ntt"

#: the transpose exchanges make_dist_ntt takes
EXCHANGES = ("all_to_all", "ring", "pallas")


class Mesh:
    """Devices laid out on named axes: ``devices`` an object ndarray of
    ``torch.device`` (a device may repeat), ``axis_names`` ("ntt",) or
    ("replica", "ntt"), ``shape`` {axis: size} as in JAX."""

    def __init__(self, devices: np.ndarray, axis_names: tuple):
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def rows(self) -> list:
        """The replica rows, each a list of the ``ntt`` axis' devices."""
        return [list(r) for r in self.devices.reshape(-1, self.shape[AXIS])]

    def _key(self) -> tuple:
        return (self.axis_names, self.devices.shape,
                tuple(str(d) for d in self.devices.flat))

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())


def make_mesh(devices=None, axis: str = AXIS) -> Mesh:
    """1-D mesh over ``axis``, or (replica, axis) for a device count that
    is not a power of two, the axis taking the largest power of two that
    divides the count. ``devices``: a list of devices (names or
    ``torch.device``; repeats allowed, e.g. ``["cuda:0"] * 4`` for four
    shards on one card, ``["cpu"] * 4`` for the plain versions); None means
    every CUDA device, and raises without one."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass the mesh's devices, e.g. ['cpu'] * 4, "
                "to run the plain versions")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        devs[i] = torch.device(d)
    d = len(devs)
    ntt_size = d & (-d)
    if ntt_size == d:
        return Mesh(devs, (axis,))
    return Mesh(devs.reshape(d // ntt_size, ntt_size), ("replica", axis))


def _axis_size(mesh: Mesh, axis: str = AXIS) -> int:
    return mesh.shape[axis]


def exchange_options(n: int, mesh: Mesh) -> dict:
    """Which transpose exchanges are eligible at this (n, mesh), and why:
    {exchange_name: {"eligible": bool, "why": str}}. K8 needs a 1-D mesh of
    at most MAX_SHARDS shards; every exchange needs D to divide both split
    factors (the shard layout itself)."""
    D = _axis_size(mesh)
    n1, n2 = split_log(n)
    divides = n1 % D == 0 and n2 % D == 0
    one_d = len(mesh.axis_names) == 1
    layout = (f"mesh size D={D} must divide both split factors (n1={n1}, "
              f"n2={n2}): the four-step shard layout itself is ineligible")
    if not one_d:
        why = (f"needs a 1-D mesh (got axes {mesh.axis_names}): the kernel "
               "exchanges the shards of one axis, indexed by shard number")
    elif not divides:
        why = layout
    elif D > MAX_SHARDS:
        why = (f"D={D} shards: the kernel takes at most {MAX_SHARDS} source "
               "pointers")
    else:
        why = ("K8: one pull launch a shard, every source chunk read in "
               "parallel")
    return {
        "all_to_all": {"eligible": divides,
                       "why": ("K8's plain version: slices, device copies "
                               "and one concatenation a shard, any mesh"
                               if divides else layout)},
        "ring": {"eligible": divides,
                 "why": (f"{D - 1} buffer rotations between devices, any "
                         "mesh" if divides else layout)},
        "pallas": {"eligible": one_d and divides and D <= MAX_SHARDS,
                   "why": why},
    }


def shard_for_ntt(x, field: Field, mesh: Mesh, axis: str = AXIS) -> list:
    """Place a uint32[W, n] array (a tensor, or a numpy array such as
    ``np.asarray`` of a JAX array) into the distributed four-step layout:
    one uint32[W, n1, n2/D] a device of the first replica row, holding
    columns d·n2/D .. (d+1)·n2/D - 1 of A[i1, i2] = x[i1·n2 + i2]."""
    x = _as_tensor(x)
    W, n = x.shape
    if W != field.n_words or x.dtype != torch.uint32:
        raise ValueError(f"expected uint32[{field.n_words}, n], got "
                         f"{x.dtype}{tuple(x.shape)}")
    n1, n2 = split_log(n)
    D = _axis_size(mesh, axis)
    if n2 % D:
        raise ValueError(f"n2={n2} must be divisible by '{axis}' axis size "
                         f"{D}")
    n2_loc = n2 // D
    xm = x.reshape(W, n1, n2)
    return [xm[:, :, d * n2_loc:(d + 1) * n2_loc].contiguous().to(dev)
            for d, dev in enumerate(mesh.rows()[0])]


def unshard(y) -> torch.Tensor:
    """Gather a distributed array (the output [W, n2, n1_loc] per shard, or
    an input [W, n1, n2_loc]) into one flat natural-order uint32[W, n] on
    the CPU: X[k2·n1 + k1] = y[:, k2, k1]."""
    full = torch.cat([t.cpu() for t in y], dim=2)
    return full.reshape(full.shape[0], -1)


def _on(device):
    """The shard's device as the current CUDA device (its kernels launch
    there); nothing for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _axis_fn(algorithm: str, field: Field):
    """The local sub-NTT of the distributed four-step: (``fn(x, field,
    inverse, aux)``, ``prepare(field, m, batch, inverse) -> (tws, mats)``)
    for a length-m transform along axis 1 of uint32[W, m, batch]. The
    tables are built on the host, as for ``api.get_runner``; the peel of
    the digit-matmul transforms is read here, when the transform is made,
    as the tables are (:func:`make_dist_ntt`)."""
    if algorithm == "jnp":
        return (lambda x, field, inverse, aux: fourstep.ntt_fourstep(
            x, field, inverse, iter(aux["tws"])),
            _plain_prepare(lambda field: fourstep.BASE_MAX))
    if algorithm == "pallas":
        # kernel K5 as the base transform, generic levels
        return (lambda x, field, inverse, aux: fourstep.ntt_fourstep_pallas(
            x, field, inverse, iter(aux["tws"])),
            _plain_prepare(fourstep.pallas_base_max))
    if algorithm == "mxu":
        # the plain digit-matmul base, as the JAX package's local transform
        peel = mxu.BASE
        return (lambda x, field, inverse, aux: mxu.ntt_axis_mxu(
            x, field, inverse, iter(aux["tws"]), mats=aux["mats"],
            base_max=peel), _prepare_mxu)
    if algorithm == "mxu_sub":
        # kernel K3 (multi-level on the narrow fields) for every level
        peel = mxu.effective_subbase(field)
        return (lambda x, field, inverse, aux: mxu.ntt_mxu_sub(
            x, field, inverse, iter(aux["tws"]), aux["mats"],
            base_max=peel), _prepare_mxu_sub)
    raise ValueError(f"unknown local algorithm {algorithm!r}")


def _plain_prepare(base_max):
    def prepare(field: Field, m: int, batch: int, inverse: bool):
        reqs = fourstep.twiddle_requests(m, base_max(field))
        return _tw_tables(field, m, inverse, reqs), {}
    return prepare


def _prepare_mxu(field: Field, m: int, batch: int, inverse: bool):
    return (_tw_tables(field, m, inverse, mxu.twiddle_requests(m)),
            mxu.base_mats(field, m, inverse))


def _prepare_mxu_sub(field: Field, m: int, batch: int, inverse: bool):
    """Plain tables for a batched transform: every level below the top is
    deep, and the top one too when batch > 1 (``mxu.plain_table`` lays
    them out as the level kernels read them). Not ``api._prep_mxu_sub``:
    its 256-bit matrix fold is built for an unbatched transform."""
    reqs = fourstep.twiddle_requests(m, mxu.effective_subbase(field))
    top = m if batch == 1 else 0
    return (_tw_tables(field, top, inverse, reqs, deep=True),
            mxu.sub_mats(field, m, inverse))


def _device_scalar(table: np.ndarray, d: int) -> torch.Tensor:
    """Shard d's entry of a [W, D] Montgomery table, as a [W, 1, 1]
    broadcastable scalar."""
    return torch.from_numpy(np.ascontiguousarray(table[:, d]))[:, None, None]


def shard_twiddle(field: Field, omega: int, n1: int, n2_loc: int, d: int,
                  device, Ts=None) -> torch.Tensor:
    """Shard d's step-2 twiddle ω^{k1·(d·n2_loc + j)}, uint32[W, n1, n2_loc]
    on ``device``: the static ω^{k1·j} (``Ts``, the same on every shard;
    when not given, :func:`core.power_table` makes it, on the host up to
    ``HOST_TW_LIMIT`` entries and generated on ``device`` above) times the
    shard's column (ω^{d·n2_loc})^{k1}, one Montgomery product on the
    device; row k1 = 1 at j = 0 holds the shard's base ω^{d·n2_loc}. The
    JAX package applies the two factors as two passes over the data each
    call."""
    if Ts is None:
        Ts = power_table(field, omega, n1, n2_loc, device)
    col = torch.from_numpy(host_powers_fast(
        field, pow(omega, d * n2_loc, field.p), n1)).to(device)
    return limbs.mont_mul(torch.as_tensor(Ts).to(device), col[:, :, None],
                          field)


def coset_tables(field: Field, n: int, D: int, shift: int,
                 inverse: bool) -> tuple:
    """(local, dev) of the coset scaling, as numpy Montgomery tables: the
    forward transform premultiplies inputs by c^{i1·n2 + off + j}, off =
    d·n2_loc: local[W, n1, n2_loc] = c^{i1·n2 + j} (the same on every
    shard) times dev[:, d] = c^{d·n2_loc}. The inverse post-multiplies
    outputs [W, k2, k1_loc] by ci^{k2·n1 + off + k1}, ci = c^{-1}, off =
    d·n1_loc: local[W, n2, n1_loc] = ci^{k2·n1 + k1}, dev[:, d] =
    ci^{d·n1_loc}."""
    n1, n2 = split_log(n)
    if not inverse:
        c = shift % field.p
        rows, cols, stride = n1, n2 // D, n2
    else:
        c = inv_mod(shift, field.p)
        rows, cols, stride = n2, n1 // D, n1
    pw = host_powers_fast(field, c, (rows - 1) * stride + cols)
    idxm = np.arange(rows)[:, None] * stride + np.arange(cols)[None, :]
    local = np.ascontiguousarray(pw[:, idxm])
    dev = host_powers_fast(field, pow(c, cols, field.p), D)
    return local, dev


def _ring_transpose(C: list, n1: int, D: int) -> list:
    """The four-step transpose as D - 1 rotations of the buffers (buffer i
    moves to device i + 1): shard ``me`` takes its row block out of each
    buffer that passes and places it at the column block of the buffer's
    source."""
    W, _, n2_loc = C[0].shape
    n1_loc = n1 // D
    devs = [c.device for c in C]
    out = [torch.empty((W, n1_loc, D * n2_loc), dtype=torch.uint32,
                       device=dev) for dev in devs]
    bufs = list(C)
    for s in range(D):
        for me in range(D):
            src = (me - s) % D
            out[me][:, :, src * n2_loc:(src + 1) * n2_loc] = \
                bufs[me][:, me * n1_loc:(me + 1) * n1_loc, :]
        if s < D - 1:
            bufs = [bufs[(i - 1) % D].to(devs[i]) for i in range(D)]
    return out


def make_dist_ntt(field: Field, n: int, mesh: Mesh, inverse: bool = False,
                  mont_io: bool = True, algorithm: str = "jnp",
                  coset_shift: int | None = None,
                  exchange: str = "all_to_all", donate: bool = False):
    """Build a distributed NTT for (field, n, mesh): ``run(xs)`` takes the
    list of :func:`shard_for_ntt` (uint32[W, n1, n2/D] a shard) and returns
    one uint32[W, n2, n1/D] a shard holding X[k2·n1 + k1] at [:, k2, k1].

    Montgomery-form I/O by default; ``mont_io=False`` adds conversion
    passes. ``coset_shift`` evaluates on the coset shift·<ω_n> (the inverse
    interpolates from it, 1/n included). ``exchange``: "all_to_all",
    "ring" or "pallas" (kernel K8; a 1-D mesh only). ``algorithm``: the
    local transform, "jnp", "pallas", "mxu" or "mxu_sub". ``donate=True``
    hands the input list to the runner, which empties it, so that each
    input shard is freed once its column transforms have read it.

    Every table is built here, once, and kept on each shard's device: the
    local transforms' tables and matrices, one step-2 twiddle table a shard
    (the static ω^{k1·j} times the shard's ω^{k1·d·n2_loc}, multiplied on
    the device; the static table built once on the host up to
    ``core.HOST_TW_LIMIT`` entries, above it generated on each shard's
    device), the coset table a shard likewise (with n^{-1} in it for the
    inverse). A plan-only knob of the JAX package warns, as in
    ``api.get_runner``."""
    warn_plan_only_knobs()
    n1, n2 = split_log(n)
    D = _axis_size(mesh)
    if exchange not in EXCHANGES:
        raise ValueError(f"unknown exchange {exchange!r}; one of {EXCHANGES}")
    opt = exchange_options(n, mesh)[exchange]
    if not opt["eligible"]:
        raise ValueError(
            f"exchange={exchange!r} unavailable at n={n}, D={D}: "
            f"{opt['why']}"
            + ("; use exchange='all_to_all' or 'ring'"
               if exchange == "pallas" else ""))
    fn, prepare = _axis_fn(algorithm, field)
    p = field.p
    n1_loc, n2_loc = n1 // D, n2 // D
    omega = field.inv_root_of_unity(n) if inverse else field.root_of_unity(n)
    Ts = (power_table(field, omega, n1, n2_loc)
          if n1 * n2_loc <= core.HOST_TW_LIMIT else None)
    n_inv = field.to_mont_int(inv_mod(n, p)) if inverse else None
    coset = (None if coset_shift is None
             else coset_tables(field, n, D, coset_shift, inverse))

    # the local tables, built now with the peel of ``fn``; put on each
    # shard's device when it first runs
    host = {}
    for m, batch in ((n1, n2_loc), (n2, n1_loc)):
        if (m, batch == 1) not in host:
            host[(m, batch == 1)] = prepare(field, m, batch, inverse)
    aux_cache: dict = {}

    def local_aux(m: int, batch: int, dev):
        key = (m, batch == 1, str(dev))
        if key not in aux_cache:
            aux_cache[key] = aux_from_numpy(*host[(m, batch == 1)],
                                            device=dev)
        return aux_cache[key]

    def shard_tables(d: int, dev) -> dict:
        with _on(dev):
            t = {"tw": shard_twiddle(field, omega, n1, n2_loc, d, dev, Ts),
                 "a1": local_aux(n1, n2_loc, dev),
                 "a4": local_aux(n2, n1_loc, dev)}
            if coset is not None:
                scale = _device_scalar(coset[1], d).to(dev)
                if n_inv is not None:
                    scale = limbs.mont_mul(scale, limbs.const_planes(
                        n_inv, field, 2, device=dev), field)
                t["coset"] = limbs.mont_mul(
                    torch.from_numpy(coset[0]).to(dev), scale, field)
        return t

    tables = [[shard_tables(d, dev) for d, dev in enumerate(row)]
              for row in mesh.rows()]

    def transpose(C: list) -> list:
        if exchange == "pallas":
            return a2a_transpose(C, D)
        if exchange == "ring":
            return _ring_transpose(C, n1, D)
        return a2a_transpose_plain(C, D)

    def one_row(xs: list, row_tables: list) -> list:
        C = []
        for d, tab in enumerate(row_tables):
            x = xs[d]
            xs[d] = None
            with _on(x.device):
                if not mont_io:
                    with span("ntt.pass.to_mont"):
                        x = limbs.to_mont(x, field)
                if coset is not None and not inverse:
                    with span("ntt.pass.coset"):
                        x = limbs.mont_mul(x, tab["coset"], field)
                with span("ntt.dist.local"):
                    B = fn(x, field, inverse, tab["a1"])
                with span("ntt.dist.twiddle"):
                    C.append(limbs.mont_mul(B, tab["tw"], field))
        with span("ntt.dist.exchange"):
            Ca = transpose(C)
        del C, x, B
        out = []
        for d, tab in enumerate(row_tables):
            Cd = Ca[d]
            Ca[d] = None
            with _on(Cd.device):
                with span("ntt.copy"):
                    Ct = Cd.transpose(1, 2).contiguous()     # [W, n2, n1_loc]
                with span("ntt.dist.local"):
                    y = fn(Ct, field, inverse, tab["a4"])
                if coset is not None and inverse:
                    with span("ntt.pass.coset"):
                        y = limbs.mont_mul(y, tab["coset"], field)
                elif n_inv is not None:
                    with span("ntt.pass.scale"):
                        y = limbs.mont_mul(y, limbs.const_planes(
                            n_inv, field, 2, device=y.device), field)
                if not mont_io:
                    with span("ntt.pass.from_mont"):
                        y = limbs.from_mont(y, field)
                out.append(y)
        return out

    def run(xs) -> list:
        if len(xs) != D:
            raise ValueError(f"expected {D} shards, got {len(xs)}")
        rows = mesh.rows()
        inputs = [list(xs)] + [[x.to(dev) for x, dev in zip(xs, row)]
                               for row in rows[1:]]
        if donate:
            xs.clear()
        outs = [one_row(ins, tabs) for ins, tabs in zip(inputs, tables)]
        return outs[0]

    return run


_dist_cache: dict = {}


def _get(field: Field, n: int, mesh: Mesh, inverse: bool, mont_io: bool,
         algorithm: str = "jnp", exchange: str = "all_to_all",
         coset_shift: int | None = None):
    key = (field.name, n, mesh, inverse, mont_io, algorithm, exchange,
           coset_shift, config_key())
    if key not in _dist_cache:
        with span("ntt.runner.build"):
            _dist_cache[key] = make_dist_ntt(
                field, n, mesh, inverse, mont_io, algorithm,
                coset_shift=coset_shift, exchange=exchange)
    return _dist_cache[key]


def dist_ntt(x_sharded, field: Field, mesh: Mesh, n: int,
             mont_io: bool = True, algorithm: str = "jnp",
             exchange: str = "all_to_all") -> list:
    with span("ntt.api"):
        return _get(field, n, mesh, False, mont_io, algorithm,
                    exchange)(x_sharded)


def dist_intt(x_sharded, field: Field, mesh: Mesh, n: int,
              mont_io: bool = True, algorithm: str = "jnp",
              exchange: str = "all_to_all") -> list:
    with span("ntt.api"):
        return _get(field, n, mesh, True, mont_io, algorithm,
                    exchange)(x_sharded)


def dist_lde(x_sharded, field: Field, mesh: Mesh, n: int, blowup: int = 4,
             shift: int | None = None, algorithm: str = "jnp") -> list:
    """Distributed low-degree extension: interpolate the n sharded
    evaluations, zero-pad the coefficients to blowup·n, and evaluate on the
    coset domain; the re-layout between the two is plain copies.

    Input: the :func:`shard_for_ntt` list of size n, Montgomery form.
    Output: the coset evaluations in the distributed output layout for
    N = blowup·n, one uint32[W, N2, N1/D] a shard, value X[k2·N1 + k1]."""
    with span("ntt.api"):
        shift = field.generator if shift is None else shift
        N = blowup * n
        W = field.n_words
        coeffs = _get(field, n, mesh, True, True, algorithm)(x_sharded)
        # coeffs: [W, n2, n1_loc] a shard, natural order once gathered
        dev = coeffs[0].device
        flat = torch.cat([c.to(dev) for c in coeffs], dim=2).reshape(W, n)
        expanded = shard_for_ntt(torch.cat(
            [flat, flat.new_zeros((W, N - n))], dim=1), field, mesh)
        del coeffs, flat
        return _get(field, N, mesh, False, True, algorithm,
                    coset_shift=shift)(expanded)

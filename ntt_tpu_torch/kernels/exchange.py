"""Kernel K8: the four-step transpose exchange between the shards of a mesh
(port of ``ntt_tpu.kernels.exchange``).

Shard s holds C_s = uint32[W, n1, n2_loc]; :func:`a2a_transpose` returns,
for every shard t, uint32[W, n1_loc, D·n2_loc] (n1_loc = n1 / D) with::

    out_t[:, i, s*n2_loc + j] = C_s[:, t*n1_loc + i, j]

which is what the JAX entry returns inside ``shard_map``: the tiled
``all_to_all(split_axis=1, concat_axis=2)``. On CUDA shards it launches the
pull kernel of ``csrc/exchange.cu`` once per destination shard, on that
shard's device and current stream; the shards may lie on one card (D logical
shards) or on several, which then read each other over peer access. Where
every shard lies on the CPU it runs :func:`a2a_transpose_plain`.

The TPU kernel's barrier (no remote write before its target is ready) is
CUDA events here: each destination's stream waits for every source's
stream before its launch, and each source's stream waits for every launch
that read it, so that the caching allocator cannot hand the source memory
to later work early. ``Tensor.record_stream`` cannot say this, since it
does not cover a stream of another device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..tracing import span
from . import _build

#: the most shards a launch takes (its source pointers travel by value)
MAX_SHARDS = 16

#: ordered (device, peer) pairs of distinct cards with peer access enabled
_peers: set = set()


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("exchange")
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.exchange_enable_peer.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.exchange_enable_peer.restype = ctypes.c_int
    lib.exchange_a2a_pull.argtypes = [
        ctypes.POINTER(vp), ctypes.c_int, vp, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ll, ll, ctypes.c_int, vp]
    lib.exchange_a2a_pull.restype = ctypes.c_int
    return lib


def _shape(shards, D: int) -> tuple:
    """(W, n1, n2_loc) of the D shards, which must agree."""
    if len(shards) != D:
        raise ValueError(f"expected {D} shards, got {len(shards)}")
    first = shards[0]
    if first.dim() != 3 or first.shape[1] % D or first.shape[1] < D:
        raise ValueError(f"a shard must be uint32[W, n1, n2_loc] with D = {D} "
                         f"dividing n1, got {tuple(first.shape)}")
    for x in shards:
        if x.shape != first.shape or x.dtype != torch.uint32:
            raise ValueError(
                f"shards differ: {x.dtype}{tuple(x.shape)} beside "
                f"{first.dtype}{tuple(first.shape)} (uint32 expected)")
    return tuple(first.shape)


def a2a_transpose_plain(shards, D: int) -> list:
    """Plain PyTorch version of K8: slices, device copies and one
    concatenation a destination shard."""
    W, n1, n2_loc = _shape(shards, D)
    n1_loc = n1 // D
    return [torch.cat([c[:, t * n1_loc:(t + 1) * n1_loc, :].to(out.device)
                       for c in shards], dim=2)
            for t, out in enumerate(shards)]


def _enable_peers(devices) -> None:
    for dev in devices:
        for peer in devices:
            if dev == peer or (dev, peer) in _peers:
                continue
            rc = _lib().exchange_enable_peer(dev, peer)
            if rc != 0:
                raise RuntimeError(
                    f"K8: cuda:{dev} cannot read cuda:{peer} (peer access "
                    f"refused, CUDA error {rc}); the exchange does not stage "
                    "through the host")
            _peers.add((dev, peer))


def a2a_transpose(shards, D: int) -> list:
    """The four-step exchange of D shards C_s uint32[W, n1, n2_loc] -> one
    uint32[W, n1/D, D·n2_loc] on each shard's device (see the module
    docstring)."""
    W, n1, n2_loc = _shape(shards, D)
    if all(x.device.type == "cpu" for x in shards):
        return a2a_transpose_plain(shards, D)
    with span("ntt.launch.a2a_transpose"):
        if any(x.device.type != "cuda" for x in shards):
            raise ValueError(
                "K8 takes shards all on CUDA devices or all on the CPU, "
                f"got {[str(x.device) for x in shards]}")
        if D > MAX_SHARDS:
            raise ValueError(f"K8 takes at most {MAX_SHARDS} shards, got {D}")
        for x in shards:
            if not x.is_contiguous():
                raise ValueError("K8 takes contiguous shards")
        n1_loc = n1 // D
        devs = [x.device for x in shards]
        cards = sorted({d.index for d in devs})
        multi = len(cards) > 1
        ready = []
        if multi:
            _enable_peers(cards)
            for x in shards:
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(x.device))
                ready.append(ev)
        vec = int(n2_loc % 4 == 0
                  and all(x.data_ptr() % 16 == 0 for x in shards))
        srcs = (ctypes.c_void_p * D)(*[x.data_ptr() for x in shards])
        outs, done = [], []
        for t, dev in enumerate(devs):
            stream = torch.cuda.current_stream(dev)
            for s, ev in enumerate(ready):
                if devs[s] != dev:
                    stream.wait_event(ev)
            out = torch.empty((W, n1_loc, D * n2_loc), dtype=torch.uint32,
                              device=dev)
            rc = _lib().exchange_a2a_pull(
                srcs, D, _build.ptr(out), dev.index, t, W, n1, n2_loc, vec,
                ctypes.c_void_p(stream.cuda_stream))
            _build.check(rc, "a2a_transpose")
            _build.launches["a2a_transpose"] += 1
            if multi:
                ev = torch.cuda.Event()
                ev.record(stream)
                done.append(ev)
            outs.append(out)
        for x in (shards if multi else ()):
            stream = torch.cuda.current_stream(x.device)
            for t, ev in enumerate(done):
                if devs[t] != x.device:
                    stream.wait_event(ev)
        return outs

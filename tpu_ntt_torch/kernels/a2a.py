"""Kernel K6 on the card: the tiled all-to-all of the four-step's stage exchange.

``all_to_all(shards, split_from_end)`` is ``jax.lax.all_to_all(..., tiled=True)``
over one mesh axis, as ``tpu_ntt.sharded._a2a_pallas_leaf`` (K6,
tpu_ntt/sharded.py:580, its ``pallas_call`` at :669) computes it inside
``shard_map``; here the D shards of the axis are D tensors in one process,
each on its own device (or all on one card, as logical shards).  Every
shard is a (..., rows, cols) leaf of one shape and dtype:

* ``split_from_end=2`` (the forward exchange): block t of source s, its rows
  [t * rows / D, (t + 1) * rows / D), lands in columns [s * cols, (s + 1) *
  cols) of output t, a (..., rows / D, cols * D) leaf;
* ``split_from_end=1`` (the inverse): block t, source s's columns
  [t * cols / D, (t + 1) * cols / D), lands in rows [s * rows, (s + 1) *
  rows) of output t, a (..., rows * D, cols / D) leaf.

On CUDA shards it launches ``a2a_exchange`` of ``csrc/a2a.cu`` once per
source, on the source's device and current stream, and counts each launch in
``launches``; on CPU shards it runs ``all_to_all_plain``, the same function
as D^2 ``Tensor.copy_`` calls of block views, which runs on any devices and
is what ``ShardedNtt(fused_exchange=False)`` runs.  Shards on CPU and CUDA
at once, or on any other device, raise; nothing falls back.

The TPU kernel's barrier (:625-634) becomes stream order.  With every shard
on one card, one stream orders everything.  Across cards, each source's
stream waits on an event recorded on every destination's stream once the
outputs exist, and each destination's stream waits on every source's event
after the launches; an output written from another card's stream is
``record_stream``-ed to it for the caching allocator.  Two cards without
peer access raise ``RuntimeError``: nothing is copied through the host.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _plan

MAX_PEERS = 16  # csrc/a2a.cu's kMaxPeers: the destination pointers a launch carries
KERNELS = ("a2a_exchange",)
#: launches of the kernel in this process; a caller that must show a run went
#: through it zeroes the count first
launches = dict.fromkeys(KERNELS, 0)


class Peers(ctypes.Structure):
    """csrc/a2a.cu's ``Peers``: the destination pointers, passed by value."""

    _fields_ = [("dst", ctypes.c_void_p * MAX_PEERS)]


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed and load ``csrc/a2a.cu``, its entry points typed as
    declared there."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    return _plan.bind("a2a", {
        "exchange": [ptr, Peers] + [i32] * 7 + [ptr],
        "peer_access": [i32],
    })


def out_shape(shape, peers: int, split_from_end: int) -> tuple:
    """The shape of every output of an exchange of ``shape`` leaves."""
    *lead, rows, cols = shape
    if split_from_end == 2:
        return (*lead, rows // peers, cols * peers)
    return (*lead, rows * peers, cols // peers)


def _check(shards, split_from_end: int) -> None:
    if split_from_end not in (1, 2):
        raise ValueError(f"split_from_end must be 1 or 2, got {split_from_end}")
    if not shards:
        raise ValueError("an exchange needs at least one shard")
    first, peers = shards[0], len(shards)
    if first.dim() < 2:
        raise ValueError(f"a shard must have rows and columns, got {tuple(first.shape)}")
    for s in shards:
        if s.shape != first.shape or s.dtype != first.dtype:
            raise ValueError(f"the shards differ: {tuple(s.shape)} {s.dtype} against "
                             f"{tuple(first.shape)} {first.dtype}")
    split = first.shape[-split_from_end]
    if split % peers:
        raise ValueError(f"{peers} shards do not divide the split axis of "
                         f"{split} ({'rows' if split_from_end == 2 else 'columns'})")
    kinds = {s.device.type for s in shards}
    if not kinds <= {"cpu", "cuda"}:
        raise ValueError(f"no exchange for devices {sorted(kinds)}: CPU or CUDA shards only")
    if kinds == {"cpu", "cuda"}:
        raise ValueError("the shards lie on the CPU and on CUDA devices at once")


def all_to_all(shards: list, split_from_end: int) -> list:
    """The exchange of D same-shaped (..., rows, cols) shards (the module
    docstring's layout): ``a2a_exchange`` on CUDA shards, the plain version
    on CPU shards."""
    _check(shards, split_from_end)
    if shards[0].device.type == "cpu":
        return all_to_all_plain(shards, split_from_end)
    peers = len(shards)
    if peers > MAX_PEERS:
        raise ValueError(f"a2a_exchange takes at most {MAX_PEERS} shards, got {peers}")
    if shards[0].element_size() not in (4, 8):
        raise TypeError(f"a2a_exchange copies 4- or 8-byte words, got {shards[0].dtype}")
    shards = [s.contiguous() for s in shards]
    shape = out_shape(shards[0].shape, peers, split_from_end)
    outs = [torch.empty(shape, dtype=s.dtype, device=s.device) for s in shards]
    if not shards[0].numel():
        return outs  # nothing to copy: no launch
    devices = list(dict.fromkeys(s.device for s in shards))
    cross = len(devices) > 1
    if cross:
        _peer_access(devices)
        ready = [_recorded(d) for d in devices]  # the outputs exist on every card
    *lead, rows, cols = shards[0].shape
    batch = 1
    for k in lead:
        batch *= k
    dsts = Peers()
    for t, o in enumerate(outs):
        dsts.dst[t] = o.data_ptr()
    lib, done = load(), {}
    for me, src in enumerate(shards):
        stream = torch.cuda.current_stream(src.device)
        if cross and src.device not in done:
            for event in ready:
                stream.wait_event(event)
        _plan.launch("a2a", lib, "exchange", launches, src, src, dsts, peers, me, batch,
                     rows, cols, src.element_size(), split_from_end)
        done[src.device] = stream
    if cross:
        events = [_recorded(d) for d in done]
        for o in outs:
            own = torch.cuda.current_stream(o.device)
            for event in events:
                own.wait_event(event)
            for device, stream in done.items():
                if device != o.device:
                    o.record_stream(stream)
    return outs


def _recorded(device: torch.device) -> torch.cuda.Event:
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


@functools.lru_cache(maxsize=None)
def _enable(device: int, peer: int) -> None:
    with torch.cuda.device(device):
        err = load().a2a_peer_access(peer)
    if err:
        message = load().a2a_error_string(err).decode()
        raise RuntimeError(f"a2a_peer_access({device} -> {peer}) failed: {message}")


def _peer_access(devices: list) -> None:
    """Let every card's kernels write to every other's memory, or raise."""
    for d in devices:
        for e in devices:
            if d == e:
                continue
            if not torch.cuda.can_device_access_peer(d.index, e.index):
                raise RuntimeError(f"{d} cannot write to {e}'s memory (no peer access): "
                                   "the exchange copies through no host")
            _enable(d.index, e.index)


def all_to_all_plain(shards: list, split_from_end: int) -> list:
    """The plain version of ``all_to_all`` on any devices: D^2 copies of
    block views, each into its destination's device."""
    _check(shards, split_from_end)
    peers = len(shards)
    shape = out_shape(shards[0].shape, peers, split_from_end)
    outs = [torch.empty(shape, dtype=s.dtype, device=s.device) for s in shards]
    for me, src in enumerate(shards):
        for t, out in enumerate(outs):
            if split_from_end == 2:
                rows = shape[-2]
                out[..., me * src.shape[-1]:(me + 1) * src.shape[-1]].copy_(
                    src[..., t * rows:(t + 1) * rows, :])
            else:
                cols = shape[-1]
                out[..., me * src.shape[-2]:(me + 1) * src.shape[-2], :].copy_(
                    src[..., t * cols:(t + 1) * cols])
    return outs

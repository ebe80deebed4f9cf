"""One-sync device->host result fetching.

Every blocking wait on the card is a host sync; a fragment's result is
a small tree of tensors (states per aggregate, counts), and fetching
each with its own `.cpu()` would add one sync per tensor. `prefetch`
starts ONE non-blocking copy per CUDA tensor into pinned host memory
and records ONE event behind them; the first `host_array` on any
member of that tree waits on the event (one counted sync) and every
other member then reads from host memory that is already filled.

The seam counts what it moves into the statement's phase counters
(utils/phase.py): `syncs` (blocking waits on the card), `fetches` and
`fetch_bytes` (device->host copies). CPU tensors need no wait and are
not counted as syncs.

Reference analog: pkg/store/copr/coprocessor.go's copIterator overlaps
region responses the same way (streamed, not lock-step).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from . import phase


class _Ticket:
    """The event behind one prefetch call's copies."""

    __slots__ = ("event", "done")

    def __init__(self, event):
        self.event = event
        self.done = False

    def wait(self):
        if not self.done:
            t0 = time.perf_counter()
            self.event.synchronize()
            phase.add("sync_s", time.perf_counter() - t0)
            phase.inc("syncs")
            self.done = True


class _Fetched:
    """A CUDA tensor whose copy into pinned host memory is in flight."""

    __slots__ = ("host", "ticket")

    def __init__(self, host, ticket):
        self.host = host
        self.ticket = ticket


def host_array(x):
    """THE designated device->host materialization seam: a prefetched
    member waits on its tree's one event, an un-prefetched CUDA tensor
    pays its own counted sync, a CPU tensor or numpy array is read in
    place."""
    if isinstance(x, _Fetched):
        x.ticket.wait()
        return x.host.numpy()
    if isinstance(x, torch.Tensor):
        if x.device.type == "cuda":
            t0 = time.perf_counter()
            out = x.cpu()
            phase.add("sync_s", time.perf_counter() - t0)
            phase.inc("syncs")
            phase.inc("fetches")
            phase.add("fetch_bytes", out.numel() * out.element_size())
            return out.numpy()
        return x.numpy()
    return np.asarray(x)


def host_int(x) -> int:
    """An int read (group counts, survivor counts) through host_array:
    a prefetched member costs its tree's one wait, not a sync of its
    own."""
    return int(host_array(x))


def prefetch(tree):
    """Start non-blocking copies of every CUDA tensor in a result tree
    (dict/list/tuple nests; anything else passes through) into pinned
    host memory, behind one recorded event. Returns the same tree with
    each CUDA tensor replaced by its in-flight copy, which host_array
    reads after one wait."""
    cuda = []
    _collect(tree, cuda)
    if not cuda:
        return tree
    ticket = _Ticket(torch.cuda.Event())
    copies = {}
    nbytes = 0
    for t in cuda:
        if id(t) in copies:
            continue
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        copies[id(t)] = _Fetched(h, ticket)
        nbytes += h.numel() * h.element_size()
    ticket.event.record()
    phase.add("fetches", len(copies))
    phase.add("fetch_bytes", nbytes)
    return _replace(tree, copies)


def _collect(x, out):
    if isinstance(x, dict):
        for v in x.values():
            _collect(v, out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _collect(v, out)
    elif isinstance(x, torch.Tensor) and x.device.type == "cuda":
        out.append(x)


def _replace(x, copies):
    if isinstance(x, dict):
        return {k: _replace(v, copies) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_replace(v, copies) for v in x)
    if isinstance(x, torch.Tensor) and id(x) in copies:
        return copies[id(x)]
    return x

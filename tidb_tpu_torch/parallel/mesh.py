"""Device mesh, row placement and collectives in one process (reference
tidb_tpu/parallel/mesh.py, whose analog is the MPP task/store topology
— pkg/kv/mpp.go task placement — re-expressed as a jax Mesh).

A Mesh is an ordered tuple of torch devices on the one axis "dp". A
device may repeat: N shards on one card are what the reference's N
virtual CPU devices are (--xla_force_host_platform_device_count), so a
mesh program runs the same per-shard body N times and merges with a
collective.

Placement:
  Sharded     the row-partitioned buffer: shard i holds rows
              [i * local, (i + 1) * local) on devices[i]. When every
              shard is on one device the buffer is ONE contiguous
              padded tensor and the shards are views of it.
  Replicated  the Broadcast placement: one full copy per distinct
              device of the mesh.

Collectives (the torch forms of jax.lax.psum / pmax / pmin /
all_to_all over the mesh axis): each takes one tensor per shard, in
shard order, and leaves its result on devices[0], the coordinator.
With every shard on one card they are device tensor ops with no host
round trip; shards on separate devices of one process copy with
.to(device, non_blocking=True). psum adds the partials in shard order
0..N-1, so a float result does not depend on timing."""
from __future__ import annotations

import numpy as np
import torch

from ..chunk.device import upload


class Mesh:
    """Ordered devices on one named axis."""

    def __init__(self, devices, axis: str = "dp"):
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        self.devices = devs
        self.axis_names = (axis,)

    @property
    def size(self) -> int:
        return len(self.devices)

    def distinct(self) -> tuple:
        """The mesh's devices without repeats, in mesh order."""
        return tuple(dict.fromkeys(self.devices))

    def fingerprint(self):
        return (tuple(str(d) for d in self.devices), self.axis_names)

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]}, {self.axis_names})"


def make_mesh(n_devices: int | None = None, devices=None,
              axis: str = "dp") -> Mesh:
    """Mesh over `devices` (default: every visible CUDA device), cut to
    the first `n_devices`."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"mesh of {n_devices} over {len(devices)} "
                             "devices")
        devices = devices[:n_devices]
    return Mesh(devices, axis)


def mesh_of(spec, device) -> Mesh | None:
    """A Domain's mesh argument -> Mesh: a Mesh as is, an int n as n
    shards on `device`, None as every visible CUDA device."""
    if isinstance(spec, Mesh):
        return spec
    if spec is None:
        return make_mesh()
    return make_mesh(devices=[torch.device(device)] * int(spec))


class Sharded:
    """A row-sharded buffer (see the module docstring)."""

    spec = "sharded"

    def __init__(self, mesh: Mesh, shards, full=None):
        self.mesh = mesh
        self.shards = tuple(shards)
        self.full = full
        self.local = int(self.shards[0].shape[0])
        self.dtype = self.shards[0].dtype

    def numel(self) -> int:
        return sum(s.numel() for s in self.shards)

    def element_size(self) -> int:
        return self.shards[0].element_size()

    def __len__(self):
        return self.local * self.mesh.size

    def patched(self, tail: np.ndarray, off: int) -> "Sharded":
        """A fresh buffer with rows [off, off + len(tail)) replaced by
        `tail`, in the same placement (the old one is never written: a
        statement may still read it)."""
        if self.full is not None:
            nf = self.full.clone()
            nf[off:off + len(tail)] = upload(tail, nf.device)
            return _split(self.mesh, nf)
        out = []
        for i, s in enumerate(self.shards):
            lo, hi = i * self.local, (i + 1) * self.local
            a, b = max(lo, off), min(hi, off + len(tail))
            if a >= b:
                out.append(s)
                continue
            ns = s.clone()
            ns[a - lo:b - lo] = upload(tail[a - off:b - off], ns.device)
            out.append(ns)
        return Sharded(self.mesh, out)

    def numpy(self) -> np.ndarray:
        """The whole buffer on the host (tests and debugging)."""
        return np.concatenate([s.cpu().numpy() for s in self.shards])


class Replicated:
    """A full copy on every distinct device of the mesh."""

    spec = "replicated"

    def __init__(self, mesh: Mesh, copies: dict):
        self.mesh = mesh
        self.copies = copies            # str(device) -> tensor
        self.dtype = next(iter(copies.values())).dtype

    def on(self, device) -> torch.Tensor:
        return self.copies[str(torch.device(device))]

    def numel(self) -> int:
        return next(iter(self.copies.values())).numel()

    def element_size(self) -> int:
        return next(iter(self.copies.values())).element_size()

    def patched(self, tail: np.ndarray, off: int) -> "Replicated":
        out = {}
        for k, t in self.copies.items():
            nt = t.clone()
            nt[off:off + len(tail)] = upload(tail, nt.device)
            out[k] = nt
        return Replicated(self.mesh, out)

    def numpy(self) -> np.ndarray:
        return next(iter(self.copies.values())).cpu().numpy()


def placed(x) -> bool:
    return isinstance(x, (Sharded, Replicated))


def _split(mesh: Mesh, full: torch.Tensor) -> Sharded:
    local = full.shape[0] // mesh.size
    return Sharded(mesh, [full[i * local:(i + 1) * local]
                          for i in range(mesh.size)], full)


def place_sharded(mesh: Mesh, arr: np.ndarray) -> Sharded:
    """Host array (rows divisible by the mesh size) -> Sharded."""
    n = mesh.size
    if arr.shape[0] % n:
        raise ValueError(f"{arr.shape[0]} rows do not split over {n} "
                         "shards")
    if len(mesh.distinct()) == 1:
        return _split(mesh, upload(arr, mesh.devices[0]))
    local = arr.shape[0] // n
    return Sharded(mesh, [upload(arr[i * local:(i + 1) * local], d)
                          for i, d in enumerate(mesh.devices)])


def place_replicated(mesh: Mesh, arr: np.ndarray) -> Replicated:
    return Replicated(mesh, {str(d): upload(arr, d)
                             for d in mesh.distinct()})


def shard_rows(mesh: Mesh, arr, pad_fill=0) -> Sharded:
    """Place a host array row-sharded across the mesh (pads to a
    multiple of the mesh size)."""
    arr = np.asarray(arr)
    pad = (-arr.shape[0]) % mesh.size
    if pad:
        arr = np.concatenate([arr, np.full((pad,) + arr.shape[1:],
                                           pad_fill, dtype=arr.dtype)])
    return place_sharded(mesh, arr)


def replicate(mesh: Mesh, arr) -> Replicated:
    return place_replicated(mesh, np.asarray(arr))


# ---- collectives ------------------------------------------------------

def _to(t, device):
    return t if t.device == device else t.to(device, non_blocking=True)


def psum(parts, mesh: Mesh) -> torch.Tensor:
    """Sum of the shards' partials, added in shard order on devices[0]."""
    dev = mesh.devices[0]
    acc = _to(parts[0], dev)
    for p in parts[1:]:
        acc = acc + _to(p, dev)
    return acc


def pmax(parts, mesh: Mesh) -> torch.Tensor:
    dev = mesh.devices[0]
    acc = _to(parts[0], dev)
    for p in parts[1:]:
        acc = torch.maximum(acc, _to(p, dev))
    return acc


def pmin(parts, mesh: Mesh) -> torch.Tensor:
    dev = mesh.devices[0]
    acc = _to(parts[0], dev)
    for p in parts[1:]:
        acc = torch.minimum(acc, _to(p, dev))
    return acc


def all_to_all(frames, mesh: Mesh) -> list:
    """frames[s] is shard s's [ndev_dst, cap] send frame; -> one
    [ndev_src, cap] receive frame per destination shard d, row s being
    what shard s sent to d, on devices[d]."""
    n = mesh.size
    if len(mesh.distinct()) == 1:
        # one card: swap the [src, dst, cap] axes of the stacked frames
        swapped = torch.stack(list(frames)).transpose(0, 1)
        return [swapped[d] for d in range(n)]
    return [torch.stack([_to(frames[s][d], mesh.devices[d])
                         for s in range(n)]) for d in range(n)]


# ---- programs -----------------------------------------------------------

def local_args(tree, i: int, device):
    """Shard i's view of a program's argument tree: a Sharded leaf gives
    its i-th shard, a Replicated leaf its copy on `device`; dicts, lists
    and tuples recurse and anything else passes through."""
    if isinstance(tree, Sharded):
        return tree.shards[i]
    if isinstance(tree, Replicated):
        return tree.on(device)
    if isinstance(tree, dict):
        return {k: local_args(v, i, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(local_args(v, i, device) for v in tree)
    return tree


def shard_map(mesh: Mesh, body_for, merge):
    """The torch form of a shard_map program: ONE callable that runs the
    per-shard body on every shard's arguments, in shard order, then
    `merge(outputs)` (a collective, or the per-shard partials moved to
    devices[0]). body_for(device) builds the body for one device; shards
    on one device share it."""
    bodies = {d: body_for(d) for d in mesh.distinct()}

    def program(*args):
        outs = [bodies[d](*local_args(args, i, d))
                for i, d in enumerate(mesh.devices)]
        return merge(outs)
    return program


def to_coordinator(tree, mesh: Mesh):
    """Move every tensor of a result tree to devices[0] (the PassThrough
    exchange of per-shard partials), so one prefetch covers it."""
    dev = mesh.devices[0]
    if isinstance(tree, dict):
        return {k: to_coordinator(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_coordinator(v, mesh) for v in tree)
    if isinstance(tree, torch.Tensor):
        return _to(tree, dev)
    return tree

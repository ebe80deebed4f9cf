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
0..N-1, so a float result does not depend on timing.

A GroupMesh spans the processes of one torch.distributed group
(parallel/dist.py: init_distributed, global_mesh): this process holds
its local shards, `size` counts every process's, and process r's shards
are block r of the global shard order. Its collectives merge the local
shards in shard order first, then cross the group: psum, pmax and pmin
as dist.all_reduce (SUM, MAX, MIN), all_to_all as one
dist.all_to_all_single over the [src, dst, cap] frames. On the gloo
backend a collective on CUDA tensors is staged through pinned host
memory by the fetch seam (utils/fetch.py prefetch: one counted sync for
a whole batch of tensors, phase counter `collective_stage_bytes`), and
its result stays on the host: an all-reduced partial is then already
fetched, so the stage is the statement's one sync. gloo's own CUDA
paths would copy through the host too, with a wait on the card that no
counter sees."""
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


class GroupMesh(Mesh):
    """A mesh over every process of one torch.distributed group:
    `devices` are this process's shards, `size` the shards of all
    `world` processes, and rank r's shards are global positions
    [r * len(devices), (r + 1) * len(devices))."""

    def __init__(self, devices, rank: int, world: int, backend: str,
                 axis: str = "dp"):
        super().__init__(devices, axis)
        self.rank = rank
        self.world = world
        self.backend = backend

    @property
    def size(self) -> int:
        return len(self.devices) * self.world

    def fingerprint(self):
        return (super().fingerprint(), self.rank, self.world, self.backend)

    def __repr__(self):
        return (f"GroupMesh({[str(d) for d in self.devices]}, rank "
                f"{self.rank} of {self.world}, {self.backend})")


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

    def gather(self, device) -> torch.Tensor:
        """The whole buffer as one tensor on `device`: the contiguous
        buffer itself when every shard lies on one device (a copy only
        when that is another device), else the shards copied over
        (non-blocking) and concatenated in shard order."""
        device = torch.device(device)
        if self.full is not None:
            return _to(self.full, device)
        return torch.cat([_to(s, device) for s in self.shards])

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


_LOCAL = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum}


def _local_merge(parts, op, dev):
    acc = _to(parts[0], dev)
    for p in parts[1:]:
        acc = _LOCAL[op](acc, _to(p, dev))
    return acc


def merge_parts(batch, mesh: Mesh) -> list:
    """Several collectives in one: `batch` is [(parts, op)], parts one
    tensor per local shard in shard order, op "sum" | "max" | "min".
    -> the merged tensor of each entry, on devices[0] (a GroupMesh over
    gloo: on the host). Local shards merge in shard order; a GroupMesh
    then all-reduces the whole batch across the group with one stage."""
    dev = mesh.devices[0]
    merged = [_local_merge(parts, op, dev) for parts, op in batch]
    if not isinstance(mesh, GroupMesh):
        return merged
    return _all_reduce(mesh, merged, [op for _parts, op in batch])


def psum(parts, mesh: Mesh) -> torch.Tensor:
    """Sum of the shards' partials, added in shard order on devices[0]."""
    return merge_parts([(parts, "sum")], mesh)[0]


def pmax(parts, mesh: Mesh) -> torch.Tensor:
    return merge_parts([(parts, "max")], mesh)[0]


def pmin(parts, mesh: Mesh) -> torch.Tensor:
    return merge_parts([(parts, "min")], mesh)[0]


def all_to_all(frames, mesh: Mesh) -> list:
    """frames[s] is shard s's [ndev_dst, cap] send frame; -> one
    [ndev_src, cap] receive frame per destination shard d, row s being
    what shard s sent to d, on devices[d]."""
    return all_to_all_frames([frames], mesh)[0]


def all_to_all_frames(kinds, mesh: Mesh) -> list:
    """all_to_all of several frame kinds at once (a shuffle's keys,
    validity and values): kinds[k] is the per-local-shard frames of one
    kind, all [size, cap]. On a GroupMesh every kind crosses the group
    in one dist.all_to_all_single, each kind carried as int64 bits
    (_frame_bits) and given back its own type."""
    if isinstance(mesh, GroupMesh):
        return _group_all_to_all(kinds, mesh)
    n = mesh.size
    out = []
    for frames in kinds:
        if len(mesh.distinct()) == 1:
            # one card: swap the [src, dst, cap] axes of the stacked frames
            swapped = torch.stack(list(frames)).transpose(0, 1)
            out.append([swapped[d] for d in range(n)])
        else:
            out.append([torch.stack([_to(frames[s][d], mesh.devices[d])
                                     for s in range(n)])
                        for d in range(n)])
    return out


# ---- collectives across processes (GroupMesh) ------------------------

def _stage(mesh: GroupMesh, tensors) -> list:
    """The tensors as the group's backend takes them: on gloo, CUDA
    tensors fetched into pinned host memory, the whole batch behind one
    counted sync (utils/fetch.py); anything else as it is."""
    if mesh.backend != "gloo" or \
            not any(t.device.type == "cuda" for t in tensors):
        return list(tensors)
    from ..utils import phase
    from ..utils.fetch import host_array, prefetch
    fetched = prefetch(list(tensors))
    out = [torch.from_numpy(host_array(f)) for f in fetched]
    phase.inc("collective_stages")
    phase.add("collective_stage_bytes",
              sum(t.numel() * t.element_size() for t in out))
    return out


def _dist_op(op):
    import torch.distributed as dist
    return {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
            "min": dist.ReduceOp.MIN}[op]


def _all_reduce(mesh: GroupMesh, tensors, ops) -> list:
    import torch.distributed as dist
    out = []
    for t, op in zip(_stage(mesh, tensors), ops):
        # all_reduce writes in place: into a copy, never into the
        # program's own output, and never into a staged buffer that
        # another entry shares (a count state and the row count are
        # one tensor, and prefetch copies a tensor once)
        buf = t.reshape(-1).clone()
        dist.all_reduce(buf, op=_dist_op(op))
        out.append(buf.reshape(t.shape))
    return out


def _frame_bits(t):
    """A frame as int64 for the one all_to_all_single, losslessly:
    8-byte types bit for bit, narrower floats through float64, bool and
    narrower integers widened."""
    if t.dtype == torch.int64:
        return t
    if t.dtype.itemsize == 8:
        return t.view(torch.int64)
    if t.dtype.is_floating_point:
        return t.to(torch.float64).view(torch.int64)
    return t.to(torch.int64)


def _frame_back(t, dtype):
    """_frame_bits undone."""
    if dtype == torch.int64:
        return t
    if dtype.itemsize == 8:
        return t.view(dtype)
    if dtype.is_floating_point:
        return t.view(torch.float64).to(dtype)
    return t.to(dtype)


def _group_all_to_all(kinds, mesh: GroupMesh) -> list:
    import torch.distributed as dist
    loc, world, nk = len(mesh.devices), mesh.world, len(kinds)
    dev = mesh.devices[0]
    dtypes = [frames[0].dtype for frames in kinds]
    cap = int(kinds[0][0].shape[1])
    # [kind, src, dst process, dst shard, cap] -> [dst process, ...]
    send = torch.stack([torch.stack([_frame_bits(_to(f, dev))
                                     for f in frames])
                        for frames in kinds])
    send = send.view(nk, loc, world, loc, cap).permute(2, 0, 1, 3, 4)
    send = _stage(mesh, [send.contiguous()])[0]
    recv = torch.empty(send.shape, dtype=send.dtype, device=send.device,
                       pin_memory=send.device.type == "cpu" and
                       dev.type == "cuda")
    dist.all_to_all_single(recv, send)
    if recv.device != dev:
        recv = recv.to(dev, non_blocking=True)
    # recv[src process, kind, src shard, dst shard, cap]: destination d's
    # frame is every source's row, in global source order
    return [[_frame_back(recv[:, k, :, d, :].reshape(world * loc, cap),
                         dtypes[k])
             for d in range(loc)] for k in range(nk)]


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

"""Placement specs of the mesh (reference tidb_tpu/parallel/dist.py:23-49).

In the reference these are jax NamedShardings; here each is a spec the
upload seam reads (copr/dag_exec.py:_upload_padded) to place a padded
host array: "sharded" row-partitions it over the mesh, "replicated"
copies it to every device. Every sharded upload (mesh columns, shuffle
inputs, validity masks) builds its placement here, so the residency
store's "sharded" entries all mean the same thing.

The multi-process half (reference :52-130): every cluster worker joins
ONE torch.distributed process group (init_distributed), a fragment is
one program per rank over the group's mesh (global_mesh, a GroupMesh),
and each rank binds its own store shard as its local shards of that
mesh (bind_host_rows). The backend is a rule on the layout, never a
fallback on failure (backend_for, over every rank's card as the
group's store reports it): nccl when every rank has a card of its own,
gloo otherwise (the CPU, and several ranks on one card, which NCCL
refuses). A rank's shards live on its Domain's device, which is also
its device in the group."""
from __future__ import annotations

from datetime import timedelta

import numpy as np
import torch

from ..chunk.device import upload
from ..utils import phase
from .mesh import GroupMesh, Mesh, Sharded, place_replicated, place_sharded


class Placement:
    """Where a host array goes on a mesh: kind "sharded" | "replicated"."""

    __slots__ = ("kind", "mesh")

    def __init__(self, kind: str, mesh: Mesh):
        self.kind = kind
        self.mesh = mesh

    def place(self, arr):
        if self.kind == "sharded":
            return place_sharded(self.mesh, arr)
        return place_replicated(self.mesh, arr)


def row_sharding(mesh: Mesh) -> Placement:
    """THE row-partitioned placement: one shard of the row axis per
    mesh position."""
    return Placement("sharded", mesh)


def replicated_sharding(mesh: Mesh) -> Placement:
    """Broadcast-exchange placement: a full copy on every device."""
    return Placement("replicated", mesh)


def sharding_tree(tree, mesh: Mesh):
    """Per-leaf placement for a tree (dict / list / tuple) of arrays:
    row arrays (ndim >= 1) partition over the row axis, scalars
    replicate."""
    if isinstance(tree, dict):
        return {k: sharding_tree(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(sharding_tree(v, mesh) for v in tree)
    nd = getattr(tree, "ndim", 0)
    return row_sharding(mesh) if nd else replicated_sharding(mesh)


# this process's place in its group, set once by init_distributed (the
# process group itself is process-global in torch.distributed)
_GROUP: dict = {}
# a collective that a peer never joins (a rank that raised before it)
# fails after this long instead of blocking its peers forever
_TIMEOUT = timedelta(seconds=120)


def card_id(device) -> str:
    """The card a device is on, comparable across processes: its UUID
    on cuda, "cpu" on the host."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    return str(torch.cuda.get_device_properties(device).uuid)


def backend_for(cards) -> str:
    """The layout rule over every rank's card_id, in rank order: nccl
    when each rank is on a card and no two ranks share one, else gloo
    (CPU ranks, or several ranks on one card, which NCCL refuses)."""
    cards = list(cards)
    if "cpu" not in cards and len(set(cards)) == len(cards):
        return "nccl"
    return "gloo"


def init_distributed(coordinator_address: str, num_processes: int,
                     process_id: int, device="cpu",
                     local_shards: int = 1) -> dict:
    """Join the group on this rank's own `device` (the worker's Domain
    device): every rank publishes its card_id in the group's TCP store
    at coordinator_address (process 0 hosts it), reads every other's,
    and takes backend_for's answer, the same on every rank; then
    torch.distributed.init_process_group over that store with _TIMEOUT,
    so a rank that raises before a collective cannot block its peers
    forever. Idempotent per process.
    `local_shards`: this process's shards of the global mesh. -> the
    group's layout: rank, world, backend, device, local_shards."""
    import torch.distributed as dist
    if _GROUP:
        return dict(_GROUP)
    dev = torch.device(device)
    host, port = coordinator_address.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), num_processes,
                          process_id == 0, timeout=_TIMEOUT)
    store.set(f"card/{process_id}", card_id(dev))
    backend = backend_for(store.get(f"card/{r}").decode()
                          for r in range(num_processes))
    if backend == "nccl" and dev.index is not None:
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=store,
                            world_size=num_processes, rank=process_id,
                            timeout=_TIMEOUT)
    # tpulint: disable=shared-state-race — a process joins its group
    # once, from its main thread, before it serves any connection
    _GROUP.update(rank=process_id, world=num_processes, backend=backend,
                  device=str(dev), local_shards=int(local_shards))
    return dict(_GROUP)


def shutdown_distributed():
    """Leave the group (tests that form one in their own process)."""
    import torch.distributed as dist
    if _GROUP:
        # tpulint: disable=shared-state-race — the main thread leaves
        # the group after its connections are done
        _GROUP.clear()
        dist.destroy_process_group()


def global_mesh(axis: str = "dp") -> GroupMesh:
    """The group's mesh: this process's local shards plus the group, in
    rank order. Rank r's rows are block r of the global layout, as
    jax.devices() orders the reference's devices by process — the row
    layout of bind_host_rows is [rank0 rows | rank1 rows | ...]."""
    if not _GROUP:
        raise RuntimeError("global_mesh before init_distributed")
    g = _GROUP
    return GroupMesh([torch.device(g["device"])] * g["local_shards"],
                     g["rank"], g["world"], g["backend"], axis)


def local_row_cap(n_rows: int, mesh: Mesh) -> int:
    """Smallest per-process row capacity >= n_rows divisible by the
    local shard count. Every process must agree on ONE cap (static
    shapes); the coordinator takes the max over workers and broadcasts
    it."""
    ld = max(1, len(mesh.devices))
    return -(-max(n_rows, 1) // ld) * ld


def bind_host_rows(mesh: Mesh, arr, local_cap: int) -> Sharded:
    """This process's rows as its local shards of the group's Sharded
    buffer: padded with zero rows to local_cap (which must be identical
    on every process and divisible by the local shard count), so callers
    pass a validity mask bound the same way. The uploaded bytes count
    as the phase counter `spmd_upload_bytes`."""
    arr = np.asarray(arr)
    if arr.shape[0] < local_cap:
        pad = np.zeros((local_cap - arr.shape[0],) + arr.shape[1:],
                       dtype=arr.dtype)
        arr = np.concatenate([arr, pad])
    elif arr.shape[0] > local_cap:
        raise ValueError(f"rows {arr.shape[0]} exceed local_cap "
                         f"{local_cap}")
    mine = mesh.devices
    per = local_cap // len(mine)
    if per * len(mine) != local_cap:
        raise ValueError(f"local device count {len(mine)} must divide "
                         f"local_cap {local_cap}")
    shards = [upload(arr[i * per:(i + 1) * per], d)
              for i, d in enumerate(mine)]
    phase.add("spmd_upload_bytes", int(arr.nbytes))
    return Sharded(mesh, shards)

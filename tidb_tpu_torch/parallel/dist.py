"""Placement specs of the mesh (reference tidb_tpu/parallel/dist.py:23-49).

In the reference these are jax NamedShardings; here each is a spec the
upload seam reads (copr/dag_exec.py:_upload_padded) to place a padded
host array: "sharded" row-partitions it over the mesh, "replicated"
copies it to every device. Every sharded upload (mesh columns, shuffle
inputs, validity masks) builds its placement here, so the residency
store's "sharded" entries all mean the same thing.

The multi-process half of the reference module (init_distributed,
global_mesh, local_row_cap, bind_host_rows) comes with the
multi-process slice."""
from __future__ import annotations

from .mesh import Mesh, place_replicated, place_sharded


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

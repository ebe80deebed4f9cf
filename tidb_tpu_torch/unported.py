"""Surfaces of tidb_tpu that this package does not carry yet.

The reference wires the cluster transport (its multi-process mesh, the
owner's remote lease store) at query time; the read-replica fabric, BR
and the single-process MPP mesh are ported. Until the transport is, a
statement that needs it fails with the error below instead of reaching
for the reference package."""
from __future__ import annotations

from .errors import UnsupportedError


def not_ported(surface: str) -> UnsupportedError:
    return UnsupportedError(
        "%s is not yet ported to tidb_tpu_torch", surface)

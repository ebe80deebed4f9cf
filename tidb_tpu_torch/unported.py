"""Surfaces of tidb_tpu that this package does not carry yet.

The reference wires the read-replica fabric, MPP mesh fragments, the
cluster transport and BR at query time. Until each is ported, a statement that needs one fails with
the error below instead of reaching for the reference package."""
from __future__ import annotations

from .errors import UnsupportedError


def not_ported(surface: str) -> UnsupportedError:
    return UnsupportedError(
        "%s is not yet ported to tidb_tpu_torch", surface)

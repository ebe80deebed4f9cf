"""Log-backup file format (reference br/pkg/stream log files +
TiCDC storage sink, collapsed onto the WAL frame container).

A log backup is a single append-only file of WAL-framed records —
the same ``u32 length + u32 crc32 + payload`` container commit.wal
uses (storage/wal.py), so `wal.valid_prefix` torn-tail recovery works
unchanged: a kill -9 mid-append leaves a structurally invalid tail
that the next open truncates away, and a reader stops at the last
whole frame instead of erroring.

Three payload kinds, distinguished by a 4-byte magic:

  * ``WAL2`` — one committed transaction's RECORD mutations (the
    exact `wal.encode_frame_payload` encoding: commit_ts, wallclock,
    [(key, value|None)…]). Frames appear in commit_ts order.
  * ``LBRS`` — a resolved-ts watermark: every transaction at/below
    the ts is durably present ABOVE it in the file. The sink fsyncs
    before writing the marker, so the largest marker in the valid
    prefix is the sink's resume watermark.
  * ``LBDL`` — a DDL barrier (commit_ts, schema_version). Recorded
    for audit/ordering; PITR replay applies DML only (schema comes
    from the snapshot manifest — see docs/BACKUP.md).

`wal.replay` would raise on the marker magics by design (an unknown
crc-valid frame in commit.wal is corruption); this module owns the
multi-magic reader.
"""
from __future__ import annotations

import os
import struct
import zlib

from ..storage import wal as walmod

MAGIC_TXN = b"WAL2"            # walmod._MAGIC — committed txn frame
MAGIC_RESOLVED = b"LBRS"       # resolved-ts watermark marker
MAGIC_DDL = b"LBDL"            # DDL barrier marker

_HDR = struct.Struct("<II")


def encode_resolved(ts: int) -> bytes:
    return MAGIC_RESOLVED + struct.pack("<Q", ts)


def encode_ddl(commit_ts: int, schema_version: int) -> bytes:
    return MAGIC_DDL + struct.pack("<QI", commit_ts, schema_version)


def frame(payload: bytes) -> bytes:
    """One WAL-container frame around ``payload``."""
    return _HDR.pack(len(payload),
                     zlib.crc32(payload) & 0xFFFFFFFF) + payload


def open_for_append(path: str):
    """Open the log for appending, truncated to its valid prefix —
    `WalWriter`'s torn-tail contract reused verbatim: a crash-torn
    tail is cut off, the last whole frame survives."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if os.path.exists(path):
        good = walmod.valid_prefix(path)
        if good < os.path.getsize(path):
            with open(path, "r+b") as f:
                f.truncate(good)
    return open(path, "ab")


def scan(path: str):
    """Yield typed records from the structurally valid prefix:

        ("txn", commit_ts, mutations, wall)
        ("resolved", ts)
        ("ddl", commit_ts, schema_version)

    Stops silently at a torn tail (crash mid-append) — the contract
    the torn-tail regression test pins."""
    if not os.path.exists(path):
        return
    with open(path, "rb") as f:
        while True:
            hdr = f.read(_HDR.size)
            if len(hdr) < _HDR.size:
                return
            ln, crc = _HDR.unpack(hdr)
            payload = f.read(ln)
            if len(payload) < ln or \
                    zlib.crc32(payload) & 0xFFFFFFFF != crc:
                return                     # torn tail
            magic = payload[:4]
            if magic == MAGIC_TXN:
                decoded = walmod.decode_frame_payload(payload)
                if decoded is not None:
                    commit_ts, mutations, wall = decoded
                    yield ("txn", commit_ts, mutations, wall)
            elif magic == MAGIC_RESOLVED:
                (ts,) = struct.unpack_from("<Q", payload, 4)
                yield ("resolved", ts)
            elif magic == MAGIC_DDL:
                ts, sv = struct.unpack_from("<QI", payload, 4)
                yield ("ddl", ts, sv)
            # unknown magic: a future record kind — skip, frames are
            # self-delimiting


def last_resolved(path: str) -> int:
    """Largest resolved-ts marker in the valid prefix (0 = none)."""
    last = 0
    for rec in scan(path):
        if rec[0] == "resolved":
            last = max(last, rec[1])
    return last

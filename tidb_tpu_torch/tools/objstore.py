"""External blob-storage seam for BR / IMPORT (reference pkg/objstore —
the S3/GCS/azblob abstraction behind br and lightning; re-designed to
the minimal object contract those tools actually need: whole-object
put/get over flat keys, prefix listing, existence).

Backends:
  - LocalStorage: a directory (the default; keeps every existing
    `BACKUP ... TO '/path'` working unchanged).
  - MemS3Storage: an in-process S3-style bucket (`s3://bucket/prefix`)
    — flat keyspace, whole-object semantics, shared across sessions of
    the process. The zero-egress test stand-in for a real S3 client;
    a production client implements the same five methods.

`open_storage(uri)` picks the backend by scheme, so every BR/import
call site is already written against the interface.
"""
from __future__ import annotations

import os
import threading


class ExternalStorage:
    """Whole-object store: keys are /-separated names under a root."""

    def write(self, name: str, data: bytes) -> None:
        raise NotImplementedError

    def read(self, name: str) -> bytes:
        raise NotImplementedError

    def exists(self, name: str) -> bool:
        raise NotImplementedError

    def list(self, prefix: str = "") -> list:
        raise NotImplementedError

    def delete(self, name: str) -> None:
        raise NotImplementedError


class LocalStorage(ExternalStorage):
    def __init__(self, root: str):
        self.root = root

    def _p(self, name):
        return os.path.join(self.root, *name.split("/"))

    def write(self, name, data):
        p = self._p(name)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        tmp = p + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, p)           # object puts are atomic

    def read(self, name):
        with open(self._p(name), "rb") as f:
            return f.read()

    def exists(self, name):
        return os.path.exists(self._p(name))

    def list(self, prefix=""):
        out = []
        for dirpath, _dirs, files in os.walk(self.root):
            for fn in files:
                if fn.endswith(".tmp"):
                    continue
                rel = os.path.relpath(os.path.join(dirpath, fn),
                                      self.root).replace(os.sep, "/")
                if rel.startswith(prefix):
                    out.append(rel)
        return sorted(out)

    def delete(self, name):
        try:
            os.remove(self._p(name))
        except FileNotFoundError:
            pass


# process-wide buckets: backup in one session, restore in another
_MEM_BUCKETS: dict = {}
_MEM_BUCKETS_MU = threading.Lock()


class MemS3Storage(ExternalStorage):
    def __init__(self, bucket: str, prefix: str = ""):
        with _MEM_BUCKETS_MU:
            self._objs = _MEM_BUCKETS.setdefault(bucket, {})
        self.prefix = prefix.strip("/")

    def _k(self, name):
        return f"{self.prefix}/{name}" if self.prefix else name

    def write(self, name, data):
        self._objs[self._k(name)] = bytes(data)

    def read(self, name):
        k = self._k(name)
        if k not in self._objs:
            raise FileNotFoundError(k)
        return self._objs[k]

    def exists(self, name):
        return self._k(name) in self._objs

    def list(self, prefix=""):
        p = self._k(prefix) if prefix else (
            self.prefix + "/" if self.prefix else "")
        out = []
        for k in self._objs:
            if k.startswith(p):
                rel = k[len(self.prefix) + 1:] if self.prefix else k
                out.append(rel)
        return sorted(out)

    def delete(self, name):
        self._objs.pop(self._k(name), None)


def open_storage(uri: str) -> ExternalStorage:
    """'s3://bucket/prefix' -> MemS3Storage stub; anything else (plain
    path or 'local://path') -> LocalStorage."""
    if uri.startswith("s3://"):
        rest = uri[5:]
        bucket, _, prefix = rest.partition("/")
        return MemS3Storage(bucket, prefix)
    if uri.startswith("local://"):
        uri = uri[8:]
    return LocalStorage(uri)

"""Incremental result cache: warm `--strict` runs in well under a
second.

One JSON blob per (file sha256 x config fingerprint) under the
directory the caller names (cli: --cache-dir) holding the file's
NON-program findings (waivers already applied — they live in the source, so the sha covers
them) and its callgraph inventory.  The whole-program rules are never
cached — their graph is rebuilt every run — but they consume the
CACHED per-file inventories, which is where all the AST time goes.

The fingerprint covers everything that can change a per-file result
without the file itself changing: the enabled per-file rule set, the
parsed catalogs (error codes, sysvars, failpoint sites), the lock-rank
registry, and the inventory/lint schema versions.  Baseline status is
NOT cached: findings are re-absorbed against the live baseline on
every run (stale-entry detection needs the match set anyway).
"""
from __future__ import annotations

import hashlib
import json
import os

from .callgraph import INVENTORY_VERSION

CACHE_SCHEMA = 2


def config_fingerprint(config, rule_names) -> str:
    h = hashlib.sha256()
    h.update(f"schema={CACHE_SCHEMA};inv={INVENTORY_VERSION};".encode())
    h.update(("rules=" + ",".join(sorted(rule_names)) + ";").encode())
    for label in ("known_errors", "known_sysvars", "error_dups",
                  "known_failpoints", "lock_ranks", "hot_locks"):
        val = getattr(config, label, None)
        try:
            enc = json.dumps(val, sort_keys=True, default=sorted)
        except (TypeError, ValueError):
            enc = repr(sorted(val)) if isinstance(val, (set, frozenset)) \
                else repr(val)
        h.update(f"{label}={enc};".encode())
    return h.hexdigest()


class LintCache:
    def __init__(self, directory):
        self.dir = directory
        self.hits = 0
        self.misses = 0
        self._ready = False

    def _ensure_dir(self):
        if not self._ready:
            os.makedirs(self.dir, exist_ok=True)
            self._ready = True

    @staticmethod
    def key(src: str, fingerprint: str) -> str:
        h = hashlib.sha256()
        h.update(src.encode("utf-8", "surrogatepass"))
        h.update(b"\x00")
        h.update(fingerprint.encode())
        return h.hexdigest()

    def _path(self, key: str) -> str:
        return os.path.join(self.dir, key[:2], key + ".json")

    def get(self, key: str):
        try:
            with open(self._path(key), "r", encoding="utf-8") as f:
                blob = json.load(f)
        except (OSError, ValueError):
            self.misses += 1
            return None
        if blob.get("schema") != CACHE_SCHEMA:
            self.misses += 1
            return None
        self.hits += 1
        return blob

    def put(self, key: str, findings, inventory) -> None:
        self._ensure_dir()
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        blob = {"schema": CACHE_SCHEMA, "findings": findings,
                "inventory": inventory}
        tmp = path + f".tmp.{os.getpid()}"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(blob, f, separators=(",", ":"))
            os.replace(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def clear(self) -> int:
        n = 0
        if not os.path.isdir(self.dir):
            return 0
        for dirpath, _, filenames in os.walk(self.dir):
            for fn in filenames:
                if fn.endswith(".json"):
                    try:
                        os.unlink(os.path.join(dirpath, fn))
                        n += 1
                    except OSError:
                        pass
        return n

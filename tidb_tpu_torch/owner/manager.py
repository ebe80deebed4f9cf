"""Owner election (reference pkg/owner/manager.go:147 — etcd
campaign/lease; the DDL owner and background-service singletons in a
multi-node cluster). Redesign: a lease store with compare-and-swap
semantics — in-process it is a mutex'd dict, across processes it is the
`lease` RPC op on a cluster worker (the PD role) — and an OwnerManager
that campaigns, renews on a background thread, and loses ownership the
moment its lease lapses."""
from __future__ import annotations

import threading
import time


class LocalLeaseStore:
    """In-process lease authority (also the worker-side implementation
    behind the cluster `lease` op)."""

    def __init__(self):
        self._mu = threading.Lock()
        self._leases: dict = {}       # key -> (node, expire_wall)

    def acquire(self, key: str, node: str, ttl: float) -> bool:
        now = time.time()
        with self._mu:
            cur = self._leases.get(key)
            if cur is not None and cur[1] > now and cur[0] != node:
                return False
            self._leases[key] = (node, now + ttl)
            return True

    def renew(self, key: str, node: str, ttl: float) -> bool:
        now = time.time()
        with self._mu:
            cur = self._leases.get(key)
            if cur is None or cur[0] != node or cur[1] <= now:
                return False
            self._leases[key] = (node, now + ttl)
            return True

    def resign(self, key: str, node: str) -> None:
        with self._mu:
            cur = self._leases.get(key)
            if cur is not None and cur[0] == node:
                del self._leases[key]

    def holder(self, key: str):
        now = time.time()
        with self._mu:
            cur = self._leases.get(key)
            if cur is None or cur[1] <= now:
                return None
            return cur[0]


class _RemoteLeaseStore:
    """Lease store over its OWN connection to a cluster worker (PD
    role). The background renew thread must never share a socket with
    query traffic — interleaved frames would corrupt both streams."""

    def __init__(self, worker_client):
        from ..cluster.coordinator import _WorkerClient
        self.w = _WorkerClient(worker_client.port)

    def _call(self, action, key, node, ttl=0.0):
        # no lock here: _WorkerClient._call_mu already serializes the
        # dedicated socket — a second mutex on top only added a
        # blocking-under-lock layer (socket I/O under OUR lock)
        out, _ = self.w.call({"op": "lease", "action": action,
                              "key": key, "node": node, "ttl": ttl})
        return out

    def acquire(self, key, node, ttl):
        return bool(self._call("acquire", key, node, ttl)["granted"])

    def renew(self, key, node, ttl):
        return bool(self._call("renew", key, node, ttl)["granted"])

    def resign(self, key, node):
        self._call("resign", key, node)

    def holder(self, key):
        return self._call("holder", key, "").get("holder")


class OwnerManager:
    """Campaign for a named ownership (e.g. 'ddl-owner'); renew at
    ttl/3; `is_owner()` is authoritative against the store so a lapsed
    lease is lost immediately, not at the next renew tick."""

    def __init__(self, store, key: str, node_id: str, ttl: float = 3.0):
        self.store = store
        self.key = key
        self.node_id = node_id
        self.ttl = ttl
        self._stop = threading.Event()
        self._thread = None

    def campaign(self) -> bool:
        ok = self.store.acquire(self.key, self.node_id, self.ttl)
        if ok:
            # ALWAYS swap in a fresh renewer: the old loop (if any) may
            # be mid-exit after a lost lease — checking is_alive() races
            # with it and can leave a won lease with no renewer
            self._stop.set()
            stop = threading.Event()
            self._stop = stop

            def loop():
                while not stop.wait(self.ttl / 3.0):
                    if not self.store.renew(self.key, self.node_id,
                                            self.ttl):
                        return
            self._thread = threading.Thread(target=loop, daemon=True)
            self._thread.start()
        return ok

    def is_owner(self) -> bool:
        return self.store.holder(self.key) == self.node_id

    def resign(self):
        self._stop.set()
        self.store.resign(self.key, self.node_id)
        self._thread = None
        self._stop = threading.Event()


def remote_store(worker_client):
    return _RemoteLeaseStore(worker_client)

"""Device-resident columnar store: the device-memory buffer pool
behind every upload seam (copr column slices, fused-pipeline columns,
mesh shards). Entries are tensors on the domain's device, or placed
buffers over its mesh (parallel/mesh.py), charged by the caller's
nbytes under the placement policy below.

Base-table column buffers are keyed by (table uid, ..., version, ...)
so repeated analytic statements over an unchanged table upload ZERO
bytes — the PystachIO thesis (PAPERS.md): accelerator query engines win
only when data stays resident in device memory across operators and
statements. The store adds the two behaviors the old ad-hoc LRU dict
lacked:

* EAGER VERSION INVALIDATION: a DML commit bumps the table version;
  the next bind drops every buffer recorded under an older version
  instead of letting dead device memory age out by LRU pressure (a steady write
  trickle would otherwise keep the pool full of unreachable buffers).
* a per-table key index, so invalidation is O(buffers of that table),
  not O(pool).

MESH entries: a mesh holds base tables partitioned over the row axis,
so the pool speaks placement too. Every entry records a placement
`spec` and the store owns the charging policy:

  spec="sharded"     the buffer is split across the mesh — each shard
                     holds 1/ndev of it, so the AGGREGATE device memory
                     is the buffer's own bytes. Charged nbytes.
  spec="replicated"  a Broadcast-exchange build side: every device
                     holds a full copy. Charged nbytes * ndev.
  spec="local"       single-device entry (the default). Charged nbytes.

Invalidation is placement-blind: a DML commit drops the stale sharded,
replicated and local entries of that uid alike (they all index under
the uid), so a mesh and a single device share one invalidation
contract.

Padding is bucketed (chunk.device.shape_bucket) BEFORE keying: growth
within a bucket re-uploads the changed data but reuses the cached
fragment (same padded shape); only growth past a bucket boundary
re-pads. Dirty-transaction overlays never enter the pool (their keys
are never cacheable — see _partitions' empty bind_keys).

APPENDABLE entries (incremental HTAP, docs/PERFORMANCE.md
"Incremental HTAP"): base-table column slices are append-only between
gc() compactions — put_row/bulk_append only write at the tail and
delete/update freshness rides the MVCC validity mask, never the data
arrays. Entries put through ``put_appendable`` therefore record
(rows, version) OUT of the cache key: when a DML commit bumps the
table version, the delta maintainer (copr/delta.py) patches the tail
rows into a fresh copy of the buffer and ``apply_delta``
advances the entry's version — the commit costs O(delta) upload
bytes instead of an O(table) drop-and-reupload. ``invalidate(uid,
keep_version)`` keeps such a delta-advanced entry (its recorded
version matches) while still dropping the version/ts-keyed DERIVED
entries (validity masks, dim luts/sort orders) the statement must
rebuild. apply_delta/advance_version write the new version through to
the ``_by_uid`` index — without that write-through the very next
bind-time sweep would drop the entry the maintainer just patched.

Thread safety: one store is shared by every connection thread of a
domain; all internal state mutates under one lock (the get/put fast
paths are a few dict ops)."""
from __future__ import annotations


from ..utils import metrics as _metrics
from ..utils import lockrank

SPECS = ("local", "sharded", "replicated")


class DeviceResidentStore:
    """LRU + version-indexed pool of device tensors, byte-budgeted,
    placement(spec)-aware."""

    def __init__(self, budget_bytes: int):
        self.budget = budget_bytes
        self.bytes = 0
        self._mu = lockrank.ranked_lock("residency.device")
        self._entries: dict = {}       # key -> device array
        self._sizes: dict = {}         # key -> charged bytes (the spec
        #                                charging policy, see module doc)
        self._order: dict = {}         # key -> None; insertion order IS
        #                                LRU order (py3.7 dicts), so
        #                                touch/evict are O(1) — no list
        #                                scan under the lock on the
        #                                per-column hot path
        self._uid_of: dict = {}        # key -> uid it was indexed under
        self._by_uid: dict = {}        # uid -> {key: version}
        self._spec_of: dict = {}       # key -> placement spec
        self._bytes_by_spec = {sp: 0 for sp in SPECS}
        # key -> [rows, start, span|None, cap, epoch] for
        # append-only table-column entries (delta maintenance,
        # copr/delta.py); version lives in _by_uid like every other
        # entry. epoch is the table's gc_epoch at put time: compaction
        # rewrites positions in place, so a stale-epoch entry must be
        # dropped, never patched or advanced.
        self._append: dict = {}

    def __len__(self):
        return len(self._entries)

    def __del__(self):
        # the gauge is process-global and delta-maintained: a store
        # dropped with entries still charged (a removed CDC mirror
        # domain, a discarded test domain) must hand its charge back or
        # the gauge drifts upward forever
        try:
            for sp, b in self._bytes_by_spec.items():
                if b:
                    _metrics.DEV_RESIDENT_BYTES.labels(sp).dec(b)
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass

    def get(self, key):
        with self._mu:
            hit = self._entries.get(key)
            if hit is not None:
                self._order.pop(key)
                self._order[key] = None      # move to MRU end
            return hit

    @staticmethod
    def charged_bytes(nbytes: int, spec: str = "local",
                      ndev: int = 1) -> int:
        """THE charging policy: replicated entries cost a full copy per
        device; sharded entries cost their own bytes in aggregate
        device memory, exactly like a local entry on one device."""
        if spec not in SPECS:
            raise ValueError(f"unknown placement spec {spec!r}")
        return nbytes * ndev if spec == "replicated" else nbytes

    def put(self, key, dev, nbytes: int, uid=None, version=None,
            spec: str = "local", ndev: int = 1):
        """Insert a buffer; the store charges it by placement spec
        (charged_bytes) and evicts LRU entries past the byte budget.
        uid/version feed the invalidation index — unversioned entries
        (version None) are dropped whenever their uid invalidates.
        -> True when inserted, False when the key already held a
        buffer (the existing one wins; callers that must know — e.g.
        put_appendable's metadata — check the return)."""
        charged = self.charged_bytes(nbytes, spec, ndev)
        with self._mu:
            if key in self._entries:
                return False
            while self.bytes + charged > self.budget and self._order:
                self._drop_locked(next(iter(self._order)), "lru")
            self._entries[key] = dev
            self._sizes[key] = charged
            self._order[key] = None
            self.bytes += charged
            self._spec_of[key] = spec
            self._bytes_by_spec[spec] += charged
            # delta, not set(): several stores share the process-global
            # gauge (the CDC TableSink mirror runs a second Domain with
            # its own store) — last-writer-wins set() would flap
            _metrics.DEV_RESIDENT_BYTES.labels(spec).inc(charged)
            if uid is not None:
                self._uid_of[key] = uid
                self._by_uid.setdefault(uid, {})[key] = version
            return True

    # ---- append-only entries (delta maintenance) ----------------------
    def put_appendable(self, key, dev, nbytes: int, uid, version,
                       rows: int, start: int, span, cap: int,
                       epoch: int = 0, spec: str = "local",
                       ndev: int = 1):
        """Insert an append-only table-column buffer. The buffer holds
        ``rows`` valid rows of the column slice [start, start+span)
        (span None = unbounded: the slice runs to the table tail),
        padded to ``cap``; rows beyond ``rows`` are padding the MVCC
        validity mask must gate off. The delta maintainer patches the
        tail and advances (rows, version) in place via apply_delta."""
        if not self.put(key, dev, nbytes, uid=uid, version=version,
                        spec=spec, ndev=ndev):
            # a concurrent bind inserted first (its buffer is equally
            # correct); recording OUR rows against ITS buffer would
            # overclaim coverage
            return
        with self._mu:
            if key in self._entries:
                self._append[key] = [rows, start, span, cap, epoch]

    def get_appendable(self, key):
        """-> (dev, rows, version) for a live appendable entry, else
        None. LRU-touches like get()."""
        with self._mu:
            hit = self._entries.get(key)
            meta = self._append.get(key)
            if hit is None or meta is None:
                return None
            self._order.pop(key)
            self._order[key] = None
            uid = self._uid_of.get(key)
            ver = self._by_uid.get(uid, {}).get(key)
            return hit, meta[0], ver

    def appendable_entries(self, uid) -> list:
        """Snapshot of the uid's appendable entries for a maintainer
        fold: [(key, dev, rows, version, start, span, cap, epoch)]."""
        out = []
        with self._mu:
            keys = self._by_uid.get(uid)
            if not keys:
                return out
            for k, ver in keys.items():
                meta = self._append.get(k)
                if meta is None:
                    continue
                out.append((k, self._entries[k], meta[0], ver, meta[1],
                            meta[2], meta[3], meta[4]))
        return out

    def apply_delta(self, key, dev, rows: int, version,
                    expect_rows: int | None = None) -> bool:
        """Replace an appendable entry's buffer with its tail-patched
        successor and advance (rows, version) IN PLACE — the padded
        capacity is unchanged, so the charge is too. The version is
        written through to the ``_by_uid`` index: ``invalidate(uid,
        keep_version=version)`` (the bind-time sweep) must KEEP the
        patched entry, not drop it. With ``expect_rows`` the swap is
        compare-and-set: a concurrent fold that already advanced the
        entry wins and this one is discarded (returns False)."""
        with self._mu:
            meta = self._append.get(key)
            if meta is None or key not in self._entries:
                return False
            if expect_rows is not None and meta[0] != expect_rows:
                return False
            self._entries[key] = dev
            meta[0] = rows
            self._order.pop(key, None)
            self._order[key] = None
            uid = self._uid_of.get(key)
            idx = self._by_uid.get(uid)
            if idx is not None and key in idx:
                idx[key] = version
            return True

    def advance_version(self, key, version) -> bool:
        """Record that an appendable entry is current at ``version``
        without touching its buffer (delete/update-only commits: the
        data arrays did not change, only the validity mask — which is
        derived, rebuilt per read). Write-through to _by_uid, same
        rationale as apply_delta."""
        with self._mu:
            if key not in self._entries or key not in self._append:
                return False
            uid = self._uid_of.get(key)
            idx = self._by_uid.get(uid)
            if idx is not None and key in idx:
                idx[key] = version
                return True
            return False

    def drop(self, key, cause: str = "delta_overflow") -> bool:
        """Drop one entry by key (delta fallback-to-full-upload)."""
        with self._mu:
            if key not in self._entries:
                return False
            self._drop_locked(key, cause)
            return True

    def evict_bytes(self, n: int) -> int:
        """Device-memory pressure relief (utils/device_guard pressure protocol):
        drop LRU-cold entries until at least ``n`` charged bytes are
        freed or the pool is empty. A RESOURCE_EXHAUSTED dispatch
        retries against the freed headroom instead of the same full
        device memory; evicted entries are re-uploadable at the next
        bind (cost: bytes, never correctness). -> bytes freed."""
        if n <= 0:
            return 0
        with self._mu:
            freed = 0
            while freed < n and self._order:
                k = next(iter(self._order))
                freed += self._sizes.get(k, 0)
                self._drop_locked(k, "pressure")
            return freed

    def invalidate(self, uid, keep_version=None) -> int:
        """Drop every buffer of `uid` whose recorded version differs
        from keep_version (None keep_version drops them all). Called at
        bind time with the table's current version: a DML commit or
        schema change leaves no stale device memory behind, and
        nothing of any other uid is touched. With a keep_version the
        appendable buffers stay: they are the delta fold's to patch or
        drop, and right at any version (a bind tail-patches one that
        fell behind). Under concurrent commits a sweep at a version
        newer than the fold's, or past a buffer a racing bind inserted
        after the fold, would drop live buffers for the next bind to
        upload whole.
        -> buffers dropped."""
        with self._mu:
            keys = self._by_uid.get(uid)
            if not keys:
                return 0
            stale = [k for k, v in keys.items()
                     if keep_version is None or
                     (v != keep_version and k not in self._append)]
            for k in stale:
                self._drop_locked(k, "version")
            return len(stale)

    def spec_of(self, key):
        """Recorded placement spec of a live entry, else None."""
        with self._mu:
            return self._spec_of.get(key)

    def stats(self) -> dict:
        """Point-in-time accounting: total charged bytes and the
        per-placement split (information_schema / debugging surface)."""
        with self._mu:
            return {"entries": len(self._entries), "bytes": self.bytes,
                    "bytes_by_spec": dict(self._bytes_by_spec)}

    def _drop_locked(self, key, cause: str):
        self._entries.pop(key, None)
        self._append.pop(key, None)
        freed = self._sizes.pop(key, 0)
        self.bytes -= freed
        self._order.pop(key, None)
        spec = self._spec_of.pop(key, "local")
        self._bytes_by_spec[spec] -= freed
        _metrics.DEV_RESIDENT_BYTES.labels(spec).dec(freed)
        # unindex under the uid put() recorded, NOT key[0] — a caller
        # may index under an explicit uid, and a mismatch here would
        # leave a dangling _by_uid row that inflates invalidate counts
        uid = self._uid_of.pop(key, None)
        idx = self._by_uid.get(uid)
        if idx is not None:
            idx.pop(key, None)
            if not idx:
                self._by_uid.pop(uid, None)
        _metrics.DEV_BUFFER_EVICTIONS.labels(cause).inc()

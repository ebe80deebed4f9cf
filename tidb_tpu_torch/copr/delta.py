"""Incremental HTAP: changefeed-fed delta maintenance of the
device-resident columnar store (docs/PERFORMANCE.md "Incremental
HTAP"; reference role: TiFlash's raft-learner delta tree, transplanted
to device-memory residency).

Before this layer, freshness was invalidate-and-reupload: every DML
commit bumped the table version and the next analytic bind dropped the
table's HBM buffers and re-uploaded them whole — a steady OLTP write
trickle made every analytic statement pay O(table) upload bytes. The
maintainer exploits the columnar engine's append-only contract
(storage/columnar.py: put_row/bulk_append write column data ONLY at
the tail; deletes and updates touch delete_ts, i.e. the derived MVCC
validity mask, never the data arrays) to fold commits into resident
buffers incrementally:

  * SUBSCRIPTION — the maintainer is the capture seam's second
    consumer (cdc/capture.py, ``subscribe_inline``): every commit
    batch fanned to changefeeds also lands here, decoded just enough
    (record-key -> table id, cdc/capture's key classifier) to keep
    per-table pending-delta counters and the last commit ts. This is
    the freshness bookkeeping behind
    information_schema.tidb_replica_freshness.
  * FOLD — at bind time (dag_exec._execute_inner / fused_partials),
    ``refresh(tbl)`` patches every appendable entry of the table with
    its new tail rows using ONE fold program per table: for each stale
    buffer, a copy into a fresh tensor with the tail rows slice-assigned
    on the device. The entry then advances (rows, version) in place via
    residency.apply_delta — the bind-time invalidation sweep
    (``invalidate(uid, keep_version=tbl.version)``) keeps it.
  * FALLBACK — a delta larger than tidb_tpu_delta_max_rows, a padding
    bucket crossed by growth, a gc compaction (positions rewritten),
    or a patch dispatch failure drops the entry instead: the next
    bind re-uploads it whole. Correctness never depends on the fold;
    only upload bytes do.

The old buffer is NEVER written in place: a concurrent statement on
another session may have bound it already (store.get returns raw
references). The patch allocates the successor, the store swaps the
entry, and the orphan buffer dies with its last reader.

Read side: analytic statements under tidb_tpu_analytic_read_mode =
'resolved' snapshot at ``resolved_ts()`` — the exact
storage/mvcc.resolved_floor watermark (every commit at/below it has
reached the hooks, so the columnar arrays contain it; nothing can
commit at/below it later) — so the MVCC validity mask built at that
ts is a consistent committed-data view that never blocks on OLTP
write locks and never sees an uncommitted or above-watermark row.
"""
from __future__ import annotations

import threading
import time

import numpy as np

from ..chunk.device import shape_bucket, upload
from ..utils import device_guard, env_int, phase
from ..utils import metrics as _metrics
from ..parallel.mesh import placed


class _FoldItem:
    """One stale appendable entry scheduled into a fold program."""

    __slots__ = ("key", "dev", "rows", "want", "cap", "upd", "off",
                 "dbytes")

    def __init__(self, key, dev, rows, want, cap, upd, off, dbytes):
        self.key = key
        self.dev = dev
        self.rows = rows
        self.want = want
        self.cap = cap
        self.upd = upd          # padded host delta (ulen rows)
        self.off = off          # write offset into the buffer
        self.dbytes = dbytes    # real (unpadded) delta bytes


def _fold(bufs, upds, offs):
    """The fold program: each buffer copied into a fresh tensor with its
    padded tail delta slice-assigned at its offset (never in place). A
    mesh entry (parallel/mesh.py Sharded / Replicated) is patched in
    its own placement: the shards the tail reaches, or every copy
    (reference copr/delta.py:_build_fold_kernel(out_shardings=...))."""
    out = []
    for b, u, o in zip(bufs, upds, offs):
        if placed(b):
            out.append(b.patched(u, o))
            continue
        nb = b.clone()
        nb[o:o + u.shape[0]] = u
        out.append(nb)
    return tuple(out)


class DeltaMaintainer:
    """One per CoprExecutor: folds committed deltas into the
    device-resident store and tracks per-table replica freshness."""

    def __init__(self, copr):
        self.copr = copr
        self._mu = threading.Lock()
        # table_id -> [pending_rows, last_commit_ts, folded_rows,
        #              folds, wall_of_last_event]
        self._tables: dict = {}
        self._folded_ver: dict = {}     # uid -> last reconciled version
        # nothing unregisters a dropped table from these maps (uids
        # are globally monotonic, temp tables churn per session), so
        # both are bounded: past the cap the oldest half is evicted —
        # for _folded_ver that only costs one extra reconcile pass on
        # a live table's next bind
        self._map_cap = 4096
        self._domain = None
        self._err_logged = False
        self.max_delta_rows = env_int("TIDB_TPU_DELTA_MAX_ROWS", 1 << 20)

    # ---- capture subscription (freshness bookkeeping) -----------------
    def attach(self, domain):
        """Subscribe to the domain's CDC capture seam as its inline
        second consumer. Idempotent; safe before any feed exists (the
        capture hook installs on first subscription)."""
        with self._mu:
            if self._domain is not None:
                return
            self._domain = domain
        domain.cdc.capture.subscribe_inline(self.on_commit)

    def on_commit(self, commit_ts: int, mutations: list):
        """Inline commit-hook consumer: count record-key mutations per
        table. Runs on the committing thread — keep it O(mutations)
        with no decode beyond the key prefix, and never raise (a
        bookkeeping bug must not fail a commit)."""
        try:
            from ..cdc.capture import _is_record_key
            from ..codec.tablecodec import decode_record_key
            counts: dict = {}
            for key, _v in mutations:
                if _is_record_key(key):
                    tid, _h = decode_record_key(key)
                    counts[tid] = counts.get(tid, 0) + 1
            if not counts:
                return
            now = time.time()
            with self._mu:
                for tid, cnt in counts.items():
                    st = self._tables.setdefault(tid, [0, 0, 0, 0, 0.0])
                    st[0] += cnt
                    if commit_ts > st[1]:
                        st[1] = commit_ts
                    st[4] = now
                self._prune_locked(self._tables)
        except Exception:                       # noqa: BLE001
            if not self._err_logged:
                self._err_logged = True
                from ..utils.logutil import log
                log("warn", "delta_bookkeeping_error")

    # ---- freshness surface --------------------------------------------
    def resolved_ts(self) -> int:
        """The replica read view: the exact resolved floor from
        storage/mvcc.py over a fresh oracle ts."""
        storage = self._domain.storage
        return storage.mvcc.resolved_floor(storage.oracle.get_ts())

    def lag_ms(self, resolved: int) -> float:
        """Wallclock age of the resolved floor (oracle.wall_for_ts);
        0 when the floor is current (postdates recorded history)."""
        wall = self._domain.storage.oracle.wall_for_ts(resolved)
        if wall is None:
            return 0.0
        return max(0.0, (time.time() - wall) * 1000.0)

    def table_stats(self) -> dict:
        """table_id -> (pending_rows, last_commit_ts, folds) snapshot
        for information_schema.tidb_replica_freshness."""
        with self._mu:
            return {tid: (st[0], st[1], st[3])
                    for tid, st in self._tables.items()}

    # ---- fold ----------------------------------------------------------
    def refresh(self, tbl, ectx=None):
        """Reconcile every appendable resident entry of ``tbl`` with
        the host columnar arrays, BEFORE the bind-time invalidation
        sweep: patched/advanced entries record the current version and
        survive it; everything else is left stale for the sweep.
        Returns the number of entries patched or advanced."""
        with self._mu:
            if self._folded_ver.get(tbl.uid) == tbl.version:
                return 0            # reconciled: nothing moved since
        store = self.copr._dev_store
        ents = store.appendable_entries(tbl.uid)
        if not ents:
            self._mark_folded(tbl, 0, tbl.version)
            return 0
        # version BEFORE n: rows appended between the two reads make
        # the entry claim an older version than its rows cover, which
        # only means one extra (no-op) fold next bind — never the
        # reverse, where an entry would claim coverage it lacks
        version = tbl.version
        n = tbl.n
        epoch = tbl.gc_epoch
        max_rows = self.max_delta_rows
        if ectx is not None:
            try:
                max_rows = int(ectx.sv.get("tidb_tpu_delta_max_rows"))
            except Exception:               # noqa: BLE001
                pass
        items = []
        advanced = 0
        for (key, dev, rows, ver, start, span, cap, ent_epoch) in ents:
            if ver == version:
                continue                    # already current
            if ent_epoch != epoch:
                # gc compacted: positions rewrote under the entry
                store.drop(key, "delta_compact")
                _metrics.DELTA_APPLY.labels("compacted").inc()
                continue
            want = n - start if span is None else min(n - start, span)
            if want <= 0 or want > cap:
                # grew past the padding bucket: the entry is superseded
                store.drop(key, "delta_compact")
                _metrics.DELTA_APPLY.labels("compacted").inc()
                continue
            if want <= rows:
                # delete/update tombstone folding (only the derived
                # validity mask changed; the data tail is untouched), or
                # a concurrent fold already carried the entry past the
                # rows read above: not a shrink (a gc changes the epoch)
                if store.advance_version(key, version):
                    _metrics.DELTA_APPLY.labels("advanced").inc()
                    advanced += 1
                continue
            if want - rows > max_rows:
                store.drop(key, "delta_overflow")
                _metrics.DELTA_APPLY.labels("fell_back_full_upload").inc()
                continue
            item = self._plan_patch(tbl, key, dev, rows, want, cap,
                                    start)
            if item is None:
                store.drop(key, "delta_overflow")
                _metrics.DELTA_APPLY.labels("fell_back_full_upload").inc()
                continue
            items.append(item)
        applied = self._dispatch_items(items, version, store)
        self._mark_folded(tbl, applied + advanced, version)
        return applied + advanced

    def patch_entry(self, key, dev, rows, want, cap, src_tail,
                    pad_fill, version):
        """Reader-side single-entry patch (the bind seam found a live
        buffer that fell behind its snapshot): append ``src_tail``
        (host rows [rows, want) of the column) on device and advance
        the entry. -> the patched device array, or None (caller falls
        back to drop + full upload)."""
        dlen = want - rows
        if dlen <= 0 or dlen > self.max_delta_rows:
            return None
        ulen = min(shape_bucket(dlen), cap - rows)
        if ulen < dlen:
            return None
        delta = np.asarray(src_tail)
        if ulen != dlen:
            delta = np.concatenate(
                [delta, np.full(ulen - dlen, pad_fill,
                                dtype=delta.dtype)])
        item = _FoldItem(key, dev, rows, want, cap, delta, rows,
                         dlen * delta.dtype.itemsize)
        try:
            out = device_guard.guarded_dispatch(
                lambda: self._run_fold([item]),
                site="copr/delta",
                domain=getattr(self.copr, "domain", None),
                host_fallback=lambda: None, fallback_is_host=False)
        except Exception:                   # noqa: BLE001
            return None
        if out is None:
            return None
        new = out[0]
        phase.add("upload_bytes", delta.size * delta.dtype.itemsize)
        store = self.copr._dev_store
        if not store.apply_delta(key, new, want, version,
                                 expect_rows=rows):
            # a concurrent fold advanced the entry first: use what the
            # store holds if it covers the snapshot, else this patch
            # (right for this snapshot; a drop and a full upload would
            # throw away the winner's buffer too)
            ent = store.get_appendable(key)
            return ent[0] if ent is not None and ent[1] >= want else new
        _metrics.DELTA_APPLY.labels("applied").inc()
        _metrics.DELTA_APPLY_BYTES.inc(item.dbytes)
        avoided = cap * delta.dtype.itemsize - item.dbytes
        if avoided > 0:
            _metrics.DELTA_REUPLOAD_AVOIDED_BYTES.inc(avoided)
        phase.inc("delta_applies")
        phase.add("delta_bytes", item.dbytes)
        return new

    def _prune_locked(self, d: dict):
        """Caller holds self._mu: evict the oldest half past the cap
        (insertion order; dropped-table and temp-table ids/uids age
        out here since nothing unregisters them)."""
        if len(d) > self._map_cap:
            for k in list(d)[:self._map_cap // 2]:
                del d[k]

    def _mark_folded(self, tbl, nfolded: int, version):
        tid = tbl.table_info.id
        with self._mu:
            # the version read BEFORE the fold, never a fresh one: a
            # commit that landed mid-fold must re-run the reconcile at
            # the next bind, not be short-circuited past
            self._folded_ver.pop(tbl.uid, None)   # re-insert as MRU
            self._folded_ver[tbl.uid] = version
            self._prune_locked(self._folded_ver)
            st = self._tables.get(tid)
            if st is not None:
                st[0] = 0
                st[2] = tbl.n
                if nfolded:
                    st[3] += nfolded

    def _plan_patch(self, tbl, key, rows_dev, rows, want, cap, start):
        """Build the host-side padded delta for one entry -> _FoldItem
        (None when the source column cannot be resolved — schema
        drift; the caller falls back to a full re-upload)."""
        # key layout (dag_exec/pipeline append seams): the source
        # column rides IN the key as (..., cid, kind, ...) via the
        # "tcol" marker — see _append_key()
        src = _append_src(tbl, key)
        if src is None:
            return None
        dlen = want - rows
        lo = start + rows
        delta = np.asarray(src[lo:lo + dlen])
        ulen = min(shape_bucket(dlen), cap - rows)
        if ulen < dlen:
            return None
        if ulen != dlen:
            fill = _append_fill(key)
            delta = np.concatenate(
                [delta, np.full(ulen - dlen, fill, dtype=delta.dtype)])
        return _FoldItem(key, rows_dev, rows, want, cap, delta, rows,
                         dlen * delta.dtype.itemsize)

    def _dispatch_items(self, items, version, store) -> int:
        if not items:
            return 0
        new_bufs = None
        try:
            new_bufs = device_guard.guarded_dispatch(
                lambda: self._run_fold(items),
                site="copr/delta",
                domain=getattr(self.copr, "domain", None),
                host_fallback=lambda: None, fallback_is_host=False)
        except Exception:                   # noqa: BLE001
            new_bufs = None
        if new_bufs is None:
            for it in items:
                store.drop(it.key, "delta_overflow")
                _metrics.DELTA_APPLY.labels("fell_back_full_upload").inc()
            return 0
        applied = 0
        for it, nb in zip(items, new_bufs):
            if not store.apply_delta(it.key, nb, it.want, version,
                                     expect_rows=it.rows):
                continue                    # concurrent fold won
            applied += 1
            _metrics.DELTA_APPLY.labels("applied").inc()
            _metrics.DELTA_APPLY_BYTES.inc(it.dbytes)
            avoided = it.cap * it.upd.dtype.itemsize - it.dbytes
            if avoided > 0:
                _metrics.DELTA_REUPLOAD_AVOIDED_BYTES.inc(avoided)
            phase.inc("delta_applies")
            phase.add("delta_bytes", it.dbytes)
            phase.add("upload_bytes", it.upd.size * it.upd.dtype.itemsize)
        return applied

    def _run_fold(self, items):
        """Dispatch ONE fold program over the stale entries (counted as
        one fragment dispatch through the kernel cache's phase
        wrapper); the padded host deltas upload here."""
        kc = self.copr._kernel_cache
        kern = kc.get(("delta",))
        if kern is None:
            kern = kc.put(("delta",), _fold)
        bufs = tuple(it.dev for it in items)
        # pinned, non-blocking on the card: a copy from pageable memory
        # would hold the host until the card is done with it
        # (a mesh entry uploads its tail to each device it patches)
        upds = tuple(it.upd if placed(it.dev) else
                     upload(it.upd, it.dev.device) for it in items)
        offs = tuple(int(it.off) for it in items)
        return kern(bufs, upds, offs)


# ---- append-seam key layout -------------------------------------------
# Every appendable entry's key is built by _append_key() so the
# maintainer can resolve its host source column without caller-specific
# knowledge: ("tcol", uid, tag, cid, kind, gc_epoch, extra..., cap).
# kind: "d" = data array, "n" = null mask, "h" = handle array.

def append_key(uid, tag, cid, kind, epoch, extra, cap):
    return ("tcol", uid, tag, cid, kind, epoch) + tuple(extra) + (cap,)


def _append_src(tbl, key):
    if not (isinstance(key, tuple) and key and key[0] == "tcol"):
        return None
    cid, kind = key[3], key[4]
    if kind == "h":
        return tbl.handles
    if kind == "n":
        return tbl.nulls.get(cid)
    return tbl.data.get(cid)


def _append_fill(key):
    # null-mask padding is True (padded rows read as NULL, matching
    # _dev_put's pad_fill=True); data padding is 0
    return True if key[4] == "n" else 0

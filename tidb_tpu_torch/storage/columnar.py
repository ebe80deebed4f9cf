"""Columnar engine (reference role: TiFlash — columnar replica fed by raft
learner; here fed by MVCCStore.commit_hooks in-process).

Per table: consolidated numpy arrays per column (amortized doubling),
string columns dictionary-encoded, deletion bitmap, handle index. The copr
layer scans these arrays straight into padded device buffers.

Bulk import (`IMPORT INTO` / load_table) appends directly here — the
lightning local-backend analog (reference lightning/backend/local) — and
writes no per-row KV; such tables serve the OLAP path.
"""
from __future__ import annotations

import threading

import numpy as np

from ..chunk.column import Column, py_to_datum_fast
from ..chunk.device import StringDict
from ..codec.tablecodec import decode_record_key, TABLE_PREFIX, RECORD_PREFIX_SEP
from ..codec.codec import decode_row_value
from ..types.field_type import TypeClass


_CTAB_UID = [0]
_CTAB_UID_MU = threading.Lock()  # concurrent CREATE TABLE / CTAS


def _is_big_decimal(ft) -> bool:
    # scale > 18 cannot ride the scaled-int64 fast path; precision <= 38
    # with small scale keeps int64 (the documented money-scale trade)
    return ft.tclass == TypeClass.DECIMAL and max(ft.decimal, 0) > 18


class ColumnarTable:
    """Row-versioned columnar store: per-row (insert_ts, delete_ts) arrays
    give MVCC snapshot scans (TiFlash delta-tree role). delete_ts == 0 means
    live. Updates append a new version row; handle_pos tracks the newest.
    `uid` is globally unique (cache keys must NOT use id(self): CPython
    recycles addresses and the kernel/buffer caches would collide)."""

    def __init__(self, table_info):
        with _CTAB_UID_MU:
            _CTAB_UID[0] += 1
            self.uid = _CTAB_UID[0]
        self.table_info = table_info
        self.n = 0
        self.cap = 0
        self.version = 0          # bumped on every mutation batch
        self.max_commit_ts = 0    # newest insert/delete ts ever applied:
        # a snapshot at read_ts >= max_commit_ts sees every row — lets
        # host-side derived results (materialized dims) be reused across
        # later snapshots when the table hasn't changed
        self.gc_epoch = 0         # bumped only by gc() compaction: host
        # caches that pinned an optimization OFF for unclustered/tie-heavy
        # data retry after a reorganization restores clustering
        self.data: dict[int, np.ndarray] = {}    # col_id -> array
        self.nulls: dict[int, np.ndarray] = {}
        self.dicts: dict[int, StringDict] = {}
        self.handles = np.empty(0, dtype=np.int64)
        self.insert_ts = np.empty(0, dtype=np.int64)
        self.delete_ts = np.empty(0, dtype=np.int64)
        self._hpos: dict[int, int] | None = {}
        self._hpos_mu = threading.Lock()   # serializes lazy rebuilds
        self.bulk_rows = 0           # rows without row-KV/index entries
        # cid -> [rows_checked, still_clustered]: lazy monotone-order
        # tracker behind is_clustered()
        self._clustered: dict[int, list] = {}
        # VECTOR(k) fixed-width twin: cid -> [float32[cap, k] matrix,
        # rows_filled]; append-only like the data arrays (filled
        # incrementally from the dict-encoded text column by
        # vector_matrix(); gc() compaction resets it — positions move)
        self._vecmat: dict = {}
        self._vecmat_mu = threading.Lock()
        self._init_columns()

    def _init_columns(self):
        for ci in self.table_info.columns:
            if ci.id in self.data:
                continue
            if ci.ft.tclass in (TypeClass.STRING, TypeClass.JSON):
                self.data[ci.id] = np.zeros(self.cap, dtype=np.int32)
                self.dicts[ci.id] = StringDict()
            elif ci.ft.tclass == TypeClass.FLOAT:
                self.data[ci.id] = np.zeros(self.cap, dtype=np.float64)
            elif _is_big_decimal(ci.ft):
                # precision > 18: python-int object array — EXACT host
                # arithmetic (reference MyDecimal's 65 digits); such
                # columns are host-path-only (expression/vec.py
                # is_device_safe routes around them)
                self.data[ci.id] = np.zeros(self.cap, dtype=object)
            else:
                self.data[ci.id] = np.zeros(self.cap, dtype=np.int64)
            self.nulls[ci.id] = np.zeros(self.cap, dtype=bool)

    def update_schema(self, table_info):
        """ADD/DROP COLUMN: extend arrays; dropped column arrays are kept
        until compaction (harmless)."""
        old = self.table_info
        self.table_info = table_info
        for ci in table_info.columns:
            if ci.id not in self.data:
                if ci.ft.tclass in (TypeClass.STRING, TypeClass.JSON):
                    arr = np.zeros(self.cap, dtype=np.int32)
                    self.dicts[ci.id] = StringDict()
                elif ci.ft.tclass == TypeClass.FLOAT:
                    arr = np.zeros(self.cap, dtype=np.float64)
                elif _is_big_decimal(ci.ft):
                    arr = np.zeros(self.cap, dtype=object)
                else:
                    arr = np.zeros(self.cap, dtype=np.int64)
                nulls = np.zeros(self.cap, dtype=bool)
                default = ci.ft.default_value
                if default is None and not ci.ft.has_default:
                    nulls[:self.n] = True
                elif default is not None:
                    d = py_to_datum_fast(default, ci.ft)
                    if ci.id in self.dicts:
                        arr[:self.n] = self.dicts[ci.id].encode_one(str(d.val))
                    else:
                        arr[:self.n] = d.val
                self.data[ci.id] = arr
                self.nulls[ci.id] = nulls
        self.version += 1

    # ---- growth -------------------------------------------------------
    def _ensure(self, extra: int):
        need = self.n + extra
        if need <= self.cap:
            return
        new_cap = max(1024, self.cap * 2, need)
        for cid, arr in self.data.items():
            na = np.zeros(new_cap, dtype=arr.dtype)
            na[:self.n] = arr[:self.n]
            self.data[cid] = na
            nn = np.zeros(new_cap, dtype=bool)
            nn[:self.n] = self.nulls[cid][:self.n]
            self.nulls[cid] = nn
        nh = np.zeros(new_cap, dtype=np.int64)
        nh[:self.n] = self.handles[:self.n]
        self.handles = nh
        for attr in ("insert_ts", "delete_ts"):
            a = getattr(self, attr)
            na = np.zeros(new_cap, dtype=np.int64)
            na[:self.n] = a[:self.n]
            setattr(self, attr, na)
        self.cap = new_cap

    @property
    def handle_pos(self) -> dict:
        """handle -> position of its NEWEST version row (which may be a
        closed/deleted version; readers check delete_ts themselves).
        Later rows win in storage order, so last-occurrence via
        dict(zip) reproduces the incrementally-maintained mapping.
        Invalidated (None) by bulk_append/gc, rebuilt on first access.
        The rebuild is double-check-locked: concurrent readers must not
        each build and publish their own dict, or a committer's
        incremental `handle_pos[h] = pos` written into the losing copy
        would vanish (rows are immutable once written and self.n is
        bumped after the row data, so a locked rebuild always sees a
        consistent prefix)."""
        hp = self._hpos
        if hp is None:
            with self._hpos_mu:
                hp = self._hpos
                if hp is None:
                    hp = dict(zip(self.handles[:self.n].tolist(),
                                  range(self.n)))
                    self._hpos = hp
        return hp

    @handle_pos.setter
    def handle_pos(self, v):
        self._hpos = v

    # ---- mutations ----------------------------------------------------
    def put_row(self, handle: int, datums: list, commit_ts: int = 1):
        """Insert/overwrite one row; an existing version is closed at
        commit_ts and a new version row appended. Row data is fully
        written BEFORE self.n is bumped so concurrent snapshot readers
        never see a half-written row."""
        old = self.handle_pos.get(handle)
        if old is not None and self.delete_ts[old] == 0:
            self.delete_ts[old] = commit_ts
        self._ensure(1)
        pos = self.n
        self.handles[pos] = handle
        self.insert_ts[pos] = commit_ts
        self.delete_ts[pos] = 0
        cols = self.table_info.columns
        for ci in cols[len(datums):]:
            # row encoded under an older schema (e.g. WAL replay of a
            # pre-ADD COLUMN write): later columns get default/NULL
            arr = self.data[ci.id]
            nl = self.nulls[ci.id]
            default = ci.ft.default_value
            if default is None:
                nl[pos] = True
                arr[pos] = 0
            else:
                d0 = py_to_datum_fast(default, ci.ft)
                nl[pos] = False
                arr[pos] = (self.dicts[ci.id].encode_one(str(d0.val))
                            if ci.id in self.dicts else d0.val)
        for ci, d in zip(cols, datums):
            arr = self.data[ci.id]
            nl = self.nulls[ci.id]
            if d is None or d.is_null:
                nl[pos] = True
                arr[pos] = 0
                continue
            nl[pos] = False
            if ci.id in self.dicts:
                v = d.val
                arr[pos] = self.dicts[ci.id].encode_one(
                    v if isinstance(v, str) else str(v))
            elif arr.dtype == np.float64:
                arr[pos] = float(d.val)
            else:
                v = int(d.val)
                if arr.dtype != object and v > 0x7FFFFFFFFFFFFFFF:
                    v -= 1 << 64       # unsigned upper half as bit pattern
                arr[pos] = v
        self.n = pos + 1
        self.handle_pos[handle] = pos
        self.version += 1
        if commit_ts > self.max_commit_ts:
            self.max_commit_ts = commit_ts

    def delete_row(self, handle: int, commit_ts: int = 1):
        pos = self.handle_pos.get(handle)
        if pos is not None and self.delete_ts[pos] == 0:
            self.delete_ts[pos] = commit_ts
            self.version += 1
            if commit_ts > self.max_commit_ts:
                self.max_commit_ts = commit_ts

    def bulk_append(self, columns: dict, n: int, handles=None,
                    commit_ts: int = 1, nulls=None):
        """Fast import path: columns maps column NAME -> numpy array (or
        list). String arrays are dict-encoded here. `nulls` optionally
        maps column NAME -> bool mask (segment reload); import data is
        otherwise dense."""
        self._ensure(n)
        start = self.n
        if handles is None:
            handles = np.arange(start + 1, start + n + 1, dtype=np.int64)
        self.handles[start:start + n] = handles
        self.insert_ts[start:start + n] = commit_ts
        self.delete_ts[start:start + n] = 0
        if commit_ts > self.max_commit_ts:
            self.max_commit_ts = commit_ts
        self._hpos = None     # rebuilt lazily on first point access: a
        # bulk load of N rows must not pay N Python dict inserts when
        # the workload never point-reads the table
        for ci in self.table_info.columns:
            src = columns.get(ci.name)
            arr = self.data[ci.id]
            if src is None:
                self.nulls[ci.id][start:start + n] = True
                continue
            if ci.id in self.dicts:
                if not isinstance(src, np.ndarray) or src.dtype != np.int32:
                    src = self.dicts[ci.id].encode(
                        np.asarray(src, dtype=object))
                arr[start:start + n] = src
            else:
                arr[start:start + n] = np.asarray(src, dtype=arr.dtype)
            if nulls and ci.name in nulls:
                self.nulls[ci.id][start:start + n] = nulls[ci.name]
        self.n += n
        # bulk rows never get row/index KV: index-driven read paths must
        # not be trusted for this table (planner gates on bulk_rows == 0,
        # executors fall back to columnar scans)
        self.bulk_rows += n
        self.version += 1

    def is_clustered(self, cid: int) -> bool:
        """True when the column is non-NULL and monotone non-decreasing
        in STORAGE ORDER across every version row — equal values are
        then contiguous, so contiguous-run aggregation partials
        (copr/dag_exec runs lowering) are exact per-group within a
        partition. TPC-H lineitem.l_orderkey and orders.o_orderkey hold
        this by construction of the load order.

        Verified, not assumed: checked over the data array itself,
        incrementally (only rows appended since the last call), and
        permanently demoted on the first violation (updates append new
        versions at the tail, which breaks monotonicity naturally).
        gc() rebuilds arrays and resets the tracker."""
        arr = self.data.get(cid)
        n = self.n
        if arr is None or arr.dtype == object or n == 0:
            return False
        st = self._clustered.setdefault(cid, [0, True])
        upto, ok = st
        if ok and n > upto:
            lo = max(upto - 1, 0)
            seg = arr[lo:n]
            ok = bool(np.all(seg[1:] >= seg[:-1])) and \
                not bool(self.nulls[cid][upto:n].any())
            st[0], st[1] = n, ok
        return st[1]

    def gc(self, safepoint: int) -> int:
        """Compact away versions deleted before `safepoint` (reference: TiKV
        GC under gc_life_time). Rebuilds arrays densely; dictionaries keep
        their codes."""
        dead = (self.delete_ts[:self.n] != 0) & \
               (self.delete_ts[:self.n] < safepoint)
        ndead = int(dead.sum())
        if ndead == 0:
            return 0
        keep = ~dead
        idx = np.nonzero(keep)[0]
        m = len(idx)
        for cid in list(self.data):
            self.data[cid][:m] = self.data[cid][idx]
            self.nulls[cid][:m] = self.nulls[cid][idx]
        self.handles[:m] = self.handles[idx]
        self.insert_ts[:m] = self.insert_ts[idx]
        self.delete_ts[:m] = self.delete_ts[idx]
        self.n = m
        self._clustered.clear()    # rows moved: re-verify from scratch
        with self._vecmat_mu:
            self._vecmat.clear()   # row positions moved under the twin
        self.gc_epoch += 1
        self._hpos = None          # positions changed: lazy rebuild
        self.version += 1
        return ndead

    # ---- reads --------------------------------------------------------
    def live_count(self) -> int:
        return int((self.delete_ts[:self.n] == 0).sum())

    def valid_at(self, read_ts: int | None = None, n: int | None = None
                 ) -> np.ndarray:
        """MVCC visibility mask: inserted at-or-before read_ts and not yet
        deleted at read_ts (read_ts None = read latest)."""
        if n is None:
            n = self.n
        ins = self.insert_ts[:n]
        dele = self.delete_ts[:n]
        if read_ts is None:
            return dele == 0
        return (ins <= read_ts) & ((dele == 0) | (dele > read_ts))

    def snapshot(self, col_ids: list, read_ts: int | None = None):
        """-> (arrays dict col_id -> (data, nulls|None, dict|None), valid).
        Captures self.n ONCE so concurrent appends can't produce
        inconsistent column lengths (copy-on-read consistency: rows below
        the captured n are immutable apart from delete marks)."""
        n = self.n
        valid = self.valid_at(read_ts, n)
        out = {}
        for cid in col_ids:
            arr = self.data[cid][:n]
            nl = self.nulls[cid][:n]
            out[cid] = (arr, nl if nl.any() else None, self.dicts.get(cid))
        return out, valid

    def handle_array(self):
        return self.handles[:self.n]

    def column_for(self, ci, idx=None) -> Column:
        arr = self.data[ci.id][:self.n]
        nl = self.nulls[ci.id][:self.n]
        col = Column(ci.ft, arr if idx is None else arr[idx],
                     (nl if idx is None else nl[idx]) if nl.any() else None,
                     self.dicts.get(ci.id))
        return col

    # ---- VECTOR(k) fixed-width twin -----------------------------------
    def _vec_parsed_table(self, cid: int, dim: int):
        """Per-dict parse cache: float32[ncodes, dim] + valid mask,
        extended only for codes added since the last call (the dict is
        append-only). Rows that fail to parse or disagree with the
        declared dimension are NaN/invalid. The cache also keeps the
        longest parsed length: where it is `dim`, the evaluator's
        dictionary matrix (expression/vec.py:_vec_matrix) is this very
        table and is not parsed a second time."""
        sd = self.dicts[cid]
        vals = sd.values
        cache = getattr(sd, "_vecmat_cache", None)
        if cache is None or cache[2] != dim:
            cache = [np.full((0, dim), np.nan, dtype=np.float32),
                     0, dim, 0]
        tab, upto, _d, maxlen = cache
        u = len(vals)
        if u > upto:
            from ..expression.vec import _parse_vec_text
            ext = np.full((u - upto, dim), np.nan, dtype=np.float32)
            for i in range(upto, u):
                v = _parse_vec_text(vals[i])
                if v is not None:
                    maxlen = max(maxlen, len(v))
                    if len(v) == dim:
                        ext[i - upto] = v
            tab = np.concatenate([tab, ext]) if upto else ext
            sd._vecmat_cache = [tab, u, dim, maxlen]
        return tab

    def vector_matrix(self, cid: int, dim: int):
        """The fixed-width columnar form of a VECTOR(dim) column:
        float32[n, dim], maintained APPEND-ONLY (only rows
        [filled, n) are decoded per call — the delta contract the
        device residency and the IVF index fold from). NULL/invalid
        rows are NaN rows. -> (matrix view [:n], n)."""
        n = self.n
        with self._vecmat_mu:
            st = self._vecmat.get(cid)
            if st is not None and (st[0].shape[1] != dim):
                st = None               # dimension changed under DDL
            if st is None:
                st = [np.full((max(n, 1024), dim), np.nan,
                              dtype=np.float32), 0]
                self._vecmat[cid] = st
            mat, filled = st
            if n > len(mat):
                grown = np.full((max(n, 2 * len(mat)), dim), np.nan,
                                dtype=np.float32)
                grown[:filled] = mat[:filled]
                mat = st[0] = grown
            if n > filled:
                tab = self._vec_parsed_table(cid, dim)
                codes = self.data[cid][filled:n]
                tail = tab[np.asarray(codes, dtype=np.int64)]
                nl = self.nulls[cid][filled:n]
                if nl.any():
                    tail = tail.copy()
                    tail[nl] = np.nan
                mat[filled:n] = tail
                st[1] = n
            return mat[:n], n


class ColumnarEngine:
    """Routes committed row mutations into per-table columnar deltas."""

    def __init__(self, storage, table_info_by_id):
        import threading
        self.storage = storage
        self.table_info_by_id = table_info_by_id   # callback id -> TableInfo
        self.tables: dict[int, ColumnarTable] = {}
        # commit hooks run outside the MVCC mutex; concurrent committers
        # must not interleave put_row/_ensure on the same arrays
        self._apply_mu = threading.Lock()
        # recovery: mutations buffer here until bulk segments are loaded,
        # so replayed DELETEs/UPDATEs of imported rows find their handles
        self._replay_buffer = None
        storage.mvcc.commit_hooks.append(self.apply_commit)

    def table(self, table_info) -> ColumnarTable:
        t = self.tables.get(table_info.id)
        if t is None:
            t = ColumnarTable(table_info)
            self.tables[table_info.id] = t
        elif t.table_info is not table_info:
            t.update_schema(table_info)
        return t

    def drop_table(self, table_id: int):
        """-> the dropped ColumnarTable, or None."""
        return self.tables.pop(table_id, None)

    def apply_commit(self, commit_ts: int, mutations: list):
        if self._replay_buffer is not None:
            self._replay_buffer.append((commit_ts, mutations))
            return
        with self._apply_mu:
            self._apply_locked(commit_ts, mutations)

    def _apply_locked(self, commit_ts: int, mutations: list):
        for key, value in mutations:
            if not key.startswith(TABLE_PREFIX) or key[9:11] != RECORD_PREFIX_SEP:
                continue
            table_id, handle = decode_record_key(key)
            info = self.table_info_by_id(table_id)
            if info is None:
                continue
            tbl = self.table(info)
            if value is None:
                tbl.delete_row(handle, commit_ts)
            else:
                tbl.put_row(handle, decode_row_value(value), commit_ts)

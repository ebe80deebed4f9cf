"""Vector search runtime: one per Domain (domain.vector); reference
tidb_tpu/vector/runtime.py.

Owns (1) the DEVICE RESIDENCY of every VECTOR(k) column's fixed-width
float32[rows, k] matrix, APPEND-ONLY maintained: commits tail-patch the
resident buffer with one program (site vector/delta: a clone of the
buffer with the padded tail slice-assigned, the old buffer never
written) instead of re-uploading it, riding the residency store's
appendable CAS machinery under its own uid ("vec", table uid) so the
base-table delta maintainer never mistakes it for a 1-D column; (2) the
IVF index registry (vector/ivf.py), fed by the capture seam
(Capture.subscribe_inline) for freshness bookkeeping; (3) the `topk`
entry the executor calls: exact single-dispatch brute force or the ANN
path, both returning a CANDIDATE slate the executor re-ranks on host
with the statement's own expression evaluator (device/host parity by
construction).

Each program is enqueued through copr/dag_exec.py:run_fragment, the
seam chip_smoke.py runs under torch.cuda.set_sync_debug_mode("error");
the query vector and the IVF candidate ids go up as pinned non-blocking
copies (counted as `query_upload_bytes`, beside the resident store's
`upload_bytes`), and the slate comes back in one pinned fetch (one
counted sync).

With a mesh (copr._get_mesh(): two or more shards) the matrix is
row-sharded over it as the reference's is (parallel.mesh Sharded, the
capacity rounded up to 128 x ndev, stored with spec "sharded"), and so
is the validity mask; the tail patch keeps the placement
(Sharded.patched); exact top-k and IVF scoring run the mesh programs of
vector/kernels.py, one program per statement as on one device, the
query vector and candidates replicated to each distinct device of the
mesh. IVF training and assignment read the shards gathered onto the
Domain's device (the reference trains on one local copy too), so the
index equals the single-device one.
"""
from __future__ import annotations

import os
import threading
import time

import numpy as np

from ..chunk.device import shape_bucket, upload
from ..copr import dag_exec
from ..parallel.mesh import Replicated, Sharded, place_sharded
from ..utils import phase
from ..utils import memory as _memory
from ..utils import metrics as _metrics
from ..utils.device_guard import DeviceDegradedError
from ..utils.fetch import host_array, prefetch
from . import kernels
from .ivf import IVFIndex, guarded

# the ORDER BY ops the planner lowers to a vector search (ascending:
# nearest first). vec_inner_product ASC would be farthest-first —
# that shape stays on the conventional path.
METRIC_OPS = ("vec_l2_distance", "vec_cosine_distance",
              "vec_negative_inner_product")

# candidate slack past offset+count: the device program selects in
# float32; the host re-rank (float64, the statement's own expression
# eval) needs the true top-k inside the slate even when ulp-level
# disagreement shuffles the boundary
TOPK_SLACK = 16
TOPK_MAX = 1 << 14          # the copr top-k push gate, same bound


def _device_scoring(copr) -> bool:
    """ANN candidate scoring placement: the numpy twin wins on the CPU
    (a per-query dispatch costs more than scoring a few thousand
    candidates); the card — or the force env the tests use — scores on
    the device."""
    mode = os.environ.get("TIDB_TPU_VECTOR_DEVICE", "auto")
    if mode == "0" or not copr.use_device:
        return False
    if mode == "1":
        return True
    return copr.device.type == "cuda"


def _query_upload(q32, device, mesh=None):
    """The query vector (or candidate ids) as a pinned non-blocking
    copy, counted apart from the resident store's uploads; with a mesh
    one copy per distinct device (a Replicated)."""
    if mesh is not None:
        return Replicated(mesh, {str(d): _query_upload(q32, d)
                                 for d in mesh.distinct()})
    phase.add("query_upload_bytes", q32.nbytes)
    return upload(q32, device)


def _mesh_of(dmat):
    """The mesh a resident matrix is sharded over, else None."""
    return dmat.mesh if isinstance(dmat, Sharded) else None


def _mesh_key(mesh):
    return None if mesh is None else mesh.fingerprint()


class VectorRuntime:
    """Registry + residency + search entry (module docstring)."""

    def __init__(self, domain):
        self.domain = domain
        self._mu = threading.Lock()
        self._indexes: dict = {}      # (table_id, name) -> IVFIndex
        self._pending: dict = {}      # table_id -> rows since last fold
        self._matkey: dict = {}       # (uid, cid) -> live resident key
        # uid -> (version, read_ts, n, mask): the MVCC validity mask is
        # pure in those keys; a search-heavy steady state must not
        # rebuild a corpus-length bool array per query
        self._valid_cache: dict = {}
        self._subscribed = False

    # ---- capture subscription (delta bookkeeping) ----------------------
    def attach(self):
        """Subscribe to the domain's capture seam (idempotent; called
        when the first vector index appears — a vector-free workload
        pays nothing)."""
        with self._mu:
            if self._subscribed:
                return
            self._subscribed = True
        self.domain.cdc.capture.subscribe_inline(self.on_commit)

    def on_commit(self, commit_ts: int, mutations: list):
        """Inline commit-hook consumer: count record mutations against
        indexed tables. Committing-thread context — O(batch), never
        raises; the actual fold is pull-based at search time."""
        try:
            with self._mu:
                watched = {tid for tid, _n in self._indexes}
            if not watched:
                return
            from ..cdc.capture import _is_record_key
            from ..codec.tablecodec import decode_record_key
            counts: dict = {}
            for key, _v in mutations:
                if _is_record_key(key):
                    tid, _h = decode_record_key(key)
                    if tid in watched:
                        counts[tid] = counts.get(tid, 0) + 1
            if counts:
                with self._mu:
                    for tid, c in counts.items():
                        self._pending[tid] = self._pending.get(tid, 0) + c
        except Exception:                   # noqa: BLE001
            pass

    def pending_rows(self, table_id: int) -> int:
        with self._mu:
            return self._pending.get(table_id, 0)

    # ---- index registry ------------------------------------------------
    def index_for(self, table_info, col_name: str):
        """Live IVFIndex for a PUBLIC vector IndexInfo over col_name,
        created lazily from the durable meta; None when the table has
        no vector index on that column."""
        meta = None
        for idx in table_info.indexes:
            if getattr(idx, "vector", False) and idx.columns and \
                    idx.columns[0].lower() == col_name.lower():
                meta = idx
                break
        if meta is None:
            return None
        ci = table_info.find_column(col_name)
        if ci is None or ci.ft.flen <= 0:
            return None
        key = (table_info.id, meta.name.lower())
        created = False
        with self._mu:
            inst = self._indexes.get(key)
            if inst is None:
                inst = IVFIndex(self.domain, table_info.id, meta.name,
                                col_name, ci.ft.flen,
                                getattr(meta, "params", None))
                self._indexes[key] = inst
                created = True
        if created:
            # a restarted domain rebuilds instances from durable meta:
            # the capture subscription (pending-delta bookkeeping)
            # must come back with them, not only from the DDL path
            self.attach()
        return inst

    def drop_index(self, table_id: int, name: str):
        with self._mu:
            self._indexes.pop((table_id, name.lower()), None)

    def indexes(self) -> list:
        """Snapshot for information_schema.tidb_vector_indexes."""
        with self._mu:
            return list(self._indexes.items())

    def clear_pending(self, table_id: int):
        with self._mu:
            self._pending.pop(table_id, None)

    # ---- device-resident matrix (delta-folded) -------------------------
    def device_matrix(self, copr, ctab, cid: int, dim: int, ectx=None):
        """The resident float32[cap, dim] matrix for a vector column:
        pure pool hit on an unchanged table, 2-D tail patch (ONE
        program, site vector/delta) under appends, full upload only on
        first touch / bucket growth / gc. With a mesh the matrix is a
        Sharded placement over it. -> (device tensor or Sharded, rows,
        cap)."""
        mat, n = ctab.vector_matrix(cid, dim)
        store = copr._dev_store
        mesh = copr._get_mesh()
        ndev = mesh.size if mesh is not None else 1
        cap = shape_bucket(n)
        if ndev > 1:
            lane = 128 * ndev
            cap = ((cap + lane - 1) // lane) * lane
        uid = ("vec", ctab.uid)
        key = ("vecmat", ctab.uid, cid, dim, ctab.gc_epoch, ndev, cap)
        with self._mu:
            prev = self._matkey.get((ctab.uid, cid))
            if prev is not None and prev != key:
                # bucket growth / gc compaction superseded the buffer
                store.drop(prev, "delta_compact")
            self._matkey[(ctab.uid, cid)] = key
        ent = store.get_appendable(key)
        if ent is not None:
            dev, rows, _ver = ent
            if rows >= n:
                phase.inc("upload_hits")
                _metrics.DEV_BUFFER_POOL.labels("hit").inc()
                return dev, n, cap
            patched = self._patch_matrix(copr, key, dev, rows, n, mat,
                                         ectx)
            if patched is not None:
                return patched, n, cap
            store.drop(key, "delta_overflow")
            _metrics.DELTA_APPLY.labels("fell_back_full_upload").inc()
        _metrics.DEV_BUFFER_POOL.labels("miss").inc()
        # pre-padded on the host: the shared upload tail pads 1-D only
        padded = np.full((cap, dim), np.nan, dtype=np.float32)
        padded[:n] = mat[:n]
        t0 = time.perf_counter()
        if mesh is not None:
            dev = place_sharded(mesh, padded)
            spec = "sharded"
        else:
            dev = upload(padded, copr.device)
            spec = "local"
        nbytes = padded.nbytes
        phase.add("upload_s", time.perf_counter() - t0)
        phase.add("upload_bytes", nbytes)
        phase.inc("uploads")
        _memory.consume_current(nbytes)
        store.put_appendable(key, dev, nbytes, uid, ctab.version,
                             rows=n, start=0, span=None, cap=cap,
                             spec=spec, ndev=ndev, epoch=ctab.gc_epoch)
        return dev, n, cap

    def _patch_matrix(self, copr, key, dev, rows, want, mat, ectx):
        """Tail-patch rows [rows, want) on device; CAS-advance the
        entry. None -> caller falls back to a full upload (on the CPU;
        on the card a degraded patch fails the statement)."""
        dlen = want - rows
        max_rows = copr.delta.max_delta_rows
        if ectx is not None:
            try:
                max_rows = int(ectx.sv.get("tidb_tpu_delta_max_rows"))
            except Exception:               # noqa: BLE001
                pass
        cap = key[-1]
        if dlen <= 0 or dlen > max_rows or want > cap:
            return None
        # bucket the update length (NaN-padded: padding rows are NULL
        # until later folds overwrite them), as the reference does so
        # that a steady write stream reuses one program per bucket
        ulen = min(shape_bucket(dlen), cap - rows)
        if ulen < dlen:
            return None
        upd = np.full((ulen, mat.shape[1]), np.nan, dtype=np.float32)
        upd[:dlen] = mat[rows:want]
        mesh = _mesh_of(dev)

        def fold():
            kc = copr._kernel_cache
            ck = ("vec_fold", cap, ulen, mat.shape[1], _mesh_key(mesh))
            if mesh is not None:
                # the same placement: a patch whose rows straddle a
                # shard boundary writes both shards' fresh copies
                kern = kc.get(ck) or kc.put(ck, Sharded.patched)
                return kern(dev, upd, rows)
            kern = kc.get(ck) or kc.put(ck, kernels.patch_rows)
            return kern(dev, upload(upd, copr.device), rows)

        try:
            new = guarded(copr, fold, "vector/delta", ectx, self.domain,
                          lambda: None)
        except DeviceDegradedError:
            raise
        except Exception:                   # noqa: BLE001
            return None
        if new is None:
            return None
        store = copr._dev_store
        # version is tracked by `rows` coverage, not the table version:
        # the uid ("vec", uid) never rides the bind-time version sweep
        if not store.apply_delta(key, new, want, None,
                                 expect_rows=rows):
            ent = store.get_appendable(key)
            if ent is not None and ent[1] >= want:
                return ent[0]
            return None
        dbytes = upd.size * upd.dtype.itemsize
        _metrics.DELTA_APPLY.labels("applied").inc()
        _metrics.DELTA_APPLY_BYTES.inc(dbytes)
        avoided = cap * upd.shape[1] * 4 - dbytes
        if avoided > 0:
            _metrics.DELTA_REUPLOAD_AVOIDED_BYTES.inc(avoided)
        phase.inc("delta_applies")
        phase.add("delta_bytes", dbytes)
        phase.add("upload_bytes", dbytes)
        return new

    # ---- search entries ------------------------------------------------
    def exact_topk(self, copr, ctab, cid: int, dim: int, metric: str,
                   q: np.ndarray, k: int, read_ts, ectx=None,
                   served=None, prefilter=None, filter_fp=None):
        """Exact brute-force top-k: ONE program over the resident matrix
        (distances + the tie-ordered top-k), one pinned fetch (one
        sync). -> candidate row positions (np.int64, best-first, may
        exceed k by slack). On the CPU a degrade serves the full numpy
        twin (chaos parity: the executor re-ranks either slate
        identically); on the card it fails the statement.

        prefilter: optional bool[n] predicate mask (hybrid search) —
        ANDed into MVCC validity BEFORE selection, so the program never
        spends its k-slots on non-matching rows. filter_fp keys the
        device-resident combined mask per predicate set (a warm repeat
        of the same hybrid query re-uses it: zero upload bytes)."""
        mat, n = ctab.vector_matrix(cid, dim)
        valid = self._valid_for(ctab, read_ts, n)
        if prefilter is not None:
            valid = valid & prefilter[:n]     # copy: never mutate cache
        kcap = _kcap(k, n)
        q32 = np.asarray(q, dtype=np.float32)

        def dev():
            dmat, _rows, cap = self.device_matrix(copr, ctab, cid, dim,
                                                  ectx)
            mesh = _mesh_of(dmat)
            pv = valid
            if len(pv) != cap:
                pv = np.zeros(cap, dtype=bool)
                pv[:n] = valid[:n]
            # derived per-(version, snapshot) entry under the TABLE uid,
            # in the matrix's placement: the bind-time sweep reclaims
            # stale ones like every other validity mask
            dvalid = copr._dev_put(
                (ctab.uid, "vecvalid", ctab.version, read_ts,
                 ctab.gc_epoch, filter_fp, _mesh_key(mesh), cap),
                pv, pad_fill=False, uid=ctab.uid, version=ctab.version,
                mesh=mesh, spec="sharded")
            dq = _query_upload(q32, copr.device, mesh)
            kc = copr._kernel_cache
            ck = ("vec_topk", metric, cap, dim, kcap, _mesh_key(mesh))
            kern = kc.get(ck) or kc.put(ck, (
                kernels.build_topk_kernel(metric, kcap) if mesh is None
                else kernels.build_topk_mesh_kernel(
                    metric, kcap, mesh, dmat.local, copr.device)))
            keys, idx = prefetch(dag_exec.run_fragment(kern, dmat, dvalid,
                                                       dq))
            hk = host_array(keys)
            hi = host_array(idx).astype(np.int64)
            return hi[hk > -np.inf]

        def host():
            if served is not None:
                served["host"] = True
            return kernels.host_topk(mat[:n], valid, q32, metric, kcap)

        if not copr.use_device:
            return host()
        return guarded(copr, dev, "vector/topk", ectx, self.domain, host)

    def ivf_topk(self, copr, ctab, index: IVFIndex, metric: str,
                 q: np.ndarray, k: int, read_ts, ectx=None,
                 prefilter=None):
        """ANN: probe nprobe partitions, score their postings.
        -> candidate positions (best-first).

        prefilter (hybrid search): bool[n] predicate mask ANDed into
        MVCC validity before scoring — and BEFORE probing: nprobe widens
        by ~1/selectivity so a 1% filter still probes enough partitions
        to surface k matching rows (candidates() clamps to the centroid
        count). Candidates failing the combined mask are dropped
        pre-upload: the scoring program only sees rows that could
        appear in the result."""
        index.refresh(copr, ctab, ectx)
        self.clear_pending(ctab.table_info.id)
        nprobe = _nprobe(ectx)
        q32 = np.asarray(q, dtype=np.float32)
        mat, n = ctab.vector_matrix(cid := self._cid_of(ctab, index),
                                    index.dim)
        valid = self._valid_for(ctab, read_ts, n)
        if prefilter is not None:
            valid = valid & prefilter[:n]     # copy: never mutate cache
            live = int(valid.sum())
            sel = live / n if n else 1.0
            if 0.0 < sel < 1.0:
                nprobe = max(nprobe, min(int(nprobe / sel) + 1, 4096))
        cand = index.candidates(q32, metric, nprobe)
        if not len(cand):
            return np.empty(0, dtype=np.int64)
        cand = cand[cand < n]
        if prefilter is not None:
            # pre-shrink: only rows passing predicate + MVCC get scored
            cand = cand[valid[cand]]
            if not len(cand):
                return np.empty(0, dtype=np.int64)
        kcap = _kcap(k, len(cand))

        def host():
            return _host_score(mat, valid, cand, q32, metric, kcap,
                               m2=index.sq_norms())

        if not _device_scoring(copr):
            return host()
        ccap = shape_bucket(len(cand))

        def dev():
            dmat, _rows, cap = self.device_matrix(copr, ctab, cid,
                                                  index.dim, ectx)
            mesh = _mesh_of(dmat)
            pc = np.zeros(ccap, dtype=np.int32)
            pc[:len(cand)] = cand
            cv = np.zeros(ccap, dtype=bool)
            cv[:len(cand)] = valid[cand]
            kc = copr._kernel_cache
            ck = ("vec_ivf", metric, cap, index.dim, ccap, kcap,
                  _mesh_key(mesh))
            kern = kc.get(ck) or kc.put(ck, (
                kernels.build_ivf_score_kernel(metric, kcap)
                if mesh is None else kernels.build_ivf_score_mesh_kernel(
                    metric, kcap, mesh, dmat.local, copr.device)))
            keys, idx = prefetch(dag_exec.run_fragment(
                kern, dmat, _query_upload(pc, copr.device, mesh),
                _query_upload(cv, copr.device, mesh),
                _query_upload(q32, copr.device, mesh)))
            hk = host_array(keys)
            hi = host_array(idx).astype(np.int64)
            return hi[hk > -np.inf]

        return guarded(copr, dev, "vector/ivf", ectx, self.domain, host)

    @staticmethod
    def _cid_of(ctab, index: IVFIndex) -> int:
        ci = ctab.table_info.find_column(index.col_name)
        return ci.id

    def _valid_for(self, ctab, read_ts, n):
        key = (ctab.version, read_ts, n)
        with self._mu:
            hit = self._valid_cache.get(ctab.uid)
            if hit is not None and hit[0] == key:
                return hit[1]
        mask = ctab.valid_at(read_ts, n)
        with self._mu:
            self._valid_cache[ctab.uid] = (key, mask)
            if len(self._valid_cache) > 64:
                self._valid_cache.pop(next(iter(self._valid_cache)))
        return mask


def _host_score(mat, valid, cand, q32, metric, kcap, m2=None):
    """Numpy twin of the IVF scoring program: same selection-key
    construction and the same tie rule (lowest position in the
    candidate array). Ranks L2 by SQUARED distance (monotone in the
    program's sqrt'd key, so the slate is identical) and selects with
    argpartition: the ANN hot path must not pay a full sort of every
    probed posting row. ``m2`` is the index's cached row squared-norm
    table — with it the L2 score is one gather + one [cand, dim] x
    [dim] matmul."""
    sub = mat[cand]
    with np.errstate(invalid="ignore", divide="ignore"):
        if metric == "vec_l2_distance":
            s = sub @ q32
            m2c = m2[cand] if m2 is not None and \
                (not len(cand) or cand.max() < len(m2)) \
                else (sub * sub).sum(axis=1)
            d = m2c - 2.0 * s + (q32 * q32).sum()
        else:
            d = kernels.host_distances(sub, q32, metric)
        key = np.where(valid[cand],
                       np.where(np.isnan(d), np.inf, -d),
                       np.float32(-np.inf))
    if len(key) > kcap:
        part = np.argpartition(-key, kcap - 1)[:kcap]
        order = part[np.lexsort((part, -key[part]))]
    else:
        order = np.argsort(-key, kind="stable")
    return cand[order[key[order] > -np.inf]]


def _kcap(k: int, n: int) -> int:
    """Top-k width: k + slack, bucketed to keep the program-cache key
    set small, clamped to the corpus."""
    want = min(max(k + TOPK_SLACK, 2 * k), max(n, 1))
    b = 16
    while b < want:
        b <<= 1
    return min(b, max(n, 1)) if n else b


def _nprobe(ectx) -> int:
    if ectx is not None:
        try:
            return int(ectx.sv.get("tidb_tpu_vector_nprobe"))
        except Exception:                   # noqa: BLE001
            pass
    from ..utils import env_int
    return env_int("TIDB_TPU_VECTOR_NPROBE", 8)

"""IVF vector index (reference tidb_tpu/vector/ivf.py): k-means
partitions, maintained incrementally through the delta contract.

Layout: `centroids` float32[nlist, dim] (k-means trained on the
domain's device over the resident matrix, site vector/train, numpy
Lloyd twin as the host fallback on the CPU) and one posting list of row
positions per centroid. Postings are append-only chunk lists — the same
contract the columnar arrays follow — so an OLTP write stream folds in
O(delta):

  * the runtime's capture subscription (Capture.subscribe_inline)
    counts committed record mutations per indexed table on the
    committing thread (bookkeeping only — O(batch), never raises);
  * at search time `refresh` assigns ONLY rows [folded_n, n) to their
    nearest centroid and appends them
    (tidb_tpu_vector_index_delta_total{outcome="applied"});
  * DELETE/UPDATE tombstones never touch postings — visibility rides
    the MVCC validity mask at scoring time, the version advance is
    free (outcome="advanced");
  * only a gc compaction (row positions rewritten under the index)
    rebuilds postings from the resident matrix (outcome="rebuild") —
    never a write.

Search: probe the `nprobe` nearest centroids (metric-consistent with
the query), gather their postings, and score candidates — on the card
(gather from the RESIDENT matrix + top-k, one dispatch, only the
candidate id vector uploaded), on the numpy twin on the CPU
(TIDB_TPU_VECTOR_DEVICE overrides).
"""
from __future__ import annotations

import math
import threading
import time

import numpy as np

from ..chunk.device import shape_bucket, upload
from ..parallel.mesh import Sharded
from ..utils import device_guard
from ..utils import metrics as _metrics
from ..utils.fetch import host_array, prefetch
from . import kernels

TRAIN_SAMPLE_MAX = 1 << 16
KMEANS_ITERS = 8
NLIST_MAX = 2048


def default_nlist(nrows: int) -> int:
    """4*sqrt(corpus) partitions, clamped — the classic IVF sizing
    band (FAISS guideline sqrt..16*sqrt; the 4x point keeps probed
    candidate sets ~nprobe/nlist of the corpus small enough that the
    ANN scan beats the exact scan by an order of magnitude)."""
    return max(1, min(4 * (int(math.sqrt(max(nrows, 1))) or 1),
                      NLIST_MAX))


def guarded(copr, fn, site, ectx, domain, host):
    """One supervised device program of the vector runtime: on the CPU
    a degrade takes the host twin `host`; on the card no host twin
    serves and the degrade (DeviceDegradedError) fails the statement."""
    to_host = copr.degrade_to_host
    return device_guard.guarded_dispatch(
        fn, site=site, ectx=ectx, domain=domain,
        host_fallback=host if to_host else None, fallback_is_host=to_host)


class IVFIndex:
    """One CREATE VECTOR INDEX ... USING IVF instance (runtime state;
    the durable meta is the IndexInfo row on the table)."""

    def __init__(self, domain, table_id: int, name: str, col_name: str,
                 dim: int, params: dict | None = None):
        self.domain = domain
        self.table_id = table_id
        self.name = name
        self.col_name = col_name
        self.dim = dim
        self.params = dict(params or {})
        self._mu = threading.Lock()
        self.built = False
        self.centroids = None          # float32 [nlist, dim]
        self._c2 = None                # cached centroid sq norms
        self._post: list = []          # centroid -> [np.int64 chunks]
        self._post_rows = 0
        # float32 row squared-norms aligned to folded rows: the ANN
        # host scorer's L2 needs only a gather + one matmul with these
        self._m2 = np.empty(0, dtype=np.float32)
        self.folded_n = 0
        self.folded_version = -1
        self.epoch = -1
        self.last_train_ts = 0.0
        self.rebuilds = 0              # posting rebuilds (gc only)

    # ---- stats surface (information_schema.tidb_vector_indexes) -------
    def stats(self) -> dict:
        with self._mu:
            return {
                "centroids": 0 if self.centroids is None
                else len(self.centroids),
                "rows": self._post_rows,
                "built": self.built,
                "last_train_ts": self.last_train_ts,
            }

    # ---- build / maintenance ------------------------------------------
    def refresh(self, copr, ctab, ectx=None):
        """Bring the index up to the table: lazy first build, then the
        incremental delta contract. Called at search time (pull-based,
        like copr/delta.py)."""
        with self._mu:
            if not self.built:
                # first build dispatches (kmeans) under _mu by design:
                # every concurrent search needs the trained index
                # anyway, so serializing them here IS the lazy-build
                # contract rather than a convoy
                # tpulint: disable=blocking-under-lock — lazy build
                self._train_locked(copr, ctab, ectx)
                return
            if ctab.gc_epoch != self.epoch:
                # positions rewrote under the postings: rebuild them
                # from the current matrix (centroids survive — the
                # data distribution did not change)
                self._rebuild_postings_locked(copr, ctab, ectx)
                _metrics.VECTOR_INDEX_DELTA.labels("rebuild").inc()
                self.rebuilds += 1
                return
            if ctab.version == self.folded_version:
                return
            # version BEFORE n (the delta.refresh rationale): a commit
            # landing between the two reads makes the index claim an
            # older version than its rows cover — one extra no-op
            # reconcile next search, never unclaimed rows
            version = ctab.version
            n = ctab.n
            if n > self.folded_n:
                self._fold_locked(copr, ctab, ectx, n)
                _metrics.VECTOR_INDEX_DELTA.labels("applied").inc()
            else:
                # delete/update tombstones: visibility rides the MVCC
                # mask at scoring time; nothing to fold
                _metrics.VECTOR_INDEX_DELTA.labels("advanced").inc()
            self.folded_version = version

    def _train_locked(self, copr, ctab, ectx):
        cid = self._cid(ctab)
        version = ctab.version         # BEFORE the matrix read (see
        epoch = ctab.gc_epoch          # refresh): coverage never over-
        mat, n = ctab.vector_matrix(cid, self.dim)  # claims rows
        live = ctab.valid_at(None, n) & ~np.isnan(mat[:n, 0])
        ids = np.nonzero(live)[0]
        nlist = int(self.params.get("lists") or default_nlist(len(ids)))
        nlist = max(1, min(nlist, max(len(ids), 1)))
        rng = np.random.RandomState(ctab.uid % (1 << 31) or 13)
        if len(ids) == 0:
            cent = np.zeros((nlist, self.dim), dtype=np.float32)
        else:
            sample = ids if len(ids) <= TRAIN_SAMPLE_MAX else \
                rng.choice(ids, TRAIN_SAMPLE_MAX, replace=False)
            seeds = rng.choice(sample, nlist, replace=False) \
                if len(sample) >= nlist else sample[:nlist]
            cent0 = mat[np.sort(seeds)].astype(np.float32)
            cent = self._kmeans(copr, ctab, cid, mat[:n], live, cent0,
                                ectx)
        self.centroids = np.asarray(cent, dtype=np.float32)
        self._c2 = (self.centroids * self.centroids).sum(
            axis=1, dtype=np.float32)
        self.epoch = epoch
        self.folded_version = version
        self.last_train_ts = time.time()
        self.built = True
        self._build_postings_locked(copr, ctab, ectx, mat, n)

    def _resident(self, copr, ctab, cid, n, ectx):
        """The runtime's resident [cap, dim] matrix, holding at least n
        rows (the training and posting programs read it in place: no
        second upload of the corpus). A matrix sharded over a mesh is
        gathered onto the Domain's device (a device copy, no upload):
        the reference trains on one local copy too, so the centroids
        and postings equal the single-device route's."""
        dmat, rows, _cap = self.domain.vector.device_matrix(
            copr, ctab, cid, self.dim, ectx)
        if isinstance(dmat, Sharded):
            dmat = dmat.gather(copr.device)
        return dmat, rows

    def _kmeans(self, copr, ctab, cid, mat, live, cent0, ectx):
        """KMEANS_ITERS Lloyd steps over the resident matrix, on the
        device under supervision (the numpy twin is the host fallback
        on the CPU)."""
        n = len(mat)

        def host():
            return kernels.host_kmeans(mat, live, cent0.copy(),
                                       KMEANS_ITERS)

        if not copr.use_device:
            return host()

        def dev():
            dmat, _rows = self._resident(copr, ctab, cid, n, ectx)
            cap = dmat.shape[0]
            pv = np.zeros(cap, dtype=bool)
            pv[:n] = live
            kc = copr._kernel_cache
            key = ("vec_kmeans", cap, self.dim, len(cent0))
            kern = kc.get(key) or kc.put(key, kernels.build_kmeans_step())
            dv = upload(pv, copr.device)
            c = upload(cent0, copr.device)
            for _ in range(KMEANS_ITERS):
                c = kern(dmat, dv, c)
            return host_array(prefetch(c))

        return guarded(copr, dev, "vector/train", ectx, self.domain, host)

    def _assign(self, copr, mat, ectx, dmat=None):
        """Nearest-centroid id per row — device for large deltas, the
        numpy twin for small ones (a per-commit fold must not pay a
        dispatch round-trip for a handful of rows). `dmat`: the
        resident matrix whose first len(mat) rows are `mat`."""
        if len(mat) < 4096 or not copr.use_device:
            return kernels.host_assign(mat, self.centroids)

        def dev():
            src = dmat
            if src is None:
                cap = shape_bucket(len(mat))
                src = upload(_pad_rows(mat, cap), copr.device)
            kc = copr._kernel_cache
            key = ("vec_assign", src.shape[0], self.dim,
                   len(self.centroids))
            kern = kc.get(key) or kc.put(key, kernels.build_assign_kernel())
            out = kern(src[:len(mat)],
                       upload(self.centroids, copr.device))
            return host_array(prefetch(out))

        return guarded(copr, dev, "vector/train", ectx, self.domain,
                       lambda: kernels.host_assign(mat, self.centroids))

    def _build_postings_locked(self, copr, ctab, ectx, mat, n):
        self._post = [[] for _ in range(len(self.centroids))]
        self._post_rows = 0
        with np.errstate(invalid="ignore"):
            self._m2 = (mat[:n] * mat[:n]).sum(axis=1, dtype=np.float32)
        if n:
            dmat = None
            if n >= 4096 and copr.use_device:
                dmat, _rows = self._resident(copr, ctab, self._cid(ctab),
                                             n, ectx)
            a = self._assign(copr, mat[:n], ectx, dmat=dmat)
            order = np.argsort(a, kind="stable")
            bounds = np.searchsorted(a[order],
                                     np.arange(len(self.centroids) + 1))
            for c in range(len(self.centroids)):
                seg = order[bounds[c]:bounds[c + 1]]
                if len(seg):
                    self._post[c].append(seg.astype(np.int64))
            self._post_rows = n
        self.folded_n = n

    def _rebuild_postings_locked(self, copr, ctab, ectx):
        cid = self._cid(ctab)
        version = ctab.version
        epoch = ctab.gc_epoch
        mat, n = ctab.vector_matrix(cid, self.dim)
        self.epoch = epoch
        self.folded_version = version
        self._build_postings_locked(copr, ctab, ectx, mat, n)

    def _fold_locked(self, copr, ctab, ectx, n):
        """THE delta path: assign only the appended tail and append to
        postings — O(delta), never a rebuild."""
        cid = self._cid(ctab)
        mat, upto = ctab.vector_matrix(cid, self.dim)
        upto = min(upto, n)
        tail = mat[self.folded_n:upto]
        if len(tail) == 0:
            return
        with np.errstate(invalid="ignore"):
            self._m2 = np.concatenate(
                [self._m2, (tail * tail).sum(axis=1, dtype=np.float32)])
        a = self._assign(copr, tail, ectx)
        base = self.folded_n
        order = np.argsort(a, kind="stable")
        bounds = np.searchsorted(a[order], np.arange(len(self._post) + 1))
        for c in range(len(self._post)):
            seg = order[bounds[c]:bounds[c + 1]]
            if len(seg):
                self._post[c].append(base + seg.astype(np.int64))
        self._post_rows += len(tail)
        self.folded_n = upto

    def _cid(self, ctab):
        ci = ctab.table_info.find_column(self.col_name)
        if ci is None:
            raise KeyError(f"vector index column {self.col_name} gone")
        return ci.id

    def sq_norms(self):
        return self._m2

    # ---- search --------------------------------------------------------
    def candidates(self, q: np.ndarray, metric: str, nprobe: int):
        """Row positions from the nprobe nearest partitions (by the
        query's metric over the centroids). -> int64 positions."""
        with self._mu:
            cent = self.centroids
            if cent is None or not len(cent):
                return np.empty(0, dtype=np.int64)
            with np.errstate(invalid="ignore", divide="ignore"):
                if metric == "vec_l2_distance":
                    # squared form with the cached centroid norms:
                    # ordering-identical, one matmul per probe
                    cd = self._c2 - 2.0 * (cent @ q)
                elif metric == "vec_negative_inner_product":
                    cd = -(cent @ q)
                else:
                    cd = kernels.host_distances(cent, q, metric)
            bad = np.isnan(cd)
            if bad.any():
                cd = np.where(bad, np.inf, cd)
            nprobe = max(1, min(int(nprobe), len(cent)))
            if nprobe < len(cent):
                probe = np.argpartition(cd, nprobe - 1)[:nprobe]
            else:
                probe = np.arange(len(cent))
            _metrics.VECTOR_NPROBE_PARTITIONS.inc(len(probe))
            chunks = []
            for c in probe:
                post = self._post[c]
                if len(post) > 1:
                    # consolidate append chunks so steady-state probes
                    # concat one array per partition
                    self._post[c] = post = [np.concatenate(post)]
                chunks.extend(post)
            if not chunks:
                return np.empty(0, dtype=np.int64)
            return np.concatenate(chunks)


def _pad_rows(mat, cap):
    if len(mat) == cap:
        return np.ascontiguousarray(mat, dtype=np.float32)
    out = np.full((cap, mat.shape[1]), np.nan, dtype=np.float32)
    out[:len(mat)] = mat
    return out

"""VectorSearchExec: serves PhysVectorSearch (reference
tidb_tpu/executor/vector_search.py; docs/VECTOR.md).

Pipeline: the vector runtime produces a CANDIDATE SLATE of row
positions (exact single-dispatch program, IVF ANN probe, or the numpy
twin under degradation on the CPU), then this executor gathers those rows from the
columnar snapshot and RE-RANKS them with the statement's own ORDER BY
expression through the host TopN machinery (_sort_key_arrays — the
exact code path the conventional plan would run). Device selection
therefore decides only WHICH rows reach the slate; their final order
and the NULLs-first/tie-stability semantics are host semantics by
construction, which is what makes chaos parity (injected grant loss at
device_guard/vector/topk) hold bit-identically on the CPU. On the card
no host twin serves a degraded program: the statement fails
(copr.degrade_to_host is False), as a failed fused fragment does.

Anything outside the runtime's contract — a dirty transaction overlay
on this table, a resolved-read mismatch, a vanished column — falls back
to the conventional TopN-over-TableReader subtree wholesale.
"""
from __future__ import annotations

import numpy as np

from ..utils import metrics as _metrics
from ..utils.device_guard import DeviceDegradedError
from .exec_base import Executor
from .executors import (TableReaderExec, TopNExec, _sort_key_arrays)


class VectorSearchExec(Executor):
    def __init__(self, ctx, plan):
        super().__init__(ctx, plan.schema, [])
        self.plan = plan
        self._out = None

    def open(self):
        pass

    def backend_info(self):
        return getattr(self, "_backend", "")

    def next(self):
        if self._out is None:
            self._out = self._run()
        if not self._out:
            return None
        return self._out.pop(0)

    # ---- serving ------------------------------------------------------
    def _fallback(self, path: str):
        """The conventional subtree: host TopN over the table reader
        (UnionScan overlays and all)."""
        self._backend = "host"
        _metrics.VECTOR_SEARCH.labels(path).inc()
        reader = TableReaderExec(self.ctx, self.plan.reader)
        topn = TopNExec(self.ctx, self.plan, reader)
        out = []
        while True:
            ch = topn.next()
            if ch is None:
                return out
            out.append(ch)

    def _run(self):
        plan = self.plan
        ctx = self.ctx
        dag = plan.reader.dag
        copr = ctx.copr
        dom = ctx.sess.domain
        rt = dom.vector
        ctab = copr.engine.table(dag.table_info)
        reader = TableReaderExec(ctx, plan.reader)
        if reader._overlay(dag) is not None:
            # uncommitted rows in scope: UnionScan semantics belong to
            # the conventional subtree
            return self._fallback("host_fallback")
        read_ts = ctx.read_ts()
        ci = dag.table_info.find_column(plan.col_name)
        if ci is None or ci.ft.flen != len(plan.query):
            return self._fallback("host_fallback")
        # bind-time freshness, same order as copr._execute_inner: fold
        # deltas first (patched entries survive), then sweep stale
        copr.delta.refresh(ctab, ctx)
        copr._dev_store.invalidate(ctab.uid, ctab.version)
        k = plan.offset + plan.count
        served = {}
        prefilter = filter_fp = None
        if plan.filters:
            # hybrid search (docs/VECTOR.md): scalar predicates become a
            # row mask ANDed into MVCC validity BEFORE top-k selection
            try:
                prefilter, filter_fp = self._filter_mask(
                    ctab, dag, read_ts)
            except Exception:                   # noqa: BLE001
                # predicate not maskable over the snapshot (exotic
                # expr): conventional subtree owns it
                return self._fallback("host_fallback")
        index = rt.index_for(dag.table_info, plan.col_name)
        nprobe = _nprobe_of(ctx)
        try:
            if index is not None and nprobe > 0:
                cand = rt.ivf_topk(copr, ctab, index, plan.metric,
                                   plan.query, k, read_ts, ectx=ctx,
                                   prefilter=prefilter)
                path = "ivf"
                if len(cand) < k:
                    # probed partitions hold fewer live rows than the
                    # statement asked for (dead clusters, tiny
                    # postings, or a selective hybrid predicate): ANN
                    # may not silently shrink a LIMIT — the exact scan
                    # owns the answer
                    cand = rt.exact_topk(copr, ctab, ci.id, ci.ft.flen,
                                         plan.metric, plan.query, k,
                                         read_ts, ectx=ctx,
                                         served=served,
                                         prefilter=prefilter,
                                         filter_fp=filter_fp)
                    path = "host_fallback" if served.get("host") \
                        else "exact"
            else:
                cand = rt.exact_topk(copr, ctab, ci.id, ci.ft.flen,
                                     plan.metric, plan.query, k,
                                     read_ts, ectx=ctx, served=served,
                                     prefilter=prefilter,
                                     filter_fp=filter_fp)
                path = "host_fallback" if served.get("host") else "exact"
        except DeviceDegradedError:
            if not copr.degrade_to_host:
                raise
            return self._fallback("host_fallback")
        if prefilter is not None:
            path = "hybrid_" + path
        _metrics.VECTOR_SEARCH.labels(path).inc()
        self._backend = "vector/" + path
        return [self._gather(ctab, dag, read_ts, np.asarray(
            cand, dtype=np.int64))]

    def _filter_mask(self, ctab, dag, read_ts):
        """Hybrid search: evaluate the statement's scalar predicates
        host-side over the full columnar snapshot -> (bool[n] mask,
        fingerprint). Same EvalCtx + eval_bool_mask loop (NULL->False)
        the conventional subtree runs, so the pre-filtered slate is
        row-for-row what TopN-over-filtered-scan would admit. The
        fingerprint keys the device-resident combined validity mask per
        predicate set: a warm repeat of the same hybrid statement at
        the same snapshot re-uses the resident mask (zero uploads)."""
        import zlib
        from ..expression.vec import EvalCtx, eval_bool_mask
        copr = self.ctx.copr
        cids = [cid for cid in (copr._cid(dag, sc) for sc in dag.cols)
                if cid != -1]
        arrays, valid = ctab.snapshot(cids, read_ts)
        n = len(valid)
        handles = ctab.handle_array()[:n]
        cols = {}
        for sc in dag.cols:
            cid = copr._cid(dag, sc)
            if cid == -1:
                cols[sc.col.idx] = (handles, None, None)
                continue
            data, nulls, sdict = arrays[cid]
            cols[sc.col.idx] = (
                data[:n], None if nulls is None else nulls[:n], sdict)
        ectx = EvalCtx(np, n, cols, host=True)
        mask = np.ones(n, dtype=bool)
        for f in self.plan.filters:
            mask &= np.asarray(eval_bool_mask(ectx, f))
        fp = "%08x" % zlib.crc32("|".join(
            sorted(repr(f) for f in self.plan.filters)).encode())
        return mask, fp

    def _gather(self, ctab, dag, read_ts, cand):
        """Gather the slate rows and re-rank on host (module
        docstring)."""
        from ..chunk.chunk import Chunk
        from ..chunk.column import Column as CCol
        plan = self.plan
        cids = [cid for cid in (self.ctx.copr._cid(dag, sc)
                                for sc in dag.cols) if cid != -1]
        arrays, valid = ctab.snapshot(cids, read_ts)
        n = len(valid)
        cand = cand[(cand >= 0) & (cand < n)]
        cand = cand[valid[cand]]
        handles = ctab.handle_array()[:n]
        cols = []
        for sc in dag.cols:
            cid = self.ctx.copr._cid(dag, sc)
            if cid == -1:
                cols.append(CCol(sc.col.ft, handles[cand], None, None))
                continue
            data, nulls, sdict = arrays[cid]
            cols.append(CCol(sc.col.ft, data[cand],
                             None if nulls is None else nulls[cand],
                             sdict))
        chunk = Chunk(cols)
        if len(chunk):
            keys = _sort_key_arrays(self.schema, chunk, plan.items)
            order = np.lexsort(list(reversed(keys)))[
                :plan.offset + plan.count]
            chunk = chunk.take(order)
        return chunk.take(np.arange(plan.offset, len(chunk))) \
            if plan.offset else chunk


def _nprobe_of(ctx) -> int:
    from ..vector.runtime import _nprobe
    return _nprobe(ctx)

"""MLPredictExec: serves PhysMLPredict (reference
tidb_tpu/executor/ml_predict.py; docs/ML.md).

Standalone in-SQL inference: `SELECT ..., predict(m, f...) FROM t`
drains the wrapped table reader (MVCC, overlays, and residual filters
all belong to the reader — the batch IS the result set), extracts the
feature matrix host-side with the exact numpy evaluator ProjectionExec
would use, and forwards ALL rows through MLRuntime.predict_rows in ONE
call: resident weights (uploaded once per model version), resident
padded features (pool-hit on a warm repeat at the same snapshot), one
matmul-chain dispatch, one fetch sync. Non-predict expressions
in the projection evaluate per chunk exactly as ProjectionExec does,
so the output is bit-identical to the conventional plan — which is
also the parity twin: a dirty transaction overlay (residency keys
cannot describe uncommitted rows) or, on the CPU, device degradation
serves the same rows through the host forward pass (on the card a
degraded forward fails the statement).
"""
from __future__ import annotations

import numpy as np

from ..chunk.chunk import Chunk
from ..expression.vec import (EvalCtx, _to_float, eval_expr,
                              materialize_nulls, or_nulls)
from ..utils import phase
from ..utils import metrics as _metrics
from .exec_base import Executor, bind_chunk, eval_to_column
from .executors import TableReaderExec


class MLPredictExec(Executor):
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

    def _run(self):
        from ..ml.lowering import MLFunc
        ctx = self.ctx
        plan = self.plan
        dag = plan.reader.dag
        copr = ctx.copr
        reader = TableReaderExec(ctx, plan.reader)
        # residency keys (version + read_ts) cannot describe a dirty
        # overlay's rows: uncommitted statements take the host twin
        dirty = reader._overlay(dag) is not None
        read_ts = ctx.read_ts()
        chunks = reader.all_chunks()
        if not chunks:
            return []
        rschema = plan.reader.schema
        mls = [e for e in plan.exprs
               if isinstance(e, MLFunc) and e.op == "predict"]
        # stage 1: per-chunk host feature extraction (numpy, same
        # _to_float/or_nulls semantics as the registered predict op)
        ectxs, feats, nullms = [], {id(e): [] for e in mls}, {}
        for ch in chunks:
            n = len(ch)
            ectx = EvalCtx(np, n, bind_chunk(rschema, ch), host=True)
            ectxs.append(ectx)
            for e in mls:
                X, nm = _features(ectx, e)
                feats[id(e)].append(X)
                nullms.setdefault(id(e), []).append(nm)
        total = sum(len(ch) for ch in chunks)
        # stage 2: ONE batched forward per distinct predict expr
        rt = ctx.sess.domain.ml
        ctab = copr.engine.table(dag.table_info)
        ys = {}
        for e in mls:
            h = e.model
            X = feats[id(e)][0] if len(feats[id(e)]) == 1 \
                else np.concatenate(feats[id(e)], axis=0)
            served = {}
            if dirty:
                served["host"] = True
                from ..ml import kernels
                y = kernels.host_forward(X, h.weights, h.biases)
            else:
                fids = tuple(a.fingerprint() for a in e.args)
                y = rt.predict_rows(copr, ctab, h, X, read_ts,
                                    (h.fingerprint(),) + fids,
                                    ectx=ctx, served=served)
            ys[id(e)] = np.asarray(y, dtype=np.float64)
            h.predict_calls += 1
            h.predict_rows += total
            _metrics.ML_PREDICT.labels(
                "host_fallback" if served.get("host") else
                "device").inc()
            _metrics.ML_ROWS.inc(total)
            phase.inc("ml_predicts")
            phase.add("ml_rows", total)
        self._backend = "ml/host" if dirty else "ml/device"
        # stage 3: reassemble output chunks (predict columns sliced
        # from the batched result, everything else via eval_to_column)
        from ..chunk.column import Column as CCol
        out, off = [], 0
        for ch, ectx in zip(chunks, ectxs):
            n = len(ch)
            cols = []
            for e in plan.exprs:
                if id(e) in ys:
                    nm = nullms[id(e)][len(out)]
                    cols.append(CCol(e.ft, ys[id(e)][off:off + n],
                                     nm if nm is not None and nm.any()
                                     else None, None))
                else:
                    cols.append(eval_to_column(ectx, e, n))
            out.append(Chunk(cols))
            off += n
        return out


def _features(ectx, e):
    """-> ([n, nf] float32 feature matrix, bool null mask | None) for
    one MLFunc predict over a bound chunk — the same arg-eval loop the
    registered op runs, hoisted so the batch can span chunks."""
    nullm = None
    cols = []
    for a in e.args:
        data, nulls, _sd = eval_expr(ectx, a)
        nullm = or_nulls(np, nullm, nulls)
        v = _to_float(ectx, data, a.ft)
        if np.isscalar(v) or getattr(v, "ndim", 1) == 0:
            v = ectx.full(float(v), dtype=np.float32)
        cols.append(np.asarray(v, dtype=np.float32))
    X = np.stack(cols, axis=1)
    nm = np.asarray(materialize_nulls(ectx, nullm))
    return X, (nm if nm.any() else None)

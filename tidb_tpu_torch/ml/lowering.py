"""Expression-level lowering of in-SQL inference (reference
tidb_tpu/ml/lowering.py).

`predict(m, f1, f2, ...)` is a registered, device-safe expression op
(expression/torch_ns.device_form): when a filter/projection containing
it lands in a copr fragment, the xp-generic forward chain runs in the
SAME fragment body as the scan/filter/agg over the fragment's device
columns, with the model's weights taken from MLRuntime.device_weights
(resident under ("mlw", id, version, i): the reference's weights are
XLA constants of its compiled fragment, while the port's fragment
re-runs Python per statement, so a per-call `xp.asarray(W)` would copy
them every time). Scoring a million rows inside a WHERE clause is part
of the one fused dispatch, not a separate pass. `embed(m, txt)` is
host-only: it runs at ingest (computed VECTOR columns) and in host
eval, producing canonical vector text that folds into the resident
vector matrix through the delta path.

Kernel-cache / plan-cache correctness: `MLFunc` embeds the model's
version-qualified fingerprint (`name#v3`) in both `fingerprint()` and
`repr()` — `_plan_fp` keys fragment programs on filter reprs and the
plan cache keys on schema version, so replacing a model can never serve
a stale lowered form.

Model-name resolution happens at rewrite time (`resolve_ml_call`,
called from the planner's `_rw_FuncCall`): the first argument is a bare
identifier or string literal naming the model, looked up through
`pctx.model_lookup` (the domain's epoch-keyed ModelRegistry).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..errors import TiDBError, UnsupportedError
from ..expression.expr import ScalarFunc
from ..expression.vec import (_HOST_ONLY, _apply_str_fn, _fmt_vec_f,
                              _to_float, eval_expr, op, or_nulls)
from ..types.field_type import new_double_type, new_vector_type
from ..utils import metrics as _metrics
from ..utils import phase
from . import kernels


@dataclass
class MLFunc(ScalarFunc):
    """A ScalarFunc bound to a resolved ModelHandle. args are the
    FEATURE expressions only — the model argument is consumed at
    rewrite time."""

    model: object = None

    def fingerprint(self):
        mfp = self.model.fingerprint() if self.model is not None else "?"
        return (f"{self.op}[{mfp}]"
                f"({','.join(a.fingerprint() for a in self.args)})")

    def __repr__(self):
        mfp = self.model.fingerprint() if self.model is not None else "?"
        return (f"{self.op}[{mfp}]"
                f"({', '.join(map(repr, self.args))})")


@op("predict")
def _op_predict(ctx, e):
    """Dense forward pass over the row's feature columns. xp-generic:
    on host this is the numpy twin; in a fragment (xp=TorchNS) the
    chain runs in the fragment body over the resident weights. Any
    NULL feature nulls the output row."""
    h = e.model
    xp = ctx.xp
    nullm = None
    feats = []
    for a in e.args:
        data, nulls, _sd = eval_expr(ctx, a)
        nullm = or_nulls(xp, nullm, nulls)
        v = _to_float(ctx, data, a.ft)
        if np.isscalar(v) or getattr(v, "ndim", 1) == 0:
            v = ctx.full(float(v), dtype=np.float32)
        feats.append(xp.asarray(v, dtype=xp.float32))
    X = xp.stack(feats, axis=1)
    ws, bs = h.weights, h.biases
    if not ctx.host and h.runtime is not None:
        copr = h.runtime.domain.copr
        if copr.device == getattr(xp, "device", None):
            ws, bs = h.runtime.device_weights(copr, h)
    y = kernels.forward_xp(xp, X, ws, bs)
    if ctx.host:
        h.predict_calls += 1
        h.predict_rows += ctx.n
        _metrics.ML_PREDICT.labels("host").inc()
        _metrics.ML_ROWS.inc(ctx.n)
        phase.inc("ml_predicts")
        phase.add("ml_rows", ctx.n)
    else:
        # once per fragment call: the rows ride the fragment's own
        # phase counters
        _metrics.ML_PREDICT.labels("fused").inc()
    return xp.asarray(y, dtype=ctx.float_dtype), nullm, None


@op("embed")
def _op_embed(ctx, e):
    """Embedding-table lookup -> canonical vector text. Host-only (in
    _HOST_ONLY): runs at ingest for computed VECTOR columns and in
    host eval; the device story is the maintained column folding into
    the resident vector matrix via the delta path."""
    h = e.model
    table = h.table
    vocab = max(1, len(table))

    def tok(s):
        import zlib
        row = table[zlib.crc32(str(s).encode("utf-8")) % vocab]
        return "[" + ",".join(_fmt_vec_f(float(x))
                              for x in row.tolist()) + "]"

    h.predict_calls += 1
    h.predict_rows += ctx.n
    _metrics.ML_ROWS.inc(ctx.n)
    phase.add("ml_rows", ctx.n)
    return _apply_str_fn(ctx, eval_expr(ctx, e.args[0]), tok)


_HOST_ONLY.add("embed")


def resolve_ml_call(rw, node):
    """Rewrite a predict()/embed() FuncCall: resolve the model name
    through pctx.model_lookup, validate arity/kind against the parsed
    weights, and bind an MLFunc. Called from Rewriter._rw_FuncCall."""
    from ..parser import ast

    name = node.name.lower()
    if not node.args:
        raise TiDBError("%s() requires a model name as its first "
                        "argument", name)
    marg = node.args[0]
    if isinstance(marg, ast.ColumnRef) and not marg.table:
        mname = marg.name
    elif isinstance(marg, ast.Literal) and isinstance(marg.value, str):
        mname = marg.value
    else:
        raise UnsupportedError(
            "first argument of %s() must be a model name", name)
    lookup = getattr(rw.pctx, "model_lookup", None)
    h = lookup(mname) if lookup is not None else None
    if h is None:
        raise TiDBError("Model '%s' doesn't exist", mname)

    args = [rw.rewrite(a) for a in node.args[1:]]
    if name == "predict":
        if h.kind == "embedding":
            raise TiDBError("Model '%s' is an embedding table; use "
                            "embed()", mname)
        if int(h.info.params.get("out_dim", 1)) != 1:
            raise UnsupportedError(
                "predict() requires a single-output model; '%s' has %d "
                "outputs", mname, int(h.info.params.get("out_dim", 1)))
        if len(args) != h.in_features:
            raise TiDBError(
                "Model '%s' expects %d feature arguments, got %d",
                mname, h.in_features, len(args))
        for a in args:
            if a.ft is not None and getattr(a.ft, "is_vector", False):
                raise UnsupportedError(
                    "predict() feature arguments must be numeric, not "
                    "VECTOR")
        ft = new_double_type()
    else:
        if h.kind != "embedding":
            raise TiDBError("Model '%s' is not an embedding table; use "
                            "predict()", mname)
        if len(args) != 1:
            raise TiDBError("embed() takes exactly (model, column)")
        ft = new_vector_type(h.dim)
    return MLFunc(op=name, args=args, ft=ft, model=h)

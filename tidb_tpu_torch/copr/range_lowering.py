"""Range lowering of a fused fragment's fact filters: the comparisons
of a bare column against a constant become per-column inclusive int64
bounds [lo, hi], the input of the range_filter_sums kernel
(ops/scan_kernels.py; tidb_tpu/ops/pallas_scan.py:range_filter_sums on
the TPU).

This module is the port's own: the reference has no counterpart. Its
TPU kernel is reached only from tidb_tpu's tests, and its fused fragment
evaluates every filter through the expression evaluator. The lowering
changes no answer: a bound is what the evaluator's comparison selects
on the same column, derived from the evaluator's own arithmetic
(expression/vec.py: _eval_const for the constant, coerce_numeric_pair
for the common scale), so `lo <= x <= hi` equals eval_bool_mask of the
filter on every value of the column's type (NULL compares false: the
fragment ANDs the column's ~nulls into the kernel's valid mask).

Accepted: `<`, `<=`, `>`, `>=`, `=` (BETWEEN arrives split into two of
them) between a bare Column and a Constant, the constant on either side,
where the column is int or decimal (int64 storage, signed) against an
int or decimal constant, or date against a date constant. `<` c is
`<=` c - 1 on the scaled ints; a constant with more scale than the
column takes the floor or the ceiling by the direction of the test, and
only where the column's values cannot overflow the evaluator's rescale.
Bounds past INT64_MIN/MAX leave the range empty or unbounded; they never
wrap. Several predicates on one column intersect into one [lo, hi].

Declined (the filter stays on the evaluator path): `!=`, IN, OR, NOT,
anything over an expression, float columns or constants, unsigned
columns or constants, dictionary-coded strings, datetime, timestamp and
time types, NULL constants, and anything not listed above. Parameter
markers reach a fragment as Constants bound at plan time; their values
are in the filters' fingerprints, which key the cached fragment
(copr/pipeline.py:_fused_cache_key), so a bound never outlives them.
"""
from __future__ import annotations

import numpy as np

from ..expression import EvalCtx
from ..expression.expr import Column, Constant, ScalarFunc
from ..expression.vec import _eval_const, coerce_numeric_pair
from ..ops.scan_kernels import MAX_PREDS
from ..types.datum import Kind
from ..types.field_type import TypeClass

I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1
EMPTY = (I64_MAX, I64_MIN)              # lo > hi: no row passes

_OPS = ("<", "<=", ">", ">=", "=")
_FLIP = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "="}


class RangeLowering:
    """One fragment's filters split for range_filter_sums: `cols` are the
    plan column indexes of the predicate columns, in the order of their
    first filter; `bounds` their intersected (lo, hi); `lowered` the
    filters they replace; `rest` the declined filters, which stay on the
    evaluator path."""

    __slots__ = ("cols", "bounds", "lowered", "rest")

    def __init__(self, cols, bounds, lowered, rest):
        self.cols = cols
        self.bounds = bounds
        self.lowered = lowered
        self.rest = rest


def _column_class(ft):
    """-> "int", "decimal" or "date" for a column stored as signed int64
    that this lowering takes, else None."""
    if ft is None or ft.unsigned:
        return None
    if ft.tclass == TypeClass.INT:
        return "int"
    if ft.tclass == TypeClass.DECIMAL and max(ft.decimal, 0) <= 18:
        return "decimal"        # scale > 18 is host-only object storage
    if ft.tclass == TypeClass.DATE:
        return "date"
    return None


# constant kind -> (the type class its ft must have, its class here)
_CONST_KIND = {Kind.INT: (TypeClass.INT, "int"),
               Kind.DECIMAL: (TypeClass.DECIMAL, "decimal"),
               Kind.DATE: (TypeClass.DATE, "date")}


def _constant_class(const):
    ft = const.ft
    tclass, cls = _CONST_KIND.get(const.value.kind, (None, None))
    if ft is None or ft.unsigned or ft.tclass != tclass:
        return None
    return cls


def _max_abs(ft):
    """Largest |value| the column's type holds, within int64."""
    if ft.tclass == TypeClass.DECIMAL:
        if ft.flen <= 0:
            return I64_MAX
        return min(10 ** ft.flen - 1, I64_MAX)
    lo, hi = ft.int_limits()
    return max(-lo, hi)


def _scaled_range(op, c, m):
    """The x with `x * m op c` (python ints, m >= 1) as an inclusive
    int64 range; EMPTY when there is none."""
    if op == ">=":
        lo, hi = -(-c // m), I64_MAX + 1
    elif op == ">":
        lo, hi = -(-(c + 1) // m), I64_MAX + 1
    elif op == "<=":
        lo, hi = I64_MIN - 1, c // m
    elif op == "<":
        lo, hi = I64_MIN - 1, (c - 1) // m
    else:                                   # "="
        if c % m:
            return EMPTY
        lo = hi = c // m
    if lo > hi or lo > I64_MAX or hi < I64_MIN:
        return EMPTY
    return max(lo, I64_MIN), min(hi, I64_MAX)


def filter_bound(expr):
    """-> (column idx, lo, hi) when `expr` is a comparison this lowering
    accepts, else None."""
    if not isinstance(expr, ScalarFunc) or expr.op not in _OPS or \
            len(expr.args) != 2:
        return None
    col, const, op = expr.args[0], expr.args[1], expr.op
    if isinstance(col, Constant) and isinstance(const, Column):
        col, const, op = const, col, _FLIP[op]
    if not (isinstance(col, Column) and isinstance(const, Constant)):
        return None
    ccls, kcls = _column_class(col.ft), _constant_class(const)
    if ccls is None or kcls is None or (ccls == "date") != (kcls == "date"):
        return None
    # the evaluator's comparison is `x' op c'` with (x', c') from
    # coerce_numeric_pair: a probe of 1 gives the column's scale factor
    ctx = EvalCtx(np, 1, {}, host=True)
    c = _eval_const(ctx, const)[0]
    probe, c2, _cls, _scale = coerce_numeric_pair(
        ctx, np.ones(1, np.int64), col.ft, c, const.ft)
    m, c2 = int(probe[0]), int(c2)
    if not I64_MIN <= c2 <= I64_MAX:
        return None
    if m != 1 and _max_abs(col.ft) > I64_MAX // m:
        return None             # the evaluator's rescale could wrap
    lo, hi = _scaled_range(op, c2, m)
    return col.idx, lo, hi


def lower_filters(filters):
    """-> RangeLowering of `filters`, or None when no filter lowers."""
    ranges: dict = {}
    lowered, rest = [], []
    for f in filters:
        b = filter_bound(f)
        if b is None or (b[0] not in ranges and len(ranges) == MAX_PREDS):
            rest.append(f)
            continue
        idx, lo, hi = b
        if idx in ranges:
            plo, phi = ranges[idx]
            lo, hi = max(lo, plo), min(hi, phi)
        ranges[idx] = (lo, hi)
        lowered.append(f)
    if not ranges:
        return None
    return RangeLowering(list(ranges), list(ranges.values()), lowered, rest)

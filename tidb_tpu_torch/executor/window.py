"""Window function executor (reference pkg/executor/window.go + pipelined
window in pkg/executor/pipelined_window.go — re-designed as whole-partition
vectorized numpy: one lexsort per window spec, segment-scan computations,
scatter back to input order; no goroutine pipeline).

Default frame semantics (MySQL): with ORDER BY the frame is RANGE UNBOUNDED
PRECEDING..CURRENT ROW (peers included); without ORDER BY the frame is the
whole partition."""
from __future__ import annotations

import numpy as np

from ..chunk.chunk import Chunk
from ..chunk.column import Column
from ..expression import EvalCtx, eval_expr
from ..expression.vec import materialize_nulls
from ..types.field_type import TypeClass
from ..types.decimal import _POW10
from ..errors import UnsupportedError
from .exec_base import Executor, bind_chunk
from .executors import _sort_key_arrays

_I64_MAX = np.iinfo(np.int64).max

_UNIT_MICROS = {"microsecond": 1.0, "second": 1e6, "minute": 6e7,
                "hour": 3.6e9, "day": 8.64e10, "week": 6.048e11}


def _interval_shift(real, n, unit, ft):
    """Shift temporal key values by n units (n may be negative).
    Keys are DAYS for DATE columns, MICROS otherwise. Fixed-width
    units add a constant; MONTH/QUARTER/YEAR walk the civil calendar
    with MySQL's day-of-month clamping (Jan 31 + 1 month = Feb 29)."""
    from ..types.time_types import MICROS_PER_DAY
    from ..expression.vec import civil_from_days, days_from_civil
    unit = unit.lower().rstrip("s")
    is_date = ft.tclass == TypeClass.DATE
    if unit not in ("second", "microsecond"):
        # MySQL: only SECOND counts keep a decimal fraction; other
        # units coerce decimal -> int with rounding (1.5 DAY = 2 DAY)
        n = int(round(n))
    if unit in _UNIT_MICROS:
        if is_date:
            days = _UNIT_MICROS[unit] * n / 8.64e10
            if days != int(days):
                raise UnsupportedError(
                    "INTERVAL %s frames need a DATETIME ORDER key", unit)
            return real + int(days)
        return real + _UNIT_MICROS[unit] * n
    if unit in ("month", "quarter", "year"):
        # fractional counts round like MySQL's decimal->int coercion
        months = int(round(n * {"month": 1, "quarter": 3,
                                "year": 12}[unit]))
        if is_date:
            days, tod = real.astype(np.int64), None
        else:
            ri = real.astype(np.int64)
            days = ri // MICROS_PER_DAY
            tod = ri - days * MICROS_PER_DAY
        y, m, dd = civil_from_days(np, days)
        m0 = np.asarray(m) + months - 1
        y2 = np.asarray(y) + m0 // 12
        m2 = m0 % 12 + 1
        first_this = days_from_civil(np, y2, m2, np.asarray(1))
        ny = np.where(m2 == 12, y2 + 1, y2)
        nm = np.where(m2 == 12, 1, m2 + 1)
        dim = days_from_civil(np, ny, nm, np.asarray(1)) - first_this
        days2 = first_this + np.minimum(np.asarray(dd), dim) - 1
        out = days2 if is_date else days2 * MICROS_PER_DAY + tod
        return out.astype(np.float64)
    raise UnsupportedError("unsupported INTERVAL unit %s in frame", unit)


class WindowExec(Executor):
    def __init__(self, ctx, plan, child):
        super().__init__(ctx, plan.schema, [child])
        self.descs = plan.descs
        self._out = None

    def next(self):
        if self._out is None:
            chunks = self.child.all_chunks()
            merged = Chunk.concat_all(chunks)
            if merged is None:
                self._out = []
            else:
                self._out = [self._compute(merged)]
        if not self._out:
            return None
        return self._out.pop(0)

    def _compute(self, chunk: Chunk) -> Chunk:
        n = len(chunk)
        cols = bind_chunk(self.child.schema, chunk)
        ectx = EvalCtx(np, n, cols, host=True)
        by_idx = {sc.col.idx: col
                  for sc, col in zip(self.child.schema.cols, chunk.columns)}
        for d in self.descs:
            by_idx[d.out_col.idx] = self._one_desc(d, ectx, chunk, n)
        # emit in output-schema order (pruning may have reshaped it)
        return Chunk([by_idx[sc.col.idx] for sc in self.schema.cols])

    def _one_desc(self, d, ectx, chunk, n) -> Column:
        items = [(e, False) for e in d.partition_by] + list(d.order_by)
        keys = _sort_key_arrays(self.child.schema, chunk, items) \
            if items else []
        name = d.name
        if d.args:
            adata, anulls, asd = eval_expr(ectx, d.args[0])
            nm = np.asarray(materialize_nulls(ectx, anulls))
            vals = np.asarray(adata) if not np.isscalar(adata) \
                else np.full(n, adata)
            if name in ("min", "max") and asd is not None:
                # dict codes are insertion-ordered: numeric MIN/MAX over
                # raw codes returns first-inserted, not smallest — remap
                # through the rank-ordered dict (same fix as the agg
                # path's _minmaxkey)
                from ..expression.vec import _coll_arg
                code_map, asd = asd.rank_codes(_coll_arg(d.ft))
                vals = code_map[vals.astype(np.int64)]
            vals0, ok0 = vals, ~nm
        else:
            vals0 = np.ones(n, dtype=np.int64)
            ok0 = np.ones(n, dtype=bool)
            asd = None
        # device first: the kernel sorts on device, so the host lexsort
        # and boundary passes below would be thrown-away work on a hit
        dres = self._try_device(d, name, keys, vals0, ok0, asd, n)
        if dres is not None:
            out, nulls, out_dict = dres
            return Column(d.ft, out, nulls, out_dict)
        order = np.lexsort(list(reversed(keys))) if items \
            else np.arange(n)
        # boundary flags come from the SAME key arrays the sort (and the
        # device kernel) use — collation ranks, float keys, and NULL
        # sentinels all share one equality notion, so host and device
        # can't disagree across the size threshold
        npart = len(d.partition_by)
        part_start_flag = np.zeros(n, dtype=bool)
        if n:
            part_start_flag[0] = True
        for key in keys[:npart]:
            skey = key[order]
            chg = np.ones(n, dtype=bool)
            chg[1:] = skey[1:] != skey[:-1]
            part_start_flag |= chg
        part_id = np.cumsum(part_start_flag) - 1 if n else part_start_flag
        part_start = np.zeros(n, dtype=np.int64)
        starts = np.nonzero(part_start_flag)[0]
        if n:
            part_start = starts[part_id]
        # partition end (exclusive)
        ends = np.append(starts[1:], n) if n else np.array([], dtype=np.int64)
        part_end = ends[part_id] if n else part_start
        # peer groups: order-key change within partition
        peer_start_flag = part_start_flag.copy()
        for key in keys[npart:]:
            skey = key[order]
            chg = np.ones(n, dtype=bool)
            chg[1:] = skey[1:] != skey[:-1]
            peer_start_flag |= chg
        peer_id = np.cumsum(peer_start_flag) - 1 if n else peer_start_flag
        pstarts = np.nonzero(peer_start_flag)[0]
        peer_start = pstarts[peer_id] if n else np.zeros(0, dtype=np.int64)
        pends = np.append(pstarts[1:], n) if n else np.array([], dtype=np.int64)
        peer_end = np.minimum(pends[peer_id], part_end) if n else peer_start

        seq = np.arange(n) - part_start          # 0-based row num in partition
        size = part_end - part_start
        svals = vals0[order]
        sok = ok0[order]

        if d.frame is not None and name in ("sum", "avg", "count", "min",
                                            "max", "first_value",
                                            "last_value"):
            if d.frame[0] == "range":
                lo, hi_excl = self._range_bounds(d, part_start, part_end,
                                                 n, ectx, order)
            else:
                lo, hi_excl = self._rows_bounds(d, part_start, part_end, n)
            sorted_out, sorted_nulls = self._frame_eval(
                d, svals, sok, lo, hi_excl, n)
        else:
            sorted_out, sorted_nulls = self._fn(
                name, d, svals, sok, seq, size, part_start, part_end,
                peer_start, peer_end, part_start_flag, n, ectx)

        # scatter back to input row order
        out = np.empty_like(sorted_out)
        out[order] = sorted_out
        nulls = None
        if sorted_nulls is not None:
            nulls = np.empty_like(sorted_nulls)
            nulls[order] = sorted_nulls
            if not nulls.any():
                nulls = None
        return Column(d.ft, out, nulls, asd if name in (
            "lag", "lead", "first_value", "last_value", "min", "max") else None)

    @staticmethod
    def _lag_args(d):
        """Parse lag/lead (expr [, offset [, default]]) once for both
        paths. -> (offset | None if non-constant, raw default | None)."""
        from ..expression import Constant
        offset, default = 1, None
        if len(d.args) > 1:
            if not isinstance(d.args[1], Constant):
                offset = None
            else:
                offset = int(d.args[1].value.val)
        if len(d.args) > 2 and isinstance(d.args[2], Constant) and \
                not d.args[2].value.is_null:
            default = d.args[2].value.val
        return offset, default

    def _try_device(self, d, name, keys, vals0, ok0, asd, n):
        """Route an eligible window spec to the device program
        (executor/window_device.py): unbounded-frame rank/agg/lag
        functions over int-comparable keys, above a size floor (tiny
        windows aren't worth a device round trip). -> (out, nulls,
        out_dict) in input-row order, or None to run the host path. On
        the card a degraded dispatch fails the statement; on the CPU
        the host path runs."""
        import os
        min_rows = int(os.environ.get("TIDB_TPU_WINDOW_MIN", 1 << 14))
        from .window_device import DEVICE_FNS, run_window_device
        copr = self.ctx.copr
        if (d.frame is not None or name not in DEVICE_FNS or
                not copr.use_device or n < min_rows):
            return None
        if vals0.dtype == object:            # big decimals: host-exact
            return None
        if vals0.dtype.kind == "u":
            # unsigned BIGINT: torch has few uint64 ops on the card, so
            # such values take the host route, as in the evaluator
            return None
        if name == "avg" and d.ft.tclass == TypeClass.DECIMAL:
            return None                       # exact rounding on host
        shift, default, out_dict = 0, None, None
        if name in ("lag", "lead"):
            offset, dv = self._lag_args(d)
            if offset is None:                # non-constant offset
                return None
            if dv is not None:
                if asd is not None:           # dict default needs encode
                    return None
                if not isinstance(dv, (int, float)):
                    return None
                if d.ft.tclass == TypeClass.DECIMAL:
                    # column values are SCALED ints: scale the default
                    # the same way (mirrors the host path)
                    from ..types.decimal import dec_to_scaled_int
                    dv = dec_to_scaled_int(dv, max(d.ft.decimal, 0))
                default = dv
            shift = -offset if name == "lag" else offset
            out_dict = asd
        if name in ("min", "max") and asd is not None:
            # codes arrive already remapped into rank order by
            # _one_desc (host/device share the same pre-map)
            out_dict = asd
        from ..utils import device_guard
        try:
            out, nulls = device_guard.guarded_dispatch(
                lambda: run_window_device(
                    name, keys, len(d.partition_by), bool(d.order_by),
                    vals0, ok0, n, copr.device, shift=shift,
                    default=default),
                site="window", ectx=self.ctx,
                fallback_is_host=copr.degrade_to_host)
        except device_guard.DeviceDegradedError:
            if not copr.degrade_to_host:
                raise
            self.ctx.sess.domain.inc_metric("window_device_error")
            return None
        self.ctx.sess.domain.inc_metric("window_device")
        if name == "sum":
            out = self._sum_scale(d, out)
        return out, nulls, out_dict

    def _rows_bounds(self, d, part_start, part_end, n):
        """ROWS frame: [i-prec, i+fol] clipped to the partition."""
        _, n_prec, n_fol = d.frame
        idx = np.arange(n)
        lo = part_start if n_prec is None else np.maximum(part_start,
                                                          idx - n_prec)
        hi_excl = part_end if n_fol is None else np.minimum(part_end,
                                                            idx + n_fol + 1)
        return lo, hi_excl

    def _range_bounds(self, d, part_start, part_end, n, ectx, order):
        """RANGE frame with numeric OR INTERVAL offsets (reference
        pkg/executor/internal/vecgroupchecker + range framer semantics):
        frame = rows in the partition whose single ORDER BY key lies within
        [cur-prec, cur+fol] along the sort direction. NULL-key rows form
        their own peer frame; bounds never reach them. Per-partition
        searchsorted over the (already sorted) key block. INTERVAL
        units shift temporal keys (days for DATE, micros otherwise);
        MONTH/QUARTER/YEAR shift through civil-calendar arithmetic
        with MySQL's day-of-month clamping."""
        _, n_prec, n_fol = d.frame
        if len(d.order_by) != 1:
            raise UnsupportedError(
                "RANGE frame with offsets requires exactly one ORDER BY")
        e, desc = d.order_by[0]
        data, nulls, sd = eval_expr(ectx, e)
        nm = np.asarray(materialize_nulls(ectx, nulls))
        arr = np.asarray(data) if not np.isscalar(data) else np.full(n, data)
        if sd is not None or arr.dtype == object:
            raise UnsupportedError("RANGE frame ORDER BY key must be numeric")
        has_ival = isinstance(n_prec, tuple) or isinstance(n_fol, tuple)
        if has_ival and e.ft.tclass not in (
                TypeClass.DATE, TypeClass.DATETIME,
                TypeClass.TIMESTAMP):
            # MySQL rejects INTERVAL frames over non-temporal keys;
            # silently shifting an INT/DECIMAL key by "microseconds"
            # would degrade to a running total
            raise UnsupportedError(
                "INTERVAL frame bounds require a temporal ORDER BY key")
        scale = 1
        if e.ft.tclass == TypeClass.DECIMAL:
            scale = int(_POW10[max(e.ft.decimal, 0)])
        keys = arr.astype(np.float64)
        sign = -1.0 if desc else 1.0
        k = (keys * sign)[order]
        knull = nm[order]

        def target(seg, amount, forward):
            """Bound values in SIGN space for each row of seg.
            amount: int (numeric, key units) or ("ival", count, unit);
            count is the magnitude in the named direction (preceding
            for the low bound, following for the high), negative =
            opposite direction."""
            if not isinstance(amount, tuple):
                delta = amount * scale * 1.0
                return seg + (delta if forward else -delta)
            _tag, cnt, unit = amount
            # shift happens in REAL key space: iteration order is
            # sign space, so preceding = real -sign*cnt units
            step = cnt if forward else -cnt
            real = seg * sign
            shifted = _interval_shift(real, step if sign > 0 else -step,
                                      unit, e.ft)
            return shifted * sign
        lo = np.empty(n, dtype=np.int64)
        hi = np.empty(n, dtype=np.int64)
        starts = np.unique(part_start) if n else np.array([], dtype=np.int64)
        for s0 in starts:
            e0 = int(part_end[s0])
            s0 = int(s0)
            seg_null = knull[s0:e0]
            nn = int(seg_null.sum())
            if nn:
                # sort keys put NULLs first (asc) / last (desc)
                null_first = bool(seg_null[0])
                nlo, nhi = (s0, s0 + nn) if null_first else (e0 - nn, e0)
                lo[nlo:nhi] = nlo
                hi[nlo:nhi] = nhi
                vlo, vhi = (nhi, e0) if null_first else (s0, nlo)
            else:
                vlo, vhi = s0, e0
            if vhi > vlo:
                seg = k[vlo:vhi]
                if n_prec is None:
                    lo[vlo:vhi] = s0      # unbounded: includes NULL block
                else:
                    lo[vlo:vhi] = vlo + np.searchsorted(
                        seg, target(seg, n_prec, False), side="left")
                if n_fol is None:
                    hi[vlo:vhi] = e0
                else:
                    hi[vlo:vhi] = vlo + np.searchsorted(
                        seg, target(seg, n_fol, True), side="right")
        return lo, hi

    def _frame_eval(self, d, svals, sok, lo, hi_excl, n):
        """Evaluate an aggregate over per-row frame bounds [lo, hi_excl).
        Sums/counts via prefix sums; min/max via an O(n log n) sparse table
        (vectorized range-reduce; no frame-width cap)."""
        empty = hi_excl <= lo
        name = d.name
        if name == "first_value":
            pos = np.clip(lo, 0, max(n - 1, 0))
            return svals[pos], (~sok[pos]) | empty
        if name == "last_value":
            pos = np.clip(hi_excl - 1, 0, max(n - 1, 0))
            return svals[pos], (~sok[pos]) | empty
        if name in ("sum", "avg", "count"):
            acc = np.cumsum(np.where(sok, svals, 0).astype(
                np.float64 if svals.dtype.kind == "f" else np.int64))
            cnt = np.cumsum(sok.astype(np.int64))
            hi_i = np.clip(hi_excl - 1, 0, max(n - 1, 0))
            lo_base = np.where(lo > 0, lo - 1, 0)
            s = acc[hi_i] - np.where(lo > 0, acc[lo_base], 0)
            c = cnt[hi_i] - np.where(lo > 0, cnt[lo_base], 0)
            s = np.where(empty, 0, s)
            c = np.where(empty, 0, c)
            nulls = c == 0
            if name == "count":
                return c, None
            if name == "sum":
                return self._sum_scale(d, s), nulls
            if d.ft.tclass == TypeClass.DECIMAL:
                src = max(d.args[0].ft.decimal, 0) \
                    if d.args[0].ft.tclass == TypeClass.DECIMAL else 0
                tgt = max(d.ft.decimal, 0)
                num = s.astype(np.int64) * _POW10[max(tgt - src, 0)]
                safe = np.maximum(c, 1)
                q = num // safe
                r = num - q * safe
                q = np.where(2 * np.abs(r) >= safe, q + np.sign(num), q)
                return q, nulls
            return s.astype(np.float64) / np.maximum(c, 1), nulls
        # min/max: sparse-table range reduce over [lo, hi_excl)
        if svals.dtype.kind == "f":
            ident = np.inf if name == "min" else -np.inf
        else:
            ident = _I64_MAX if name == "min" else -_I64_MAX
        op = np.minimum if name == "min" else np.maximum
        filled = np.where(sok, svals, ident)
        levels = [filled]                      # levels[j][i] = op over
        j = 0                                  # [i, i+2^j) clipped to n
        while (1 << (j + 1)) <= max(n, 1):
            prev = levels[j]
            step = 1 << j
            nxt = prev.copy()
            nxt[: n - step] = op(prev[: n - step], prev[step:])
            levels.append(nxt)
            j += 1
        w = np.maximum(hi_excl - lo, 1)
        jsel = np.int64(np.floor(np.log2(w)))
        out = np.full(n, ident, dtype=filled.dtype)
        for jj, sp in enumerate(levels):
            m = (jsel == jj) & ~empty
            if m.any():
                li = lo[m]
                ri = hi_excl[m] - (1 << jj)
                out[m] = op(sp[li], sp[ri])
        cnt_cum = np.cumsum(sok.astype(np.int64))
        hi_i = np.clip(hi_excl - 1, 0, max(n - 1, 0))
        c = cnt_cum[hi_i] - np.where(lo > 0,
                                     cnt_cum[np.maximum(lo - 1, 0)], 0)
        return out, (c <= 0) | empty

    def _fn(self, name, d, svals, sok, seq, size, part_start, part_end,
            peer_start, peer_end, part_flag, n, ectx):
        if name == "row_number":
            return seq + 1, None
        if name == "rank":
            return peer_start - part_start + 1, None
        if name == "dense_rank":
            # number of peer groups before current, within partition
            peer_flag_int = np.zeros(n, dtype=np.int64)
            peer_flag_int[np.nonzero(part_flag | (peer_start == np.arange(n)))] = 0
            # dense rank = count of peer starts in partition up to current
            starts_cum = np.cumsum((peer_start == np.arange(n)).astype(np.int64))
            base = starts_cum[part_start]
            return starts_cum[peer_start] - base + 1, None
        if name == "percent_rank":
            denom = np.maximum(size - 1, 1)
            return (peer_start - part_start) / denom, None
        if name == "cume_dist":
            return (peer_end - part_start) / np.maximum(size, 1), None
        if name == "ntile":
            nt = int(d.args[0].value.val) if d.args else 1
            q, r = np.divmod(size, max(nt, 1))
            # first r buckets get q+1 rows
            big = r * (q + 1)
            in_big = seq < big
            bucket = np.where(in_big, seq // np.maximum(q + 1, 1),
                              r + (seq - big) // np.maximum(q, 1))
            return bucket + 1, None
        if name in ("lag", "lead"):
            offset, default = self._lag_args(d)
            if offset is None:
                offset = 1                    # non-constant: legacy host default
            shift = -offset if name == "lag" else offset
            idx = np.arange(n) + shift
            valid = (idx >= part_start) & (idx < part_end)
            idx = np.clip(idx, 0, max(n - 1, 0))
            out = svals[idx]
            nulls = (~sok[idx]) | ~valid
            if default is not None:
                dv = default
                if d.ft.tclass == TypeClass.DECIMAL:
                    from ..types.decimal import dec_to_scaled_int
                    dv = dec_to_scaled_int(dv, max(d.ft.decimal, 0))
                out = np.where(valid, out, dv)
                nulls = np.where(valid, nulls, False)
            return out, nulls
        if name == "first_value":
            out = svals[part_start]
            return out, ~sok[part_start]
        if name == "last_value":
            last = np.maximum(peer_end - 1, part_start)
            return svals[last], ~sok[last]
        if name == "count":
            cnt_cum = np.cumsum(sok.astype(np.int64))
            base = np.where(part_start > 0, cnt_cum[part_start - 1], 0)
            if d.order_by:
                return cnt_cum[peer_end - 1] - base, None
            return cnt_cum[part_end - 1] - base, None
        if name in ("sum", "avg"):
            acc = np.cumsum(np.where(sok, svals, 0).astype(
                np.float64 if svals.dtype.kind == "f" else np.int64))
            cnt_cum = np.cumsum(sok.astype(np.int64))
            base = np.where(part_start > 0, acc[part_start - 1], 0)
            cbase = np.where(part_start > 0, cnt_cum[part_start - 1], 0)
            end = (peer_end if d.order_by else part_end) - 1
            s = acc[end] - base
            c = cnt_cum[end] - cbase
            nulls = c == 0
            if name == "sum":
                s = self._sum_scale(d, s)
                return s, nulls
            # avg
            if d.ft.tclass == TypeClass.DECIMAL:
                src = max(d.args[0].ft.decimal, 0) \
                    if d.args[0].ft.tclass == TypeClass.DECIMAL else 0
                tgt = max(d.ft.decimal, 0)
                num = s.astype(np.int64) * _POW10[max(tgt - src, 0)]
                safe = np.maximum(c, 1)
                q = num // safe
                r = num - q * safe
                q = np.where(2 * np.abs(r) >= safe, q + np.sign(num), q)
                return q, nulls
            return s.astype(np.float64) / np.maximum(c, 1), nulls
        if name in ("min", "max"):
            out = np.empty_like(svals)
            if svals.dtype.kind == "f":
                ident = np.inf if name == "min" else -np.inf
            else:
                ident = _I64_MAX if name == "min" else -_I64_MAX
            filled = np.where(sok, svals, ident)
            starts = np.nonzero(part_flag)[0]
            ends = np.append(starts[1:], n)
            op = np.minimum if name == "min" else np.maximum
            cnt_cum = np.cumsum(sok.astype(np.int64))
            cbase = np.where(part_start > 0, cnt_cum[part_start - 1], 0)
            for s0, e0 in zip(starts, ends):
                out[s0:e0] = op.accumulate(filled[s0:e0])
            if d.order_by:
                # extend to peer end
                out = out[np.maximum(peer_end - 1, part_start)]
                c = cnt_cum[peer_end - 1] - cbase
            else:
                out = out[part_end - 1]
                c = cnt_cum[part_end - 1] - cbase
            return out, c == 0
        raise UnsupportedError("window function %s not supported", name)

    def _sum_scale(self, d, s):
        if d.ft.tclass == TypeClass.DECIMAL:
            src = max(d.args[0].ft.decimal, 0) \
                if d.args[0].ft.tclass == TypeClass.DECIMAL else 0
            tgt = max(d.ft.decimal, 0)
            if tgt > src:
                return s.astype(np.int64) * _POW10[tgt - src]
            return s.astype(np.int64)
        if d.ft.tclass == TypeClass.FLOAT and s.dtype.kind != "f":
            return s.astype(np.float64)
        return s

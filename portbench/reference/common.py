"""Helpers of the reference: key lookups, decimal formatting and the
three arithmetics (scaled int64, float64, float32)."""
from __future__ import annotations

import numpy as np

EPOCH = np.datetime64("1970-01-01", "D")


def day(text: str) -> int:
    """'YYYY-MM-DD' -> days since 1970-01-01."""
    return int((np.datetime64(text.strip(), "D") - EPOCH).astype(np.int64))


def add_years(days: int, years: int) -> int:
    d = EPOCH + np.timedelta64(int(days), "D")
    y = d.astype("datetime64[Y]").astype(int) + 1970
    md = str(d)[4:]
    return day(f"{y + years:04d}{md}")


def day_text(days: int) -> str:
    return str(EPOCH + np.timedelta64(int(days), "D"))


def scaled(text: str, scale: int) -> int:
    """'0.06' at scale 2 -> 6: a decimal literal as a scaled integer."""
    neg = text.strip().startswith("-")
    whole, _, frac = text.strip().lstrip("+-").partition(".")
    frac = (frac + "0" * scale)[:scale]
    v = int(whole or "0") * 10 ** scale + int(frac or "0")
    return -v if neg else v


def col(tables, table, name):
    return tables[table]["cols"][name]


def code_of(tables, table, name, value):
    """The dictionary code of `value` in column `name` (-1: absent)."""
    vals = tables[table]["dicts"][name]
    return vals.index(value) if value in vals else -1


def value_of(tables, table, name, code):
    return tables[table]["dicts"][name][int(code)]


def position_of(keys):
    """-> a table mapping key -> row, -1 where no row has the key."""
    pos = np.full(int(keys.max()) + 2, -1, dtype=np.int64)
    pos[keys] = np.arange(len(keys))
    return pos


def lookup(pos, keys):
    ok = (keys >= 0) & (keys < len(pos))
    return np.where(ok, pos[np.clip(keys, 0, len(pos) - 1)], -1)


def fmt_scaled(v: int, scale: int) -> str:
    sign = "-" if v < 0 else ""
    q, r = divmod(abs(int(v)), 10 ** scale)
    return f"{sign}{q}.{r:0{scale}d}" if scale else f"{sign}{q}"


def avg_scaled(total: int, cnt: int) -> int:
    """MySQL AVG of a decimal: the argument's scale + 4, half away from
    zero."""
    num = abs(int(total)) * 10 ** 4
    q = (2 * num + cnt) // (2 * cnt)
    return q if total >= 0 else -q


class Arith:
    """Decimal arithmetic in one precision. A decimal column arrives as
    scaled int64 at `scale`; `val` turns it into this precision's
    values, `sum`/`avg` reduce and `text` formats at the result's scale.
    Exact: int64 values at their scale, products add scales."""

    def __init__(self, precision: str):
        if precision not in ("exact", "float64", "float32"):
            raise ValueError(precision)
        self.precision = precision
        self.exact = precision == "exact"
        self.dtype = {"float64": np.float64, "float32": np.float32}.get(
            precision)

    def val(self, arr, scale):
        """Column values: int64 scaled by 10^scale (exact), or floats."""
        if self.exact:
            return arr.astype(np.int64)
        return (arr.astype(self.dtype) / self.dtype(10 ** scale)).astype(
            self.dtype)

    def const(self, scaled_int, scale):
        """A literal scaled int -> this precision's value at `scale`."""
        if self.exact:
            return np.int64(scaled_int)
        return self.dtype(scaled_int) / self.dtype(10 ** scale)

    def one_minus(self, v, scale):
        """1 - v for v at `scale` (the result keeps `scale`)."""
        if self.exact:
            return np.int64(10 ** scale) - v
        return (self.dtype(1) - v).astype(self.dtype)

    def one_plus(self, v, scale):
        if self.exact:
            return np.int64(10 ** scale) + v
        return (self.dtype(1) + v).astype(self.dtype)

    def sum(self, arr):
        if self.exact:
            return int(arr.sum(dtype=np.int64))
        return arr.sum(dtype=self.dtype)

    def text(self, v, scale):
        """A reduced value at result scale `scale` -> its wire text."""
        if self.exact:
            return fmt_scaled(int(v), scale)
        return f"{float(v):.{scale}f}"

    def avg_text(self, total, cnt, scale):
        """AVG of a decimal of scale `scale` -> text at scale + 4."""
        if self.exact:
            return fmt_scaled(avg_scaled(int(total), cnt), scale + 4)
        return f"{float(total) / cnt:.{scale + 4}f}"

    def key(self, v):
        """A sort key for ORDER BY over a reduced value."""
        return int(v) if self.exact else float(v)

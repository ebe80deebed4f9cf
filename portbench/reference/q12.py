"""TPC-H Q12 (shipping modes and order priority): lines of two SHIPMODEs
received in the year from DATE, late against their commit date, counted
by their order's priority class."""
from __future__ import annotations

import numpy as np

from .common import add_years, code_of, col, day, lookup, position_of

TABLES = ("orders", "lineitem")
HIGH = ("1-URGENT", "2-HIGH")


def rows(tables, params, precision="exact"):
    # every output is a count: no decimal, so every precision agrees
    lo = day(params["DATE"])
    li = "lineitem"
    modes = sorted({params["SHIPMODE1"], params["SHIPMODE2"]})
    mode = col(tables, li, "l_shipmode")
    commit = col(tables, li, "l_commitdate")
    receipt = col(tables, li, "l_receiptdate")
    m = np.isin(mode, [code_of(tables, li, "l_shipmode", s) for s in modes])
    m &= (commit < receipt) & (col(tables, li, "l_shipdate") < commit)
    m &= (receipt >= lo) & (receipt < add_years(lo, 1))
    orow = lookup(position_of(col(tables, "orders", "o_orderkey")),
                  col(tables, li, "l_orderkey"))
    m &= orow >= 0
    high_codes = [code_of(tables, "orders", "o_orderpriority", p)
                  for p in HIGH]
    high = np.isin(col(tables, "orders", "o_orderpriority")[orow[m]],
                   high_codes)
    out = []
    for s in modes:
        g = mode[m] == code_of(tables, li, "l_shipmode", s)
        if g.any():
            out.append((s, str(int((high & g).sum())),
                        str(int((~high & g).sum()))))
    return out

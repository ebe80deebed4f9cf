"""TPC-H Q3 (shipping priority): SEGMENT customers' orders before DATE,
their lines shipped after it, revenue per order, the 10 largest (ties by
order date)."""
from __future__ import annotations

import numpy as np

from .common import (Arith, code_of, col, day, day_text, lookup,
                     position_of)

TABLES = ("customer", "orders", "lineitem")


def rows(tables, params, precision="exact"):
    a = Arith(precision)
    when = day(params["DATE"])
    seg = code_of(tables, "customer", "c_mktsegment", params["SEGMENT"])
    okey = col(tables, "orders", "o_orderkey")
    odate = col(tables, "orders", "o_orderdate")
    crow = lookup(position_of(col(tables, "customer", "c_custkey")),
                  col(tables, "orders", "o_custkey"))
    o_ok = (crow >= 0) & (odate < when)
    o_ok[o_ok] = col(tables, "customer", "c_mktsegment")[crow[o_ok]] == seg
    orow = lookup(position_of(okey), col(tables, "lineitem", "l_orderkey"))
    m = (orow >= 0) & (col(tables, "lineitem", "l_shipdate") > when)
    m[m] = o_ok[orow[m]]
    vol = a.val(col(tables, "lineitem", "l_extendedprice")[m], 2) * \
        a.one_minus(a.val(col(tables, "lineitem", "l_discount")[m], 2), 2)
    groups, inv = np.unique(orow[m], return_inverse=True)
    if a.exact:
        rev = np.zeros(len(groups), dtype=np.int64)
    else:
        rev = np.zeros(len(groups), dtype=a.dtype)
    np.add.at(rev, inv, vol)
    # ORDER BY revenue DESC, o_orderdate LIMIT 10
    top = sorted(range(len(groups)),
                 key=lambda i: (-a.key(rev[i]), int(odate[groups[i]])))[:10]
    prio = col(tables, "orders", "o_shippriority")
    return [(str(int(okey[groups[i]])), a.text(rev[i], 4),
             day_text(odate[groups[i]]), str(int(prio[groups[i]])))
            for i in top]

"""TPC-H Q5 (local supplier volume): a year of orders from DATE, the
lines supplied from the customer's own nation in REGION, revenue per
nation."""
from __future__ import annotations

import numpy as np

from .common import (Arith, add_years, code_of, col, day, lookup,
                     position_of, value_of)

TABLES = ("customer", "orders", "lineitem", "supplier", "nation", "region")


def rows(tables, params, precision="exact"):
    a = Arith(precision)
    lo = day(params["DATE"])
    hi = add_years(lo, 1)
    rcode = code_of(tables, "region", "r_name", params["REGION"])
    in_region = col(tables, "region", "r_regionkey")[
        col(tables, "region", "r_name") == rcode]
    nkey = col(tables, "nation", "n_nationkey")
    nat_ok = np.isin(col(tables, "nation", "n_regionkey"), in_region)
    okey = col(tables, "orders", "o_orderkey")
    odate = col(tables, "orders", "o_orderdate")
    ocust = col(tables, "orders", "o_custkey")
    lok = col(tables, "lineitem", "l_orderkey")
    orow = lookup(position_of(okey), lok)
    srow = lookup(position_of(col(tables, "supplier", "s_suppkey")),
                  col(tables, "lineitem", "l_suppkey"))
    m = (orow >= 0) & (srow >= 0)
    m[m] = (odate[orow[m]] >= lo) & (odate[orow[m]] < hi)
    crow = np.full(len(lok), -1, dtype=np.int64)
    crow[m] = lookup(position_of(col(tables, "customer", "c_custkey")),
                     ocust[orow[m]])
    m &= crow >= 0
    cnat = col(tables, "customer", "c_nationkey")
    snat = col(tables, "supplier", "s_nationkey")
    m[m] = cnat[crow[m]] == snat[srow[m]]
    nrow = np.full(len(lok), -1, dtype=np.int64)
    nrow[m] = lookup(position_of(nkey), cnat[crow[m]])
    m &= nrow >= 0
    m[m] = nat_ok[nrow[m]]
    vol = a.val(col(tables, "lineitem", "l_extendedprice")[m], 2) * \
        a.one_minus(a.val(col(tables, "lineitem", "l_discount")[m], 2), 2)
    out = []
    for n in np.unique(nrow[m]):
        rev = a.sum(vol[nrow[m] == n])
        out.append((value_of(tables, "nation", "n_name",
                             col(tables, "nation", "n_name")[n]), rev))
    # ORDER BY revenue DESC
    out.sort(key=lambda r: -a.key(r[1]))
    return [(name, a.text(rev, 4)) for name, rev in out]

"""TPC-H Q1 (pricing summary report): lineitem shipped by 1998-12-01
less DELTA days, grouped by return flag and line status."""
from __future__ import annotations

import numpy as np

from .common import Arith, col, day, value_of

TABLES = ("lineitem",)


def rows(tables, params, precision="exact"):
    a = Arith(precision)
    li = "lineitem"
    ship = col(tables, li, "l_shipdate")
    m = ship <= day("1998-12-01") - int(params["DELTA"])
    rf = col(tables, li, "l_returnflag")[m].astype(np.int64)
    ls = col(tables, li, "l_linestatus")[m].astype(np.int64)
    qty = a.val(col(tables, li, "l_quantity")[m], 2)
    price = a.val(col(tables, li, "l_extendedprice")[m], 2)
    disc = a.val(col(tables, li, "l_discount")[m], 2)
    tax = a.val(col(tables, li, "l_tax")[m], 2)
    disc_price = price * a.one_minus(disc, 2)          # scale 4
    charge = disc_price * a.one_plus(tax, 2)           # scale 6
    nls = len(tables[li]["dicts"]["l_linestatus"])
    key = rf * nls + ls
    out = []
    for k in np.unique(key):
        g = key == k
        cnt = int(g.sum())
        sq, sp, sd = a.sum(qty[g]), a.sum(price[g]), a.sum(disc[g])
        out.append((value_of(tables, li, "l_returnflag", k // nls),
                    value_of(tables, li, "l_linestatus", k % nls),
                    a.text(sq, 2), a.text(sp, 2),
                    a.text(a.sum(disc_price[g]), 4),
                    a.text(a.sum(charge[g]), 6),
                    a.avg_text(sq, cnt, 2), a.avg_text(sp, cnt, 2),
                    a.avg_text(sd, cnt, 2), str(cnt)))
    # ORDER BY l_returnflag, l_linestatus
    return sorted(out, key=lambda r: (r[0], r[1]))

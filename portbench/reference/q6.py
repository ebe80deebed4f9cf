"""TPC-H Q6 (forecasting revenue change): a year of lineitem with a
discount of DISCOUNT +- 0.01 and a quantity under QUANTITY."""
from __future__ import annotations

from .common import Arith, add_years, col, day, scaled

TABLES = ("lineitem",)


def rows(tables, params, precision="exact"):
    a = Arith(precision)
    li = "lineitem"
    lo = day(params["DATE"])
    disc_i = col(tables, li, "l_discount")
    d = scaled(params["DISCOUNT"], 2)
    ship = col(tables, li, "l_shipdate")
    m = (ship >= lo) & (ship < add_years(lo, 1)) & \
        (disc_i >= d - 1) & (disc_i <= d + 1) & \
        (col(tables, li, "l_quantity") < scaled(params["QUANTITY"], 2))
    if not m.any():
        return [(None,)]
    rev = a.val(col(tables, li, "l_extendedprice")[m], 2) * \
        a.val(disc_i[m], 2)
    return [(a.text(a.sum(rev), 4),)]

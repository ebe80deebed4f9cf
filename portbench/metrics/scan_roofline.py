"""The scan's share of its roofline, in percent: the least time the
window's statements need to read, once, the bytes their filters and
aggregates must read on this run's data, at the H100's 3.35 TB/s,
over the device's busy time in the traced window.

Bytes are counted in 32-byte sectors, as the card reads device memory:
for each column read, every sector that holds a row still live where it
is read (a copy of chip_smoke.py's `sector_bytes` and
`range_filter_bytes`, over the generated arrays in NumPy, with each
column at its stored width). The validity mask is read whole, one byte
a row. A filter column is read at the rows that passed the filters
before it, in the order that reads least; aggregate operands at the
rows that passed them all. The count depends on the statement, not on
the kernel that runs it, so fusing work cannot take it past 100 %.
Statements other than TPC-H Q1 and Q6 add no bytes; a window with
neither gives nothing."""
from itertools import permutations

import numpy as np

PEAK_BYTES_S = 3.35e12


def _day(text):
    return int((np.datetime64(text, "D") -
                np.datetime64("1970-01-01", "D")).astype(np.int64))


def sector_bytes(live, itemsize):
    per = 32 // itemsize
    pad = (-len(live)) % per
    if pad:
        live = np.concatenate([live, np.zeros(pad, dtype=bool)])
    return 32 * int(live.reshape(-1, per).any(1).sum())


def filter_bytes(preds, operands, n):
    """preds: [(column, mask of rows it passes)], operands: columns read
    at the rows that pass every filter. -> the least bytes over the
    orders of the filters."""
    best = None
    for order in permutations(range(len(preds))):
        live = np.ones(n, dtype=bool)
        b = n                                   # the validity mask
        for i in order:
            c, ok = preds[i]
            b += sector_bytes(live, c.itemsize)
            live = live & ok
        best = b if best is None else min(best, b)
    for c in operands:
        best += sector_bytes(live, c.itemsize)
    return best


def q6_bytes(li, p):
    c = li["cols"]
    lo = _day(p["DATE"])
    hi = _day(f"{int(p['DATE'][:4]) + 1}{p['DATE'][4:]}")
    d = round(float(p["DISCOUNT"]) * 100)
    q = round(float(p["QUANTITY"]) * 100)
    ship, disc, qty = c["l_shipdate"], c["l_discount"], c["l_quantity"]
    preds = [(ship, (ship >= lo) & (ship < hi)),
             (disc, (disc >= d - 1) & (disc <= d + 1)),
             (qty, qty < q)]
    return filter_bytes(preds, [c["l_extendedprice"]], li["n"]) + 16


def q1_bytes(li, p):
    c = li["cols"]
    ship = c["l_shipdate"]
    ok = ship <= _day("1998-12-01") - int(p["DELTA"])
    ops = [c[k] for k in ("l_returnflag", "l_linestatus", "l_quantity",
                          "l_extendedprice", "l_discount", "l_tax")]
    # 4 groups of 8 outputs each
    return filter_bytes([(ship, ok)], ops, li["n"]) + 4 * 8 * 8


BYTES = {"q1": q1_bytes, "q6": q6_bytes}


def read(ctx):
    tr = ctx["trace"]
    li = ctx["tables"].get("lineitem")
    if tr is None or not tr.busy_s or li is None:
        return None
    cache, total = {}, 0
    for s in ctx["stmts"]:
        fn = BYTES.get(s["name"])
        if fn is None:
            continue
        key = (s["stream"], s["k"])
        if key not in cache:
            cache[key] = fn(li, ctx["streams"][s["stream"]][s["k"]]["params"])
        total += cache[key]
    if not total:
        return None
    return total / PEAK_BYTES_S / tr.busy_s * 100.0

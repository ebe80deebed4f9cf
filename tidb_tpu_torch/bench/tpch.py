"""TPC-H schema + synthetic data generator (dbgen-shaped distributions,
numpy-vectorized). Loads straight into the columnar engine via bulk_append
(the lightning local-backend path). Values follow the TPC-H spec's shapes
(uniform ranges, date windows) so query selectivities are realistic; exact
dbgen text (comments etc.) is irrelevant for the engine paths exercised."""
from __future__ import annotations

import numpy as np

from ..types.time_types import days_to_str, parse_date

DDL = {
    "region": """create table region (
        r_regionkey int primary key, r_name char(25), r_comment varchar(152))""",
    "nation": """create table nation (
        n_nationkey int primary key, n_name char(25), n_regionkey int,
        n_comment varchar(152))""",
    "supplier": """create table supplier (
        s_suppkey int primary key, s_name char(25), s_address varchar(40),
        s_nationkey int, s_phone char(15), s_acctbal decimal(15,2),
        s_comment varchar(101))""",
    "customer": """create table customer (
        c_custkey int primary key, c_name varchar(25), c_address varchar(40),
        c_nationkey int, c_phone char(15), c_acctbal decimal(15,2),
        c_mktsegment char(10), c_comment varchar(117))""",
    "part": """create table part (
        p_partkey int primary key, p_name varchar(55), p_mfgr char(25),
        p_brand char(10), p_type varchar(25), p_size int,
        p_container char(10), p_retailprice decimal(15,2),
        p_comment varchar(23))""",
    "partsupp": """create table partsupp (
        ps_partkey int, ps_suppkey int, ps_availqty int,
        ps_supplycost decimal(15,2), ps_comment varchar(199))""",
    "orders": """create table orders (
        o_orderkey int primary key, o_custkey int, o_orderstatus char(1),
        o_totalprice decimal(15,2), o_orderdate date,
        o_orderpriority char(15), o_clerk char(15), o_shippriority int,
        o_comment varchar(79))""",
    "lineitem": """create table lineitem (
        l_orderkey int, l_partkey int, l_suppkey int, l_linenumber int,
        l_quantity decimal(15,2), l_extendedprice decimal(15,2),
        l_discount decimal(15,2), l_tax decimal(15,2),
        l_returnflag char(1), l_linestatus char(1),
        l_shipdate date, l_commitdate date, l_receiptdate date,
        l_shipinstruct char(25), l_shipmode char(10), l_comment varchar(44))""",
}

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1)]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
INSTRUCTS = ["DELIVER IN PERSON", "COLLECT COD", "NONE",
             "TAKE BACK RETURN"]

_D92 = parse_date("1992-01-01")
_D98 = parse_date("1998-08-02")   # last shipdate window per spec

# dbgen's P_NAME color list (spec 4.2.3); q9 greps '%green%', q20 'forest%'
P_NAME_WORDS = (
    "almond antique aquamarine azure beige bisque black blanched blue "
    "blush brown burlywood burnished chartreuse chiffon chocolate coral "
    "cornflower cornsilk cream cyan dark deep dim dodger drab firebrick "
    "floral forest frosted gainsboro ghost goldenrod green grey honeydew "
    "hot indian ivory khaki lace lavender lawn lemon light lime linen "
    "magenta maroon medium metallic midnight mint misty moccasin navajo "
    "navy olive orange orchid pale papaya peach peru pink plum powder "
    "puff purple red rose rosy royal saddle salmon sandy seashell sienna "
    "sky slate smoke snow spring steel tan thistle tomato turquoise "
    "violet wheat white yellow").split()


def _part_names(rng, n):
    """5 space-joined color words per part, dbgen-style."""
    codes = rng.integers(0, len(P_NAME_WORDS), (n, 5))
    w = np.array(P_NAME_WORDS, dtype=object)
    parts = w[codes]
    return np.array([" ".join(row) for row in parts], dtype=object)


def _phones(nationkey):
    """dbgen phone: country code 10+nationkey, so q22's substring
    country-code predicate selects real rows."""
    return np.array([f"{10 + int(nk)}-467-819-{1000 + (int(nk) * 37) % 9000}"
                     for nk in nationkey], dtype=object)


def _codes(rng, choices, n):
    return rng.integers(0, len(choices), n).astype(np.int32)


def _seed_dict(ctab, col_name, values):
    """Pre-seed the table's string dictionary so int32 codes load as-is."""
    tbl = ctab.table_info
    ci = tbl.find_column(col_name)
    d = ctab.dicts[ci.id]
    for v in values:
        d.encode_one(v)


def load_tpch(tk, sf: float = 0.01, seed: int = 7, skip_tables=()):
    """Create + bulk-load all TPC-H tables at scale factor sf."""
    rng = np.random.default_rng(seed)
    domain = tk.domain
    ischema = lambda: domain.infoschema()   # noqa: E731
    for name, ddl in DDL.items():
        if name in skip_tables:
            continue
        tk.must_exec(f"drop table if exists {name}")
        tk.must_exec(ddl)

    def ctab(name):
        tbl = ischema().table_by_name("test", name)
        return domain.columnar.table(tbl)

    # region / nation (fixed)
    if "region" not in skip_tables:
        t = ctab("region")
        _seed_dict(t, "r_name", REGIONS)
        t.bulk_append({
            "r_regionkey": np.arange(5, dtype=np.int64),
            "r_name": np.array(REGIONS, dtype=object),
            "r_comment": np.array(["" for _ in REGIONS], dtype=object),
        }, 5)
    if "nation" not in skip_tables:
        t = ctab("nation")
        _seed_dict(t, "n_name", [n for n, _ in NATIONS])
        t.bulk_append({
            "n_nationkey": np.arange(25, dtype=np.int64),
            "n_name": np.array([n for n, _ in NATIONS], dtype=object),
            "n_regionkey": np.array([r for _, r in NATIONS], dtype=np.int64),
            "n_comment": np.array(["" for _ in NATIONS], dtype=object),
        }, 25)

    n_supp = max(int(10_000 * sf), 10)
    n_cust = max(int(150_000 * sf), 30)
    n_part = max(int(200_000 * sf), 40)
    n_ord = max(int(1_500_000 * sf), 150)

    if "supplier" not in skip_tables:
        t = ctab("supplier")
        s_nat = rng.integers(0, 25, n_supp).astype(np.int64)
        # ~0.05% "Customer Complaints" suppliers (q16 NOT IN branch)
        s_cmnt = np.array([""] * n_supp, dtype=object)
        ncompl = max(n_supp // 2000, 1)
        s_cmnt[rng.choice(n_supp, ncompl, replace=False)] = \
            "sly Customer slyly Complaints cajole"
        t.bulk_append({
            "s_suppkey": np.arange(1, n_supp + 1, dtype=np.int64),
            "s_name": np.array([f"Supplier#{i:09d}" for i in range(1, n_supp + 1)],
                               dtype=object),
            "s_address": np.array(["addr"] * n_supp, dtype=object),
            "s_nationkey": s_nat,
            "s_phone": _phones(s_nat),
            "s_acctbal": rng.integers(-99999, 999999, n_supp).astype(np.int64),
            "s_comment": s_cmnt,
        }, n_supp)

    if "customer" not in skip_tables:
        t = ctab("customer")
        _seed_dict(t, "c_mktsegment", SEGMENTS)
        c_nat = rng.integers(0, 25, n_cust).astype(np.int64)
        t.bulk_append({
            "c_custkey": np.arange(1, n_cust + 1, dtype=np.int64),
            "c_name": np.array([f"Customer#{i:09d}" for i in range(1, n_cust + 1)],
                               dtype=object),
            "c_address": np.array(["addr"] * n_cust, dtype=object),
            "c_nationkey": c_nat,
            "c_phone": _phones(c_nat),
            "c_acctbal": rng.integers(-99999, 999999, n_cust).astype(np.int64),
            "c_mktsegment": _codes(rng, SEGMENTS, n_cust),
            "c_comment": np.array([""] * n_cust, dtype=object),
        }, n_cust)

    if "part" not in skip_tables:
        t = ctab("part")
        types = [f"{a} {b} {c}"
                 for a in ("STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY",
                           "PROMO")
                 for b in ("ANODIZED", "BURNISHED", "PLATED", "POLISHED",
                           "BRUSHED")
                 for c in ("TIN", "NICKEL", "BRASS", "STEEL", "COPPER")]
        brands = [f"Brand#{i}{j}" for i in range(1, 6) for j in range(1, 6)]
        containers = [f"{a} {b}" for a in ("SM", "LG", "MED", "JUMBO", "WRAP")
                      for b in ("CASE", "BOX", "BAG", "JAR", "PKG", "PACK",
                                "CAN", "DRUM")]
        _seed_dict(t, "p_type", types)
        _seed_dict(t, "p_brand", brands)
        _seed_dict(t, "p_container", containers)
        t.bulk_append({
            "p_partkey": np.arange(1, n_part + 1, dtype=np.int64),
            "p_name": _part_names(rng, n_part),
            "p_mfgr": np.array(["Manufacturer#1"] * n_part, dtype=object),
            "p_brand": _codes(rng, brands, n_part),
            "p_type": _codes(rng, types, n_part),
            "p_size": rng.integers(1, 51, n_part).astype(np.int64),
            "p_container": _codes(rng, containers, n_part),
            "p_retailprice": rng.integers(90000, 200000, n_part).astype(np.int64),
            "p_comment": np.array([""] * n_part, dtype=object),
        }, n_part)

    if "partsupp" not in skip_tables:
        t = ctab("partsupp")
        n_ps = n_part * 4
        # dbgen-style supplier spread, 4 DISTINCT suppkeys per part:
        # stride S//4 keeps i*stride < S for i<4 at every scale (the
        # spec's extra (partkey-1)/S term collides at clamped test SFs)
        pk = np.repeat(np.arange(1, n_part + 1, dtype=np.int64), 4)
        i4 = np.tile(np.arange(4, dtype=np.int64), n_part)
        s_cnt = np.int64(n_supp)
        sk = (pk - 1 + i4 * max(s_cnt // 4, np.int64(1))) % s_cnt + 1
        t.bulk_append({
            "ps_partkey": pk,
            "ps_suppkey": sk,
            "ps_availqty": rng.integers(1, 10000, n_ps).astype(np.int64),
            "ps_supplycost": rng.integers(100, 100001, n_ps).astype(np.int64),
            "ps_comment": np.array([""] * n_ps, dtype=object),
        }, n_ps)

    o_orderdate = (_D92 + rng.integers(0, _D98 - 151 - _D92, n_ord)).astype(np.int64)
    # ~1.2% of order comments match q13's '%special%requests%' exclusion
    o_comment = np.array([""] * n_ord, dtype=object)
    nspec = max(int(n_ord * 0.012), 1)
    o_comment[rng.choice(n_ord, nspec, replace=False)] = \
        "blithely special pending requests haggle"
    if "orders" not in skip_tables:
        t = ctab("orders")
        _seed_dict(t, "o_orderstatus", ["F", "O", "P"])
        _seed_dict(t, "o_orderpriority", PRIORITIES)
        t.bulk_append({
            "o_orderkey": np.arange(1, n_ord + 1, dtype=np.int64),
            # dbgen skips custkey % 3 == 0 (a third of customers have no
            # orders — the population Q13/Q22 measure)
            "o_custkey": (lambda c: np.where(c % 3 == 0,
                                             np.maximum(c - 1, 1), c))(
                rng.integers(1, n_cust + 1, n_ord).astype(np.int64)),
            "o_orderstatus": _codes(rng, ["F", "O", "P"], n_ord),
            "o_totalprice": rng.integers(100000, 50000000, n_ord).astype(np.int64),
            "o_orderdate": o_orderdate,
            "o_orderpriority": _codes(rng, PRIORITIES, n_ord),
            "o_clerk": np.array(["Clerk#000000001"] * n_ord, dtype=object),
            "o_shippriority": np.zeros(n_ord, dtype=np.int64),
            "o_comment": o_comment,
        }, n_ord)

    if "lineitem" not in skip_tables:
        t = ctab("lineitem")
        nl_per = rng.integers(1, 8, n_ord)
        n_li = int(nl_per.sum())
        l_orderkey = np.repeat(np.arange(1, n_ord + 1, dtype=np.int64), nl_per)
        base_date = np.repeat(o_orderdate, nl_per)
        shipdate = base_date + rng.integers(1, 122, n_li)
        commitdate = base_date + rng.integers(30, 91, n_li)
        receiptdate = shipdate + rng.integers(1, 31, n_li)
        # returnflag: R/A for old (shipped before 1995-06-17), N for new
        cutoff = parse_date("1995-06-17")
        is_old = receiptdate <= cutoff
        rf = np.where(is_old, rng.integers(0, 2, n_li), 2).astype(np.int32)
        ls = np.where(shipdate > cutoff, 1, 0).astype(np.int32)   # O / F
        _seed_dict(t, "l_returnflag", ["R", "A", "N"])
        _seed_dict(t, "l_linestatus", ["F", "O"])
        _seed_dict(t, "l_shipmode", SHIPMODES)
        _seed_dict(t, "l_shipinstruct", INSTRUCTS)
        quantity = rng.integers(1, 51, n_li).astype(np.int64) * 100
        extprice = rng.integers(90000, 10500000, n_li).astype(np.int64)
        t.bulk_append({
            "l_orderkey": l_orderkey,
            "l_partkey": rng.integers(1, n_part + 1, n_li).astype(np.int64),
            "l_suppkey": rng.integers(1, n_supp + 1, n_li).astype(np.int64),
            "l_linenumber": np.concatenate(
                [np.arange(1, k + 1) for k in nl_per]).astype(np.int64)
            if n_ord < 200_000 else np.ones(n_li, dtype=np.int64),
            "l_quantity": quantity,
            "l_extendedprice": extprice,
            "l_discount": rng.integers(0, 11, n_li).astype(np.int64),
            "l_tax": rng.integers(0, 9, n_li).astype(np.int64),
            "l_returnflag": rf,
            "l_linestatus": ls,
            "l_shipdate": shipdate.astype(np.int64),
            "l_commitdate": commitdate.astype(np.int64),
            "l_receiptdate": receiptdate.astype(np.int64),
            "l_shipinstruct": _codes(rng, INSTRUCTS, n_li),
            "l_shipmode": _codes(rng, SHIPMODES, n_li),
            "l_comment": np.zeros(n_li, dtype=np.int32),
        }, n_li)
        # comment dict needs at least the zero code
        _seed_dict(t, "l_comment", [""])
    return



# ---- independent numpy oracle for Q6 and Q1 -----------------------------
# Computed straight from the columnar arrays with exact int64 arithmetic
# (the checks of tests/test_tpch.py, vectorized and extended to every
# output column), so an answer from the SQL path can be held to it
# without running the engine twice.

def _columns(tk, table, *cols):
    """-> per column of `table` (data, dict values or None): dictionary
    columns as their int32 codes."""
    tbl = tk.domain.infoschema().table_by_name("test", table)
    ctab = tk.domain.columnar.tables[tbl.id]
    out = []
    for c in cols:
        ci = tbl.find_column(c)
        d = ctab.dicts.get(ci.id)
        out.append((ctab.data[ci.id][:ctab.n],
                    None if d is None else list(d.values)))
    return out


def _lineitem(tk, *cols):
    """_columns of lineitem."""
    return _columns(tk, "lineitem", *cols)


def _position_of(keys):
    """-> (keys -> row) as a lookup table over the key range, -1 where no
    row has the key (TPC-H keys are dense and non-negative)."""
    pos = np.full(int(keys.max()) + 2, -1, dtype=np.int64)
    pos[keys] = np.arange(len(keys))
    return pos


def _lookup(pos, keys):
    """Rows of `keys` through a _position_of table (-1: no such row)."""
    ok = (keys >= 0) & (keys < len(pos))
    return np.where(ok, pos[np.clip(keys, 0, len(pos) - 1)], -1)


def _fmt_scaled(v: int, scale: int) -> str:
    sign = "-" if v < 0 else ""
    q, r = divmod(abs(int(v)), 10 ** scale)
    return f"{sign}{q}.{r:0{scale}d}"


def _avg_scaled(total: int, cnt: int) -> int:
    """MySQL AVG at the argument's scale + 4, half away from zero."""
    num = abs(int(total)) * 10 ** 4
    q = (2 * num + cnt) // (2 * cnt)
    return q if total >= 0 else -q


def q6_oracle(tk) -> list:
    """Q6's rows as strings (TestKit's normal form)."""
    (ship, _), (disc, _), (qty, _), (price, _) = _lineitem(
        tk, "l_shipdate", "l_discount", "l_quantity", "l_extendedprice")
    m = (ship >= parse_date("1994-01-01")) & \
        (ship < parse_date("1995-01-01")) & (disc >= 5) & (disc <= 7) & \
        (qty < 2400)
    if not m.any():
        return [("<nil>",)]
    return [(_fmt_scaled(int((price[m] * disc[m]).sum()), 4),)]


def q1_oracle(tk) -> list:
    """Q1's rows as strings (TestKit's normal form)."""
    (ship, _), (rf, rfd), (ls, lsd), (qty, _), (price, _), (disc, _), \
        (tax, _) = _lineitem(tk, "l_shipdate", "l_returnflag",
                             "l_linestatus", "l_quantity",
                             "l_extendedprice", "l_discount", "l_tax")
    m = ship <= parse_date("1998-12-01") - 90
    key = rf[m].astype(np.int64) * len(lsd) + ls[m]
    order = np.argsort(key, kind="stable")
    skey = key[order]
    if len(skey) == 0:
        return []
    starts = np.nonzero(np.r_[True, skey[1:] != skey[:-1]])[0]
    ends = np.r_[starts[1:], len(skey)]
    qty, price, disc, tax = (a[m][order] for a in (qty, price, disc, tax))
    disc_price = price * (100 - disc)
    charge = disc_price * (100 + tax)
    rows = []
    for s, e in zip(starts, ends):
        cnt = int(e - s)
        sq, sp, sdp, sc, sd = (int(a[s:e].sum()) for a in
                               (qty, price, disc_price, charge, disc))
        k = int(skey[s])
        rows.append((rfd[k // len(lsd)], lsd[k % len(lsd)],
                     _fmt_scaled(sq, 2), _fmt_scaled(sp, 2),
                     _fmt_scaled(sdp, 4), _fmt_scaled(sc, 6),
                     _fmt_scaled(_avg_scaled(sq, cnt), 6),
                     _fmt_scaled(_avg_scaled(sp, cnt), 6),
                     _fmt_scaled(_avg_scaled(sd, cnt), 6), str(cnt)))
    # ORDER BY l_returnflag, l_linestatus (string order)
    return sorted(rows, key=lambda r: (r[0], r[1]))


def _int_bincount(group, vals, ngroups):
    """Exact int64 sums of `vals` per group code."""
    out = np.zeros(ngroups, dtype=np.int64)
    np.add.at(out, group, vals.astype(np.int64))
    return out


def q3_oracle(tk) -> list:
    """Q3's rows as strings (TestKit's normal form): BUILDING customers'
    orders before 1995-03-15, their lines shipped after it, revenue per
    order, the 10 largest (ties by order date)."""
    (ckey, _), (seg, segd) = _columns(tk, "customer", "c_custkey",
                                      "c_mktsegment")
    (okey, _), (ocust, _), (odate, _), (oprio, _) = _columns(
        tk, "orders", "o_orderkey", "o_custkey", "o_orderdate",
        "o_shippriority")
    (lok, _), (ship, _), (price, _), (disc, _) = _lineitem(
        tk, "l_orderkey", "l_shipdate", "l_extendedprice", "l_discount")
    day = parse_date("1995-03-15")
    crow = _lookup(_position_of(ckey), ocust)
    o_ok = (crow >= 0) & (odate < day)
    o_ok[o_ok] = seg[crow[o_ok]] == segd.index("BUILDING")
    orow = _lookup(_position_of(okey), lok)
    m = (orow >= 0) & (ship > day)
    m[m] = o_ok[orow[m]]
    rev = _int_bincount(orow[m], price[m] * (100 - disc[m]), len(okey))
    hit = np.zeros(len(okey), dtype=bool)
    hit[orow[m]] = True
    rows = np.nonzero(hit)[0]
    # ORDER BY revenue DESC, o_orderdate LIMIT 10
    order = np.lexsort((odate[rows], -rev[rows]))[:10]
    return [(str(int(okey[r])), _fmt_scaled(int(rev[r]), 4),
             days_to_str(int(odate[r])), str(int(oprio[r])))
            for r in rows[order]]


def q5_oracle(tk) -> list:
    """Q5's rows as strings: 1994 orders of ASIA customers, the lines
    supplied from the customer's own nation, revenue per nation."""
    (rkey, _), (rname, rnd) = _columns(tk, "region", "r_regionkey",
                                       "r_name")
    (nkey, _), (nname, nnd), (nreg, _) = _columns(
        tk, "nation", "n_nationkey", "n_name", "n_regionkey")
    (ckey, _), (cnat, _) = _columns(tk, "customer", "c_custkey",
                                    "c_nationkey")
    (skey, _), (snat, _) = _columns(tk, "supplier", "s_suppkey",
                                    "s_nationkey")
    (okey, _), (ocust, _), (odate, _) = _columns(
        tk, "orders", "o_orderkey", "o_custkey", "o_orderdate")
    (lok, _), (lsupp, _), (price, _), (disc, _) = _lineitem(
        tk, "l_orderkey", "l_suppkey", "l_extendedprice", "l_discount")
    asia = rkey[rname == rnd.index("ASIA")]
    nat_ok = np.isin(nreg, asia)
    orow = _lookup(_position_of(okey), lok)
    srow = _lookup(_position_of(skey), lsupp)
    m = (orow >= 0) & (srow >= 0)
    m[m] = (odate[orow[m]] >= parse_date("1994-01-01")) & \
        (odate[orow[m]] < parse_date("1995-01-01"))
    crow = np.full(len(lok), -1, dtype=np.int64)
    crow[m] = _lookup(_position_of(ckey), ocust[orow[m]])
    m &= crow >= 0
    # the customer's nation is the supplier's, and lies in ASIA
    m[m] = cnat[crow[m]] == snat[srow[m]]
    nrow = np.full(len(lok), -1, dtype=np.int64)
    nrow[m] = _lookup(_position_of(nkey), cnat[crow[m]])
    m &= nrow >= 0
    m[m] = nat_ok[nrow[m]]
    rev = _int_bincount(nrow[m], price[m] * (100 - disc[m]), len(nkey))
    hit = np.zeros(len(nkey), dtype=bool)
    hit[nrow[m]] = True
    rows = np.nonzero(hit)[0]
    # ORDER BY revenue DESC
    order = np.argsort(-rev[rows], kind="stable")
    return [(nnd[nname[r]], _fmt_scaled(int(rev[r]), 4))
            for r in rows[order]]


def qsum_oracle(tk) -> list:
    """QSUM's rows as strings (TestKit's normal form)."""
    (rf, rfd), (qty, _), (price, _) = _lineitem(
        tk, "l_returnflag", "l_quantity", "l_extendedprice")
    m = rf == (rfd.index("R") if "R" in rfd else -1)
    if not m.any():
        return [("<nil>", "<nil>", "0")]
    return [(_fmt_scaled(int(qty[m].sum()), 2),
             _fmt_scaled(int(price[m].sum()), 2), str(int(m.sum())))]


Q1 = """
select l_returnflag, l_linestatus, sum(l_quantity) as sum_qty,
  sum(l_extendedprice) as sum_base_price,
  sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
  sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
  avg(l_quantity) as avg_qty, avg(l_extendedprice) as avg_price,
  avg(l_discount) as avg_disc, count(*) as count_order
from lineitem
where l_shipdate <= date '1998-12-01' - interval 90 day
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus
"""

Q3 = """
select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue,
  o_orderdate, o_shippriority
from customer, orders, lineitem
where c_mktsegment = 'BUILDING' and c_custkey = o_custkey
  and l_orderkey = o_orderkey and o_orderdate < date '1995-03-15'
  and l_shipdate > date '1995-03-15'
group by l_orderkey, o_orderdate, o_shippriority
order by revenue desc, o_orderdate limit 10
"""

Q5 = """
select n_name, sum(l_extendedprice * (1 - l_discount)) as revenue
from customer, orders, lineitem, supplier, nation, region
where c_custkey = o_custkey and l_orderkey = o_orderkey
  and l_suppkey = s_suppkey and c_nationkey = s_nationkey
  and s_nationkey = n_nationkey and n_regionkey = r_regionkey
  and r_name = 'ASIA' and o_orderdate >= date '1994-01-01'
  and o_orderdate < date '1994-01-01' + interval 1 year
group by n_name order by revenue desc
"""

Q6 = """
select sum(l_extendedprice * l_discount) as revenue from lineitem
where l_shipdate >= date '1994-01-01'
  and l_shipdate < date '1994-01-01' + interval 1 year
  and l_discount between 0.06 - 0.01 and 0.06 + 0.01
  and l_quantity < 24
"""

# a fused global aggregate with no range predicate: its string filter
# stays on the evaluator, so it reduces through masked_sums
QSUM = """
select sum(l_quantity) as sum_qty, sum(l_extendedprice) as sum_price,
  count(*) as count_order
from lineitem where l_returnflag = 'R'
"""

QUERIES = {"q1": Q1, "q3": Q3, "q5": Q5, "q6": Q6}


# ---- the remaining TPC-H queries (spec shapes, standard substitutions) ----

Q2 = """
select s_acctbal, s_name, n_name, p_partkey, p_mfgr, s_address, s_phone,
  s_comment
from part, supplier, partsupp, nation, region
where p_partkey = ps_partkey and s_suppkey = ps_suppkey and p_size = 15
  and p_type like '%BRASS' and s_nationkey = n_nationkey
  and n_regionkey = r_regionkey and r_name = 'EUROPE'
  and ps_supplycost = (
    select min(ps_supplycost) from partsupp, supplier, nation, region
    where p_partkey = ps_partkey and s_suppkey = ps_suppkey
      and s_nationkey = n_nationkey and n_regionkey = r_regionkey
      and r_name = 'EUROPE')
order by s_acctbal desc, n_name, s_name, p_partkey limit 100
"""

Q4 = """
select o_orderpriority, count(*) as order_count from orders
where o_orderdate >= date '1993-07-01'
  and o_orderdate < date '1993-07-01' + interval 3 month
  and exists (select * from lineitem
              where l_orderkey = o_orderkey and l_commitdate < l_receiptdate)
group by o_orderpriority order by o_orderpriority
"""

Q7 = """
select supp_nation, cust_nation, l_year, sum(volume) as revenue
from (select n1.n_name as supp_nation, n2.n_name as cust_nation,
        year(l_shipdate) as l_year,
        l_extendedprice * (1 - l_discount) as volume
      from supplier, lineitem, orders, customer, nation n1, nation n2
      where s_suppkey = l_suppkey and o_orderkey = l_orderkey
        and c_custkey = o_custkey and s_nationkey = n1.n_nationkey
        and c_nationkey = n2.n_nationkey
        and ((n1.n_name = 'FRANCE' and n2.n_name = 'GERMANY')
          or (n1.n_name = 'GERMANY' and n2.n_name = 'FRANCE'))
        and l_shipdate between date '1995-01-01' and date '1996-12-31'
     ) as shipping
group by supp_nation, cust_nation, l_year
order by supp_nation, cust_nation, l_year
"""

Q8 = """
select o_year, sum(case when nation = 'BRAZIL' then volume else 0 end)
  / sum(volume) as mkt_share
from (select year(o_orderdate) as o_year,
        l_extendedprice * (1 - l_discount) as volume, n2.n_name as nation
      from part, supplier, lineitem, orders, customer,
           nation n1, nation n2, region
      where p_partkey = l_partkey and s_suppkey = l_suppkey
        and l_orderkey = o_orderkey and o_custkey = c_custkey
        and c_nationkey = n1.n_nationkey and n1.n_regionkey = r_regionkey
        and r_name = 'AMERICA' and s_nationkey = n2.n_nationkey
        and o_orderdate between date '1995-01-01' and date '1996-12-31'
        and p_type = 'ECONOMY ANODIZED STEEL') as all_nations
group by o_year order by o_year
"""

Q9 = """
select nation, o_year, sum(amount) as sum_profit
from (select n_name as nation, year(o_orderdate) as o_year,
        l_extendedprice * (1 - l_discount) - ps_supplycost * l_quantity
          as amount
      from part, supplier, lineitem, partsupp, orders, nation
      where s_suppkey = l_suppkey and ps_suppkey = l_suppkey
        and ps_partkey = l_partkey and p_partkey = l_partkey
        and o_orderkey = l_orderkey and s_nationkey = n_nationkey
        and p_name like '%green%') as profit
group by nation, o_year order by nation, o_year desc
"""

Q10 = """
select c_custkey, c_name, sum(l_extendedprice * (1 - l_discount)) as revenue,
  c_acctbal, n_name, c_address, c_phone, c_comment
from customer, orders, lineitem, nation
where c_custkey = o_custkey and l_orderkey = o_orderkey
  and o_orderdate >= date '1993-10-01'
  and o_orderdate < date '1993-10-01' + interval 3 month
  and l_returnflag = 'R' and c_nationkey = n_nationkey
group by c_custkey, c_name, c_acctbal, c_phone, n_name, c_address, c_comment
order by revenue desc limit 20
"""

Q11 = """
select ps_partkey, sum(ps_supplycost * ps_availqty) as value
from partsupp, supplier, nation
where ps_suppkey = s_suppkey and s_nationkey = n_nationkey
  and n_name = 'GERMANY'
group by ps_partkey
having sum(ps_supplycost * ps_availqty) > (
  select sum(ps_supplycost * ps_availqty) * 0.0001
  from partsupp, supplier, nation
  where ps_suppkey = s_suppkey and s_nationkey = n_nationkey
    and n_name = 'GERMANY')
order by value desc
"""

Q12 = """
select l_shipmode,
  sum(case when o_orderpriority = '1-URGENT' or o_orderpriority = '2-HIGH'
      then 1 else 0 end) as high_line_count,
  sum(case when o_orderpriority <> '1-URGENT'
       and o_orderpriority <> '2-HIGH' then 1 else 0 end) as low_line_count
from orders, lineitem
where o_orderkey = l_orderkey and l_shipmode in ('MAIL', 'SHIP')
  and l_commitdate < l_receiptdate and l_shipdate < l_commitdate
  and l_receiptdate >= date '1994-01-01'
  and l_receiptdate < date '1994-01-01' + interval 1 year
group by l_shipmode order by l_shipmode
"""

Q13 = """
select c_count, count(*) as custdist
from (select c_custkey, count(o_orderkey) as c_count
      from customer left join orders on c_custkey = o_custkey
        and o_comment not like '%special%requests%'
      group by c_custkey) as c_orders
group by c_count order by custdist desc, c_count desc
"""

Q14 = """
select 100.00 * sum(case when p_type like 'PROMO%'
    then l_extendedprice * (1 - l_discount) else 0 end)
  / sum(l_extendedprice * (1 - l_discount)) as promo_revenue
from lineitem, part
where l_partkey = p_partkey and l_shipdate >= date '1995-09-01'
  and l_shipdate < date '1995-09-01' + interval 1 month
"""

Q15 = """
select s_suppkey, s_name, s_address, s_phone, total_revenue
from supplier,
  (select l_suppkey as supplier_no,
          sum(l_extendedprice * (1 - l_discount)) as total_revenue
   from lineitem
   where l_shipdate >= date '1996-01-01'
     and l_shipdate < date '1996-01-01' + interval 3 month
   group by l_suppkey) revenue0
where s_suppkey = supplier_no
  and total_revenue = (
    select max(total_revenue)
    from (select l_suppkey as supplier_no,
                 sum(l_extendedprice * (1 - l_discount)) as total_revenue
          from lineitem
          where l_shipdate >= date '1996-01-01'
            and l_shipdate < date '1996-01-01' + interval 3 month
          group by l_suppkey) revenue1)
order by s_suppkey
"""

Q16 = """
select p_brand, p_type, p_size, count(distinct ps_suppkey) as supplier_cnt
from partsupp, part
where p_partkey = ps_partkey and p_brand <> 'Brand#45'
  and p_type not like 'MEDIUM POLISHED%'
  and p_size in (49, 14, 23, 45, 19, 3, 36, 9)
  and ps_suppkey not in (
    select s_suppkey from supplier where s_comment like '%Customer%Complaints%')
group by p_brand, p_type, p_size
order by supplier_cnt desc, p_brand, p_type, p_size
"""

Q17 = """
select sum(l_extendedprice) / 7.0 as avg_yearly
from lineitem, part
where p_partkey = l_partkey and p_brand = 'Brand#23'
  and p_container = 'MED BOX'
  and l_quantity < (select 0.2 * avg(l_quantity) from lineitem
                    where l_partkey = p_partkey)
"""

Q18 = """
select c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice,
  sum(l_quantity)
from customer, orders, lineitem
where o_orderkey in (select l_orderkey from lineitem
                     group by l_orderkey having sum(l_quantity) > 300)
  and c_custkey = o_custkey and o_orderkey = l_orderkey
group by c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice
order by o_totalprice desc, o_orderdate limit 100
"""

Q19 = """
select sum(l_extendedprice * (1 - l_discount)) as revenue
from lineitem, part
where (p_partkey = l_partkey and p_brand = 'Brand#12'
    and p_container in ('SM CASE', 'SM BOX', 'SM PACK', 'SM PKG')
    and l_quantity >= 1 and l_quantity <= 11 and p_size between 1 and 5
    and l_shipmode in ('AIR', 'AIR REG')
    and l_shipinstruct = 'DELIVER IN PERSON')
  or (p_partkey = l_partkey and p_brand = 'Brand#23'
    and p_container in ('MED BAG', 'MED BOX', 'MED PKG', 'MED PACK')
    and l_quantity >= 10 and l_quantity <= 20 and p_size between 1 and 10
    and l_shipmode in ('AIR', 'AIR REG')
    and l_shipinstruct = 'DELIVER IN PERSON')
  or (p_partkey = l_partkey and p_brand = 'Brand#34'
    and p_container in ('LG CASE', 'LG BOX', 'LG PACK', 'LG PKG')
    and l_quantity >= 20 and l_quantity <= 30 and p_size between 1 and 15
    and l_shipmode in ('AIR', 'AIR REG')
    and l_shipinstruct = 'DELIVER IN PERSON')
"""

Q20 = """
select s_name, s_address from supplier, nation
where s_suppkey in (
    select ps_suppkey from partsupp
    where ps_partkey in (select p_partkey from part
                         where p_name like 'forest%')
      and ps_availqty > (
        select 0.5 * sum(l_quantity) from lineitem
        where l_partkey = ps_partkey and l_suppkey = ps_suppkey
          and l_shipdate >= date '1994-01-01'
          and l_shipdate < date '1994-01-01' + interval 1 year))
  and s_nationkey = n_nationkey and n_name = 'CANADA'
order by s_name
"""

# Q20 without its nation predicate: Q20 itself returns no row at the
# scale factors the tests and chip_smoke.py use (no CANADA supplier
# passes), so this statement is the one whose rows show its subqueries
# at work
Q20_ALL_NATIONS = Q20.replace(
    "and s_nationkey = n_nationkey and n_name = 'CANADA'",
    "and s_nationkey = n_nationkey")
assert Q20_ALL_NATIONS != Q20

Q21 = """
select s_name, count(*) as numwait
from supplier, lineitem l1, orders, nation
where s_suppkey = l1.l_suppkey and o_orderkey = l1.l_orderkey
  and o_orderstatus = 'F' and l1.l_receiptdate > l1.l_commitdate
  and exists (select * from lineitem l2
              where l2.l_orderkey = l1.l_orderkey
                and l2.l_suppkey <> l1.l_suppkey)
  and not exists (select * from lineitem l3
                  where l3.l_orderkey = l1.l_orderkey
                    and l3.l_suppkey <> l1.l_suppkey
                    and l3.l_receiptdate > l3.l_commitdate)
  and s_nationkey = n_nationkey and n_name = 'SAUDI ARABIA'
group by s_name order by numwait desc, s_name limit 100
"""

Q22 = """
select cntrycode, count(*) as numcust, sum(c_acctbal) as totacctbal
from (select substring(c_phone, 1, 2) as cntrycode, c_acctbal
      from customer
      where substring(c_phone, 1, 2) in ('13', '31', '23', '29', '30', '18', '17')
        and c_acctbal > (select avg(c_acctbal) from customer
                         where c_acctbal > 0.00
                           and substring(c_phone, 1, 2) in
                             ('13', '31', '23', '29', '30', '18', '17'))
        and not exists (select * from orders
                        where o_custkey = c_custkey)) as custsale
group by cntrycode order by cntrycode
"""

ALL_QUERIES = {
    "q1": Q1, "q2": Q2, "q3": Q3, "q4": Q4, "q5": Q5, "q6": Q6, "q7": Q7,
    "q8": Q8, "q9": Q9, "q10": Q10, "q11": Q11, "q12": Q12, "q13": Q13,
    "q14": Q14, "q15": Q15, "q16": Q16, "q17": Q17, "q18": Q18, "q19": Q19,
    "q20": Q20, "q21": Q21, "q22": Q22,
}

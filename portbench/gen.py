"""TPC-H tables as numpy arrays, made from a seed.

A frozen copy of the array generation of the port's TPC-H loader
(`tidb_tpu_torch/bench/tpch.py:load_tpch`): dbgen's value ranges and
date windows, numpy-vectorised. Changes from the loader: each table
draws from a random stream of its own (seed, table), so a cell makes only
the tables its statements read and gets the same rows as a cell that
makes all eight; p_retailprice, ps_suppkey, l_suppkey and
l_extendedprice follow dbgen's formulas (TPC-H 4.2.3), so a lineitem's
supplier is one of its part's four and its price is its quantity times
its part's; and nothing here imports the port. The same arrays go to the
port's bulk-load path and to the plain reference.

A table is {"n": rows, "cols": {column: array}, "dicts": {column:
values}}: a column named in "dicts" holds int32 codes into its values
(loaded with the values seeded in code order, so codes carry over)."""
from __future__ import annotations

import numpy as np

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
TABLES = tuple(DDL)

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
INSTRUCTS = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
STATUSES = ["F", "O", "P"]
RETURNFLAGS = ["R", "A", "N"]
LINESTATUSES = ["F", "O"]

# days since 1970-01-01
EPOCH = np.datetime64("1970-01-01", "D")


def day(text: str) -> int:
    """'YYYY-MM-DD' -> days since 1970-01-01 (the port's DATE storage)."""
    return int((np.datetime64(text, "D") - EPOCH).astype(np.int64))


def day_text(days: int) -> str:
    return str(EPOCH + np.timedelta64(int(days), "D"))


_D92 = day("1992-01-01")
_D98 = day("1998-08-02")          # last shipdate window per spec
_CUTOFF = day("1995-06-17")       # returnflag R/A before, N after

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


def sizes(sf: float) -> dict:
    return {"supplier": max(int(10_000 * sf), 10),
            "customer": max(int(150_000 * sf), 30),
            "part": max(int(200_000 * sf), 40),
            "orders": max(int(1_500_000 * sf), 150)}


def _rng(seed: int, table: str):
    return np.random.default_rng([int(seed) & ((1 << 64) - 1),
                                  TABLES.index(table)])


def _codes(rng, choices, n):
    return rng.integers(0, len(choices), n).astype(np.int32)


def _phones(nationkey):
    """dbgen phone: country code 10 + nationkey."""
    return np.array([f"{10 + int(nk)}-467-819-{1000 + (int(nk) * 37) % 9000}"
                     for nk in nationkey], dtype=object)


def _retailprice(partkey):
    """dbgen's P_RETAILPRICE in cents (TPC-H 4.2.3)."""
    return 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)


def _suppkey(partkey, i, n_supp):
    """dbgen's i-th supplier (0..3) of a part (TPC-H 4.2.3, PS_SUPPKEY
    and L_SUPPKEY)."""
    return (partkey + i * (n_supp // 4 + (partkey - 1) // n_supp)) \
        % n_supp + 1


def _blank(n):
    return np.array([""] * n, dtype=object)


def _region(seed, sf):
    return {"n": 5, "cols": {
        "r_regionkey": np.arange(5, dtype=np.int64),
        "r_name": np.arange(5, dtype=np.int32),
        "r_comment": _blank(5)}, "dicts": {"r_name": REGIONS}}


def _nation(seed, sf):
    return {"n": 25, "cols": {
        "n_nationkey": np.arange(25, dtype=np.int64),
        "n_name": np.arange(25, dtype=np.int32),
        "n_regionkey": np.array([r for _, r in NATIONS], dtype=np.int64),
        "n_comment": _blank(25)},
        "dicts": {"n_name": [n for n, _ in NATIONS]}}


def _supplier(seed, sf):
    rng = _rng(seed, "supplier")
    n = sizes(sf)["supplier"]
    nat = rng.integers(0, 25, n).astype(np.int64)
    cmnt = _blank(n)
    cmnt[rng.choice(n, max(n // 2000, 1), replace=False)] = \
        "sly Customer slyly Complaints cajole"
    return {"n": n, "cols": {
        "s_suppkey": np.arange(1, n + 1, dtype=np.int64),
        "s_name": np.array([f"Supplier#{i:09d}" for i in range(1, n + 1)],
                           dtype=object),
        "s_address": np.array(["addr"] * n, dtype=object),
        "s_nationkey": nat,
        "s_phone": _phones(nat),
        "s_acctbal": rng.integers(-99999, 999999, n).astype(np.int64),
        "s_comment": cmnt}, "dicts": {}}


def _customer(seed, sf):
    rng = _rng(seed, "customer")
    n = sizes(sf)["customer"]
    nat = rng.integers(0, 25, n).astype(np.int64)
    return {"n": n, "cols": {
        "c_custkey": np.arange(1, n + 1, dtype=np.int64),
        "c_name": np.array([f"Customer#{i:09d}" for i in range(1, n + 1)],
                           dtype=object),
        "c_address": np.array(["addr"] * n, dtype=object),
        "c_nationkey": nat,
        "c_phone": _phones(nat),
        "c_acctbal": rng.integers(-99999, 999999, n).astype(np.int64),
        "c_mktsegment": _codes(rng, SEGMENTS, n),
        "c_comment": _blank(n)}, "dicts": {"c_mktsegment": SEGMENTS}}


def _part(seed, sf):
    rng = _rng(seed, "part")
    n = sizes(sf)["part"]
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
    words = np.array(P_NAME_WORDS, dtype=object)[
        rng.integers(0, len(P_NAME_WORDS), (n, 5))]
    return {"n": n, "cols": {
        "p_partkey": np.arange(1, n + 1, dtype=np.int64),
        "p_name": np.array([" ".join(r) for r in words], dtype=object),
        "p_mfgr": np.array(["Manufacturer#1"] * n, dtype=object),
        "p_brand": _codes(rng, brands, n),
        "p_type": _codes(rng, types, n),
        "p_size": rng.integers(1, 51, n).astype(np.int64),
        "p_container": _codes(rng, containers, n),
        "p_retailprice": _retailprice(np.arange(1, n + 1, dtype=np.int64)),
        "p_comment": _blank(n)},
        "dicts": {"p_type": types, "p_brand": brands,
                  "p_container": containers}}


def _partsupp(seed, sf):
    rng = _rng(seed, "partsupp")
    sz = sizes(sf)
    n_part, n_supp = sz["part"], sz["supplier"]
    n = n_part * 4
    pk = np.repeat(np.arange(1, n_part + 1, dtype=np.int64), 4)
    i4 = np.tile(np.arange(4, dtype=np.int64), n_part)
    sk = _suppkey(pk, i4, n_supp)
    return {"n": n, "cols": {
        "ps_partkey": pk, "ps_suppkey": sk,
        "ps_availqty": rng.integers(1, 10000, n).astype(np.int64),
        "ps_supplycost": rng.integers(100, 100001, n).astype(np.int64),
        "ps_comment": _blank(n)}, "dicts": {}}


def _orderdates(rng, n):
    """The orders stream's first draw, so lineitem can repeat it."""
    return (_D92 + rng.integers(0, _D98 - 151 - _D92, n)).astype(np.int64)


def _orders(seed, sf):
    rng = _rng(seed, "orders")
    sz = sizes(sf)
    n, n_cust = sz["orders"], sz["customer"]
    odate = _orderdates(rng, n)
    cmnt = _blank(n)
    cmnt[rng.choice(n, max(int(n * 0.012), 1), replace=False)] = \
        "blithely special pending requests haggle"
    cust = rng.integers(1, n_cust + 1, n).astype(np.int64)
    # dbgen skips custkey % 3 == 0: a third of customers have no orders
    cust = np.where(cust % 3 == 0, np.maximum(cust - 1, 1), cust)
    return {"n": n, "cols": {
        "o_orderkey": np.arange(1, n + 1, dtype=np.int64),
        "o_custkey": cust,
        "o_orderstatus": _codes(rng, STATUSES, n),
        "o_totalprice": rng.integers(100000, 50000000, n).astype(np.int64),
        "o_orderdate": odate,
        "o_orderpriority": _codes(rng, PRIORITIES, n),
        "o_clerk": np.array(["Clerk#000000001"] * n, dtype=object),
        "o_shippriority": np.zeros(n, dtype=np.int64),
        "o_comment": cmnt},
        "dicts": {"o_orderstatus": STATUSES,
                  "o_orderpriority": PRIORITIES}}


def _lineitem(seed, sf):
    sz = sizes(sf)
    n_ord = sz["orders"]
    odate = _orderdates(_rng(seed, "orders"), n_ord)
    rng = _rng(seed, "lineitem")
    per = rng.integers(1, 8, n_ord)
    n = int(per.sum())
    base = np.repeat(odate, per)
    ship = base + rng.integers(1, 122, n)
    commit = base + rng.integers(30, 91, n)
    receipt = ship + rng.integers(1, 31, n)
    rf = np.where(receipt <= _CUTOFF, rng.integers(0, 2, n), 2)
    starts = np.repeat(np.cumsum(per) - per, per)
    part = rng.integers(1, sz["part"] + 1, n).astype(np.int64)
    supp = _suppkey(part, rng.integers(0, 4, n), sz["supplier"])
    qty = rng.integers(1, 51, n).astype(np.int64)
    return {"n": n, "cols": {
        "l_orderkey": np.repeat(np.arange(1, n_ord + 1, dtype=np.int64), per),
        "l_partkey": part,
        "l_suppkey": supp.astype(np.int64),
        "l_linenumber": (np.arange(n) - starts + 1).astype(np.int64),
        "l_quantity": qty * 100,
        "l_extendedprice": qty * _retailprice(part),
        "l_discount": rng.integers(0, 11, n).astype(np.int64),
        "l_tax": rng.integers(0, 9, n).astype(np.int64),
        "l_returnflag": rf.astype(np.int32),
        "l_linestatus": np.where(ship > _CUTOFF, 1, 0).astype(np.int32),
        "l_shipdate": ship.astype(np.int64),
        "l_commitdate": commit.astype(np.int64),
        "l_receiptdate": receipt.astype(np.int64),
        "l_shipinstruct": _codes(rng, INSTRUCTS, n),
        "l_shipmode": _codes(rng, SHIPMODES, n),
        "l_comment": np.zeros(n, dtype=np.int32)},
        "dicts": {"l_returnflag": RETURNFLAGS,
                  "l_linestatus": LINESTATUSES,
                  "l_shipmode": SHIPMODES, "l_shipinstruct": INSTRUCTS,
                  "l_comment": [""]}}


_MAKERS = {"region": _region, "nation": _nation, "supplier": _supplier,
           "customer": _customer, "part": _part, "partsupp": _partsupp,
           "orders": _orders, "lineitem": _lineitem}


def make_tables(names, sf: float, seed: int) -> dict:
    """-> {table: table dict} for `names`, in TABLES order."""
    unknown = set(names) - set(TABLES)
    if unknown:
        raise KeyError(f"no TPC-H table {sorted(unknown)}")
    return {t: _MAKERS[t](seed, sf) for t in TABLES if t in names}

"""Differential run of the port against the reference: one random
workload through both TestKits, every answer compared.

Each case makes a 3,000-row table from its seed (NULLs in every
nullable column, BIGINT UNSIGNED values on both sides of 2^63, scaled
decimals, doubles with -0.0 and 0.0), applies 30 random DML and DDL
steps (inserts, updates, deletes, ADD/DROP COLUMN, CREATE/DROP INDEX),
then runs 16 query shapes (group-bys, global aggregates, filters,
top-n, a self-join, uint and NULL semantics). Both kits run with
tidb_tpu_fragment_min_rows = 0, so the port's torch programs serve
every fragment they can. Two seeds run on one device and one on a
4-shard mesh with MPP on (the reference on its virtual devices).

Every statement's rows must agree: floats within rtol 1e-9 (the
ROADMAP's float64 rule), everything else exactly, row order included
(every query orders its output)."""
import math
import random

import numpy as np
import pytest

from tidb_tpu.testkit import TestKit as RefKit
from tidb_tpu_torch.testkit import TestKit

N_ROWS = 3000
N_STEPS = 30
WORDS = ("alpha", "beta", "gamma", "delta", "ab", "ax", "zeta", "")

QUERIES = (
    "select g, count(*), sum(n), min(dc), max(dc) from d group by g "
    "order by g",
    "select count(*), sum(dc), avg(f) from d where n > 5",
    "select s, count(*), sum(f) from d group by s order by s",
    "select id, u from d where u > 5 order by id limit 20",
    "select g, avg(dc) from d where dc is not null group by g order by g",
    "select count(distinct g), count(distinct s) from d",
    "select sum(f), min(f), max(f), count(f) from d",
    "select g, s, count(*), sum(n) from d group by g, s order by g, s",
    "select id, f from d where f = 0 order by id",
    "select id, dc from d order by dc desc, id limit 15",
    "select n, count(*) from d where s like 'a%' group by n order by n",
    "select sum(n * 2), sum(dc * n) from d where g between 3 and 9",
    "select a.g, count(*), sum(b.dc) from d a join d b on a.id = b.n "
    "group by a.g order by a.g",
    "select g, max(u), min(u), count(u) from d group by g order by g",
    "select count(*) from d where dc is null or n is null",
    "select id, f, case when n > 10 then 'hi' else s end from d "
    "where f < 0 order by f, id limit 10",
)


@pytest.fixture(autouse=True)
def _torch_registries():
    """The shared conftest resets tidb_tpu's registries only."""
    from tidb_tpu_torch.utils import device_guard, metrics, phase
    metrics.reset_all()
    device_guard.reset()
    phase.reset()
    yield


def _lit(v):
    if v is None:
        return "NULL"
    if isinstance(v, str):
        return f"'{v}'"
    return repr(v) if isinstance(v, float) else str(v)


def _row(rng, i):
    """One row: (id, g, u, dc, f, s, n) as SQL literals."""
    def maybe(v, p=0.1):
        return None if rng.random() < p else v
    u = rng.choice((rng.randrange(0, 1000), rng.randrange(2 ** 63, 2 ** 64),
                    2 ** 64 - 1, rng.randrange(0, 2 ** 63)))
    f = rng.choice((0.0, -0.0, rng.uniform(-100, 100),
                    rng.uniform(-1, 1) * 1e6))
    dc = f"{rng.randrange(-99999999, 99999999) / 100:.2f}"
    return (i, maybe(rng.randrange(20)), maybe(u), maybe(dc),
            maybe(f), maybe(rng.choice(WORDS)), maybe(rng.randrange(40)))


def _insert(rows):
    return "insert into d (id, g, u, dc, f, s, n) values " + ",".join(
        "(" + ",".join(_lit(v) for v in r) + ")" for r in rows)


def _steps(rng):
    """30 random DML and DDL statements over d."""
    out, next_id, extra = [], N_ROWS, []
    for step in range(N_STEPS):
        kind = rng.choice(("insert", "insert", "update", "update",
                           "delete", "addcol", "dropcol", "index",
                           "update_u", "update_null"))
        if kind == "insert":
            rows = [_row(rng, next_id + j) for j in range(rng.randrange(1, 40))]
            next_id += len(rows)
            out.append(_insert(rows))
        elif kind == "update":
            out.append(f"update d set n = n + {rng.randrange(1, 5)}, "
                       f"dc = dc * 2 where g = {rng.randrange(20)}")
        elif kind == "delete":
            out.append(f"delete from d where id % {rng.randrange(7, 40)} "
                       f"= {rng.randrange(7)}")
        elif kind == "addcol":
            name = f"c{step}"
            extra.append(name)
            out.append(f"alter table d add column {name} int default "
                       f"{rng.randrange(100)}")
        elif kind == "dropcol" and extra:
            out.append(f"alter table d drop column {extra.pop(0)}")
        elif kind == "index":
            out.append(f"create index i{step} on d (g)")
            out.append(f"drop index i{step} on d")
        elif kind == "update_u":
            out.append(f"update d set u = {rng.randrange(2 ** 63, 2 ** 64)} "
                       f"where n = {rng.randrange(40)}")
        else:
            out.append(f"update d set f = NULL, s = NULL where id % 97 = "
                       f"{rng.randrange(97)}")
    return out


def _same(a, b):
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return a == b or abs(a - b) <= 1e-9 * max(abs(a), abs(b))
    return a == b


def _check(ref_rows, port_rows, sql):
    assert len(ref_rows) == len(port_rows), (sql, ref_rows[:3],
                                             port_rows[:3])
    for r, p in zip(ref_rows, port_rows):
        assert len(r) == len(p) and all(_same(a, b) for a, b in
                                        zip(r, p)), (sql, r, p)


def _kits(mesh):
    ref = RefKit()
    port = TestKit(device="cpu", mesh=4) if mesh else TestKit(device="cpu")
    for tk in (ref, port):
        tk.must_exec("set @@tidb_tpu_fragment_min_rows = 0")
        if mesh:
            tk.must_exec("set @@tidb_enable_mpp = on")
            tk.must_exec("set @@tidb_mpp_min_rows = 0")
        else:
            tk.must_exec("set @@tidb_enable_mpp = off")
        tk.must_exec("create table d (id bigint primary key, g int, "
                     "u bigint unsigned, dc decimal(12,2), f double, "
                     "s varchar(16), n int)")
    return ref, port


@pytest.mark.parametrize("seed,mesh", [(1, False), (2, False), (3, True)])
def test_port_equals_reference(seed, mesh):
    rng = random.Random(seed)
    np.random.seed(seed)
    ref, port = _kits(mesh)
    rows = [_row(rng, i) for i in range(N_ROWS)]
    stmts = [_insert(rows[i:i + 500]) for i in range(0, N_ROWS, 500)]
    stmts += _steps(rng)
    for sql in stmts:
        for tk in (ref, port):
            tk.must_exec(sql)
    for sql in QUERIES:
        _check(ref.must_query(sql).rows, port.must_query(sql).rows, sql)
    m = port.domain.metrics
    served = m.get("fused_pipeline_hit", 0) + \
        m.get("fused_pipeline_mpp_hit", 0) + \
        m.get("copr_device_exec", 0) + m.get("copr_mpp_exec", 0)
    assert served > 0, m
    if mesh:
        assert m.get("fused_pipeline_mpp_hit", 0) + \
            m.get("copr_mpp_exec", 0) > 0, m

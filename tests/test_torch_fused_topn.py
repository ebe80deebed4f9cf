"""Device top-N candidates over the fused pipeline's partials
(tidb_tpu_torch/copr/pipeline.py: _fused_topn_state, _topn_select, the
cover proof at consume) against the reference's, on the CPU.

Twins of tests/test_fused_topn.py: each statement runs on the
reference's TestKit and on the port's, both under the runs lowering
(_FORCE_SEGMENT_IMPL = "runs", the card's policy, under which alone the
candidates apply), and the rows must be equal as strings to each other
and to the port's host twin (copr.use_device = False). What each
package learned is compared too: candidates selected (a spy on
_topn_select), the off pin after a failed cover proof, the runs->sorted
pin. Then _topn_select itself on CPU tensors against the reference's
under jax on the same numpy-seeded partials: equal metrics (ties) and
NULL metrics, both sort directions, a group key and each aggregate
kind, compared by equal `sel` and equal gathered arrays."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

import tidb_tpu.copr.dag_exec as rde
import tidb_tpu.copr.pipeline as rpl
from tidb_tpu.testkit import TestKit as RefKit

import tidb_tpu_torch.copr.dag_exec as pde
import tidb_tpu_torch.copr.pipeline as ppl
from tidb_tpu_torch.testkit import TestKit as PortKit
from tidb_tpu_torch.utils import phase as port_phase

I64_MAX = np.iinfo(np.int64).max


@pytest.fixture(autouse=True)
def _torch_registries():
    """The shared conftest resets tidb_tpu's registries only; both
    packages' lowering switches are put back after each test."""
    from tidb_tpu_torch.utils import metrics, device_guard
    metrics.reset_all()
    device_guard.reset()
    port_phase.reset()
    yield
    pde._FORCE_SEGMENT_IMPL = None
    rde._FORCE_SEGMENT_IMPL = None


@pytest.fixture
def runs_impl(monkeypatch):
    monkeypatch.setattr(pde, "_FORCE_SEGMENT_IMPL", "runs")
    monkeypatch.setattr(rde, "_FORCE_SEGMENT_IMPL", "runs")


def _mk_star(tk, n_orders=300, lines_per=4, val=lambda i: i % 97):
    """Clustered fact (f.ok monotone) joined to a dim with a filter."""
    tk.must_exec("create table d (ok int, dcat int, dval int)")
    tk.must_exec("create table f (ok int, v int)")
    tk.must_exec("insert into d values " + ",".join(
        f"({k},{k % 7},{k % 13})" for k in range(1, n_orders + 1)))
    rows = []
    i = 0
    for k in range(1, n_orders + 1):
        for _ in range(lines_per):
            rows.append(f"({k},{val(i)})")
            i += 1
    tk.must_exec("insert into f values " + ",".join(rows))


def _kits(setup, device_rows=None):
    """The reference's TestKit and the port's (CPU), each set up."""
    ref, port = RefKit(), PortKit(device="cpu")
    for tk in (ref, port):
        setup(tk)
        if device_rows is not None:
            tk.domain.copr.device_rows = device_rows
    return ref, port


def _strs(rows):
    return [tuple(map(str, r)) for r in rows]


def _host_rows(tk, sql):
    tk.domain.copr.use_device = False
    try:
        return tk.must_query(sql).rows
    finally:
        tk.domain.copr.use_device = True


class _Spy:
    """Counts the calls of a module's _topn_select (the port calls it
    once per partition and statement, the reference once per trace)."""

    def __init__(self, monkeypatch, mod):
        self.calls = []
        orig = mod._topn_select

        def spy(res, aggs, topn, bucket):
            self.calls.append(topn)
            return orig(res, aggs, topn, bucket)
        monkeypatch.setattr(mod, "_topn_select", spy)


def _pins(tk, kind):
    return [v for k, v in tk.domain.copr._host_cache.items()
            if isinstance(k, tuple) and k and k[0] == kind]


TOPN_SQL = ("select f.ok, d.dval, sum(f.v) s from f join d on f.ok = d.ok "
            "where d.dcat < 5 group by f.ok, d.dval "
            "order by s desc, f.ok limit 7")


def test_fused_topn_candidates_match_host(runs_impl, monkeypatch):
    ref, port = _kits(_mk_star)
    rspy, pspy = _Spy(monkeypatch, rpl), _Spy(monkeypatch, ppl)
    want = ref.must_query(TOPN_SQL).rows
    got = port.must_query(TOPN_SQL).rows
    assert len(rspy.calls) == 1 and len(pspy.calls) == 1
    # the same candidates: k + 66 of them, ("agg", sum, desc)
    assert pspy.calls == rspy.calls == [("agg", 0, True, 7 + 66)]
    assert port.domain.metrics.get("fused_topn_cand", 0) == 1
    assert _strs(got) == _strs(want) == _strs(_host_rows(port, TOPN_SQL))


def test_fused_topn_boundary_split_partitions(runs_impl, monkeypatch):
    """A clustered group whose rows straddle the partition edge merges
    exactly: the edge runs are forced into the candidates."""
    # 8-row groups and a partition of 251 rows: every edge splits one
    ref, port = _kits(lambda tk: _mk_star(tk, n_orders=100, lines_per=8),
                      device_rows=251)
    pspy = _Spy(monkeypatch, ppl)
    want = ref.must_query(TOPN_SQL).rows
    got = port.must_query(TOPN_SQL).rows
    assert len(pspy.calls) == -(-800 // 251)      # every partition
    assert _strs(got) == _strs(want) == _strs(_host_rows(port, TOPN_SQL))


def test_fused_topn_negative_sums_split_groups(runs_impl):
    """Sums that go negative across a partition split: a boundary
    partial's local metric must not vouch for dropping complete groups."""
    ref, port = _kits(lambda tk: _mk_star(
        tk, n_orders=120, lines_per=8, val=lambda i: ((i * 37) % 23) - 11),
        device_rows=251)
    sql = ("select f.ok, sum(f.v) s from f join d on f.ok = d.ok "
           "group by f.ok order by s desc, f.ok limit 5")
    want = ref.must_query(sql).rows
    got = port.must_query(sql).rows
    assert _strs(got) == _strs(want) == _strs(_host_rows(port, sql))
    assert bool(_pins(port, "ftopn_off")) == bool(_pins(ref, "ftopn_off"))


def test_fused_topn_disabled_after_degrade_pin(runs_impl, monkeypatch):
    """Once the runs-degrade rule pins a shape to the sorted lowering,
    the candidates switch off (their edge forcing assumes storage
    order) and the rows stay exact."""
    monkeypatch.setattr(pde, "_RUNS_DEGRADE_MIN", 8)
    monkeypatch.setattr(rde, "_RUNS_DEGRADE_MIN", 8)

    def setup(tk):
        # one row per group fires the degrade rule (ngroups > rows / 4)
        tk.must_exec("create table d (ok bigint, dval int)")
        tk.must_exec("create table f (ok bigint, v int)")
        n = 400
        tk.must_exec("insert into d values " + ",".join(
            f"({k},{k % 13})" for k in range(1, n + 1)))
        tk.must_exec("insert into f values " + ",".join(
            f"({k},{(k * 31) % 50})" for k in range(1, n + 1)))
    ref, port = _kits(setup)
    sql = ("select f.ok, sum(f.v) s from f join d on f.ok = d.ok "
           "group by f.ok order by s desc, f.ok limit 4")
    pspy = _Spy(monkeypatch, ppl)
    want = [ref.must_query(sql).rows for _ in range(2)]
    got = [port.must_query(sql).rows for _ in range(2)]
    host = _host_rows(port, sql)
    for w, g in zip(want, got):
        assert _strs(g) == _strs(w) == _strs(host)
    assert "sorted" in _pins(port, "aggimpl") and \
        "sorted" in _pins(ref, "aggimpl")
    # the second statement runs sorted: no candidates
    assert len(pspy.calls) == 1
    assert port.domain.metrics.get("fused_runs_degrade", 0) == 1


def test_fused_topn_tie_fallback(runs_impl):
    """Every group ties on the metric: the candidates cannot prove their
    cover, so the shape pins off and answers from every partial."""
    ref, port = _kits(lambda tk: _mk_star(tk, n_orders=2500, lines_per=1,
                                          val=lambda i: 5))
    sql = ("select f.ok, sum(f.v) s from f join d on f.ok = d.ok "
           "group by f.ok order by s desc, f.ok limit 3")
    want = ref.must_query(sql).rows
    got = port.must_query(sql).rows
    assert _strs(got) == _strs(want) == _strs(_host_rows(port, sql))
    assert _pins(port, "ftopn_off") == [True] == _pins(ref, "ftopn_off")
    assert port.domain.metrics.get("fused_topn_off", 0) == 1
    assert port.domain.metrics.get("fused_topn_cand", 0) == 0


def _tracker_tables(bigint_type, column_info, table_info, columnar_table,
                    tid):
    ti = table_info(id=tid, name="t", columns=[column_info(
        id=1, name="a", offset=0, ft=bigint_type())])
    return columnar_table(ti)


def _both_trackers(tid):
    from tidb_tpu.storage.columnar import ColumnarTable as RT
    from tidb_tpu.models.schema import TableInfo as RTI, ColumnInfo as RCI
    from tidb_tpu.types.field_type import new_bigint_type as rbig
    from tidb_tpu.types.datum import Datum as RD, Kind as RK
    from tidb_tpu_torch.storage.columnar import ColumnarTable as PT
    from tidb_tpu_torch.models.schema import (TableInfo as PTI,
                                              ColumnInfo as PCI)
    from tidb_tpu_torch.types.field_type import new_bigint_type as pbig
    from tidb_tpu_torch.types.datum import Datum as PD, Kind as PK
    return ((_tracker_tables(rbig, RCI, RTI, RT, tid), RD, RK),
            (_tracker_tables(pbig, PCI, PTI, PT, tid), PD, PK))


def test_clustered_tracker():
    seen = []
    for tbl, datum, kind in _both_trackers(900):
        got = []
        for h, v in enumerate([3, 3, 5, 9], start=1):
            tbl.put_row(h, [datum(kind.INT, v)])
        got.append(tbl.is_clustered(1))
        tbl.put_row(10, [datum(kind.INT, 100)])     # still monotone
        got.append(tbl.is_clustered(1))
        tbl.put_row(11, [datum(kind.INT, 4)])       # out of order
        got.append(tbl.is_clustered(1))
        # the demotion sticks though later appends are ordered again
        tbl.put_row(12, [datum(kind.INT, 500)])
        got.append(tbl.is_clustered(1))
        seen.append(got)
    assert seen[0] == seen[1] == [True, True, False, False]


def test_clustered_tracker_null_and_update():
    seen = []
    for (tbl, datum, kind), (tbl2, _d, _k) in zip(_both_trackers(901),
                                                  _both_trackers(902)):
        got = []
        tbl.put_row(1, [datum(kind.INT, 1)])
        tbl.put_row(2, [datum(kind.INT, 2)])
        got.append(tbl.is_clustered(1))
        # an UPDATE appends a new version at the tail: order broken
        tbl.put_row(1, [datum(kind.INT, 1)], commit_ts=5)
        got.append(tbl.is_clustered(1))
        tbl2.put_row(1, [datum(kind.INT, 1)])
        tbl2.put_row(2, [None])                     # a NULL breaks it
        got.append(tbl2.is_clustered(1))
        seen.append(got)
    assert seen[0] == seen[1] == [True, False, False]


class _Agg:
    def __init__(self, name):
        self.name = name


# (metric kind, aggregate or None, desc, values drawn from, NULL share)
SELECT_CASES = [
    ("agg", "sum", True, 5, 0.0),            # heavy ties
    ("agg", "sum", False, 5, 0.2),           # ties and NULLs (cnt 0)
    ("agg", "count", True, 3, 0.0),
    ("agg", "min", False, 1000, 0.3),
    ("agg", "max", True, 1 << 62, 0.1),      # wide values
    ("group", None, True, 7, 0.25),          # NULL keys
    ("group", None, False, 7, 0.25),
    ("agg", "sum", True, "extremes", 0.1),   # clamped to the markers
]


def _partials(rng, kind, values, ngroups, bucket, null_share):
    """Random partials of `bucket` slots with `ngroups` live, as the
    sort kind returns them: one int64 key, one aggregate's states."""
    if values == "extremes":
        pool = np.array([-I64_MAX - 1, -I64_MAX, -I64_MAX + 1, -1, 0, 1,
                         I64_MAX - 2, I64_MAX - 1, I64_MAX], dtype=np.int64)
        v = rng.choice(pool, bucket)
    else:
        v = rng.integers(-values, values, bucket, dtype=np.int64)
    nul = rng.random(bucket) < null_share
    cnt = np.where(nul, 0, rng.integers(1, 9, bucket)).astype(np.int64)
    return v, nul, cnt


@pytest.mark.parametrize("case", SELECT_CASES,
                         ids=[f"{c[0]}-{c[1]}-{'desc' if c[2] else 'asc'}-"
                              f"{c[3]}-{c[4]}" for c in SELECT_CASES])
@pytest.mark.parametrize("ngroups", [0, 1, 2, 57, 128, 200])
def test_topn_select_equals_reference(case, ngroups):
    kind, aname, desc, values, null_share = case
    bucket, kprime = 256, 73
    rng = np.random.default_rng(1000 * SELECT_CASES.index(case) + ngroups)
    v, nul, cnt = _partials(rng, kind, values, ngroups, bucket, null_share)
    key2 = rng.integers(0, 1 << 40, bucket, dtype=np.int64)
    if kind == "group":
        keys, key_nulls = [key2, v], [np.zeros(bucket, bool), nul]
        states = [[cnt.copy(), cnt]]
        aggs = [_Agg("sum")]
        spec = ("group", 1, desc, kprime)
    else:
        keys, key_nulls = [key2], [np.zeros(bucket, bool)]
        states = [[cnt]] if aname == "count" else [[v, cnt]]
        aggs = [_Agg(aname)]
        spec = ("agg", 0, desc, kprime)
    ref = rpl._topn_select(
        {"ngroups": jnp.asarray(ngroups, jnp.int64),
         "keys": [jnp.asarray(k) for k in keys],
         "key_nulls": [jnp.asarray(k) for k in key_nulls],
         "states": [[jnp.asarray(s) for s in st] for st in states],
         "nvalid": jnp.asarray(9, jnp.int64)}, aggs, spec, bucket)
    got = ppl._topn_select(
        {"ngroups": torch.tensor(ngroups),
         "keys": [torch.from_numpy(k) for k in keys],
         "key_nulls": [torch.from_numpy(k) for k in key_nulls],
         "states": [[torch.from_numpy(s) for s in st] for st in states],
         "nvalid": torch.tensor(9)}, aggs, spec, bucket)
    assert np.array_equal(got["sel"].numpy(), np.asarray(ref["sel"]))
    for g, r in zip(got["keys"] + got["key_nulls"],
                    ref["keys"] + ref["key_nulls"]):
        assert np.array_equal(g.numpy(), np.asarray(r))
    for gs, rs in zip(got["states"], ref["states"]):
        for g, r in zip(gs, rs):
            assert np.array_equal(g.numpy(), np.asarray(r))
    assert int(got["nvalid"]) == 9 and int(got["ngroups"]) == ngroups
    # the host twin of the metric, and the cover proof over it
    ncand = min(ngroups, kprime)
    args = (spec, aggs, [k.numpy()[:ncand] for k in got["keys"]],
            [k.numpy()[:ncand] for k in got["key_nulls"]],
            [[s.numpy()[:ncand] for s in st] for st in got["states"]])
    assert np.array_equal(ppl._topn_metric_host(*args),
                          rpl._topn_metric_host(*args))
    if ngroups > kprime:
        sel = got["sel"].numpy()[:ncand]
        real_m = rpl._topn_metric_host(*args)
        mnf = real_m[~((sel == 0) | (sel == ngroups - 1))]
        want = len(mnf) > 0 and int((mnf > mnf.min()).sum()) >= kprime
        assert ppl._topn_covered(*args, sel, ngroups) == want

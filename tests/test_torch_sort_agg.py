"""The port's general group-by lowerings (tidb_tpu_torch/copr/dag_exec.py:
sort_agg_body, runs_agg_body, dense_agg_states) against the reference's
on the same numpy-seeded inputs, for each of the "scatter", "sorted" and
"runs" policies (a twin of tests/test_ops.py's lowering tests and of
tests/test_runs_policy.py); then the fused pipeline's sort kind through
SQL: the runs-degrade pin, the bucket and compaction regrows, and the
MIN/MAX group-by whose sentinel once cost a host read per aggregate.

Reference calls: its "scatter" lowering is the oracle (its CPU policy)
and its "runs" lowering is compared layout for layout. Its "sorted"
lowerings (of sort_agg_body, and of dense_agg_states, which its runs
policy takes above 64 slots) compile segmented associative scans for
about a minute on the CPU (their equality with "scatter" is held in
tests/test_ops.py, marked slow), so the port's "sorted" is held to the
reference's "scatter" here.

Group order: the port orders every sort by chained stable sorts, where
the reference packs the keys into one sort key when their spans fit:
the two orders differ only in where a NULL key sorts. So a keyed
comparison outside the multisort branch is made after the partial merge
(key -> states), and the wide-key case (the reference's multisort
branch) is compared layout for layout. A first_row value of a group
whose rows all had a NULL argument is unspecified (the merge skips it)
and is not compared."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import tidb_tpu.copr.dag_exec as rde
from tidb_tpu.expression import EvalCtx as RefCtx
from tidb_tpu.expression.expr import Column as RefColumn
from tidb_tpu.types.field_type import (new_bigint_type as ref_bigint,
                                       new_double_type as ref_double)
from tidb_tpu.testkit import TestKit as RefKit
from tidb_tpu.bench import tpch as ref_tpch

import tidb_tpu_torch.copr.dag_exec as pde
from tidb_tpu_torch.copr import pipeline
from tidb_tpu_torch.expression import EvalCtx
from tidb_tpu_torch.expression.expr import Column
from tidb_tpu_torch.expression.torch_ns import TorchNS
from tidb_tpu_torch.types.field_type import new_bigint_type, new_double_type
from tidb_tpu_torch.testkit import TestKit as PortKit
from tidb_tpu_torch.bench import tpch as port_tpch
from tidb_tpu_torch.utils import phase as port_phase

IMPLS = ("scatter", "sorted", "runs")
# the aggregate kinds of the reference's tests: arg column 1 is int64
# without NULLs, column 2 float64 with NULLs
AGGS = (("count", None), ("sum", 1), ("avg", 2), ("min", 2), ("max", 1),
        ("first_row", 1), ("count", 2), ("min", 1), ("max", 2),
        ("sum", 2), ("first_row", 2))


class A:
    def __init__(self, name, args):
        self.name, self.args, self.distinct = name, args, False


def _aggs(column, bigint, double):
    types = {1: bigint, 2: double}
    return [A(name, [] if c is None else [column(c, types[c]())])
            for name, c in AGGS]


@pytest.fixture(autouse=True)
def _torch_registries():
    """The shared conftest resets tidb_tpu's registries only; the
    policy switches of both packages are put back after each test."""
    from tidb_tpu_torch.utils import metrics, device_guard
    metrics.reset_all()
    device_guard.reset()
    port_phase.reset()
    yield
    pde._FORCE_SEGMENT_IMPL = None
    rde._FORCE_SEGMENT_IMPL = None


def _inputs(shape, cap=2048, seed=11):
    """numpy inputs: mask, group column 0 (with NULLs), int column 1,
    float column 2 (with NULLs)."""
    rng = np.random.RandomState(seed)
    mask = rng.rand(cap) < 0.8
    gvals = rng.randint(0, 9, cap).astype(np.int64)
    gnull = rng.rand(cap) < 0.15
    if shape == "wide_keys":
        # keys spanning ~2^62: the reference's multisort branch
        gvals = np.where(gvals < 4, gvals - (1 << 61), gvals + (1 << 61))
    elif shape == "near_limits":
        # keys at +-(2^62 + small): the packed span wraps int64
        gvals = np.where(gvals < 4, -(1 << 62) - gvals, (1 << 62) + gvals)
    elif shape == "unclustered":
        gvals = rng.randint(0, 400, cap).astype(np.int64)
    elif shape == "clustered":
        order = np.lexsort((gvals, gnull))
        gvals, gnull = gvals[order], gnull[order]
    elif shape == "empty_mask":
        mask = np.zeros(cap, dtype=bool)
    ints = rng.randint(-100, 100, cap).astype(np.int64)
    flts = rng.randn(cap)
    fnull = rng.rand(cap) < 0.2
    return mask, {0: (gvals, gnull), 1: (ints, None), 2: (flts, fnull)}


def _ref_call(fn, impl, shape, cols, mask, cap, *args):
    rde._FORCE_SEGMENT_IMPL = impl
    ctx = RefCtx(jnp, cap, {k: (jnp.asarray(d), None if n is None else
                                jnp.asarray(n), None)
                            for k, (d, n) in cols.items()}, host=False)
    aggs = _aggs(RefColumn, ref_bigint, ref_double)
    gi = [] if shape == "global" else [RefColumn(0, ref_bigint())]
    try:
        return jax.device_get(fn(ctx, jnp.asarray(mask), *(
            (gi, aggs) if fn is rde.sort_agg_body else (aggs,)), *args))
    finally:
        rde._FORCE_SEGMENT_IMPL = None


def _port_call(fn, impl, shape, cols, mask, cap, *args):
    pde._FORCE_SEGMENT_IMPL = impl
    t = torch.from_numpy
    ctx = EvalCtx(TorchNS("cpu"), cap, {k: (t(d), None if n is None else
                                            t(n), None)
                                        for k, (d, n) in cols.items()},
                  host=False)
    aggs = _aggs(Column, new_bigint_type, new_double_type)
    gi = [] if shape == "global" else [Column(0, new_bigint_type())]
    try:
        res = fn(ctx, t(mask), *((gi, aggs) if fn in (
            pde.sort_agg_body, pde.runs_agg_body) else (aggs,)), *args)
    finally:
        pde._FORCE_SEGMENT_IMPL = None
    return _numpy(res)


def _numpy(x):
    if isinstance(x, dict):
        return {k: _numpy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_numpy(v) for v in x]
    return x.numpy() if isinstance(x, torch.Tensor) else x


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        np.testing.assert_allclose(a, b, rtol=1e-9, err_msg=what)
    else:
        np.testing.assert_array_equal(a, b, err_msg=what)


def _states_equal(sa, sb, ng, what, live=None):
    """State arrays [:ng] equal, agg by agg, at the `live` slots (all by
    default; a dense slot no row reached is never reported, and the
    reference's lowerings disagree on what it holds); a first_row value
    is compared only where its group saw a non-NULL argument."""
    if live is None:
        live = np.ones(ng, dtype=bool)
    for (name, _c), st_a, st_b in zip(AGGS, sa, sb):
        for j, (x, y) in enumerate(zip(st_a, st_b)):
            keep = live
            if name == "first_row" and j == 0:
                keep = live & (np.asarray(st_a[1])[:ng] > 0)
            _same(np.asarray(x)[:ng][keep], np.asarray(y)[:ng][keep],
                  f"{what} {name} state {j}")


def _merged(res, nkeys):
    """{key tuple: merged states} over a sort-layout result: the
    executor's partial merge, with a first_row taken from the first
    partial that saw a value (None when none did)."""
    ng = int(res["ngroups"])
    groups = {}
    for j in range(ng):
        key = tuple((bool(res["key_nulls"][i][j]), None if
                     res["key_nulls"][i][j] else int(res["keys"][i][j]))
                    for i in range(nkeys))
        acc = groups.setdefault(key, [None] * len(AGGS))
        for ai, ((name, _c), st) in enumerate(zip(AGGS, res["states"])):
            cnt = int(st[-1][j])
            val = st[0][j]
            cur = acc[ai]
            if name == "count":
                acc[ai] = (0 if cur is None else cur) + cnt
            elif name in ("sum", "avg"):
                s, c = (0, 0) if cur is None else cur
                acc[ai] = (s + val, c + cnt)
            elif name in ("min", "max"):
                v, c = (None, 0) if cur is None else cur
                if cnt:
                    v = val if v is None else (min(v, val) if name == "min"
                                               else max(v, val))
                acc[ai] = (v, c + cnt)
            else:
                v, c = (None, 0) if cur is None else cur
                acc[ai] = (val if v is None and cnt else v, c + cnt)
    return groups


def _groups_equal(ga, gb):
    assert set(ga) == set(gb)
    for key, sa in ga.items():
        for (name, _c), x, y in zip(AGGS, sa, gb[key]):
            for u, v in zip(np.atleast_1d(np.asarray(x, dtype=object)),
                            np.atleast_1d(np.asarray(y, dtype=object))):
                if isinstance(u, float) or isinstance(v, float):
                    np.testing.assert_allclose(float(u), float(v),
                                               rtol=1e-9)
                else:
                    assert u == v, (key, name, x, y)


def _layout_equal(a, b, what):
    """Equal group counts, and equal keys, NULL flags and states over
    the groups both returned (at most the bucket)."""
    ng = int(a["ngroups"])
    assert ng == int(b["ngroups"]), what
    ng = min(ng, len(a["states"][0][0]))
    for ka, kb in zip(a["keys"], b["keys"]):
        _same(np.asarray(ka)[:ng], np.asarray(kb)[:ng], f"{what} keys")
    for ka, kb in zip(a["key_nulls"], b["key_nulls"]):
        _same(np.asarray(ka)[:ng], np.asarray(kb)[:ng], f"{what} nulls")
    _states_equal(a["states"], b["states"], ng, what)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("shape", ["keyed", "global", "wide_keys",
                                   "near_limits", "unclustered",
                                   "empty_mask"])
def test_sort_agg_matches_reference(shape, impl):
    """sort_agg_body: NULL keys, masked rows, int and float sums,
    min/max, first_row, keys near +-2^62, an empty mask. "runs" equals
    the reference's runs layout for layout; "scatter" and "sorted" equal
    the reference's scatter after the merge, and layout for layout where
    the reference also took chained sorts."""
    cap, bucket = 2048, 512
    mask, cols = _inputs(shape, cap)
    got = _port_call(pde.sort_agg_body, impl, shape, cols, mask, cap,
                     cap, bucket)
    want = _ref_call(rde.sort_agg_body, "runs" if impl == "runs" else
                     "scatter", shape, cols, mask, cap, cap, bucket)
    nkeys = 0 if shape == "global" else 1
    if impl == "runs" or shape in ("global", "wide_keys", "near_limits",
                                   "empty_mask"):
        _layout_equal(got, want, f"{shape}/{impl}")
    else:
        assert int(got["ngroups"]) == int(want["ngroups"])
        _groups_equal(_merged(got, nkeys), _merged(want, nkeys))
    if shape == "empty_mask" and nkeys:
        assert int(got["ngroups"]) == 0


@pytest.mark.parametrize("shape", ["clustered", "unclustered", "global"])
def test_runs_agg_matches_reference(shape):
    """runs_agg_body (contiguous-run partials): layout for layout with
    the reference's, and after the merge with the scatter oracle;
    clustered keys give one partial per group, unclustered keys
    duplicate partials."""
    cap = 2048
    mask, cols = _inputs(shape, cap, seed=23)
    got = _port_call(pde.runs_agg_body, None, shape, cols, mask, cap, cap,
                     cap)
    # runs_agg_body is sort_agg_body's "runs" branch in the reference
    want = _ref_call(rde.sort_agg_body, "runs", shape, cols, mask, cap,
                     cap, cap)
    _layout_equal(got, want, shape)
    oracle = _ref_call(rde.sort_agg_body, "scatter", shape, cols, mask,
                       cap, cap, cap)
    nkeys = 0 if shape == "global" else 1
    _groups_equal(_merged(got, nkeys), _merged(oracle, nkeys))
    if shape == "clustered":
        assert int(got["ngroups"]) == int(oracle["ngroups"])
    elif shape == "unclustered":
        assert int(got["ngroups"]) > int(oracle["ngroups"])


def test_sort_agg_bucket_overflow_reports_ngroups():
    """More groups than the bucket: every lowering returns the true
    group count (the caller regrows and reruns) and the first `bucket`
    groups, the same ones as the reference's."""
    cap, bucket = 2048, 64
    mask, cols = _inputs("unclustered", cap)
    want = _ref_call(rde.sort_agg_body, "scatter", "keyed", cols, mask,
                     cap, cap, bucket)
    for impl in ("scatter", "sorted"):
        got = _port_call(pde.sort_agg_body, impl, "keyed", cols, mask, cap,
                         cap, bucket)
        assert int(got["ngroups"]) == int(want["ngroups"]) > bucket
    got = _port_call(pde.sort_agg_body, "runs", "keyed", cols, mask, cap,
                     cap, bucket)
    runs = _ref_call(rde.sort_agg_body, "runs", "keyed", cols, mask, cap,
                     cap, bucket)
    assert int(got["ngroups"]) == int(runs["ngroups"]) > bucket
    _states_equal(got["states"], runs["states"], bucket, "runs overflow")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("nslots", [11, 300])
def test_dense_agg_states_matches_reference(nslots, impl):
    """dense_agg_states under each policy equals the reference's
    (under the same policy where its lowering is not "sorted"), state
    for state: sums and counts exactly, min/max, first_row, NULL
    arguments, empty slots. The port takes the scan
    kernels' shape rule or its scatter at every size (its card policy
    sends domains over _BCR_MAX slots to the sort kind before they get
    here)."""
    cap = 4096
    rng = np.random.RandomState(7)
    mask = rng.rand(cap) < 0.7
    # the last two slots stay EMPTY
    slot = np.where(mask, rng.randint(0, nslots - 2, cap), nslots)
    cols = {1: (rng.randint(-50, 50, cap).astype(np.int64), None),
            2: (rng.randn(cap), rng.rand(cap) < 0.2)}
    got = _port_call(pde.dense_agg_states, impl, "dense", cols, mask, cap,
                     torch.from_numpy(slot), nslots, cap)
    # the reference's runs policy takes its broadcast-compare lowering
    # at <= 64 slots and its sorted lowering above; the sorted one is
    # held to its scatter here (see the module docstring)
    ref_impl = "runs" if impl == "runs" and nslots <= 64 else "scatter"
    want = _ref_call(rde.dense_agg_states, ref_impl, "dense", cols, mask,
                     cap, jnp.asarray(slot), nslots, cap)
    assert want["present"][nslots - 1] == 0
    _same(got["present"], want["present"], "present")
    _states_equal(got["states"], want["states"], nslots, f"dense/{impl}",
                  live=np.asarray(want["present"]) > 0)


def test_segment_impl_follows_device():
    """The policy: "runs" on the card, "scatter" on the CPU, or what
    _FORCE_SEGMENT_IMPL names; a name outside the three raises."""
    assert pde._segment_impl(torch.device("cpu")) == "scatter"
    assert pde._segment_impl(torch.device("cuda", 0)) == "runs"
    pde._FORCE_SEGMENT_IMPL = "sorted"
    assert pde._segment_impl(torch.device("cuda", 0)) == "sorted"
    pde._FORCE_SEGMENT_IMPL = "bogus"
    with pytest.raises(ValueError):
        pde._segment_impl(torch.device("cpu"))


def test_compact_policy_learns_and_regrows():
    """_compact_policy: first sight learns a bucket at <= 1/8 survivors
    and never shrinks one another partition learned; an overflow regrows
    it (or pins it off past 1/4) and asks for a rerun."""
    class C:
        _host_cache = {}
    c, k, denom = C(), ("fcompact",), 1 << 20
    bucket = pipeline.shape_bucket
    assert pipeline._compact_policy(c, k, None, 5000, denom) is None
    assert c._host_cache[k] == bucket(5000)
    assert pipeline._compact_policy(c, k, None, 100, denom) is None
    assert c._host_cache[k] == bucket(5000)    # not shrunk by a smaller one
    assert pipeline._compact_policy(c, k, bucket(5000), 5000, denom) is None
    assert pipeline._compact_policy(c, k, bucket(5000), 30000,
                                    denom) == "retry"
    assert c._host_cache[k] == bucket(30000)
    assert pipeline._compact_policy(c, k, bucket(30000), 300000,
                                    denom) == "retry"
    assert c._host_cache[k] == "off"
    assert pipeline._compact_policy(c, k, None, 10, denom) is None
    assert c._host_cache[k] == "off"
    c._host_cache.clear()
    assert pipeline._compact_policy(c, k, None, denom // 4, denom) is None
    assert c._host_cache[k] == "off"


# ---- the sort kind through SQL (fused fact x dim plans) ----------------

COUNTERS = ("fused_pipeline_hit", "fused_pipeline_fallback",
            "fused_pipeline_error", "fused_runs_degrade",
            "fused_bucket_regrow", "fused_compact_regrow")


def _kits(*stmts):
    ref, port = RefKit(), PortKit(device="cpu")
    for kit in (ref, port):
        kit.must_exec("create table d (id int primary key, w int)")
        kit.must_exec("insert into d values " + ",".join(
            f"({i}, {i % 3})" for i in range(1, 9)))
        for sql in stmts:
            kit.must_exec(sql)
    return ref, port


def _run(kits, sql):
    """sql on the port (its counters' change and phase snapshot) and on
    the reference (its default CPU policy); rows must be equal."""
    ref, port = kits
    m = port.domain.metrics
    m0 = {c: m.get(c, 0) for c in COUNTERS}
    port_phase.reset()
    got = port.must_query(sql)._norm()
    snap = port_phase.snap()
    _rows_equal(got, ref.must_query(sql)._norm(), sql)
    return got, {c: m.get(c, 0) - m0[c] for c in COUNTERS}, snap


def _rows_equal(got, want, sql):
    """Rows as strings, equal; a cell that is a float (a DOUBLE average
    here) within rtol 1e-9, since a float sum's order differs between
    lowerings."""
    assert len(got) == len(want), sql
    for rg, rw in zip(got, want):
        for g, w in zip(rg, rw):
            if g != w and "e" not in f"{g}{w}".replace("e-", "") and \
                    "." in f"{g}{w}":
                np.testing.assert_allclose(float(g), float(w), rtol=1e-9,
                                           err_msg=sql)
            else:
                assert g == w, (sql, rg, rw)


def _pins(port, kind):
    return [v for key, v in port.domain.copr._host_cache.items()
            if isinstance(key, tuple) and key and key[0] == kind]


def test_runs_degradation_pins_sorted(monkeypatch):
    """Unclustered keys explode into ~one run per row: the fused
    pipeline pins the query shape to the sorted lowering (counted, on
    the cold statement only) and still answers exactly; the warm
    statement runs one fragment with the pin."""
    monkeypatch.setattr(pde, "_RUNS_DEGRADE_MIN", 8)
    pde._FORCE_SEGMENT_IMPL = "runs"
    rng = np.random.RandomState(5)
    ks = rng.randint(0, 1 << 40, 800)
    kits = _kits("create table t (k bigint, d_id int)",
                 "insert into t values " + ",".join(
                     f"({k},{1 + i % 8})" for i, k in enumerate(ks)))
    sql = "select t.k, count(*) from t, d where t.d_id = d.id group by t.k"
    rows, d, snap = _run(kits, sql + " order by t.k")
    assert len(rows) == len(set(ks.tolist()))
    assert d["fused_pipeline_hit"] == 1 and d["fused_runs_degrade"] == 1
    assert snap["dispatches"] >= 2
    assert _pins(kits[1], "aggimpl") == ["sorted"]
    rows, d, snap = _run(kits, sql + " order by t.k")
    assert d["fused_pipeline_hit"] == 1 and d["fused_runs_degrade"] == 0
    assert d["fused_bucket_regrow"] == 0 and snap["dispatches"] == 1


@pytest.mark.parametrize("impl", IMPLS)
def test_unclustered_group_by_regrows_bucket(impl):
    """More groups than the first bucket of 1024: the cold statement
    regrows it (counted) and reruns, the warm one runs once; exact
    counts, sums, min/max and float averages."""
    pde._FORCE_SEGMENT_IMPL = impl
    rng = np.random.RandomState(3)
    n = 6000
    ks = rng.randint(0, 3000, n)
    vs = rng.randint(-1000, 1000, n)
    kits = _kits("create table t (k int, v int, f double, d_id int)",
                 "insert into t values " + ",".join(
                     f"({k},{v},{v / 7.0},{1 + i % 8})"
                     for i, (k, v) in enumerate(zip(ks, vs))))
    sql = ("select t.k, count(*), sum(t.v), min(t.v), max(t.v), avg(t.f) "
           "from t, d where t.d_id = d.id group by t.k order by t.k")
    rows, d, snap = _run(kits, sql)
    assert len(rows) == len(set(ks.tolist()))
    assert d["fused_pipeline_hit"] == 1 and d["fused_bucket_regrow"] == 1
    assert max(_pins(kits[1], "gb")) >= 2048
    rows, d, snap = _run(kits, sql)
    assert d["fused_pipeline_hit"] == 1 and d["fused_bucket_regrow"] == 0
    assert snap["dispatches"] == 1


@pytest.mark.parametrize("impl", IMPLS)
def test_compaction_learns_then_regrows(impl, monkeypatch):
    """A selective statement learns a compact capacity; a statement of
    the same group shape that keeps more rows overflows it, regrows it
    (counted) and reruns; each answers exactly. Buckets are powers of
    two from 16 here, so a 4000-row table shows what a partition of
    millions of rows does with the real quarter-octave buckets."""
    pde._FORCE_SEGMENT_IMPL = impl
    monkeypatch.setattr(pipeline, "shape_bucket",
                        lambda n: max(16, 1 << (max(n, 1) - 1).bit_length()))
    n = 4000
    kits = _kits("create table t (k int, v int, d_id int)",
                 "insert into t values " + ",".join(
                     f"({i % 97},{i},{1 + i % 8})" for i in range(n)))
    sql = ("select t.k, sum(t.v) from t, d where t.d_id = d.id and "
           "t.v < {} group by t.k order by t.k")
    _rows, d, _ = _run(kits, sql.format(100))
    assert d["fused_pipeline_hit"] == 1 and d["fused_compact_regrow"] == 0
    assert _pins(kits[1], "fcompact") == [128]
    _rows, d, snap = _run(kits, sql.format(100))
    assert d["fused_compact_regrow"] == 0 and snap["dispatches"] == 1
    _rows, d, snap = _run(kits, sql.format(400))
    assert d["fused_compact_regrow"] == 1 and snap["dispatches"] == 2


def test_first_row_skips_empty_partials():
    """A run whose rows all have NULL arguments emits a first_row
    partial that saw no value; the merge takes the first that did."""
    pde._FORCE_SEGMENT_IMPL = "runs"
    kits = _kits("create table t (k int, v int, d_id int)",
                 "insert into t values (1, null, 1), (1, null, 1), "
                 "(2, 7, 2), (2, 8, 2), (1, 42, 3), (1, 43, 3), " +
                 ", ".join(f"(3, {i}, 4)" for i in range(40)))
    rows, d, _ = _run(kits, "select t.k, t.v from t, d where t.d_id = d.id "
                      "group by t.k order by t.k")
    assert rows == [("1", "42"), ("2", "7"), ("3", "0")]
    assert d["fused_pipeline_hit"] == 1


@pytest.fixture(scope="module")
def tpch_kits():
    ref = RefKit()
    ref_tpch.load_tpch(ref, sf=0.01, seed=7)
    port = PortKit(device="cpu")
    port_tpch.load_tpch(port, sf=0.01, seed=7)
    return ref, port


# ROADMAP C.1's query: four dict-coded keys, 8 x 5 x 4 x 3 = 480 slots
MINMAX_480 = ("select l_shipmode, l_shipinstruct, l_returnflag, "
              "l_linestatus, min(l_quantity), max(l_extendedprice), "
              "min(l_discount), count(*) from lineitem, orders "
              "where l_orderkey = o_orderkey group by l_shipmode, "
              "l_shipinstruct, l_returnflag, l_linestatus order by "
              "l_shipmode, l_shipinstruct, l_returnflag, l_linestatus")


@pytest.mark.parametrize("impl", [None, "runs"])
def test_minmax_group_by_480_slots_reads_no_host(tpch_kits, monkeypatch,
                                                 impl):
    """MIN/MAX over a 480-slot dense domain: on the CPU policy the
    scatter (its sentinel once read back with Tensor.item, a blocking
    sync per aggregate on the card), on the card's policy the runs
    lowering; rows equal to the reference's and no Tensor.item inside
    the fragment."""
    pde._FORCE_SEGMENT_IMPL = impl
    items, inside = [], []
    item = torch.Tensor.item

    def spy_item(self):
        if inside:
            items.append(self.shape)
        return item(self)
    run = pipeline.run_fragment

    def spy_run(*a):
        inside.append(1)
        try:
            return run(*a)
        finally:
            inside.pop()
    monkeypatch.setattr(torch.Tensor, "item", spy_item)
    monkeypatch.setattr(pipeline, "run_fragment", spy_run)
    ref, port = tpch_kits
    m0 = port.domain.metrics.get("fused_pipeline_hit", 0)
    got = port.must_query(MINMAX_480)._norm()
    assert got == ref.must_query(MINMAX_480)._norm()
    assert len(got) > 64
    assert port.domain.metrics.get("fused_pipeline_hit", 0) == m0 + 1
    assert items == []

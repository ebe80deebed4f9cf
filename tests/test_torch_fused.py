"""The fused pipeline's dimension probes (tidb_tpu_torch/copr/pipeline.py)
against the reference package, on the CPU: the same tables and SQL
through tidb_tpu's TestKit and tidb_tpu_torch's, rows compared as
strings, and the port's routing counters checked (a twin of
tests/test_fused.py). Then TPC-H Q3, Q4, Q5, Q10, Q12, Q14, Q19 and Q22
at SF0.05 against the reference, each fused fragment counted."""
import numpy as np
import pytest

from tidb_tpu.testkit import TestKit as RefKit
from tidb_tpu.bench import tpch as ref_tpch
from tidb_tpu_torch.testkit import TestKit as PortKit
from tidb_tpu_torch.bench import tpch as port_tpch
from tidb_tpu_torch.ops import scan_kernels
from tidb_tpu_torch.utils import phase as port_phase
import tidb_tpu_torch.planner.physical as pp

COUNTERS = ("fused_pipeline_hit", "fused_pipeline_fallback",
            "fused_pipeline_error")

SETUP = [
    "create table dim_a (id int primary key, grp int, name varchar(16), "
    "val int)",
    "create table dim_b (id int primary key, tag varchar(8))",
    "create table fact (k int primary key, a_id int, b_id int, "
    "amt decimal(10,2), q int)",
    "insert into dim_a values " + ",".join(
        f"({i}, {i % 7}, 'n{i % 5}', {i * 3})" for i in range(1, 41)),
    "insert into dim_b values " + ",".join(
        f"({i}, 't{i % 3}')" for i in range(1, 21)),
]


def _fact_rows():
    rng = np.random.RandomState(3)
    rows = []
    for i in range(1, 501):
        a = rng.randint(1, 45)       # some misses -> inner join drops
        b = rng.randint(1, 21)
        rows.append(f"({i}, {a}, {b}, {rng.randint(1, 9999) / 100.0}, "
                    f"{rng.randint(0, 50)})")
    return "insert into fact values " + ",".join(rows)


@pytest.fixture(autouse=True)
def _torch_registries():
    """The shared conftest resets tidb_tpu's registries only."""
    from tidb_tpu_torch.utils import metrics, device_guard
    metrics.reset_all()
    device_guard.reset()
    port_phase.reset()
    yield


@pytest.fixture()
def kits():
    ref, port = RefKit(), PortKit(device="cpu")
    for kit in (ref, port):
        for sql in SETUP + [_fact_rows()]:
            kit.must_exec(sql)
    return ref, port


def both(kits, sql):
    """Run `sql` on the port, then the reference; the rows must be equal.
    -> (rows, the port's routing counters' change)."""
    ref, port = kits
    m = port.domain.metrics
    m0 = {c: m.get(c, 0) for c in COUNTERS}
    got = port.must_query(sql)._norm()
    d = {c: m.get(c, 0) - m0[c] for c in COUNTERS}
    assert got == ref.must_query(sql)._norm(), sql
    return got, d


def exec_both(kits, *stmts):
    for kit in kits:
        for sql in stmts:
            kit.must_exec(sql)


def port_conventional(port, sql):
    """The port's rows through the conventional (host) join subtree."""
    orig = pp._try_fuse_agg
    pp._try_fuse_agg = lambda *a, **k: None
    port.domain.invalidate_plan_cache()
    try:
        return port.must_query(sql)._norm()
    finally:
        pp._try_fuse_agg = orig
        port.domain.invalidate_plan_cache()


FUSED = {"fused_pipeline_hit": 1, "fused_pipeline_fallback": 0,
         "fused_pipeline_error": 0}
FELL_BACK = {"fused_pipeline_hit": 0, "fused_pipeline_fallback": 1,
             "fused_pipeline_error": 0}

Q = ("select dim_a.grp, sum(fact.amt), count(*), min(fact.q) "
     "from fact, dim_a, dim_b "
     "where fact.a_id = dim_a.id and fact.b_id = dim_b.id "
     "and fact.q < 40 and dim_b.tag <> 't2' "
     "group by dim_a.grp order by dim_a.grp")

Q_POS = ("select fact.a_id, dim_a.name, sum(fact.q) "
         "from fact, dim_a where fact.a_id = dim_a.id "
         "group by fact.a_id, dim_a.name order by fact.a_id")

# (name, sql): shapes that run fused in the port and must equal the
# reference
FUSED_CASES = [
    ("inner_two_dims_filtered", Q),
    ("posdense_probe_key_and_dim_col", Q_POS),
    ("semi_prefiltered_duplicate_keys",
     "select dim_a.name, count(*) from dim_a "
     "where exists (select 1 from fact "
     "where fact.a_id = dim_a.id and fact.q > 25) "
     "group by dim_a.name order by dim_a.name"),
    ("anti_prefiltered",
     "select dim_a.name, count(*), sum(dim_a.val) from dim_a "
     "where not exists (select 1 from fact "
     "where fact.a_id = dim_a.id and fact.q > 40) "
     "group by dim_a.name order by dim_a.name"),
    ("left_fact_preserved",
     "select dim_b.tag, count(*), sum(fact.q) from fact "
     "left join dim_b on fact.b_id = dim_b.id "
     "group by dim_b.tag order by dim_b.tag"),
    ("global_after_probe",
     "select sum(dim_a.val), count(*), sum(fact.amt) from fact, dim_a "
     "where fact.a_id = dim_a.id and dim_a.grp < 4"),
    ("post_filter_over_both_sides",
     "select dim_b.tag, count(*) from fact, dim_a, dim_b "
     "where fact.a_id = dim_a.id and fact.b_id = dim_b.id "
     "and (dim_a.grp = 1 or fact.q > dim_a.val) "
     "group by dim_b.tag order by dim_b.tag"),
]


@pytest.mark.parametrize("name,sql", FUSED_CASES,
                         ids=[c[0] for c in FUSED_CASES])
def test_fused_dim_shapes_equal_reference(kits, name, sql):
    rows, d = both(kits, sql)
    assert d == FUSED, (name, kits[1].domain.last_fused_reason)
    assert rows


def test_left_join_empty_dim(kits):
    """LEFT over an EMPTY dim preserves fact rows with a NULL payload
    (the 1-row always-miss placeholder)."""
    exec_both(kits, "create table dim_e2 (id int primary key, "
              "g varchar(8))")
    rows, d = both(kits, "select dim_e2.g, count(*) from fact left join "
                   "dim_e2 on fact.b_id = dim_e2.id group by dim_e2.g")
    assert d == FUSED
    assert rows == [("<nil>", "500")]


def test_empty_inner_dim_returns_no_rows(kits):
    exec_both(kits, "create table dim_empty (id int primary key, x int)")
    rows, d = both(kits, "select count(*), sum(fact.q) from fact, "
                   "dim_empty where fact.b_id = dim_empty.id")
    assert rows == [("0", "<nil>")]
    assert d == FUSED


def test_nonunique_dim_declines(kits):
    """A join keyed on a NON-unique dim column does not probe: the
    fragment declines and the conventional subtree answers."""
    sql = "select sum(fact.q) from fact, dim_a where fact.a_id = dim_a.grp"
    rows, d = both(kits, sql)
    assert d["fused_pipeline_hit"] == 0 and d["fused_pipeline_error"] == 0
    assert rows == port_conventional(kits[1], sql)


def test_null_probe_rows_drop(kits):
    """NULL FK values match no dim row (inner join) and survive ANTI."""
    a_ids = [None if i % 5 == 0 else i % 45 + 1 for i in range(120)]
    exec_both(kits, "create table f2 (k int primary key, a_id int, v int)",
              "insert into f2 values " + ",".join(
                  f"({i}, {'null' if a is None else a}, {i})"
                  for i, a in enumerate(a_ids)))
    hit = [i for i, a in enumerate(a_ids) if a is not None and a <= 40]
    rows, d = both(kits, "select count(*), sum(f2.v) from f2, dim_a "
                   "where f2.a_id = dim_a.id")
    assert rows == [(str(len(hit)), str(sum(hit)))] and d == FUSED
    rows, d = both(kits, "select count(*), sum(f2.v) from f2 where not "
                   "exists (select 1 from dim_a where dim_a.id = f2.a_id)")
    miss = [i for i in range(120) if i not in hit]
    assert rows == [(str(len(miss)), str(sum(miss)))] and d == FUSED


def test_materialized_dim_declines_by_name(kits):
    """A dim over an aggregated subquery (dim_a LEFT JOIN fact groups
    fact by a_id first) is not ported: the statement declines with its
    reason and the conventional subtree answers."""
    sql = ("select dim_a.name, count(fact.k), count(*) from dim_a "
           "left join fact on fact.a_id = dim_a.id "
           "group by dim_a.name order by dim_a.name")
    rows, d = both(kits, sql)
    assert d == FELL_BACK
    assert kits[1].domain.last_fused_reason == \
        "not yet ported: materialized (subplan) dimensions"


def test_dim_updates_stay_fused(kits):
    """Committed dim mutations are seen (version-keyed caches) and stay
    on the fused path: MVCC keeps the old version row, which must not
    read as a duplicate key."""
    sql = "select sum(dim_a.val) from fact, dim_a where fact.a_id = dim_a.id"
    before, _ = both(kits, sql)
    exec_both(kits, "update dim_a set val = val + 1000 where id = 1")
    got, d = both(kits, sql)
    assert d == FUSED
    assert int(got[0][0]) > int(before[0][0])


def test_dim_insert_joins_new_rows(kits):
    """New dim rows join at once, through the direct probe and the
    posdense layout (whose slot domain grows with the dim): fragments
    with dims are built for each call, so none is stale."""
    sql = "select count(*) from fact, dim_a where fact.a_id = dim_a.id"
    rows, _ = both(kits, sql)
    n1 = int(rows[0][0])
    both(kits, Q_POS)
    exec_both(kits, "insert into dim_a values (41, 1, 'x', 1), "
              "(42, 2, 'y', 2), (43, 3, 'z', 3), (44, 4, 'w', 4)")
    rows, d = both(kits, sql)
    assert d == FUSED
    assert int(rows[0][0]) > n1
    rows, d = both(kits, Q_POS)
    assert d == FUSED
    assert any(r[0] == "41" for r in rows)


def test_unported_layout_declines_before_fact_snapshot(kits, monkeypatch):
    """A group domain that is neither dict-coded nor a dim position (an
    int fact column), which the port once declined before the fact
    snapshot, now fuses through the sort kind: "scatter" under the CPU's
    policy, "runs" under the card's, each with the reference's rows and
    one fused fragment."""
    from tidb_tpu_torch.copr import pipeline
    import tidb_tpu_torch.copr.dag_exec as pde
    impls = []
    body = pipeline.sort_agg_body

    def spy(*a, **k):
        impls.append(k.get("impl"))
        return body(*a, **k)
    monkeypatch.setattr(pipeline, "sort_agg_body", spy)
    sql = ("select fact.q, sum(dim_a.val) from fact, dim_a "
           "where fact.a_id = dim_a.id group by fact.q order by fact.q")
    for policy, impl in ((None, "scatter"), ("runs", "runs")):
        monkeypatch.setattr(pde, "_FORCE_SEGMENT_IMPL", policy)
        impls.clear()
        rows, d = both(kits, sql)
        assert d == FUSED and len(rows) > 1
        assert impls == [impl]
        assert kits[1].domain.last_fused_reason is None


def test_dirty_dim_write_falls_back(kits):
    """A dim table the transaction wrote sends the statement to the host
    subtree (_dirty_state); the committed fact overlay stays fused."""
    for kit in kits:
        kit.must_exec("begin")
        kit.must_exec("update dim_a set val = val + 1 where id = 1")
    try:
        rows, d = both(kits, Q_POS)
        assert d == FELL_BACK
        assert "joined table" in kits[1].domain.last_fused_reason
    finally:
        exec_both(kits, "rollback")
    for kit in kits:
        kit.must_exec("begin")
        kit.must_exec("insert into fact values (1001, 1, 1, 5.00, 1)")
    try:
        _rows, d = both(kits, Q_POS)
        assert d == FUSED
    finally:
        exec_both(kits, "rollback")


def _spy_probe(monkeypatch):
    """Record the probe form (lut or sorted keys) of every dim probe."""
    from tidb_tpu_torch.copr import pipeline
    seen = []
    orig = pipeline._probe

    def spy(da, *a):
        seen.append("direct" if "lut" in da else "sorted")
        return orig(da, *a)
    monkeypatch.setattr(pipeline, "_probe", spy)
    return seen


def test_sparse_key_dim_takes_sorted_probe(kits, monkeypatch):
    exec_both(kits,
              "create table dim_s (id bigint primary key, w int)",
              "insert into dim_s values " + ",".join(
                  f"({i * 1000003}, {i % 4})" for i in range(1, 31)),
              "create table f3 (k int primary key, s_id bigint, v int)",
              "insert into f3 values " + ",".join(
                  f"({i}, {(i % 37) * 1000003}, {i})" for i in range(200)))
    seen = _spy_probe(monkeypatch)
    rows, d = both(kits, "select dim_s.w, count(*), sum(f3.v) from f3, "
                   "dim_s where f3.s_id = dim_s.id group by dim_s.w "
                   "order by dim_s.w")
    assert d == FUSED and seen == ["sorted"]
    assert len(rows) == 4


def test_composite_key_dim(kits, monkeypatch):
    """Two equalities against one dim pack into one int64 key by stride
    (the build side's layout); a component outside its span misses."""
    exec_both(kits,
              "create table dim_c (a int, b int, v int, primary key (a, b))",
              "insert into dim_c values " + ",".join(
                  f"({a}, {b}, {a * 10 + b})"
                  for a in range(1, 6) for b in range(3, 8)),
              "create table f4 (k int primary key, pa int, pb int, q int)",
              "insert into f4 values " + ",".join(
                  f"({i}, {i % 8}, {i % 11}, {i})" for i in range(300)))
    from tidb_tpu_torch.copr import pipeline
    packs = []
    orig = pipeline._probe_values

    def spy(ctx, dim, da, cap):
        packs.append(da["pack"])
        return orig(ctx, dim, da, cap)
    monkeypatch.setattr(pipeline, "_probe_values", spy)
    for sql in ("select count(*), sum(f4.q), sum(dim_c.v) from f4, dim_c "
                "where f4.pa = dim_c.a and f4.pb = dim_c.b",
                "select dim_c.v, count(*) from f4, dim_c where "
                "f4.pa = dim_c.a and f4.pb = dim_c.b group by dim_c.v "
                "order by dim_c.v"):
        rows, d = both(kits, sql)
        assert d == FUSED, kits[1].domain.last_fused_reason
        assert rows == port_conventional(kits[1], sql)
    assert packs and all(p == ((1, 3), (5, 5), (5, 1)) for p in packs)


BIG = (1 << 63) - 1


@pytest.mark.parametrize("dim_ids", ["dense", "sparse"])
def test_out_of_range_probe_keys(kits, dim_ids, monkeypatch):
    """Probe keys below the build side's lowest key, above its highest,
    at the int64 ends and NULL miss (inner), keep the row with a NULL
    payload (left) and survive (anti); no gather leaves its table."""
    ids = [i if dim_ids == "dense" else i * 7919 for i in range(1, 21)]
    probes = [ids[0] - 1, 0, -5, ids[-1] + 1, ids[-1] + 4096, BIG,
              -BIG - 1, None, ids[3], ids[-1], ids[0]] * 8
    exec_both(kits,
              "create table dim_r (id bigint primary key, w int, "
              "tag varchar(8))",
              "insert into dim_r values " + ",".join(
                  f"({i}, {n}, 't{n:02d}')" for n, i in enumerate(ids)),
              "create table f5 (k int primary key, r_id bigint, v int)",
              "insert into f5 values " + ",".join(
                  f"({n}, {'null' if p is None else p}, {n + 1})"
                  for n, p in enumerate(probes)))
    w_of = {i: n for n, i in enumerate(ids)}
    hit = [(n + 1, w_of[p]) for n, p in enumerate(probes) if p in w_of]
    miss = [n + 1 for n, p in enumerate(probes) if p not in w_of]
    by_w = {}
    for v, w in hit:
        c, t = by_w.get(w, (0, 0))
        by_w[w] = (c + 1, t + v)
    seen = _spy_probe(monkeypatch)
    for sql, want in (
            ("select count(*), sum(f5.v), sum(dim_r.w) from f5, dim_r "
             "where f5.r_id = dim_r.id",
             [(str(len(hit)), str(sum(v for v, _ in hit)),
               str(sum(w for _, w in hit)))]),
            ("select dim_r.tag, count(*), sum(f5.v) from f5 left join "
             "dim_r on f5.r_id = dim_r.id group by dim_r.tag "
             "order by dim_r.tag",
             [("<nil>", str(len(miss)), str(sum(miss)))] +
             [(f"t{w:02d}", str(c), str(t)) for w, (c, t) in sorted(
                 by_w.items())]),
            ("select count(*), sum(f5.v) from f5 where not exists (select "
             "1 from dim_r where dim_r.id = f5.r_id)",
             [(str(len(miss)), str(sum(miss)))])):
        rows, d = both(kits, sql)
        assert rows == want, sql
        assert d == FUSED, kits[1].domain.last_fused_reason
        assert rows == port_conventional(kits[1], sql)
    assert set(seen) == {"direct" if dim_ids == "dense" else "sorted"}


def test_probe_clamps_every_gather():
    """_probe on hand-built tables: keys below lo, past the lut, at the
    int64 ends and in the sorted keys' padding give in-range positions
    and no hit."""
    import torch
    from tidb_tpu_torch.copr.pipeline import _probe
    pv = torch.tensor([-(1 << 63), -1, 0, 3, 9, 10, 11, BIG],
                      dtype=torch.int64)
    miss = torch.zeros(8, dtype=torch.bool)
    # direct: keys 3..10 at rows 0..7, row 8 (n) is the miss sentinel
    lut = torch.tensor([0, 1, 2, 3, 4, 5, 6, 7, 8, 8], dtype=torch.int64)
    da = {"lut": lut, "lsize": 8, "lo": 3}
    pos, hit = _probe(da, pv, miss, 8, 8, 8)
    assert hit.tolist() == [False, False, False, True, True, True, False,
                            False]
    assert int(pos.min()) >= 0 and int(pos.max()) <= 7
    # sorted: keys 3, 9, 10 padded with INT64_MAX to capacity 4
    da = {"sk": torch.tensor([3, 9, 10, BIG]),
          "ord": torch.tensor([2, 0, 1, 0])}
    pos, hit = _probe(da, pv, miss, 4, 3, 3)
    assert hit.tolist() == [False, False, False, True, True, True, False,
                            False]
    assert pos[3:6].tolist() == [2, 0, 1]


def test_planner_heavy_dim_gate_follows_device(monkeypatch):
    """The heavy-dimension gate (aggregate-subquery dims whose build mass
    is above both bounds) plans the host join on the CPU device and keeps
    the pipeline fused when the domain's device is cuda; above the
    card's absolute ceiling the host plan again."""
    from tidb_tpu_torch.parser.parser import parse
    from tidb_tpu_torch.planner.optimize import optimize
    from tidb_tpu_torch.planner.physical import PhysFusedPipeline
    port = PortKit(device="cpu")
    port_tpch.load_tpch(port, sf=0.01, seed=7)
    # a gate that every aggregate-subquery dim trips at this size
    monkeypatch.setattr(pp, "_FUSE_MAX_DIM_MASS_ABS", 0)
    monkeypatch.setattr(pp, "_FUSE_MAX_DIM_MASS_RATIO", 0.0)

    def fused_dims(device_type):
        pctx = port.sess._plan_ctx()
        pctx.device_type = device_type
        plan = optimize(parse(port_tpch.Q21)[0], pctx)
        found, stack = [], [plan]
        while stack:
            p = stack.pop()
            if isinstance(p, PhysFusedPipeline):
                found.append(len(p.dims))
            stack.extend(p.children)
        return sorted(found)
    assert port.sess._plan_ctx().device_type == "cpu"
    cpu = fused_dims("cpu")
    assert fused_dims("cuda") == [5]       # Q21's whole join fused
    assert max(cpu, default=0) == 0, cpu   # host joins, zero-dim scans
    monkeypatch.setattr(pp, "_FUSE_DEV_DIM_MASS_ABS", 0)
    assert fused_dims("cuda") == cpu


# ---- TPC-H at SF0.05 --------------------------------------------------

SF, SEED = 0.05, 7
TPCH = ("q3", "q4", "q5", "q10", "q12", "q14", "q19", "q22")
# scan kernel each query's fused fragment must reach on the CPU (their
# plain versions run there)
TPCH_KERNEL = {"q4": "dense_group_sums", "q5": "dense_group_sums",
               "q12": "dense_group_sums", "q22": "dense_group_sums",
               "q14": "masked_sums", "q19": "masked_sums"}


@pytest.fixture(scope="module")
def tpch_kits():
    ref = RefKit()
    ref_tpch.load_tpch(ref, sf=SF, seed=SEED)
    port = PortKit(device="cpu")
    port_tpch.load_tpch(port, sf=SF, seed=SEED)
    return ref, port


@pytest.fixture
def kernel_calls(monkeypatch):
    calls = {"masked_sums": 0, "dense_group_sums": 0,
             "range_filter_sums": 0}
    for name in calls:
        fn = getattr(scan_kernels, name)

        def spy(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(scan_kernels, name, spy)
    return calls


@pytest.mark.parametrize("q", TPCH)
def test_tpch_join_queries_equal_reference(tpch_kits, kernel_calls, q):
    ref, port = tpch_kits
    sql = port_tpch.ALL_QUERIES[q]
    rm, pm = ref.domain.metrics, port.domain.metrics

    def ref_fused():
        # the reference counts a fragment it ran on its device mesh apart
        return rm.get("fused_pipeline_hit", 0) + \
            rm.get("fused_pipeline_mpp_hit", 0)
    r0 = ref_fused()
    p0 = {c: pm.get(c, 0) for c in COUNTERS}
    port_phase.reset()
    got = port.must_query(sql)._norm()
    snap = port_phase.snap()
    want = ref.must_query(ref_tpch.ALL_QUERIES[q])._norm()
    assert got == want
    d = {c: pm.get(c, 0) - p0[c] for c in COUNTERS}
    # every fragment the reference fuses, the port fuses
    assert d["fused_pipeline_hit"] == ref_fused() - r0
    assert d["fused_pipeline_hit"] >= 1
    assert d["fused_pipeline_fallback"] == d["fused_pipeline_error"] == 0
    assert snap.get("fused_fallbacks", 0) == 0
    if q in TPCH_KERNEL:
        assert kernel_calls[TPCH_KERNEL[q]] >= 1
    oracle = {"q3": port_tpch.q3_oracle, "q5": port_tpch.q5_oracle}.get(q)
    if oracle is not None:
        assert oracle(port) == got


def test_posdense_over_limit_declines_by_name(tpch_kits, monkeypatch):
    """Q3 at SF10 has more orders than _POS_DENSE_MAX slots, so its group
    domain is neither dense nor a dimension position: once declined to
    the host join, it now fuses through the sort kind, with the
    reference's rows and the numpy oracle's. Simulated by lowering the
    limit."""
    from tidb_tpu_torch.copr import pipeline
    ref, port = tpch_kits
    monkeypatch.setattr(pipeline, "_POS_DENSE_MAX", 1000)
    calls = []
    body = pipeline.sort_agg_body
    monkeypatch.setattr(pipeline, "sort_agg_body",
                        lambda *a, **k: calls.append(1) or body(*a, **k))
    pm = port.domain.metrics
    p0 = {c: pm.get(c, 0) for c in COUNTERS}
    got = port.must_query(port_tpch.Q3)._norm()
    d = {c: pm.get(c, 0) - p0[c] for c in COUNTERS}
    assert d == FUSED and calls
    assert got == ref.must_query(ref_tpch.Q3)._norm()
    assert got == port_tpch.q3_oracle(port)

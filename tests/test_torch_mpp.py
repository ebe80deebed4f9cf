"""The MPP mesh of tidb_tpu_torch on CPU tensors: twins of the ten tests
of tests/test_mpp.py over TestKit(device="cpu", mesh=8) (eight shards on
the CPU, the counterpart of the reference's eight virtual devices),
mpp_global_sum / mpp_filter_agg / mpp_shuffle_join_agg against the
reference's functions on its 8-device mesh from the same numpy inputs
(integers exactly), TPC-H Q1/Q3/Q5/Q6/Q12 at SF0.01 through both
packages' TestKits with MPP on, and EXPLAIN against the reference's
text with MPP on and off, on one device and on a mesh."""
import numpy as np
import pytest

import jax

from tidb_tpu.testkit import TestKit as RefKit
from tidb_tpu.bench import tpch as ref_tpch
from tidb_tpu_torch.testkit import TestKit
from tidb_tpu_torch.bench import tpch
from tidb_tpu_torch.bench.tpch import load_tpch, Q1, Q6
from tidb_tpu_torch.mpp import exec as mexec
from tidb_tpu_torch.parallel import Mesh, shard_rows
from tidb_tpu_torch.utils import metrics as mu
from tidb_tpu_torch.utils import phase

NDEV = 8


@pytest.fixture(autouse=True)
def _torch_registries():
    """The shared conftest resets tidb_tpu's registries only."""
    from tidb_tpu_torch.utils import device_guard
    mu.reset_all()
    device_guard.reset()
    phase.reset()
    yield


@pytest.fixture(scope="module")
def tk():
    tk = TestKit(device="cpu", mesh=NDEV)
    load_tpch(tk, sf=0.004, seed=23)
    return tk


def _mesh():
    return Mesh(["cpu"] * NDEV)


def _ref_mesh():
    from jax.sharding import Mesh as JMesh
    assert len(jax.devices()) == NDEV
    return JMesh(np.array(jax.devices()), ("dp",))


# ---- twins of tests/test_mpp.py ----------------------------------------

def test_mpp_matches_single_chip(tk):
    tk.must_exec("set @@tidb_mpp_min_rows = 0")
    tk.must_exec("set @@tidb_enable_mpp = off")
    r_single_q1 = tk.must_query(Q1).rows
    r_single_q6 = tk.must_query(Q6).rows
    tk.must_exec("set @@tidb_enable_mpp = on")
    tk.domain.plan_cache.clear()
    hits = tk.domain.metrics.get("fused_pipeline_mpp_hit", 0)
    r_mpp_q1 = tk.must_query(Q1).rows
    r_mpp_q6 = tk.must_query(Q6).rows
    assert tk.domain.metrics.get("fused_pipeline_mpp_hit", 0) == hits + 2
    assert r_mpp_q1 == r_single_q1
    assert r_mpp_q6 == r_single_q6


def test_mpp_grouped_with_filters(tk):
    tk.must_exec("set @@tidb_mpp_min_rows = 0")
    q = ("select l_shipmode, count(*), sum(l_quantity), min(l_discount), "
         "max(l_tax) from lineitem where l_quantity > 10 "
         "group by l_shipmode order by l_shipmode")
    tk.must_exec("set @@tidb_enable_mpp = off")
    want = tk.must_query(q).rows
    tk.must_exec("set @@tidb_enable_mpp = on")
    tk.domain.plan_cache.clear()
    m0 = tk.domain.metrics.get("fused_pipeline_mpp_hit", 0) + \
        tk.domain.metrics.get("copr_mpp_exec", 0)
    got = tk.must_query(q).rows
    assert tk.domain.metrics.get("fused_pipeline_mpp_hit", 0) + \
        tk.domain.metrics.get("copr_mpp_exec", 0) == m0 + 1
    assert got == want
    assert len(got) > 0


def test_fragment_plan_explain(tk):
    """EXPLAIN shows Fragment/Exchange nodes when MPP is on
    (reference fragment.go:49,78 — PassThrough + Broadcast types)."""
    tk.must_exec("create table fx_d (id int primary key, g varchar(8))")
    tk.must_exec("insert into fx_d values (1,'a'),(2,'b'),(3,'c')")
    tk.must_exec("create table fx_f (k int primary key, d int, v int)")
    tk.must_exec("insert into fx_f values (1,1,10),(2,2,20),(3,3,30),"
                 "(4,1,40)")
    rows = tk.must_query(
        "explain select fx_d.g, sum(fx_f.v) from fx_f, fx_d "
        "where fx_f.d = fx_d.id group by fx_d.g").rs.rows
    txt = "\n".join(r[0] + "\t" + r[2] for r in rows)
    assert "ExchangeSender" in txt and "ExchangeReceiver" in txt
    assert "PassThrough" in txt and "Broadcast" in txt
    assert "FusedPipeline" in txt


def test_fused_mpp_matches_single_chip(tk):
    """Join+group-by through the fused pipeline on the 8-shard mesh
    equals the single-device result."""
    tk.must_exec("create table md (id int primary key, g varchar(8), "
                 "w int)")
    rows = ",".join(f"({i}, 'g{i % 5}', {i % 11})" for i in range(1, 301))
    tk.must_exec(f"insert into md values {rows}")
    tk.must_exec("create table mf (k int primary key, d int, v int)")
    rng = np.random.RandomState(9)
    rows = ",".join(f"({i}, {rng.randint(1, 340)}, {rng.randint(0, 50)})"
                    for i in range(1, 2001))
    tk.must_exec(f"insert into mf values {rows}")
    sql = ("select md.g, sum(mf.v), count(*), max(mf.v) from mf, md "
           "where mf.d = md.id and mf.v > 3 group by md.g order by md.g")
    tk.must_exec("set tidb_mpp_min_rows = 0")
    hits = tk.domain.metrics.get("fused_pipeline_mpp_hit", 0)
    mesh_rows = tk.must_query(sql).rs.rows
    assert tk.domain.metrics.get("fused_pipeline_mpp_hit", 0) == hits + 1
    tk.must_exec("set tidb_enable_mpp = 0")
    single = tk.must_query(sql).rs.rows
    tk.must_exec("set tidb_enable_mpp = 1")
    assert mesh_rows == single


def test_shuffle_join_from_sql(tk):
    """A large build side routes over the HASH exchange (all_to_all
    shuffle) instead of Broadcast, reachable from plain SQL."""
    tk.must_exec("create table sd (id int primary key, g varchar(8))")
    rows = ",".join(f"({i}, 'x{i % 4}')" for i in range(1, 1201))
    tk.must_exec(f"insert into sd values {rows}")
    tk.must_exec("create table sf (k int primary key, d int, v int)")
    rng = np.random.RandomState(13)
    rows = ",".join(f"({i}, {rng.randint(1, 1500)}, {rng.randint(0, 30)})"
                    for i in range(1, 2501))
    tk.must_exec(f"insert into sf values {rows}")
    sql = ("select sd.g, sum(sf.v), count(*) from sf, sd "
           "where sf.d = sd.id group by sd.g order by sd.g")
    tk.must_exec("set tidb_mpp_min_rows = 0")
    base = tk.must_query(sql).rs.rows              # broadcast
    tk.must_exec("set tidb_broadcast_join_threshold_count = 100")
    tk.domain.invalidate_plan_cache()
    n0 = tk.domain.metrics.get("fused_shuffle_join", 0)
    got = tk.must_query(sql).rs.rows               # hash/shuffle
    assert tk.domain.metrics.get("fused_shuffle_join", 0) == n0 + 1
    assert got == base
    tk.must_exec("set tidb_broadcast_join_threshold_count = 1024000")


def test_exchange_kernel_cache_no_retrace():
    """A repeated exchange fragment reuses its program: the second call
    is a pure dispatch (no kernel_builds)."""
    mesh = _mesh()
    n, g = 128 * NDEV, 9
    rng = np.random.RandomState(5)
    keys = rng.randint(0, g, n).astype(np.int64)
    vals = rng.randint(0, 100, n).astype(np.int64)
    ok = np.ones(n, dtype=bool)
    a = (shard_rows(mesh, keys), shard_rows(mesh, vals),
         shard_rows(mesh, ok))
    phase.reset()
    s1, _c1 = mexec.mpp_filter_agg(mesh, *a, g)
    snap1 = phase.snap()
    phase.reset()
    s2, _c2 = mexec.mpp_filter_agg(mesh, *a, g)
    snap2 = phase.snap()
    assert snap1.get("kernel_builds", 0) == 1      # cold: built once
    assert snap2.get("kernel_builds", 0) == 0      # warm: pure dispatch
    assert snap2.get("dispatches", 0) == 1
    assert s1.tolist() == s2.tolist()


def _skewed(seed, hot_mul, okp=1.0):
    n, nd, n_groups = 128 * NDEV * 4, 128 * NDEV, 7
    rng = np.random.RandomState(seed)
    hot = hot_mul * NDEV + 1               # all hot rows to one peer
    pk = np.where(rng.rand(n) < 0.9, hot,
                  rng.randint(0, nd, size=n)).astype(np.int64)
    pv = rng.randint(0, 100, size=n).astype(np.int64)
    pok = rng.rand(n) < okp
    bk = np.arange(nd, dtype=np.int64)
    bp = rng.randint(0, n_groups, size=nd).astype(np.int64)
    bok = np.ones(nd, dtype=bool)
    return pk, pv, pok, bk, bp, bok, n_groups


def _host_join_agg(pk, pv, pok, bk, bp, bok, n_groups):
    want_s = np.zeros(n_groups, dtype=np.int64)
    want_c = np.zeros(n_groups, dtype=np.int64)
    payload_of = {int(k): int(g) for k, g, ok in zip(bk, bp, bok) if ok}
    for k, v, ok in zip(pk, pv, pok):
        if ok and int(k) in payload_of:
            g = min(max(payload_of[int(k)], 0), n_groups - 1)
            want_s[g] += int(v)
            want_c[g] += 1
    return want_s, want_c


def test_shuffle_capacity_cache_and_overflow_retrace():
    """The first call guesses a balanced capacity, the program returns
    the exact bound, an overflowing guess runs ONCE more, and the
    learned capacity lands in the per-cap_key cache so the repeat is a
    single dispatch with no host histogram."""
    mesh = _mesh()
    pk, pv, pok, bk, bp, bok, n_groups = _skewed(31, 2)
    cap_key = ("test-shufcap", 1, NDEV)
    mexec._CAP_CACHE.pop(cap_key, None)

    def run():
        return mexec.mpp_shuffle_join_agg(
            mesh, pk, pv, pok, bk, bp, bok, n_groups=n_groups,
            cap_key=cap_key)

    calls = []
    orig = mexec._shuffle_capacity

    def counting(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    mexec._shuffle_capacity = counting
    try:
        phase.reset()
        sums1, cnts1 = run()
        snap1 = phase.snap()
        # 90% skew overflows the balanced first guess: exactly one
        # rerun at the returned exact bound
        assert snap1.get("dispatches", 0) == 2
        assert snap1.get("kernel_builds", 0) == 2
        learned = mexec._CAP_CACHE.get(cap_key)
        assert learned is not None
        assert learned >= orig(pk, pok, NDEV)   # covers the hot bucket
        phase.reset()
        sums2, cnts2 = run()
        snap2 = phase.snap()
        assert snap2.get("dispatches", 0) == 1  # warm: cap cache hit
        assert snap2.get("kernel_builds", 0) == 0
    finally:
        mexec._shuffle_capacity = orig
    assert calls == []                          # no host histogram ever
    want_s, want_c = _host_join_agg(pk, pv, pok, bk, bp, bok, n_groups)
    assert cnts1.tolist() == want_c.tolist()
    assert sums1.tolist() == want_s.tolist()
    assert sums2.tolist() == want_s.tolist()


def test_shuffle_host_sizing_path_is_cap_cached(monkeypatch):
    """TIDB_TPU_MPP_HOST_CAP=1 (the host-sizing path) still lands its
    result in the capacity cache: the second call never recomputes the
    host histogram."""
    mesh = _mesh()
    n, nd, n_groups = 128 * NDEV, 64, 5
    rng = np.random.RandomState(7)
    pk = rng.randint(0, nd, size=n).astype(np.int64)
    pv = rng.randint(0, 10, size=n).astype(np.int64)
    pok = np.ones(n, dtype=bool)
    bk = np.arange(nd, dtype=np.int64)
    bp = rng.randint(0, n_groups, size=nd).astype(np.int64)
    bok = np.ones(nd, dtype=bool)
    cap_key = ("test-hostcap", 1, NDEV)
    mexec._CAP_CACHE.pop(cap_key, None)
    monkeypatch.setenv("TIDB_TPU_MPP_HOST_CAP", "1")
    calls = []
    orig = mexec._shuffle_capacity

    def counting(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(mexec, "_shuffle_capacity", counting)
    mexec.mpp_shuffle_join_agg(mesh, pk, pv, pok, bk, bp, bok,
                               n_groups=n_groups, cap_key=cap_key)
    assert len(calls) == 2                 # probe + build side, once
    mexec.mpp_shuffle_join_agg(mesh, pk, pv, pok, bk, bp, bok,
                               n_groups=n_groups, cap_key=cap_key)
    assert len(calls) == 2                 # second call: cache hit


def test_mpp_exchange_metrics_counted(tk):
    """A mesh statement lands passthrough exchange counts and bytes in
    the registry and the phase counters."""
    tk.must_exec("set @@tidb_mpp_min_rows = 0")
    tk.must_exec("set @@tidb_enable_mpp = on")
    before = mu.MPP_EXCHANGE.labels("passthrough").value
    bbytes = mu.MPP_EXCHANGE_BYTES.labels("passthrough").value
    phase.reset()
    tk.must_query(Q1)
    snap = phase.snap()
    assert mu.MPP_EXCHANGE.labels("passthrough").value > before
    assert mu.MPP_EXCHANGE_BYTES.labels("passthrough").value > bbytes
    assert snap.get("mpp_exchanges", 0) >= 1
    assert snap.get("mpp_exchange_bytes", 0) > 0


def test_shuffle_join_hot_key_skew():
    """One join key owning 90% of the probe rows loses no row in the
    hash exchange: the hot destination's frame grows instead of
    overflowing. Held to a host-side exact join+agg."""
    mesh = _mesh()
    pk, pv, pok, bk, bp, bok, n_groups = _skewed(77, 3, okp=0.95)
    assert mexec._shuffle_capacity(pk, pok, NDEV) > \
        2 * (len(pk) // NDEV) // NDEV
    sums, cnts = mexec.mpp_shuffle_join_agg(mesh, pk, pv, pok, bk, bp,
                                            bok, n_groups=n_groups)
    want_s, want_c = _host_join_agg(pk, pv, pok, bk, bp, bok, n_groups)
    assert cnts.tolist() == want_c.tolist()
    assert sums.tolist() == want_s.tolist()


# ---- parity with the reference's exchange fragments --------------------

def _exprs(pkg):
    """(filters, sum_exprs) over columns 0 (a, nullable), 1 (b) and 2
    (f, float), built in one package's expression module."""
    if pkg == "ref":
        from tidb_tpu.expression.expr import Column, ScalarFunc, \
            const_from_py
        from tidb_tpu.types.field_type import new_bigint_type, \
            new_double_type
    else:
        from tidb_tpu_torch.expression.expr import Column, ScalarFunc, \
            const_from_py
        from tidb_tpu_torch.types.field_type import new_bigint_type, \
            new_double_type
    bi, db = new_bigint_type(), new_double_type()
    a, b, f = Column(0, bi), Column(1, bi), Column(2, db)
    filters = [ScalarFunc(">", [b, const_from_py(10)], bi)]
    sums = [a, ScalarFunc("*", [a, b], bi), f]
    return filters, sums


@pytest.mark.parametrize("seed", [3, 4])
def test_global_sum_matches_reference(seed):
    from tidb_tpu.mpp import exec as rexec
    rng = np.random.RandomState(seed)
    n = 128 * NDEV
    a = rng.randint(-1000, 1000, n).astype(np.int64)
    an = rng.rand(n) < 0.1
    b = rng.randint(0, 40, n).astype(np.int64)
    f = rng.rand(n) * 100
    valid = rng.rand(n) < 0.9
    got = []
    for pkg, fn, mesh in (("ref", rexec.mpp_global_sum, _ref_mesh()),
                          ("port", mexec.mpp_global_sum, _mesh())):
        filters, sums = _exprs(pkg)
        cols = {0: (a, an, valid), 1: (b, None, valid),
                2: (f, None, valid)}
        res = fn(mesh, cols, {}, filters, sums)
        got.append([np.asarray(r) for r in res])
    ref, port = got
    for i in (0, 1, 3):                       # int sums and the count
        assert int(port[i]) == int(ref[i]), i
    np.testing.assert_allclose(port[2], ref[2], rtol=1e-9)
    ok = valid & (b > 10)
    assert int(port[3]) == int(ok.sum())
    assert int(port[0]) == int(a[ok & ~an].sum())


@pytest.mark.parametrize("case", ["in_domain", "clipped", "float"])
def test_filter_agg_matches_reference(case):
    from tidb_tpu.mpp import exec as rexec
    rng = np.random.RandomState(11)
    n, g = 128 * NDEV * 2, 13
    keys = rng.randint(0, g, n).astype(np.int64)
    if case == "clipped":                 # out of the domain: clipped
        keys = rng.randint(-5, g + 5, n).astype(np.int64)
    vals = rng.randint(-50, 100, n).astype(np.int64)
    if case == "float":
        vals = rng.rand(n) * 1e3
    ok = rng.rand(n) < 0.8
    rs, rc = rexec.mpp_filter_agg(_ref_mesh(), keys, vals, ok, g)
    ps, pc = mexec.mpp_filter_agg(_mesh(), keys, vals, ok, g)
    assert pc.numpy().tolist() == np.asarray(rc).tolist()
    if case == "float":
        np.testing.assert_allclose(ps.numpy(), np.asarray(rs), rtol=1e-9)
    else:
        assert ps.numpy().tolist() == np.asarray(rs).tolist()


def _shuffle_inputs(case):
    rng = np.random.RandomState(hash(case) % 1000)
    n, nd, n_groups = 128 * NDEV * 2, 128 * NDEV, 11
    pk = rng.randint(0, nd + 200, n).astype(np.int64)   # some miss
    pok = np.ones(n, dtype=bool)
    bk = rng.permutation(nd * 2)[:nd].astype(np.int64)
    bok = np.ones(nd, dtype=bool)
    if case == "hot_key":
        pk = np.where(rng.rand(n) < 0.9, 5 * NDEV + 3, pk)
    if case == "null_keys":               # NULL keys arrive masked off
        pok = rng.rand(n) < 0.7
        bok = rng.rand(nd) < 0.8
    pv = [rng.randint(-20, 500, n).astype(np.int64),
          np.ones(n, dtype=np.int64)]
    bp = rng.randint(0, n_groups, nd).astype(np.int64)
    return pk, pv, pok, bk, bp, bok, n_groups


@pytest.mark.parametrize("case", ["uniform", "hot_key", "null_keys",
                                  "overflow_rerun"])
def test_shuffle_join_agg_matches_reference(case):
    """Both packages' shuffle joins on the same inputs: equal integer
    sums and counts, equal to a host join, and (overflow_rerun) both
    learn a capacity from one overflowed first guess."""
    from tidb_tpu.mpp import exec as rexec
    from tidb_tpu.utils import phase as ref_phase
    pk, pv, pok, bk, bp, bok, n_groups = _shuffle_inputs(case)
    kw = {}
    if case == "overflow_rerun":
        pk = np.where(np.arange(len(pk)) % 10 != 0, 7 * NDEV + 2, pk)
    key = ("parity", case)
    rexec._CAP_CACHE.pop(key, None)
    mexec._CAP_CACHE.pop(key, None)
    ref_phase.reset()
    phase.reset()
    rs, rc = rexec.mpp_shuffle_join_agg(_ref_mesh(), pk, pv, pok, bk, bp,
                                        bok, n_groups=n_groups,
                                        cap_key=key, **kw)
    ps, pc = mexec.mpp_shuffle_join_agg(_mesh(), pk, pv, pok, bk, bp,
                                        bok, n_groups=n_groups,
                                        cap_key=key, **kw)
    assert pc.tolist() == np.asarray(rc).tolist()
    for p, r in zip(ps, rs):
        assert p.tolist() == np.asarray(r).tolist()
    want_s, want_c = _host_join_agg(pk, pv[0], pok, bk, bp, bok, n_groups)
    assert pc.tolist() == want_c.tolist()
    assert ps[0].tolist() == want_s.tolist()
    if case == "overflow_rerun":
        assert ref_phase.snap().get("dispatches", 0) == 2
        assert phase.snap().get("dispatches", 0) == 2
        assert mexec._CAP_CACHE[key] == rexec._CAP_CACHE[key]


def test_shuffle_join_max_key_never_meets_a_pad_row():
    """A probe key of 2^63-1 with no such build key matches nothing:
    invalid build rows and the frames' empty slots never match. The
    reference keys them 2^63-1 and lets such a probe row meet one
    (counted into group 0); the port does not copy that."""
    from tidb_tpu.mpp import exec as rexec
    pk, pv, pok, bk, bp, bok, n_groups = _shuffle_inputs("uniform")
    i64max = np.iinfo(np.int64).max
    pk = pk.copy()
    pk[::97] = i64max
    want_s, want_c = _host_join_agg(pk, pv[0], pok, bk, bp, bok, n_groups)
    ps, pc = mexec.mpp_shuffle_join_agg(_mesh(), pk, pv, pok, bk, bp, bok,
                                        n_groups=n_groups)
    assert pc.tolist() == want_c.tolist()
    assert ps[0].tolist() == want_s.tolist()
    _rs, rc = rexec.mpp_shuffle_join_agg(_ref_mesh(), pk, pv, pok, bk, bp,
                                         bok, n_groups=n_groups)
    extra = np.asarray(rc) - want_c
    assert extra[0] == len(pk[::97]) and not extra[1:].any()
    # with a valid build row keyed 2^63-1 both packages match it
    bk2 = bk.copy()
    bk2[-1] = i64max
    want_s, want_c = _host_join_agg(pk, pv[0], pok, bk2, bp, bok, n_groups)
    ps, pc = mexec.mpp_shuffle_join_agg(_mesh(), pk, pv, pok, bk2, bp,
                                        bok, n_groups=n_groups)
    assert pc.tolist() == want_c.tolist()
    assert ps[0].tolist() == want_s.tolist()


# ---- SQL parity with the reference, MPP on -----------------------------

@pytest.fixture(scope="module")
def kits():
    ref = RefKit()
    ref_tpch.load_tpch(ref, sf=0.01, seed=7)
    port = TestKit(device="cpu", mesh=NDEV)
    tpch.load_tpch(port, sf=0.01, seed=7)
    for k in (ref, port):
        k.must_exec("set @@tidb_enable_mpp = on")
        k.must_exec("set @@tidb_mpp_min_rows = 0")
    return ref, port


def _mesh_marks(m):
    return (m.get("fused_pipeline_mpp_hit", 0), m.get("copr_mpp_exec", 0),
            m.get("fused_shuffle_join", 0))


@pytest.mark.parametrize("q", ["q1", "q3", "q5", "q6", "q12"])
def test_tpch_rows_equal_reference_on_mesh(kits, q):
    ref, port = kits
    r0, p0 = _mesh_marks(ref.domain.metrics), \
        _mesh_marks(port.domain.metrics)
    want = ref.must_query(ref_tpch.ALL_QUERIES[q])._norm()
    got = port.must_query(tpch.ALL_QUERIES[q])._norm()
    assert got == want
    assert _mesh_marks(ref.domain.metrics) != r0     # both on a mesh
    assert _mesh_marks(port.domain.metrics) != p0
    assert port.domain.metrics.get("fused_pipeline_fallback", 0) == 0


ALL_Q = sorted(tpch.ALL_QUERIES, key=lambda q: int(q[1:]))


@pytest.mark.parametrize("policy", [None, "runs"])
@pytest.mark.parametrize("q", ALL_Q)
def test_tpch22_on_mesh_equals_reference(kits, q, policy, monkeypatch):
    """Every TPC-H query on the 8-shard mesh equals the reference's rows,
    under the CPU's aggregation policy and the card's ("runs": the sort
    kind per shard as contiguous runs), with its fused nodes on the mesh
    route and none declined. (A materialized dim's subplan runs on one
    device in both packages: fragment_plan does not reach it; a later
    Q20 serves its subquery from the plan and runs no fused node.)"""
    from tidb_tpu_torch.copr import dag_exec
    ref, port = kits
    monkeypatch.setattr(dag_exec, "_FORCE_SEGMENT_IMPL", policy)
    want = ref.must_query(ref_tpch.ALL_QUERIES[q])._norm()
    m = port.domain.metrics
    p0 = _mesh_marks(m)
    f0 = m.get("fused_pipeline_fallback", 0)
    h0 = m.get("fused_pipeline_hit", 0)
    assert port.must_query(tpch.ALL_QUERIES[q])._norm() == want
    assert _mesh_marks(m) != p0 or m.get("fused_pipeline_hit", 0) == h0
    assert m.get("fused_pipeline_fallback", 0) == f0, \
        port.domain.last_fused_reason


def _explain(kit, sql):
    return [tuple(r) for r in kit.must_query("explain " + sql).rows]


EXPLAIN_SQL = ("select d, count(*), sum(v) from xf group by d",
               "select g, sum(v) from xf join xd on xf.d = xd.id group by g",
               "select l_returnflag, count(*), sum(l_quantity) from "
               "lineitem group by l_returnflag",
               "select n_name, sum(c_acctbal) from customer join nation "
               "on c_nationkey = n_nationkey group by n_name",
               "q3")


def _explain_schema(kit):
    """The tiny schema of the EXPLAIN fault's first report: xf(k, d, v)
    and xd(id, g), created once per kit."""
    if kit.must_query("show tables like 'xf'").rows:
        return
    kit.must_exec("create table xf (k int primary key, d int, v int)")
    kit.must_exec("create table xd (id int primary key, g int)")
    kit.must_exec("insert into xf values (1, 1, 10), (2, 2, 20), "
                  "(3, 1, 30)")
    kit.must_exec("insert into xd values (1, 7), (2, 8)")


@pytest.mark.parametrize("mpp", ["on", "off"])
@pytest.mark.parametrize("mesh", [None, NDEV])
def test_explain_matches_reference_with_mpp_on_and_off(kits, mpp, mesh):
    """The port's EXPLAIN equals the reference's with tidb_enable_mpp on
    (exchange nodes, on one device as on a mesh) and off (none)."""
    ref, mesh_port = kits
    port = mesh_port if mesh else _one_device_kit()
    for k in (ref, port):
        _explain_schema(k)
        k.must_exec(f"set @@tidb_enable_mpp = {mpp}")
    try:
        for sql in EXPLAIN_SQL:
            rq = ref_tpch.ALL_QUERIES.get(sql, sql)
            pq = tpch.ALL_QUERIES.get(sql, sql)
            want, got = _explain(ref, rq), _explain(port, pq)
            assert got == want, sql
            has = any("Exchange" in r[0] for r in got)
            assert has == (mpp == "on"), sql
    finally:
        for k in (ref, port):
            k.must_exec("set @@tidb_enable_mpp = on")


_ONE = []


def _one_device_kit():
    if not _ONE:
        k = TestKit(device="cpu")
        tpch.load_tpch(k, sf=0.01, seed=7)
        _ONE.append(k)
    return _ONE[0]


def test_no_mesh_runs_the_single_device_paths():
    """A Domain given no mesh on the CPU has none (the card's default is
    every visible CUDA device, one on a one-card machine): MPP on, every
    fused and reader route runs as before, with no exchange."""
    k = _one_device_kit()
    assert k.domain.copr._get_mesh() is None
    k.must_exec("set @@tidb_mpp_min_rows = 0")
    m = k.domain.metrics
    f0 = m.get("fused_pipeline_hit", 0)
    phase.reset()
    rows = k.must_query(Q6)._norm()
    assert m.get("fused_pipeline_hit", 0) == f0 + 1
    assert _mesh_marks(m) == (0, 0, 0)
    assert phase.snap().get("mpp_exchanges", 0) == 0
    assert rows == tpch.q6_oracle(k)


def test_mesh_failure_fails_statement_when_not_degrading(tk):
    """The card's rule: a mesh run that fails fails its statement and is
    never retried on one device (copr.degrade_to_host False, as on
    cuda); on the CPU the reference's ladder retries on one device."""
    from tidb_tpu_torch.errors import TiDBError
    from tidb_tpu_torch.utils import failpoint
    tk.must_exec("set @@tidb_mpp_min_rows = 0")
    tk.must_exec("set @@tidb_enable_mpp = on")
    copr = tk.domain.copr
    m = tk.domain.metrics
    failpoint.enable("device_guard/fused/kernel", "error")
    try:
        single0 = m.get("fused_pipeline_hit", 0)
        copr.degrade_to_host = False
        with pytest.raises((TiDBError, RuntimeError)):
            tk.must_query(Q6)
        assert m.get("fused_pipeline_hit", 0) == single0
    finally:
        copr.degrade_to_host = True
        failpoint.disable("device_guard/fused/kernel")


def test_explain_analyze_reports_the_mesh_engine(tk):
    """EXPLAIN ANALYZE names the mesh's engine (runtime_stats): a fused
    pipeline on the mesh is device(fused-mpp), a reader aggregation
    device-mpp."""
    tk.must_exec("set @@tidb_mpp_min_rows = 0")
    tk.must_exec("set @@tidb_enable_mpp = on")
    txt = str(tk.must_query("explain analyze " + Q6).rows)
    assert "device(fused-mpp)" in txt
    tk.must_exec("create table ea (a int primary key, b int)")
    tk.must_exec("insert into ea values " + ",".join(
        f"({i}, {i % 3})" for i in range(300)))
    txt = str(tk.must_query(
        "explain analyze select b, count(*) from ea group by b").rows)
    assert "device-mpp" in txt


def test_profile_stages_name_functions_of_the_package():
    """bench/profile_tpch.py's cProfile stages (the mesh's among them)
    each name a function defined in the file they point at, so a rename
    cannot silently zero a stage."""
    import os
    import re
    import tidb_tpu_torch
    from tidb_tpu_torch.bench.profile_tpch import STAGES
    root = os.path.dirname(tidb_tpu_torch.__file__)
    assert ("mesh_program", "parallel/mesh.py", "program") in STAGES
    for label, suffix, fn in STAGES:
        with open(os.path.join(root, suffix)) as f:
            src = f.read()
        assert re.search(rf"^\s*def {fn}\(", src, re.M), (label, fn)

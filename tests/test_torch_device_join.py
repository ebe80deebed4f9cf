"""The device equi-join index (tidb_tpu_torch/ops/device_join.py) against
the reference's (tidb_tpu/ops/device_join.py, JAX on the CPU): exactly
equal (probe, build) pairs and semi masks on seeded keys with duplicates
and NULLs on both sides, empty sides and no match. The one case where
they differ is the reference's sentinel fault: it keys invalid build
rows with 2^63-1, so a valid probe key of 2^63-1 matches the NULL build
rows and the padding; the port equals the host join there. Then the
twin of tests/test_sql.py TestDeviceJoin and row-returning inner, left,
semi and anti joins under tidb_join_exec device and host, with rows
equal to the reference TestKit's, and the guard twin of
tests/test_device_guard.py: a grant loss at device_guard/join degrades
to identical rows on the CPU."""
import numpy as np
import pytest

from tidb_tpu.ops import device_join as ref_join
from tidb_tpu.testkit import TestKit as RefKit
from tidb_tpu_torch.ops import device_join as port_join
from tidb_tpu_torch.testkit import TestKit as PortKit
from tidb_tpu_torch.utils import failpoint, phase

I64_MAX = np.iinfo(np.int64).max


@pytest.fixture(autouse=True)
def _torch_registries():
    """The shared conftest resets tidb_tpu's registries only."""
    from tidb_tpu_torch.utils import metrics, device_guard
    metrics.reset_all()
    device_guard.reset()
    phase.reset()
    yield
    failpoint.disable_all()


def host_join(bk, bnull, pk, pnull):
    """The pairs a nested loop finds, in probe-row then build-row order
    (the order of the host hash join)."""
    pi, bi = [], []
    for i in range(len(pk)):
        if pnull[i]:
            continue
        for j in range(len(bk)):
            if not bnull[j] and bk[j] == pk[i]:
                pi.append(i)
                bi.append(j)
    return np.array(pi, dtype=np.int64), np.array(bi, dtype=np.int64)


# (build rows, probe rows, key range, NULL share)
CASES = {
    "dups_both_sides": (300, 200, 50, 0.0),
    "nulls_both_sides": (257, 333, 40, 0.15),
    "unique_build": (1000, 777, None, 0.05),
    "extreme_keys": (64, 90, "extreme", 0.1),
    "empty_build": (0, 50, 10, 0.1),
    "empty_probe": (50, 0, 10, 0.1),
    "no_match": (100, 100, "disjoint", 0.0),
    "all_null_build": (30, 40, 5, 1.0),
}


def _inputs(name):
    nb, npr, rng_keys, null_share = CASES[name]
    rng = np.random.default_rng(len(name))
    if rng_keys is None:
        bk = rng.permutation(nb).astype(np.int64)
        pk = rng.integers(-5, nb + 5, npr)
    elif rng_keys == "extreme":
        vals = np.array([-(1 << 63), -1, 0, 1, I64_MAX - 1])
        bk, pk = rng.choice(vals, nb), rng.choice(vals, npr)
    elif rng_keys == "disjoint":
        bk, pk = rng.integers(0, 50, nb), rng.integers(100, 150, npr)
    else:
        bk, pk = rng.integers(0, rng_keys, nb), rng.integers(0, rng_keys,
                                                             npr)
    bnull, pnull = rng.random(nb) < null_share, rng.random(npr) < null_share
    return (bk.astype(np.int64), bnull, pk.astype(np.int64), pnull)


@pytest.mark.parametrize("name", list(CASES))
def test_pairs_equal_reference(name):
    bk, bnull, pk, pnull = _inputs(name)
    want = ref_join.device_join_index(bk, bnull, pk, pnull)
    got = port_join.device_join_index(bk, bnull, pk, pnull, "cpu")
    for g, w, h in zip(got, want, host_join(bk, bnull, pk, pnull)):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, h)


@pytest.mark.parametrize("name", list(CASES))
def test_semi_mask_equals_reference(name):
    bk, bnull, pk, pnull = _inputs(name)
    want, _ = ref_join.device_join_index(bk, bnull, pk, pnull,
                                         semi_only=True)
    got, none = port_join.device_join_index(bk, bnull, pk, pnull, "cpu",
                                            semi_only=True)
    assert none is None
    np.testing.assert_array_equal(got, want)
    matched = np.zeros(len(pk), dtype=bool)
    matched[host_join(bk, bnull, pk, pnull)[0]] = True
    np.testing.assert_array_equal(got, matched)


def test_sentinel_key_matches_no_null_build_row():
    """A valid probe key of 2^63-1 against a NULL build key. The host
    join pairs probe row 1 with build row 0 and nothing else; the
    reference's device answer also pairs probe row 0 with the NULL build
    row 2 and its pad rows 3..1023, and reports it matched."""
    bk, bnull = np.array([1, 2, 0]), np.array([False, False, True])
    pk, pnull = np.array([I64_MAX, 1]), np.array([False, False])
    pi, bi = port_join.device_join_index(bk, bnull, pk, pnull, "cpu")
    hp, hb = host_join(bk, bnull, pk, pnull)
    assert list(pi) == list(hp) == [1] and list(bi) == list(hb) == [0]
    semi, _ = port_join.device_join_index(bk, bnull, pk, pnull, "cpu",
                                          semi_only=True)
    assert list(semi) == [False, True]
    rpi, rbi = ref_join.device_join_index(bk, bnull, pk, pnull)
    assert list(rbi[rpi == 0]) == list(range(2, 1024))
    rsemi, _ = ref_join.device_join_index(bk, bnull, pk, pnull,
                                          semi_only=True)
    assert list(rsemi) == [True, True]


def test_sentinel_key_matches_a_valid_sentinel_build_row():
    """A valid build key of 2^63-1 still matches, in build-row order,
    with the NULL build rows around it left out."""
    bk = np.array([I64_MAX, 0, I64_MAX, 5])
    bnull = np.array([False, True, False, True])
    pk, pnull = np.array([5, I64_MAX, 0]), np.zeros(3, dtype=bool)
    pi, bi = port_join.device_join_index(bk, bnull, pk, pnull, "cpu")
    assert list(pi) == [1, 1] and list(bi) == [0, 2]


@pytest.mark.parametrize("semi", [False, True])
def test_uploads_counted(semi):
    """Both sides' keys (8 B) and validity (1 B) per row, either way."""
    k = np.arange(6, dtype=np.int64)
    phase.reset()
    port_join.device_join_index(k, np.zeros(6, bool), k, np.zeros(6, bool),
                                "cpu", semi_only=semi)
    snap = phase.snap()
    assert snap.get("hook_upload_bytes") == 2 * (8 * 6 + 6)
    assert snap.get("syncs", 0) == 0          # a CPU tensor waits on nothing


# ---- SQL twins ---------------------------------------------------------

def _setup():
    rng = np.random.default_rng(9)
    rows1 = ",".join(f"({int(a)}, {i})" for i, a in
                     enumerate(rng.integers(0, 50, 300)))
    rows2 = ",".join(f"({int(a)}, {i})" for i, a in
                     enumerate(rng.integers(0, 50, 200)))
    return ["create table dj1 (id int, v int)",
            "create table dj2 (id int, w int)",
            f"insert into dj1 values {rows1}, (null, 999)",
            f"insert into dj2 values {rows2}, (null, 998)"]


@pytest.fixture(scope="module")
def kits():
    ref, port = RefKit(), PortKit(device="cpu")
    for kit in (ref, port):
        for sql in _setup():
            kit.must_exec(sql)
    return ref, port


# (SQL, whether its hash join runs on the device route under
# tidb_join_exec = device: the first four are tests/test_sql.py
# TestDeviceJoin's, whose IN subqueries become IN lists at plan time)
QUERIES = [
    ("select count(*), sum(v), sum(w) from dj1 join dj2 "
     "on dj1.id = dj2.id", True),
    ("select count(*) from dj1 left join dj2 on dj1.id = dj2.id", True),
    ("select count(*) from dj1 where id in (select id from dj2)", False),
    ("select count(*) from dj1 where id not in "
     "(select dj2.id from dj2 where dj2.id is not null)", False),
    ("select dj1.v, dj2.w from dj1 join dj2 on dj1.id = dj2.id "
     "order by 1, 2", True),
    ("select dj1.v, d.w from dj1 left join (select id, w from dj2 "
     "where w < 100) d on dj1.id = d.id order by 1, 2", True),
    ("select v from dj1 where id in (select id from dj2 where dj2.id = "
     "dj1.id and w > 20) order by v", True),
    ("select v from dj1 where exists (select 1 from dj2 where dj2.id = "
     "dj1.id) order by v", True),
    ("select v from dj1 where not exists (select 1 from dj2 where dj2.id "
     "= dj1.id and w < 150) order by v", True),
]


@pytest.mark.parametrize("i", range(len(QUERIES)))
def test_sql_join_device_and_host_match_reference(kits, i):
    ref, port = kits
    sql, routed = QUERIES[i]
    want = ref.must_query(sql)._norm()
    m = port.domain.metrics
    for mode in ("host", "device"):
        port.must_exec(f"set @@tidb_join_exec = {mode}")
        port.domain.plan_cache.clear()
        n0 = m.get("device_join", 0)
        got = port.must_query(sql)._norm()
        assert m.get("device_join", 0) - n0 == \
            (1 if routed and mode == "device" else 0), (mode, sql)
        assert m.get("device_join_fallback", 0) == 0
        assert got == want, (mode, sql)
    port.must_exec("set @@tidb_join_exec = auto")


def test_auto_stays_on_the_host_on_cpu(kits):
    """tidb_join_exec = auto takes the device join only when the
    domain's device is cuda."""
    _, port = kits
    port.must_exec("set @@tidb_join_exec = auto")
    n0 = port.domain.metrics.get("device_join", 0)
    port.must_query(QUERIES[4][0])
    assert port.domain.metrics.get("device_join", 0) == n0


# ---- guard twin of tests/test_device_guard.py --------------------------

def test_join_site_grant_loss_identical_on_cpu():
    tk = PortKit(device="cpu")
    tk.must_exec("create table t (a int primary key, b int, c int)")
    tk.must_exec("insert into t values " + ",".join(
        f"({i}, {i % 7}, {i % 13})" for i in range(400)))
    tk.must_exec("create table d (id int primary key, tag int)")
    tk.must_exec("insert into d values " + ",".join(
        f"({i}, {i % 3})" for i in range(7)))
    tk.must_exec("set tidb_join_exec = 'device'")
    sql = ("select t.a, d.tag from t, d where t.b = d.id "
           "order by t.a")
    failpoint.enable("device_guard/join", "error:grant_lost")
    rows = tk.must_query(sql).rows
    failpoint.disable_all()
    tk.must_exec("set tidb_join_exec = 'host'")
    assert rows == tk.must_query(sql).rows
    m = tk.domain.metrics
    assert m.get("device_join_fallback", 0) >= 1
    assert m.get("device_join", 0) == 0


# ---- the slice as a whole: chip_smoke's executor statements -------------

@pytest.fixture(scope="module")
def tpch_kits():
    """TPC-H at SF0.01 (lineitem not loaded) in both packages, the size
    floors lowered to 1,000 rows so that every hook takes its route as it
    does at SF1 on the card."""
    from tidb_tpu.bench import tpch as ref_tpch
    from tidb_tpu_torch.bench import tpch as port_tpch
    import os
    saved = {k: os.environ.get(k) for k in ("TIDB_TPU_SORT_MIN",
                                            "TIDB_TPU_WINDOW_MIN")}
    os.environ.update({k: "1000" for k in saved})
    ref, port = RefKit(), PortKit(device="cpu")
    ref_tpch.load_tpch(ref, sf=0.01, seed=7, skip_tables=("lineitem",))
    port_tpch.load_tpch(port, sf=0.01, seed=7, skip_tables=("lineitem",))
    port.must_exec("set tidb_join_exec = 'device'")
    yield ref, port
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k)
        else:
            os.environ[k] = v


def _executor_cases():
    from tidb_tpu_torch.bench import tpch as port_tpch
    return port_tpch.EXECUTOR_CASES


@pytest.mark.parametrize("case", _executor_cases(),
                         ids=[c[0] for c in _executor_cases()])
def test_executor_cases_match_reference(tpch_kits, case):
    """Each statement of bench/tpch.py EXECUTOR_CASES takes the hooks
    the case names, each once per call, and returns the reference's
    rows."""
    ref, port = tpch_kits
    _name, sql, hooks, _syncs = case
    counters = {"sort": "sort_device", "window": "window_device",
                "join": "device_join"}
    m = port.domain.metrics
    m0 = {c: m.get(c, 0) for c in counters.values()}
    got = port.must_query(sql)._norm()
    assert {h: m.get(c, 0) - m0[c] for h, c in counters.items()} == \
        {h: hooks.get(h, 0) for h in counters}
    for c in ("sort_device_error", "window_device_error",
              "device_join_fallback"):
        assert m.get(c, 0) == 0, c
    assert got == ref.must_query(sql)._norm()
    assert got

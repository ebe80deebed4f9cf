"""The device window program (tidb_tpu_torch/executor/window_device.py)
against the reference's (tidb_tpu/executor/window_device.py, JAX on the
CPU): every function of DEVICE_FNS with and without ORDER BY, over 0-2
partition keys, float and int keys, NULLs and ties, lag/lead shifts with
and without a default. Integer outputs and every NULL mask are exactly
equal; float outputs within rtol 1e-9 (prefix sums associate
differently); a value under a NULL is not compared (the reference reads
its pad rows there). Then the SQL twin of tests/test_window_device.py,
with rows equal to the reference TestKit's, and the guard twin of
tests/test_device_guard.py: a grant loss at device_guard/window degrades
to identical rows on the CPU."""
import os

import numpy as np
import pytest

from tidb_tpu.executor import window_device as ref_win
from tidb_tpu.testkit import TestKit as RefKit
from tidb_tpu_torch.executor import window_device as port_win
from tidb_tpu_torch.testkit import TestKit as PortKit
from tidb_tpu_torch.utils import failpoint, phase


@pytest.fixture(autouse=True)
def _torch_registries():
    """The shared conftest resets tidb_tpu's registries only."""
    from tidb_tpu_torch.utils import metrics, device_guard
    metrics.reset_all()
    device_guard.reset()
    phase.reset()
    yield
    failpoint.disable_all()


def assert_window_equal(got, want, val_float):
    (go, gn), (wo, wn) = got, want
    assert (gn is None) == (wn is None)
    live = np.ones(len(wo), dtype=bool) if wn is None else ~wn
    if wn is not None:
        np.testing.assert_array_equal(gn, wn)
    assert go.dtype == wo.dtype
    if val_float:
        np.testing.assert_allclose(go[live], wo[live], rtol=1e-9, atol=0)
    else:
        np.testing.assert_array_equal(go[live], wo[live])


# (partition keys, ORDER BY keys): key kinds "i" int, "f" float
LAYOUTS = [(("i",), ()), (("i",), ("i", "f")), (("f", "i"), ("i",)),
           ((), ("i",))]
CASES = (
    [(fn, lay, "int", 0, None) for fn in ("row_number", "rank",
                                          "dense_rank", "count")
     for lay in LAYOUTS] +
    [(fn, lay, kind, 0, None) for fn in ("sum", "avg", "min", "max")
     for lay in LAYOUTS for kind in ("int", "float")] +
    [(fn, lay, kind, shift, dflt) for fn in ("lag", "lead")
     for lay in LAYOUTS[1:] for kind in ("int", "float")
     for shift, dflt in ((1, None), (3, 7))])


def _case_id(c):
    fn, (pk, ok), kind, shift, dflt = c
    return f"{fn}-p{''.join(pk)}-o{''.join(ok)}-{kind}-{shift}-{dflt}"


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_window_program_equals_reference(case):
    fn, (pkinds, okinds), kind, shift, dflt = case
    n = 1531                                 # non-pow2
    rng = np.random.default_rng(len(_case_id(case)) * 31 + shift)

    def key(k):
        if k == "i":
            return rng.integers(-3, 4, n)
        # float keys: ties, +-0.0 (one peer), NULL sentinels
        return rng.choice(np.array([-np.inf, -1.8, -1.2, -0.0, 0.0, 1.2,
                                    1.8, np.inf]), n)
    keys = [key(k) for k in pkinds + okinds]
    if kind == "int":
        vals = rng.integers(-(1 << 40), 1 << 40, n)
    else:
        vals = rng.uniform(0.5, 1000.0, n)
    ok = rng.random(n) < 0.85
    if fn in ("min", "max", "sum", "avg"):
        ok[:40] = False                      # an all-NULL partition likely
    s = -shift if fn == "lag" else shift
    default = None if dflt is None else (float(dflt) if kind == "float"
                                         else dflt)
    want = ref_win.run_window_device(fn, keys, len(pkinds), bool(okinds),
                                     vals, ok, n, shift=s, default=default)
    got = port_win.run_window_device(fn, keys, len(pkinds), bool(okinds),
                                     vals, ok, n, "cpu", shift=s,
                                     default=default)
    assert_window_equal(got, want, kind == "float" or fn == "avg")


@pytest.mark.parametrize("is_min", [False, True])
@pytest.mark.parametrize("n", [1, 2, 3, 1000, 4097])
def test_seg_running_minmax_equals_per_partition_cummax(n, is_min):
    """The segmented running min/max (window_device.seg_running_minmax)
    equals torch.cummax/cummin run on each partition alone, int64
    extremes and one-row partitions included."""
    import torch
    rng = np.random.default_rng(n)
    x = rng.integers(-(1 << 62), 1 << 62, n)
    x[rng.random(n) < 0.01] = np.iinfo(np.int64).max
    x[rng.random(n) < 0.01] = -np.iinfo(np.int64).max
    part = np.cumsum(rng.random(n) < 0.05)
    t, pt = torch.from_numpy(x), torch.from_numpy(part)
    scan = torch.cummin if is_min else torch.cummax
    want = torch.cat([scan(t[pt == p], 0).values for p in np.unique(part)])
    assert torch.equal(port_win.seg_running_minmax(t, pt, is_min), want)


def test_float_default_on_int_values_is_float64():
    """lag(int column, 1, 2.5): the default promotes the output to
    float64, as jnp.where does in the reference."""
    n = 50
    keys = [np.arange(n) % 3, np.arange(n)]
    vals = np.arange(n, dtype=np.int64)
    ok = np.ones(n, dtype=bool)
    want = ref_win.run_window_device("lag", keys, 1, True, vals, ok, n,
                                     shift=-1, default=2.5)
    got = port_win.run_window_device("lag", keys, 1, True, vals, ok, n,
                                     "cpu", shift=-1, default=2.5)
    assert got[0].dtype == np.float64
    assert_window_equal(got, want, True)


def test_uploads_counted():
    n = 100
    keys = [np.arange(n) % 4]
    phase.reset()
    port_win.run_window_device("sum", keys, 1, False, np.ones(n, np.int64),
                               np.ones(n, bool), n, "cpu")
    snap = phase.snap()
    assert snap.get("hook_upload_bytes") == 8 * n + 8 * n + n
    assert snap.get("syncs", 0) == 0          # a CPU tensor waits on nothing


# ---- SQL twin of tests/test_window_device.py ---------------------------

def _setup_rows():
    rng = np.random.RandomState(11)
    rows = []
    for i in range(777):                     # non-pow2
        g = rng.randint(0, 7)
        v = rng.randint(0, 100)
        s = ["aa", "BB", "cc", None][rng.randint(0, 4)]
        rows.append(f"({g},{v},{'null' if s is None else repr(s)})")
    return ["create table w (g int, v int, s varchar(4))",
            "insert into w values " + ",".join(rows)]


@pytest.fixture(scope="module")
def kits():
    os.environ["TIDB_TPU_WINDOW_MIN"] = "1"
    ref, port = RefKit(), PortKit(device="cpu")
    for kit in (ref, port):
        for sql in _setup_rows():
            kit.must_exec(sql)
    yield ref, port
    os.environ.pop("TIDB_TPU_WINDOW_MIN", None)


QUERIES = [
    "select g, v, row_number() over (partition by g order by v, s) "
    "from w order by g, v, s",
    "select g, rank() over (partition by g order by v) from w "
    "order by g, v",
    "select g, dense_rank() over (partition by g order by v) from w "
    "order by g, v",
    "select g, sum(v) over (partition by g) from w order by g, v",
    "select g, count(s) over (partition by g) from w order by g, v",
    "select g, avg(v * 1e0) over (partition by g) from w order by g, v",
    "select g, min(v) over (partition by g), max(v) over "
    "(partition by g) from w order by g, v",
    "select g, sum(v) over (partition by g order by v) from w "
    "order by g, v",
    "select g, min(s) over (partition by g), max(s) over "
    "(partition by g) from w order by g, v",
    "select g, lag(v) over (partition by g order by v, s) from w "
    "order by g, v, s",
    "select g, lead(v, 2, -1) over (partition by g order by v, s) "
    "from w order by g, v, s",
    "select row_number() over (order by v, s, g) from w order by v, s, g",
]


def both(kits, sql, routed=True):
    """The port's rows == the reference's; -> the rows. The port's
    statement took the device program once per window function when
    `routed`, and never failed there."""
    ref, port = kits
    m = port.domain.metrics
    n0 = m.get("window_device", 0)
    got = port.must_query(sql)._norm()
    assert m.get("window_device_error", 0) == 0
    assert (m.get("window_device", 0) > n0) == routed, sql
    assert got == ref.must_query(sql)._norm(), sql
    return got


@pytest.mark.parametrize("i", range(len(QUERIES)))
def test_sql_window_matches_reference(kits, i):
    both(kits, QUERIES[i])


def test_float_order_keys_keep_distinct_values(kits):
    """Float sort keys rank-encode on the host: 1.2 and 1.8 stay apart."""
    for kit in kits:
        kit.must_exec("create table wf (g int, f double)")
        kit.must_exec("insert into wf values (1,1.2),(1,1.8),(1,1.2),"
                      "(2,0.5),(2,null)")
    both(kits, "select g, f, rank() over (partition by g order by f) "
               "from wf order by g, f")


def test_float_partition_keys_keep_distinct_values(kits):
    for kit in kits:
        kit.must_exec("create table wpf (f double, v int)")
        kit.must_exec("insert into wpf values (1.2,10),(1.8,20),(1.2,30),"
                      "(null,5),(2.5,7)")
    rows = both(kits, "select f, sum(v) over (partition by f) s from wpf "
                      "order by f, v")
    by_f = {str(r[0]): str(r[1]) for r in rows}
    assert by_f["1.2"] == "40" and by_f["1.8"] == "20"


def test_object_partition_keys_group_duplicates(kits):
    """Object-dtype keys (>18-digit exact decimals) give EQUAL values
    equal ranks; their sum runs on the device, over rank keys."""
    for kit in kits:
        kit.must_exec("create table wbd (d decimal(38,20), v int)")
        kit.must_exec("insert into wbd values "
                      "('1.00000000000000000001',1),"
                      "('1.00000000000000000001',2),"
                      "('2.00000000000000000002',3)")
    rows = both(kits, "select v, sum(v) over (partition by d), "
                      "rank() over (order by d) from wbd order by v")
    assert [(str(r[1]), str(r[2])) for r in rows] == \
        [("3", "1"), ("3", "1"), ("3", "3")]


def test_ci_collation_peers_match_across_paths(kits):
    for kit in kits:
        kit.must_exec("create table wci (s varchar(8) collate "
                      "utf8mb4_general_ci, v int)")
        kit.must_exec("insert into wci values ('aa',1),('AA',2),('b',3)")
    rows = both(kits, "select s, rank() over (order by s) r from wci "
                      "order by v")
    ranks = [str(r[1]) for r in rows]
    assert ranks[0] == ranks[1] == "1" and ranks[2] == "3"


# ---- guard twin of tests/test_device_guard.py --------------------------

def test_window_site_grant_loss_identical_on_cpu(monkeypatch):
    monkeypatch.setenv("TIDB_TPU_WINDOW_MIN", "1")
    tk = PortKit(device="cpu")
    tk.must_exec("create table t (a int primary key, b int, c int)")
    tk.must_exec("insert into t values " + ",".join(
        f"({i}, {i % 7}, {i % 13})" for i in range(400)))
    sql = ("select a, sum(c) over (partition by b order by a) from t "
           "order by a")
    failpoint.enable("device_guard/window", "error:grant_lost")
    rows = tk.must_query(sql).rows
    failpoint.disable_all()
    tk.domain.copr.use_device = False
    assert rows == tk.must_query(sql).rows
    m = tk.domain.metrics
    assert m.get("window_device_error", 0) >= 1
    assert m.get("window_device", 0) == 0

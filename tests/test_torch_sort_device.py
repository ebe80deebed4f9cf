"""The device ORDER BY permutation (tidb_tpu_torch/executor/sort_device.py)
against the reference's (tidb_tpu/executor/sort_device.py, JAX on the
CPU): equal permutations on seeded keys; then the SQL twin of
tests/test_sort_device.py (in memory and through the external spill)
with rows equal to the reference TestKit's, and the guard twin of
tests/test_device_guard.py: a grant loss at device_guard/sort degrades
to identical rows on the CPU."""
import os

import numpy as np
import pytest

from tidb_tpu.executor import sort_device as ref_sort
from tidb_tpu.testkit import TestKit as RefKit
from tidb_tpu_torch.executor import sort_device as port_sort
from tidb_tpu_torch.testkit import TestKit as PortKit
from tidb_tpu_torch.utils import failpoint, phase

I64_MIN, I64_MAX = np.iinfo(np.int64).min, np.iinfo(np.int64).max


@pytest.fixture(autouse=True)
def _torch_registries():
    """The shared conftest resets tidb_tpu's registries only."""
    from tidb_tpu_torch.utils import metrics, device_guard
    metrics.reset_all()
    device_guard.reset()
    phase.reset()
    yield
    failpoint.disable_all()


def _key(rng, kind, n):
    if kind == "int":                        # ties
        return rng.integers(-4, 4, n)
    if kind == "extreme":                    # the int64 extremes, ties
        return rng.choice(np.array([I64_MIN, I64_MIN + 1, -1, 0, 1,
                                    I64_MAX - 1, I64_MAX]), n)
    if kind == "wide":
        return rng.integers(I64_MIN, I64_MAX, n, endpoint=True)
    # float64 with +-0.0, +-inf and ties
    return rng.choice(np.array([-np.inf, -2.5, -1e-300, -0.0, 0.0, 1e-300,
                                0.5, 2.5, np.inf]), n)


KEY_SETS = [("int",), ("float",), ("extreme",), ("wide",),
            ("int", "float"), ("float", "extreme"),
            ("int", "int", "float"), ("extreme", "float", "int", "int")]


@pytest.mark.parametrize("n", [1, 1000, 4099, 33_333])
@pytest.mark.parametrize("kinds", KEY_SETS, ids="-".join)
def test_permutation_equals_reference(monkeypatch, kinds, n):
    monkeypatch.setenv("TIDB_TPU_SORT_MIN", "1")
    rng = np.random.default_rng(n * 7 + len(kinds))
    keys = [_key(rng, k, n) for k in kinds]
    want = ref_sort.device_sort_permutation(keys, n)
    got = port_sort.device_sort_permutation(keys, n, "cpu")
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def test_signed_zero_orders_before_positive_zero(monkeypatch):
    """As the reference (sort_device.py docstring): -0.0 sorts strictly
    before +0.0, where host numpy ties them."""
    monkeypatch.setenv("TIDB_TPU_SORT_MIN", "1")
    keys = [np.array([0.0, -0.0, 0.0, -0.0])]
    got = port_sort.device_sort_permutation(keys, 4, "cpu")
    assert list(got) == [1, 3, 0, 2]
    assert list(got) == list(ref_sort.device_sort_permutation(keys, 4))
    assert list(np.lexsort(keys)) == [0, 1, 2, 3]


@pytest.mark.parametrize("n,routed", [(999, False), (1000, True)])
def test_size_floor(monkeypatch, n, routed):
    """At the floor both sort on the device; one row below, neither."""
    monkeypatch.setenv("TIDB_TPU_SORT_MIN", "1000")
    keys = [np.arange(n)[::-1].copy()]
    want = ref_sort.device_sort_permutation(keys, n)
    got = port_sort.device_sort_permutation(keys, n, "cpu")
    assert (got is not None) == routed == (want is not None)
    if routed:
        np.testing.assert_array_equal(got, want)


def test_uploads_counted(monkeypatch):
    monkeypatch.setenv("TIDB_TPU_SORT_MIN", "1")
    keys = [np.arange(10), np.zeros(10)]
    phase.reset()
    port_sort.device_sort_permutation(keys, 10, "cpu")
    snap = phase.snap()
    assert snap.get("hook_upload_bytes") == 160
    assert snap.get("syncs", 0) == 0          # a CPU tensor waits on nothing


# ---- SQL twin of tests/test_sort_device.py ----------------------------

def _setup_rows():
    rng = np.random.RandomState(7)
    rows = []
    for i in range(941):                     # non-pow2
        a = rng.randint(0, 9)
        f = round(float(rng.uniform(-5, 5)), 3)
        s = ["aa", "BB", "cc", "AA", None][rng.randint(0, 5)]
        v = rng.randint(0, 1000)
        rows.append(f"({i},{a},{f},"
                    f"{'null' if s is None else repr(s)},{v})")
    return ["create table s (id int primary key, a int, f double, "
            "s varchar(4) collate utf8mb4_general_ci, v int)",
            "insert into s values " + ",".join(rows)]


@pytest.fixture(scope="module")
def kits():
    os.environ["TIDB_TPU_SORT_MIN"] = "1"
    ref, port = RefKit(), PortKit(device="cpu")
    for kit in (ref, port):
        for sql in _setup_rows():
            kit.must_exec(sql)
    yield ref, port
    os.environ.pop("TIDB_TPU_SORT_MIN", None)


QUERIES = [
    "select id from s order by a, id",
    "select id, a from s order by a desc, v, id",
    "select id, f from s order by f, id",
    "select id, f from s order by f desc, id",
    "select id, s from s order by s, id",
    "select id, s from s order by s desc, v desc, id",
    "select a, v from s order by a, v",          # ties: stability
    "select id from s order by v % 7, a desc, id",
]


@pytest.mark.parametrize("i", range(len(QUERIES)))
def test_sql_sort_matches_reference(kits, i):
    ref, port = kits
    sql = QUERIES[i]
    m = port.domain.metrics
    n0 = m.get("sort_device", 0)
    got = port.must_query(sql)._norm()
    assert m.get("sort_device", 0) == n0 + 1, f"query {i} not on the device"
    assert m.get("sort_device_error", 0) == 0
    assert got == ref.must_query(sql)._norm(), sql


def test_sql_sort_external_spill_matches_reference(kits):
    """The spilled external sort: the device permutation drives the
    disk-gather path too."""
    ref, port = kits
    rng = np.random.RandomState(13)
    for base in range(0, 12000, 3000):
        vals = ",".join(
            f"({base + j},{rng.randint(0, 997)},"
            f"{round(float(rng.uniform(-9, 9)), 4)})"
            for j in range(3000))
        for kit in kits:
            if base == 0:
                kit.must_exec("create table sb (id int primary key, v int, "
                              "f double)")
            kit.must_exec("insert into sb values " + vals)
    sql = "select id, v, f from sb order by v, f desc, id"
    rows = {}
    for name, kit in (("ref", ref), ("port", port)):
        old = kit.sess.vars.get("tidb_mem_quota_query")
        kit.must_exec("set @@tidb_mem_quota_query = 131072")
        try:
            m = kit.domain.metrics
            s0, d0 = m.get("sort_spill_count", 0), m.get("sort_device", 0)
            rows[name] = kit.must_query(sql)._norm()
            assert m.get("sort_spill_count", 0) > s0, name
            assert m.get("sort_device", 0) == d0 + 1, name
        finally:
            kit.must_exec(f"set @@tidb_mem_quota_query = {old}")
    assert rows["port"] == rows["ref"]
    assert len(rows["port"]) == 12000


# ---- guard twin of tests/test_device_guard.py --------------------------

def test_sort_site_grant_loss_identical_order_on_cpu(monkeypatch):
    monkeypatch.setenv("TIDB_TPU_SORT_MIN", "1")
    tk = PortKit(device="cpu")
    tk.must_exec("create table t (a int primary key, b int, c int)")
    tk.must_exec("insert into t values " + ",".join(
        f"({i}, {i % 7}, {i % 13})" for i in range(400)))
    sql = "select a from t order by b desc, c, a"
    failpoint.enable("device_guard/sort", "error:grant_lost")
    rows = tk.must_query(sql).rows
    failpoint.disable_all()
    tk.domain.copr.use_device = False
    assert rows == tk.must_query(sql).rows
    m = tk.domain.metrics
    assert m.get("sort_device_error", 0) >= 1
    assert m.get("sort_device", 0) == 0

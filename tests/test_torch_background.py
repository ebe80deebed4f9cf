"""DXF task framework, timers, TTL (reference pkg/dxf, pkg/timer, pkg/ttl).

The twin of tests/test_background.py on tidb_tpu_torch, with device="cpu" at
every store."""
import time

import pytest

from tidb_tpu_torch.testkit import TestKit
from tidb_tpu_torch.dxf import TaskManager, TaskState
from tidb_tpu_torch.ttl import run_ttl_once


@pytest.fixture(autouse=True)
def _torch_registries():
    """The shared conftest resets tidb_tpu's registries only."""
    from tidb_tpu_torch.utils import device_guard, metrics, phase
    metrics.reset_all()
    device_guard.reset()
    phase.reset()
    yield


def test_dxf_basic():
    tm = TaskManager(total_slots=4)
    results = []
    t = tm.submit("demo", [lambda c, i=i: i * 10 for i in range(6)],
                  concurrency=3)
    assert tm.wait(t, timeout=30)
    assert t.state == TaskState.SUCCEEDED
    assert sorted(t.results()) == [0, 10, 20, 30, 40, 50]


def test_dxf_failure_and_cancel():
    tm = TaskManager()

    def boom(cancel):
        raise ValueError("nope")
    t = tm.submit("bad", [boom])
    assert tm.wait(t, timeout=30)
    assert t.state == TaskState.FAILED
    assert "nope" in t.error

    import threading
    started = threading.Event()

    def slow(cancel):
        started.set()
        cancel.wait(20)
        return "done"
    t2 = tm.submit("slow", [slow])
    started.wait(10)
    tm.cancel(t2.id)
    assert tm.wait(t2, timeout=30)


def test_ttl():
    tk = TestKit(device="cpu")
    tk.must_exec("create table ev (id int primary key, created datetime) "
                 "ttl = created + interval 1 day")
    tk.must_exec("insert into ev values "
                 "(1, '2000-01-01 00:00:00'), (2, '2099-01-01 00:00:00')")
    tbl = tk.domain.infoschema().table_by_name("test", "ev")
    assert tbl.ttl == {"col": "created", "value": 1, "unit": "day",
                       "enable": True}
    deleted = run_ttl_once(tk.domain)
    assert deleted == 1
    tk.must_query("select id from ev").check([(2,)])


def test_auto_analyze():
    tk = TestKit(device="cpu")
    tk.must_exec("create table aa (a int)")
    tk.must_exec("insert into aa values " + ",".join(
        f"({i})" for i in range(100)))
    n = tk.domain.auto_analyze_once()
    assert n >= 1
    tbl = tk.domain.infoschema().table_by_name("test", "aa")
    ts = tk.domain.stats.get(tbl.id)
    assert ts is not None and ts.row_count == 100
    # fresh stats: no re-run
    assert tk.domain.auto_analyze_once() == 0


def test_durable_task_resume(tmp_path):
    """DXF checkpoint/resume (reference dxf/framework/storage): task +
    subtask rows persist in system tables; after a restart only
    not-yet-succeeded subtasks re-run."""
    from tidb_tpu_torch.session import new_store, Session
    from tidb_tpu_torch.dxf.framework import register_task_type

    runs = []

    def planner(domain, meta):
        def mk(i):
            def fn(cancel):
                runs.append((meta, i))
                return i
            return fn
        return [mk(i) for i in range(4)]
    register_task_type("bg_demo", planner)

    d = str(tmp_path / "data")
    dom = new_store(d, device="cpu")
    t = dom.durable_tasks.submit("bg_demo", "t1")
    assert dom.dxf.wait(t, 10)
    assert t.state.value == "succeeded"
    assert sorted(runs) == [("t1", i) for i in range(4)]

    # simulate a crash mid-task: persisted running task, 2 subtasks done
    s = Session(dom)
    s.vars.current_db = "mysql"
    s.execute("insert into tidb_global_task values "
              "(99, 'k99', 'bg_demo', 'running', 't2', 2)")
    for i, st in ((0, "succeeded"), (1, "succeeded"),
                  (2, "pending"), (3, "pending")):
        s.execute(f"insert into tidb_background_subtask values "
                  f"({99000 + i}, 99, {i}, '{st}')")
    dom.storage.mvcc.wal.close()

    runs.clear()
    dom2 = new_store(d, device="cpu")
    resumed = dom2.durable_tasks.resume_all()
    for t2 in resumed:
        assert dom2.dxf.wait(t2, 10)
    assert sorted(runs) == [("t2", 2), ("t2", 3)]
    s2 = Session(dom2)
    s2.vars.current_db = "mysql"
    assert s2.execute("select state from tidb_global_task "
                      "where id = 99").rows == [("succeeded",)]

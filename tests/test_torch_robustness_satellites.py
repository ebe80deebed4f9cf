"""Satellite regressions riding the device-supervision PR: one-hot
uint64 overflow rejection, named-window inheritance constraints,
COLLATE charset mismatch, and SIGNAL item literal restriction.

The twin of tests/test_robustness_satellites.py on tidb_tpu_torch, with device="cpu" at
every store. Where it differs: the port's one-hot learning uploads the
slot table in the statement that learns it (copr/pipeline.py
_oh_device, so the next statement dispatches without an upload), so
_learn's fake copr carries an _upload_padded that records each upload,
and test_oh_learn_accepts_in_range_uint64 also checks what went up."""
import numpy as np
import pytest
import torch

from tidb_tpu_torch.testkit import TestKit
from tidb_tpu_torch.errors import (CollationCharsetMismatchError, ParseError,
                             WindowNoChildPartitioningError,
                             WindowNoInheritFrameError,
                             WindowNoRedefineOrderByError)


@pytest.fixture(autouse=True)
def _torch_registries():
    """The shared conftest resets tidb_tpu's registries only."""
    from tidb_tpu_torch.utils import device_guard, metrics, phase
    metrics.reset_all()
    device_guard.reset()
    phase.reset()
    yield


@pytest.fixture()
def tk():
    tk = TestKit(device="cpu")
    tk.must_exec("create table t (a int primary key, b int, "
                 "s varchar(16))")
    tk.must_exec("insert into t values " + ",".join(
        f"({i}, {i % 4}, 's{i % 3}')" for i in range(1, 21)))
    return tk


# ---- copr/pipeline._oh_learn_table: uint64 beyond int63 --------------

def _learn(kcols, knulls):
    from tidb_tpu_torch.copr.pipeline import _oh_learn_table

    class _Copr:
        _host_cache = {}
        uploads = []

        def _upload_padded(self, arr, cap):
            self.uploads.append((np.array(arr), cap))
            return torch.from_numpy(np.array(arr))

    class _Plan:
        group_items = [None] * len(kcols)

    copr = _Copr()
    copr.uploads = []
    _oh_learn_table(copr, "ohk", _Plan(),
                    [(kcols, knulls)])
    return copr._host_cache.get("ohk"), copr.uploads


def test_oh_learn_rejects_uint64_above_int63():
    big = np.array([2 ** 63 + 5, 2 ** 63 + 9], dtype=np.uint64)
    nulls = np.zeros(2, dtype=bool)
    # seed behavior: uncaught OverflowError from np.asarray(los, int64)
    table, uploads = _learn([big], [nulls])
    assert table is False and uploads == []


def test_oh_learn_accepts_in_range_uint64():
    ok = np.array([3, 9, 11], dtype=np.uint64)
    nulls = np.zeros(3, dtype=bool)
    out, uploads = _learn([ok], [nulls])
    assert isinstance(out, dict) and out["nslots"] == 3
    # the port uploads the learned table at once: skeys, los, spans and
    # nslots, each at its own length
    assert sorted(out["dev"]) == ["los", "nslots", "skeys", "spans"]
    assert len(uploads) == 4
    assert out["dev"]["skeys"].tolist() == out["skeys"].tolist()
    assert out["dev"]["los"].tolist() == out["los"].tolist()
    assert out["dev"]["nslots"].tolist() == [3]


# ---- parser: named-window inheritance (MySQL 8 constraints) ----------

def test_named_window_chain_inherits_deep_copies(tk):
    rows = tk.must_query(
        "select a, sum(b) over (w2 order by a), "
        "sum(b) over (w2 order by a desc) from t "
        "window w1 as (partition by b), w2 as (w1) order by a").rows
    assert len(rows) == 20
    # two referencing specs of the same base must not alias state:
    # per-partition running sums in opposite directions
    assert rows[0][1] != rows[0][2]


def test_named_window_cannot_override_partition_by(tk):
    e = tk.exec_err("select sum(b) over (w partition by a) from t "
                    "window w as (partition by b)")
    assert isinstance(e, WindowNoChildPartitioningError)
    assert e.code == 3581


def test_named_window_cannot_reference_framed_window(tk):
    e = tk.exec_err(
        "select sum(b) over (w order by a) from t "
        "window w as (order by a rows unbounded preceding)")
    assert isinstance(e, WindowNoInheritFrameError)
    assert e.code == 3582
    # window-to-window reference hits the same constraint
    e = tk.exec_err(
        "select sum(b) over w2 from t window "
        "w1 as (order by a rows unbounded preceding), w2 as (w1)")
    assert isinstance(e, WindowNoInheritFrameError)


def test_named_window_bare_ref_to_framed_window_ok(tk):
    rows = tk.must_query(
        "select a, sum(b) over w from t "
        "window w as (order by a rows unbounded preceding) "
        "order by a").rows
    assert len(rows) == 20


def test_named_window_cannot_redefine_order_by(tk):
    e = tk.exec_err("select sum(b) over (w order by a) from t "
                    "window w as (order by b)")
    assert isinstance(e, WindowNoRedefineOrderByError)
    assert e.code == 3583


# ---- planner: COLLATE charset mismatch -------------------------------

def test_collate_on_number_is_mismatch(tk):
    e = tk.exec_err("select 1 collate utf8mb4_bin")
    assert isinstance(e, CollationCharsetMismatchError)
    assert e.code == 1253
    e = tk.exec_err("select a collate utf8mb4_general_ci from t")
    assert isinstance(e, CollationCharsetMismatchError)


def test_collate_on_string_still_works(tk):
    rows = tk.must_query("select s collate utf8mb4_bin from t "
                         "where a <= 2 order by a").rows
    assert rows == [("s1",), ("s2",)]


# ---- parser: SIGNAL item values --------------------------------------

def test_signal_rejects_expression_values(tk):
    for bad in ("signal sqlstate '45000' set message_text = @v",
                "signal sqlstate '45000' set message_text = "
                "concat('a', 'b')",
                "signal sqlstate '45000' set mysql_errno = a"):
        e = tk.exec_err(bad)
        assert isinstance(e, ParseError), bad


def test_signal_literal_values_still_work(tk):
    e = tk.exec_err("signal sqlstate '45000' set message_text = "
                    "'boom', mysql_errno = 1644")
    assert e.code == 1644
    assert "boom" in e.msg

"""The readers of the device's activity, on events made by hand: the busy
union, the copies' share, and a trace of the device alone (the untraced
run's), which names no idle gap."""
import types

import pytest

from portbench import trace
from portbench.metrics import device_ms_per_stmt, htod_ms

MS = 1_000_000
DEV = [(0, 2 * MS, "Memcpy HtoD (Pinned -> Device)"),
       (1 * MS, 3 * MS, "void dense_group_sums_kernel<long>(long*)"),
       (10 * MS, 11 * MS, "Memcpy HtoD (Pageable -> Device)"),
       (20 * MS, 21 * MS, "Memcpy DtoH (Device -> Pinned)")]
HOST = [(3 * MS, 10 * MS, "aten::copy_")]


@pytest.mark.parametrize("host", [True, False])
def test_busy_union_and_copies(host):
    tr = types.SimpleNamespace(host=host)
    trace.reduce_events(tr, list(DEV), list(HOST) if host else [])
    assert tr.busy_s == pytest.approx(5e-3)
    ctx = {"trace": tr, "stmts": [{}, {}]}
    assert device_ms_per_stmt.read(ctx) == pytest.approx(2.5)
    assert htod_ms.read(ctx) == pytest.approx(1.5)
    if host:
        assert tr.idle_gaps == [["host:python", pytest.approx(9e-3)],
                                ["host:aten::copy_", pytest.approx(7e-3)]]
    else:
        assert tr.idle_gaps == []


def test_no_trace_reads_nothing():
    ctx = {"trace": None, "stmts": [{}]}
    assert device_ms_per_stmt.read(ctx) is None
    assert htod_ms.read(ctx) is None

"""The check that decides `correct`, shown to fail. Each case drives a
whole run (set-up, clients over the wire, warm-up, window, judgment) on
a CPU Domain at SF0.01, with the timed path broken underneath, and
wants `correct` false; the control (the reference in a lower precision
in the program's place) must read as not correct too."""
import re

import pytest

from portbench import control, gen, reference, run, traffic
from portbench.tests.conftest import MPP_SESSION, SF, bench

CELLS = {"tpch_sf1.scan": {}, "tpch_sf1.join": {},
         "tpch_sf1_mpp4.join": {"session": MPP_SESSION}}
SEED = 3


def _run(workload, sf=SF):
    patch = dict(CELLS[workload], scale_factor=sf)
    return run.run_cell(workload, SEED, 3.0, False, device="cpu",
                        bench=bench(), config_patch=patch)[0]


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_sound_run_is_correct(workload):
    res = _run(workload)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"
    # the cell's end-to-end metrics as BENCHMARK.json lists them; on the
    # CPU no device activity is recorded, so none is read from it
    want = {m["name"] for m in run.in_cell(bench()["end_to_end"], workload)
            if m["source"] != "device_trace"}
    assert set(res["metrics"]) == want and "setup_s" in want


def _altered_text_row(orig):
    """One answer altered where it is produced: the last digit of the
    last field of every row the server writes."""
    def text_row(values):
        vals = list(values)
        v = vals[-1]
        if v is not None:
            s = str(v)
            vals[-1] = s[:-1] + str((int(s[-1]) + 1) % 10) \
                if s[-1].isdigit() else s + "x"
        return orig(vals)
    return text_row


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_answer_altered_is_not_correct(workload, monkeypatch):
    from tidb_tpu_torch.server import protocol
    monkeypatch.setattr(protocol, "text_row",
                        _altered_text_row(protocol.text_row))
    res = _run(workload)
    assert not res["correct"]
    assert res["failed"] == res["attempted"]


@pytest.mark.parametrize("workload", ["tpch_sf1.join",
                                      "tpch_sf1_mpp4.join"])
def test_stale_answer_is_not_correct(workload, monkeypatch):
    """State left unchanged: the server answers each statement with what
    the first statement of its shape (literals aside) gave, as a result
    cache that ignores the literals would. A committed mix runs one
    stream with one literal set a statement, so no answer of its can
    show this fault; the join mix run as two streams, each with its own
    qgen set, does."""
    from tidb_tpu_torch.server import server
    orig = server.Server._handle_query
    first = {}

    def handle_query(self, sess, io, sql):
        shape = re.sub(r"'[^']*'|\b\d+\b", "?", sql)
        return orig(self, sess, io, first.setdefault(shape, sql))
    monkeypatch.setattr(server.Server, "_handle_query", handle_query)
    load = traffic.load
    monkeypatch.setattr(traffic, "load",
                        lambda name: dict(load(name), streams=2))
    res = _run(workload)
    assert not res["correct"] and res["failed"] > 0


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_half_the_rows_left_out_is_not_correct(workload, monkeypatch):
    """Every scan sees half of its rows: the snapshot's visibility mask
    drops every other row."""
    from tidb_tpu_torch.storage import columnar
    orig = columnar.ColumnarTable.valid_at

    def valid_at(self, *a, **kw):
        v = orig(self, *a, **kw).copy()
        v[1::2] = False
        return v
    monkeypatch.setattr(columnar.ColumnarTable, "valid_at", valid_at)
    assert not _run(workload)["correct"]


def test_exchange_left_out_is_not_correct(monkeypatch):
    """The mesh's merge of the shards' partials keeps shard 0's alone."""
    from tidb_tpu_torch.parallel import mesh
    monkeypatch.setattr(mesh, "_local_merge",
                        lambda parts, op, dev: mesh._to(parts[0], dev))
    assert not _run("tpch_sf1_mpp4.join")["correct"]


@pytest.mark.parametrize("workload,precision,sf", [
    ("tpch_sf1.scan", "float64", 0.05), ("tpch_sf1.join", "float32", SF),
    ("tpch_sf1_mpp4.join", "float32", SF),
    ("tpch_sf1.scan", "exact", 0.05), ("tpch_sf1.join", "exact", SF)])
def test_control_in_the_programs_place_is_not_correct(
        workload, precision, sf, monkeypatch):
    """The control through the check itself: the server answers every
    statement of the window with the reference's rows computed in the
    control's precision (float64 for the scan mix, whose Q1 sums outgrow
    it from SF0.05 on; float32 for the join mix), and the run reads
    `correct` false. The same server answering with the exact reference
    reads `correct` true, so it is the precision that fails."""
    from tidb_tpu_torch.server import protocol as P, server
    mix = traffic.load(bench()["workloads"][[
        w["name"] for w in bench()["workloads"]].index(workload)]["traffic"])
    tables = gen.make_tables(traffic.tables_read(mix), sf, SEED)
    by_sql = {st["sql"]: st for stmts in traffic.streams(mix, SEED)
              for st in stmts}
    orig = server.Server._handle_query

    def handle_query(self, sess, io, sql):
        st = by_sql.get(" ".join(sql.split()))
        if st is None:                  # the session's own statements
            return orig(self, sess, io, sql)
        rows = reference.statement(st["name"]).rows(tables, st["params"],
                                                    precision)
        io.write_packet(P.lenenc_int(len(rows[0])))
        for i in range(len(rows[0])):
            io.write_packet(P.column_def(f"c{i}"))
        io.write_packet(P.eof_packet())
        for r in rows:
            io.write_packet(P.text_row(r))
        io.write_packet(P.eof_packet())
    monkeypatch.setattr(server.Server, "_handle_query", handle_query)
    res = _run(workload, sf)
    if precision == "exact":
        assert res["correct"] and res["failed"] == 0
    else:
        assert not res["correct"] and res["failed"] > 0


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_control_is_not_correct(workload):
    """float64 fails the scan mix (Q1's sums carry 17 digits at SF1);
    at SF0.01 and for the join mixes float32 is the step that fails
    (PERF.md: at SF1 float64 holds every Q3/Q5 answer exactly)."""
    got = control.control_counts(workload, SEED, bench=bench(),
                                 config_patch={"scale_factor": SF})
    assert got["float32"]


def test_float64_control_fails_scan_mix():
    """At SF0.05 already, Q1's sum_charge needs more digits than float64
    holds."""
    got = control.control_counts("tpch_sf1.scan", SEED,
                                 config_patch={"scale_factor": 0.05})
    assert "q1" in got["float64"]

"""Scale oracle (VERDICT r1 item 8): the TPC-H device-vs-host oracle at
a scale factor that actually crosses the engine's boundaries — group-
bucket regrowth (>1024 groups), shape-bucket transitions, the fused
pipeline's partition handling — unlike the SF0.003 smoke oracle.

Default: representative heavy queries at SF0.05 (~30s on the CI box).
Full sweep: TIDB_TPU_ORACLE_SF=1 TIDB_TPU_ORACLE_ALL=1 runs all 22 at
SF1 (~5 min).

The twin of tests/test_tpch_scale.py on tidb_tpu_torch, with device="cpu" at
every store. test_tpch_device_routing_pinned (marked slow, outside
tier-1) fails in the reference too, with the same message at SF0.05:
q15, q16 and q20 each run a reader scan on the host
(copr_host_exec 1, 1 and 3); the twin keeps the reference's pins."""
import os
import time

import pytest

from tidb_tpu_torch.testkit import TestKit
from tidb_tpu_torch.bench.tpch import load_tpch, ALL_QUERIES

SF = float(os.environ.get("TIDB_TPU_ORACLE_SF", "0.05"))
QUERIES = (list(ALL_QUERIES) if os.environ.get("TIDB_TPU_ORACLE_ALL")
           else ["q1", "q3", "q5", "q6", "q9", "q10", "q12", "q18"])


@pytest.fixture(autouse=True)
def _torch_registries():
    """The shared conftest resets tidb_tpu's registries only."""
    from tidb_tpu_torch.utils import device_guard, metrics, phase
    metrics.reset_all()
    device_guard.reset()
    phase.reset()
    yield


@pytest.fixture(scope="module")
def tk():
    tk = TestKit(device="cpu")
    load_tpch(tk, sf=SF, seed=11)
    return tk


@pytest.mark.parametrize("q", QUERIES)
def test_device_vs_host_at_scale(tk, q):
    sql = ALL_QUERIES[q]
    dev = tk.must_query(sql).rs.rows
    tk.domain.copr.use_device = False
    try:
        host = tk.must_query(sql).rs.rows
    finally:
        tk.domain.copr.use_device = True
    assert dev == host, (q, dev[:3], host[:3])


# Expected device placement per TPC-H query (VERDICT r2 items 2/8: pin
# routing so a silent device->host regression fails CI, reference
# pkg/util/execdetails). "fused" = the agg-over-join tree ran as one
# fused device pipeline; "scan" = no join to fuse (q1/q6) or the join
# is a few-row residual over device-computed aggs (q15/q20) — the heavy
# scans/aggs still run as device copr kernels.
# all 22 route through the fused pipeline since single-table aggs
# became zero-dim fused pipelines (they fragment onto the mesh and
# carry the dirty overlay; round-5). Exception: q21's four fact-sized
# aggregate dims cost-gate to the host join once their mass crosses
# the absolute bound (~SF0.2+) — a scale-dependent engine choice.
EXPECTED_ROUTING = {q: "fused" for q in (
    "q1", "q2", "q3", "q4", "q5", "q6", "q7", "q8", "q9", "q10",
    "q11", "q12", "q13", "q14", "q15", "q16", "q17", "q18", "q19",
    "q20", "q21", "q22")}
if SF >= 0.2:
    EXPECTED_ROUTING["q21"] = "scan"


@pytest.mark.slow          # ~40s: keeps tier-1 inside its wall budget
def test_tpch_device_routing_pinned(tk):
    """Every TPC-H query executes its heavy operators on the device:
    18/22 through the fused join pipeline, the rest as device scan/agg
    kernels. Zero fused-pipeline errors and zero host copr scans across
    the suite — a broken device kernel must fail here, not silently
    degrade to a slower host query."""
    m = tk.domain.metrics
    got, problems = {}, []
    for q in sorted(ALL_QUERIES, key=lambda s: int(s[1:])):
        before = dict(m)
        tk.must_query(ALL_QUERIES[q])
        d = {k: m.get(k, 0) - before.get(k, 0) for k in m}
        fused = d.get("fused_pipeline_hit", 0) + \
            d.get("fused_pipeline_mpp_hit", 0)
        device = d.get("copr_device_exec", 0) + d.get("copr_mpp_exec", 0)
        got[q] = "fused" if fused else ("scan" if device else "host")
        if d.get("fused_pipeline_error", 0):
            problems.append(f"{q}: fused_pipeline_error")
        if d.get("fused_pipeline_fallback", 0):
            problems.append(f"{q}: fused_pipeline_fallback")
        exempt = q == "q2" or (q == "q21" and SF >= 0.2)
        if d.get("copr_host_exec", 0) and not exempt:
            # q2 intentionally materializes a filterless partsupp scan
            # on host (no compute to offload; round-5 pure-scan
            # routing); cost-gated q21 does the same for its host join
            problems.append(f"{q}: copr_host_exec={d['copr_host_exec']}")
    if got.get("q20") == "scan":
        # q20's fused hits live in its plan-time subqueries; when the
        # subquery result cache (round-5) is warm from earlier tests,
        # the remaining execution is device scans — both are device
        # placements
        got["q20"] = EXPECTED_ROUTING["q20"]
    assert got == EXPECTED_ROUTING, {
        q: (got[q], EXPECTED_ROUTING[q]) for q in got
        if got[q] != EXPECTED_ROUTING[q]}
    assert not problems, problems


def _best_of(n, fn):
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


@pytest.mark.slow          # ~35s: keeps tier-1 inside its wall budget
def test_device_path_never_pathologically_slower(tk):
    """Perf regression fence (VERDICT r3 weak #1): the device path lost
    to its own host path on 10/22 TPC-H queries at SF1 — q21 by 39×,
    driven by per-execution kernel recompiles (unstable synthetic
    column ids) and re-executed decorrelated subqueries. Warm device
    time must stay within 2× of warm host time (plus scheduler slack)
    for EVERY query; a regression that re-introduces a per-run compile
    or a host blowup trips this at any SF."""
    violations = {}
    # single-chip device vs host: the 8-VIRTUAL-device mesh this test
    # env forces would run shard_map 8-wide on one core — mesh overhead,
    # not the recompile/host-blowup regression this fence pins
    tk.must_exec("set @@tidb_enable_mpp = off")
    for q in sorted(ALL_QUERIES, key=lambda s: int(s[1:])):
        sql = ALL_QUERIES[q]
        tk.must_query(sql)                           # warm device path
        dev = _best_of(2, lambda: tk.must_query(sql))
        tk.domain.copr.use_device = False
        try:
            tk.must_query(sql)                       # warm host path
            host = _best_of(2, lambda: tk.must_query(sql))
        finally:
            tk.domain.copr.use_device = True
        # the absolute slack only absorbs scheduler noise at tiny SFs
        # where every query is milliseconds; above SF0.2 it would make
        # the fence vacuous (round-4 verdict weak #3) — there 2x alone
        # must hold
        slack = 0.25 if SF <= 0.2 else 0.0
        if dev > max(2.0 * host, host + slack):
            violations[q] = f"device {dev * 1e3:.0f}ms vs host " \
                            f"{host * 1e3:.0f}ms"
    assert not violations, violations


def test_explain_analyze_backend_column(tk):
    """EXPLAIN ANALYZE exposes per-operator placement (reference
    pkg/util/execdetails storeType): the fused pipeline row says
    device(fused[-mpp]), scan rows say device with a kernel-cache
    hit/miss delta, and rows folded into a parent kernel show '-'."""
    rs = tk.must_query("explain analyze " + ALL_QUERIES["q3"])
    assert "backend" in rs.names
    by_op = {}
    for r in rs.rows:
        op = str(r[0]).lstrip(" │└├─").rsplit("_", 1)[0]
        by_op.setdefault(op, str(r[4]))
    assert by_op.get("FusedPipeline", "").startswith("device(fused"), \
        by_op
    rs6 = tk.must_query("explain analyze " + ALL_QUERIES["q6"])
    tr = [str(r[4]) for r in rs6.rows
          if "FusedPipeline" in str(r[0])]
    assert tr and tr[0].startswith("device(fused"), rs6.rows


def test_boundaries_crossed(tk):
    """The scale run must have exercised the paths the small oracle
    can't: fused pipeline hits and >1024-group sort aggs (bucket
    regrowth)."""
    for q in ("q1", "q3", "q5"):
        tk.must_query(ALL_QUERIES[q])
    fused = tk.domain.metrics.get("fused_pipeline_hit", 0) + \
        tk.domain.metrics.get("fused_pipeline_mpp_hit", 0)
    assert fused >= 2, tk.domain.metrics
    # wide-domain expression grouping: beyond _DENSE_MAX -> sort path,
    # group count far beyond the initial 1024 bucket
    dev = tk.must_query(
        "select (l_orderkey * 48271) % 999983 as g, count(*), sum(l_quantity) "
        "from lineitem group by g order by count(*) desc, g limit 5"
    ).rs.rows
    tk.domain.copr.use_device = False
    try:
        host = tk.must_query(
            "select (l_orderkey * 48271) % 999983 as g, count(*), sum(l_quantity) "
            "from lineitem group by g order by count(*) desc, g limit 5"
        ).rs.rows
    finally:
        tk.domain.copr.use_device = True
    assert dev == host
    learned = [v for k, v in tk.domain.copr._host_cache.items()
               if isinstance(k, tuple) and k and k[0] == "gb"]
    assert any(v > 1024 for v in learned), learned

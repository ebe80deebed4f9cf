"""All 22 TPC-H queries through the reference package and the port at
SF0.05 on the CPU: rows equal as strings, and the port's fused
fragments counted against the reference's. The port runs twice: under
its CPU policy (group-bys the dense layouts do not take lower as
"scatter") and under the card's ("runs": _FORCE_SEGMENT_IMPL, which
also sends dense and posdense domains over 64 slots to the runs
lowering, as on the H100). The reference runs once, under its CPU
policy, and its rows are computed once for the module.

Q20 returns no row at SF0.01 or SF0.05 (no CANADA supplier passes), so
its comparison proves little: Q20_ALL_NATIONS, Q20 without its nation
predicate, returns rows here and runs first, so its IN-subquery is the
one that runs fused (Q20 then reuses that subquery's result, in both
packages).

Q13, Q17 and Q21 hold materialized (subplan) dimensions, which both
packages fuse: the same fused fragments, no decline, no fallback."""
import pytest

from tidb_tpu.testkit import TestKit as RefKit
from tidb_tpu.bench import tpch as ref_tpch
from tidb_tpu_torch.testkit import TestKit as PortKit
from tidb_tpu_torch.bench import tpch as port_tpch
import tidb_tpu_torch.copr.dag_exec as pde
from tidb_tpu_torch.copr import pipeline
from tidb_tpu_torch.utils import phase as port_phase

SF, SEED = 0.05, 7
ORDER = [q for q in port_tpch.ALL_QUERIES if q != "q20"] + \
    ["q20_all_nations", "q20"]
COUNTERS = ("fused_pipeline_hit", "fused_pipeline_fallback",
            "fused_pipeline_error")


def _sql(q):
    return port_tpch.Q20_ALL_NATIONS if q == "q20_all_nations" else \
        port_tpch.ALL_QUERIES[q]


@pytest.fixture(autouse=True)
def _torch_registries():
    """The shared conftest resets tidb_tpu's registries only."""
    from tidb_tpu_torch.utils import metrics, device_guard
    metrics.reset_all()
    device_guard.reset()
    port_phase.reset()
    yield


@pytest.fixture(scope="module")
def reference():
    """{query: (rows, fused fragments)} from the reference, in ORDER."""
    ref = RefKit()
    ref_tpch.load_tpch(ref, sf=SF, seed=SEED)
    m = ref.domain.metrics
    out = {}
    for q in ORDER:
        # the reference counts a fragment it ran on its device mesh apart
        f0 = m.get("fused_pipeline_hit", 0) + \
            m.get("fused_pipeline_mpp_hit", 0)
        rows = ref.must_query(_sql(q))._norm()
        out[q] = (rows, m.get("fused_pipeline_hit", 0) +
                  m.get("fused_pipeline_mpp_hit", 0) - f0)
    assert out["q20"][0] == [] and len(out["q20_all_nations"][0]) > 0
    return out


@pytest.fixture(scope="module", params=[None, "runs"],
                ids=["cpu_policy", "runs_policy"])
def port(request):
    kit = PortKit(device="cpu")
    port_tpch.load_tpch(kit, sf=SF, seed=SEED)
    return request.param, kit


@pytest.mark.parametrize("q", ORDER)
def test_tpch_query_equals_reference(reference, port, q, monkeypatch):
    policy, kit = port
    monkeypatch.setattr(pde, "_FORCE_SEGMENT_IMPL", policy)
    reasons, set_reason = [], pipeline._set_reason
    monkeypatch.setattr(pipeline, "_set_reason", lambda copr, msg: (
        reasons.append(msg), set_reason(copr, msg)))
    m = kit.domain.metrics
    m0 = {c: m.get(c, 0) for c in COUNTERS}
    got = kit.must_query(_sql(q))._norm()
    d = {c: m.get(c, 0) - m0[c] for c in COUNTERS}
    want, ref_fused = reference[q]
    assert got == want
    assert d["fused_pipeline_error"] == 0
    assert d["fused_pipeline_hit"] == ref_fused
    assert d["fused_pipeline_fallback"] == 0
    assert not [r for r in reasons if r.startswith("not yet ported")], \
        reasons

"""All 22 TPC-H queries at SF0.05 on the CPU under the card's policy
with the three learned programs of the fused pipeline on: the runs
lowering (_FORCE_SEGMENT_IMPL = "runs") and the one-hot slot table
(TIDB_TPU_ONEHOT_FORCE, which the card does not need). Each query runs
cold (it learns) and warm (it runs what it learned); both statements'
rows equal the reference's (its CPU policy, as in
tests/test_torch_tpch22.py), and the queries whose warm statement took
each program are the ones written down here:

  early compaction   fact filters keep <= 1/8 of lineitem or orders in
                     front of a probe (fused_ecap_run)
  top-N candidates   ORDER BY ... LIMIT over a group-by anchored on a
                     clustered fact column (fused_topn_cand)
  one-hot slots      a group domain neither dense nor a join position
                     under count and int64 sum/avg (fused_onehot_agg)

Q20 returns no row at SF0.05, so Q20_ALL_NATIONS runs first (see
tests/test_torch_tpch22.py)."""
import pytest

from tidb_tpu.testkit import TestKit as RefKit
from tidb_tpu.bench import tpch as ref_tpch
from tidb_tpu_torch.testkit import TestKit as PortKit
from tidb_tpu_torch.bench import tpch as port_tpch
import tidb_tpu_torch.copr.dag_exec as pde
from tidb_tpu_torch.utils import phase as port_phase

SF, SEED = 0.05, 7
ORDER = [q for q in port_tpch.ALL_QUERIES if q != "q20"] + \
    ["q20_all_nations", "q20"]
PROGRAMS = {"ecap": "fused_ecap_run", "topn": "fused_topn_cand",
            "onehot": "fused_onehot_agg"}
# the warm statements that take each program at SF0.05, seed 7
EXPECTED = {
    # selective date / mode / brand filters on lineitem (Q12, Q14,
    # Q19), a quarter of orders (Q4), the country codes and balance of
    # customer (Q22)
    "ecap": {"q4", "q12", "q14", "q19", "q22"},
    # l_orderkey is the clustered anchor of Q3's group; Q10 and Q18
    # group by dim columns only, so no anchor
    "topn": {"q3"},
    # small group domains of the sort kind: nation pairs and years (Q7,
    # Q8, Q9), Q10's and Q18's few customers, Q11's parts, Q13's order
    # counts, Q15's suppliers, Q16's brand/type/size/supplier, Q21's
    # supplier names
    "onehot": {"q7", "q8", "q9", "q10", "q11", "q13", "q15", "q16",
               "q18", "q21"},
}
# the statements whose rerun counters may rise (a cold statement
# learning); a warm statement reruns nothing
RERUNS = ("fused_compact_regrow", "fused_topn_off", "fused_onehot_miss",
          "fused_bucket_regrow", "fused_runs_degrade")


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
    """{query: rows} from the reference, in ORDER."""
    ref = RefKit()
    ref_tpch.load_tpch(ref, sf=SF, seed=SEED)
    return {q: ref.must_query(_sql(q))._norm() for q in ORDER}


@pytest.fixture(scope="module")
def port():
    kit = PortKit(device="cpu")
    port_tpch.load_tpch(kit, sf=SF, seed=SEED)
    return kit


@pytest.mark.parametrize("q", ORDER)
def test_tpch_programs_equal_reference(reference, port, q, monkeypatch):
    kit = port
    monkeypatch.setattr(pde, "_FORCE_SEGMENT_IMPL", "runs")
    monkeypatch.setenv("TIDB_TPU_ONEHOT_FORCE", "1")
    m = kit.domain.metrics
    for run in ("cold", "warm"):
        m0 = dict(m)
        got = kit.must_query(_sql(q))._norm()
        assert got == reference[q], run
        d = {c: m.get(c, 0) - m0.get(c, 0)
             for c in list(PROGRAMS.values()) + list(RERUNS)}
        if run == "warm":
            assert not any(d[c] for c in RERUNS), d
    took = {p for p, c in PROGRAMS.items() if d[c]}
    assert took == {p for p, qs in EXPECTED.items() if q in qs}, took

"""Materialized (subplan) dimensions of the fused pipeline
(tidb_tpu_torch/copr/pipeline.py: _materialized_dim_meta) against the
reference package: TPC-H Q13, Q17 and Q21 at SF0.05 on the CPU, rows
equal as strings and the same fused fragments, under the port's CPU
policy and the card's ("runs"); the byte-bounded cache of subplan
results across statements (a second statement does not run the
subplan; a committed DML to a base table invalidates it; a dirty
transaction neither reads nor fills it; the bound evicts the least
recently used); each decline of _materialized_dim_meta, function by
function against the reference's; and the dictionary tables of string
ops (expression/vec.py), which Q9's LIKE over p_name builds once, not
once a statement."""
from types import SimpleNamespace

import numpy as np
import pytest

from tidb_tpu.testkit import TestKit as RefKit
from tidb_tpu.bench import tpch as ref_tpch
import tidb_tpu.copr.pipeline as rpl
import tidb_tpu.executor.builder as rbuilder
from tidb_tpu.chunk.chunk import Chunk as RefChunk
from tidb_tpu.chunk.column import Column as RefCol
from tidb_tpu.chunk.device import StringDict as RefDict
from tidb_tpu.types.field_type import new_bigint_type as ref_bigint

from tidb_tpu_torch.testkit import TestKit as PortKit
from tidb_tpu_torch.bench import tpch as port_tpch
import tidb_tpu_torch.copr.dag_exec as pde
import tidb_tpu_torch.copr.pipeline as ppl
import tidb_tpu_torch.executor.builder as pbuilder
from tidb_tpu_torch.chunk.chunk import Chunk as PortChunk
from tidb_tpu_torch.chunk.column import Column as PortCol
from tidb_tpu_torch.chunk.device import StringDict as PortDict
from tidb_tpu_torch.expression import vec
from tidb_tpu_torch.types.field_type import new_bigint_type as port_bigint
from tidb_tpu_torch.utils import phase as port_phase

SF, SEED = 0.05, 7
FUSED = ("fused_pipeline_hit", "fused_pipeline_fallback",
         "fused_pipeline_error")
MATDIM = ("fused_matdim_build", "fused_matdim_hit")
REF_FUSED = ("fused_pipeline_hit", "fused_pipeline_mpp_hit")


@pytest.fixture(autouse=True)
def _torch_registries():
    """The shared conftest resets tidb_tpu's registries only."""
    from tidb_tpu_torch.utils import metrics, device_guard
    metrics.reset_all()
    device_guard.reset()
    port_phase.reset()
    yield
    pde._FORCE_SEGMENT_IMPL = None


@pytest.fixture(scope="module")
def kits():
    ref = RefKit()
    ref_tpch.load_tpch(ref, sf=SF, seed=SEED)
    port = PortKit(device="cpu")
    port_tpch.load_tpch(port, sf=SF, seed=SEED)
    for kit, tpch in ((ref, ref_tpch), (port, port_tpch)):
        kit.must_exec("create table zz (a int)")
        # first touch: each base table's statistics load (a schema
        # change that re-versions the table), so the tests start warm
        for q in ("q13", "q17", "q21"):
            kit.must_query(tpch.ALL_QUERIES[q])
    return ref, port


def _delta(kit, sql, names):
    m = kit.domain.metrics
    m0 = {c: m.get(c, 0) for c in names}
    rows = kit.must_query(sql)._norm()
    return rows, {c: m.get(c, 0) - m0[c] for c in names}


def _clear(copr):
    for ck, ent in list(ppl._matdim_cache(copr).items()):
        ppl._matdim_drop(copr, ent[2])
    copr._matdim_lru.clear()
    copr._matdim_bytes = 0


@pytest.mark.parametrize("policy", [None, "runs"],
                         ids=["cpu_policy", "runs_policy"])
@pytest.mark.parametrize("q", ["q13", "q17", "q21"])
def test_matdim_query_equals_reference(kits, q, policy, monkeypatch):
    """Cold, then warm: the rows and the fused fragments of each
    statement equal the reference's, no fused node declines or falls
    back, and the warm statement serves every subplan from the cache."""
    ref, port = kits
    monkeypatch.setattr(pde, "_FORCE_SEGMENT_IMPL", policy)
    reasons, set_reason = [], ppl._set_reason
    monkeypatch.setattr(ppl, "_set_reason", lambda copr, msg: (
        reasons.append(msg), set_reason(copr, msg)))
    for kit in kits:
        if hasattr(kit.domain.copr, "_matdim_lru"):
            kit.domain.copr._matdim_lru.clear()
            kit.domain.copr._matdim_bytes = 0
    sql = port_tpch.ALL_QUERIES[q]
    for i in range(2):
        want, ref_d = _delta(ref, ref_tpch.ALL_QUERIES[q], REF_FUSED)
        got, d = _delta(port, sql, FUSED + MATDIM)
        assert got == want
        # the reference counts a fragment it ran on its device mesh apart
        assert d["fused_pipeline_hit"] == sum(ref_d.values()), (i, d, ref_d)
        assert d["fused_pipeline_fallback"] == 0
        assert d["fused_pipeline_error"] == 0
        assert reasons == []
        if i == 0:
            assert d["fused_matdim_build"] >= 1 and \
                d["fused_matdim_hit"] == 0
        else:
            assert d["fused_matdim_build"] == 0 and \
                d["fused_matdim_hit"] >= 1


def test_second_statement_does_not_run_the_subplan(kits, monkeypatch):
    """Q17's per-part average is executed once: the second statement
    finds it in the cache (the same result object) and builds no
    executor for the subplan; neither uploads it again."""
    _, port = kits
    copr = port.domain.copr
    _clear(copr)
    built = []
    real = pbuilder.build_executor
    monkeypatch.setattr(pbuilder, "build_executor", lambda ctx, plan: (
        built.append(plan), real(ctx, plan))[1])
    sql = port_tpch.ALL_QUERIES["q17"]
    _, d = _delta(port, sql, MATDIM)
    assert d == {"fused_matdim_build": 1, "fused_matdim_hit": 0}
    subplans = [dim.subplan for p in built for dim in getattr(p, "dims", ())
                if dim.subplan is not None]
    assert len(subplans) == 1 and subplans[0] in built
    (ck, ent), = copr._matdim_lru.items()
    built.clear()
    port_phase.reset()
    _, d = _delta(port, sql, MATDIM)
    assert d == {"fused_matdim_build": 0, "fused_matdim_hit": 1}
    assert built and subplans[0] not in built
    assert copr._matdim_lru[ck][2] is ent[2]
    assert port_phase.snap().get("upload_bytes", 0) == 0


def test_committed_dml_invalidates_the_cache(kits):
    """A committed insert into lineitem (a base table of Q17's subplan)
    changes the result: the next statement materializes again, and its
    rows equal the reference's after the same insert."""
    ref, port = kits
    sql = port_tpch.ALL_QUERIES["q17"]
    before, _ = _delta(port, sql, MATDIM)
    pk = ref.must_query("select p_partkey from part where p_brand = "
                        "'Brand#23' and p_container = 'MED BOX' "
                        "order by p_partkey limit 1")._norm()[0][0]
    row = (f"insert into lineitem values (1, {pk}, 1, 9, 0.01, 123456.78, "
           "0.05, 0.02, 'N', 'O', '1996-01-02', '1996-02-01', "
           "'1996-02-03', 'NONE', 'AIR', '')")
    for kit in kits:
        kit.must_exec(row)
    want, _ = _delta(ref, ref_tpch.ALL_QUERIES["q17"], ())
    got, d = _delta(port, sql, MATDIM)
    assert got == want and got != before
    assert d == {"fused_matdim_build": 1, "fused_matdim_hit": 0}
    _, d = _delta(port, sql, MATDIM)
    assert d == {"fused_matdim_build": 0, "fused_matdim_hit": 1}


def test_dirty_transaction_bypasses_the_cache(kits):
    """A session whose transaction holds uncommitted writes (to a table
    the query does not read) materializes the subplan itself and leaves
    the cached result in place; after the commit the cache serves
    again."""
    ref, port = kits
    copr = port.domain.copr
    sql = port_tpch.ALL_QUERIES["q17"]
    _delta(port, sql, MATDIM)
    cached = {ck: ent[2] for ck, ent in copr._matdim_lru.items()}
    for kit in kits:
        kit.must_exec("begin")
        kit.must_exec("insert into zz values (1)")
    try:
        want, _ = _delta(ref, ref_tpch.ALL_QUERIES["q17"], ())
        got, d = _delta(port, sql, MATDIM + ("fused_pipeline_hit",))
        assert got == want
        assert d == {"fused_matdim_build": 1, "fused_matdim_hit": 0,
                     "fused_pipeline_hit": 2}
        assert {ck: ent[2] for ck, ent in copr._matdim_lru.items()} == \
            cached
    finally:
        for kit in kits:
            kit.must_exec("commit")
    _, d = _delta(port, sql, MATDIM)
    assert d == {"fused_matdim_build": 0, "fused_matdim_hit": 1}


def test_byte_bound_evicts_least_recently_used(kits, monkeypatch):
    """With room for one result, Q13's materialization evicts Q17's (the
    older), whose device uploads are released; Q17 then materializes
    again and evicts Q13's. The byte count is the entries' sum."""
    _, port = kits
    copr = port.domain.copr
    _clear(copr)
    q13, q17 = port_tpch.ALL_QUERIES["q13"], port_tpch.ALL_QUERIES["q17"]
    _delta(port, q17, MATDIM)
    (ck17, ent17), = copr._matdim_lru.items()
    monkeypatch.setattr(ppl, "_MATDIM_MAX_BYTES", ent17[3] + 1)
    _, d = _delta(port, q13, MATDIM)
    assert d["fused_matdim_build"] == 1
    (ck13, ent13), = copr._matdim_lru.items()
    assert ck13 != ck17
    assert copr._matdim_bytes == ent13[3]
    assert ent17[2]["tbl"].uid not in copr._dev_store._by_uid
    assert ent13[2]["tbl"].uid in copr._dev_store._by_uid
    _, d = _delta(port, q17, MATDIM)
    assert d == {"fused_matdim_build": 1, "fused_matdim_hit": 0}
    assert list(copr._matdim_lru) == [ck17]


# ---- the declines of _materialized_dim_meta, function by function ------

class _Info:
    """A materialized dim's table info: columns by output position."""

    def __init__(self, names):
        self._pos = {n: SimpleNamespace(id=i) for i, n in enumerate(names)}

    def find_column(self, name):
        return self._pos.get(name)


def _dim(names, keys):
    cols = [SimpleNamespace(name=n, col=SimpleNamespace(idx=100 + i))
            for i, n in enumerate(names)]
    by = {c.name: c for c in cols}
    ks = tuple((by.get(k) or SimpleNamespace(name=k), None) for k in keys)
    return SimpleNamespace(
        dag=SimpleNamespace(cols=cols, table_info=_Info(names[:2] if
                                                        "lost" in keys
                                                        else names)),
        subplan=object(), all_keys=lambda: ks)


def _chunks(P, cols_per_chunk):
    """[[(data, nulls, dict name or None), ...] per chunk] -> Chunks; a
    dict name maps to one StringDict per package and name."""
    dicts = {}
    out = []
    for cols in cols_per_chunk:
        cc = []
        for data, nulls, dname in cols:
            sd = None
            if dname is not None:
                sd = dicts.get(dname)
                if sd is None:
                    sd = dicts[dname] = P["Dict"]()
                    sd.encode(np.array(["x", "y", "z"], dtype=object))
            cc.append(P["Col"](P["ft"](), np.asarray(data),
                               None if nulls is None else np.asarray(nulls),
                               sd))
        out.append(P["Chunk"](cc))
    return out


REF = {"Col": RefCol, "Chunk": RefChunk, "Dict": RefDict, "ft": ref_bigint}
PORT = {"Col": PortCol, "Chunk": PortChunk, "Dict": PortDict,
        "ft": port_bigint}
I = np.int64
DECLINES = {
    "no_context": (None, ["k", "v"], ["k"], []),
    "no_rows": (1, ["k", "v"], ["k"], []),
    "non_numeric_column": (1, ["k", "v"], ["k"], [[
        (np.array([1, 2], I), None, None),
        (np.array(["a", "b"], dtype=object), None, None)]]),
    "inconsistent_dicts": (1, ["k", "v"], ["k"], [
        [(np.array([1], I), None, None),
         (np.array([0], np.int32), None, "d1")],
        [(np.array([2], I), None, None),
         (np.array([1], np.int32), None, "d2")]]),
    "key_not_in_output": (1, ["k", "v", "lost"], ["lost"], [[
        (np.array([1, 2], I), None, None), (np.array([3, 4], I), None, None),
        (np.array([5, 6], I), None, None)]]),
    "float_key": (1, ["k", "v"], ["k"], [[
        (np.array([1.5, 2.5]), None, None),
        (np.array([3, 4], I), None, None)]]),
    "dict_key": (1, ["k", "v"], ["k"], [[
        (np.array([0, 1], np.int32), None, "d1"),
        (np.array([3, 4], I), None, None)]]),
    "duplicate_keys": (1, ["k", "v"], ["k"], [
        [(np.array([1, 2], I), None, None), (np.array([3, 4], I), None, None)],
        [(np.array([2], I), None, None), (np.array([5], I), None, None)]]),
    "null_key": (1, ["k", "v"], ["k"], [[
        (np.array([1, 2, 3], I), np.array([False, True, False]), None),
        (np.array([3, 4, 5], I), None, None)]]),
    "direct_lut": (1, ["k", "v"], ["k"], [
        [(np.array([7, 3], I), None, None), (np.array([1, 2], I), None, None)],
        [(np.array([5], I), None, None),
         (np.array([9], I), np.array([True]), None)]]),
    "sorted_keys": (1, ["k", "v"], ["k"], [[
        (np.array([1 << 40, 3, -(1 << 41)], I), None, None),
        (np.array([1, 2, 3], I), None, None)]]),
    "composite_keys": (1, ["k", "j", "v"], ["k", "j"], [[
        (np.array([1, 1, 2], I), None, None),
        (np.array([5, 6, 5], I), None, None),
        (np.array([0, 0, 1], np.int32), None, "d1")]]),
}


def _meta(mod, builder_mod, P, case, monkeypatch):
    ctx_kind, names, keys, chunks = DECLINES[case]
    built = _chunks(P, chunks)
    monkeypatch.setattr(builder_mod, "build_executor", lambda ctx, plan:
                        SimpleNamespace(open=lambda: None,
                                        all_chunks=lambda: built,
                                        close=lambda: None))
    reasons = []
    monkeypatch.setattr(mod, "_set_reason",
                        lambda copr, msg: reasons.append(msg))
    ctx = None if ctx_kind is None else SimpleNamespace(sess=None, sv=None)
    copr = SimpleNamespace(domain=None)
    return mod._materialized_dim_meta(copr, ctx, _dim(names, keys),
                                      None), reasons


@pytest.mark.parametrize("case", sorted(DECLINES))
def test_materialized_dim_meta_equals_reference(case, monkeypatch):
    """Each decline records the reference's reason and returns None; an
    accepted result has the reference's layout (direct LUT or sorted
    keys, packed composite keys), arrays and dictionaries."""
    want, ref_reasons = _meta(rpl, rbuilder, REF, case, monkeypatch)
    got, reasons = _meta(ppl, pbuilder, PORT, case, monkeypatch)
    assert reasons == ref_reasons
    assert (got is None) == (want is None)
    if want is None:
        assert len(reasons) == 1
        return
    for k in ("mode", "lo", "n", "n_sorted", "pack"):
        assert got[k] == want[k], k
    for k in ("lut", "order", "skeys", "valid"):
        if k in want:
            np.testing.assert_array_equal(got[k], want[k])
    assert sorted(got["arrays"]) == sorted(want["arrays"])
    for i, (d, nl, sd) in want["arrays"].items():
        gd, gnl, gsd = got["arrays"][i]
        np.testing.assert_array_equal(gd, d)
        assert (gnl is None) == (nl is None)
        if nl is not None:
            np.testing.assert_array_equal(gnl, nl)
        assert (gsd is None) == (sd is None)
        if sd is not None:
            assert gsd.values == sd.values
    assert isinstance(got["tbl"], ppl._MatTbl)


# ---- Q9's dictionary table --------------------------------------------

def test_q9_like_table_is_built_once(kits):
    """Q9's p_name LIKE '%green%' builds its table over the part-name
    dictionary once: warm statements reuse it. A new part name grows
    the dictionary, and the next statement builds it again; the rows
    equal the reference's throughout."""
    ref, port = kits
    sql = port_tpch.ALL_QUERIES["q9"]
    stats = vec.DICT_TABLE_STATS
    builds = []
    for i in range(3):
        b0 = stats["builds"]
        got = port.must_query(sql)._norm()
        builds.append(stats["builds"] - b0)
        if i == 0:
            assert got == ref.must_query(ref_tpch.ALL_QUERIES["q9"])._norm()
    assert builds[1:] == [0, 0], builds
    for kit in kits:
        kit.must_exec("insert into part values (999001, 'lime green "
                      "unseen name', 'Manufacturer#1', 'Brand#11', "
                      "'SMALL PLATED TIN', 5, 'SM BOX', 1000.00, '')")
    b0, h0 = stats["builds"], stats["hits"]
    got = port.must_query(sql)._norm()
    assert stats["builds"] - b0 >= 1
    assert got == ref.must_query(ref_tpch.ALL_QUERIES["q9"])._norm()
    b0 = stats["builds"]
    port.must_query(sql)
    assert stats["builds"] == b0 and stats["hits"] > h0

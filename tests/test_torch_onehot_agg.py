"""One-hot slot aggregation (tidb_tpu_torch/copr/dag_exec.py
onehot_agg_body, copr/pipeline.py _oh_learn_table / _oh_fold_delta and
the miss rerun) against the reference's, on the CPU.

Twins of tests/test_onehot_agg.py: the same 30,000-row table (the
reference test's RandomState(7) draws, bulk-loaded into both packages)
and statements run on the reference's TestKit and on the port's, both
under the runs lowering with TIDB_TPU_ONEHOT_FORCE set (each package's
CPU otherwise never takes the one-hot program); rows equal as strings,
and the metrics each package counts (fused_onehot_agg, _miss, _rebuild,
_delta_fold) equal.

Then the program itself: onehot_agg_body on CPU tensors against the
reference's onehot_agg_body + onehot_decode_states under jax over the
same slot table and rows: per slot, exact int64 count, sum and avg
states (the reference's int32 limb sums decoded mod 2^64; the port's
int64 adds) with values near +-2^62 whose sums wrap, NULL keys, keys
outside the table's spans and keys inside them that the table lacks
(equal miss counts); and _oh_learn_table's tables equal."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import tidb_tpu.copr.dag_exec as rde
import tidb_tpu.copr.pipeline as rpl
from tidb_tpu.expression import EvalCtx as RefCtx
from tidb_tpu.expression.expr import Column as RefColumn
from tidb_tpu.types.field_type import new_bigint_type as ref_bigint
from tidb_tpu.testkit import TestKit as RefKit

import tidb_tpu_torch.copr.dag_exec as pde
import tidb_tpu_torch.copr.pipeline as ppl
from tidb_tpu_torch.expression import EvalCtx
from tidb_tpu_torch.expression.expr import Column
from tidb_tpu_torch.expression.torch_ns import TorchNS
from tidb_tpu_torch.types.field_type import new_bigint_type
from tidb_tpu_torch.testkit import TestKit as PortKit
from tidb_tpu_torch.utils import phase as port_phase

N = 30000
METRICS = ("fused_onehot_agg", "fused_onehot_miss", "fused_onehot_rebuild",
           "fused_onehot_delta_fold")
Q = ("select g, h, count(*), sum(v), sum(w), avg(v) from f "
     "where v > -900000 group by g, h order by g, h")


def _table():
    """The reference test's rows: per row, RandomState(7)'s draws for
    g (977-multiples), h, v and w, in its order."""
    rng = np.random.RandomState(7)
    g, h, v, w = (np.empty(N, dtype=np.int64) for _ in range(4))
    for i in range(N):
        g[i] = int(rng.randint(0, 40)) * 977
        h[i] = int(rng.randint(0, 5))
        v[i] = int(rng.randint(-1000000, 1000000))
        w[i] = int(rng.randint(0, 1 << 40))
    return {"id": np.arange(N, dtype=np.int64), "g": g, "h": h, "v": v,
            "w": w}


COLS = _table()


@pytest.fixture(autouse=True)
def _torch_registries():
    """The shared conftest resets tidb_tpu's registries only."""
    from tidb_tpu_torch.utils import metrics, device_guard
    metrics.reset_all()
    device_guard.reset()
    port_phase.reset()
    yield
    pde._FORCE_SEGMENT_IMPL = None


def _load(tk):
    tk.must_exec("create table f (id bigint primary key, g bigint, "
                 "h bigint, v bigint, w bigint)")
    dom = tk.domain
    t = dom.columnar.table(dom.infoschema().table_by_name("test", "f"))
    t.bulk_append(COLS, N, handles=COLS["id"])


@pytest.fixture()
def kits(monkeypatch):
    """(reference TestKit, port TestKit), each with the table, both
    under the runs lowering with one-hot forced on."""
    monkeypatch.setenv("TIDB_TPU_SEGMENT_IMPL", "runs")    # the reference
    monkeypatch.setenv("TIDB_TPU_ONEHOT_FORCE", "1")       # both
    monkeypatch.setattr(pde, "_FORCE_SEGMENT_IMPL", "runs")
    ref, port = RefKit(), PortKit(device="cpu")
    for tk in (ref, port):
        _load(tk)
    return ref, port


class _Both:
    """Runs each statement on both kits; query() -> the port's rows
    after checking they equal the reference's as strings."""

    def __init__(self, kits):
        self.ref, self.port = kits

    def exec(self, sql):
        for tk in (self.ref, self.port):
            tk.must_exec(sql)

    def query(self, sql):
        want = self.ref.must_query(sql).rows
        got = self.port.must_query(sql).rows
        assert _strs(got) == _strs(want), sql
        return got

    def metrics(self):
        """{metric: (port, reference)} of the one-hot counters."""
        return {m: (self.port.domain.metrics.get(m, 0),
                    self.ref.domain.metrics.get(m, 0)) for m in METRICS}

    def same_metrics(self):
        got = self.metrics()
        assert all(p == r for p, r in got.values()), got
        return {m: p for m, (p, _r) in got.items()}

    def port_host(self, sql):
        self.port.domain.copr.use_device = False
        try:
            return self.port.must_query(sql).rows
        finally:
            self.port.domain.copr.use_device = True


def _strs(rows):
    return [tuple(map(str, r)) for r in rows]


def test_onehot_learns_and_matches(kits):
    b = _Both(kits)
    r1 = b.query(Q)                      # learns from the runs partials
    assert b.same_metrics()["fused_onehot_agg"] == 0
    r2 = b.query(Q)                      # the one-hot program
    assert b.same_metrics()["fused_onehot_agg"] == 1
    assert len(r1) == len(r2) == 200
    assert _strs(r1) == _strs(r2) == _strs(b.port_host(Q))


def test_onehot_miss_invalidates(kits):
    b = _Both(kits)
    b.query(Q)
    b.query(Q)
    assert b.same_metrics()["fused_onehot_agg"] > 0
    # a new group key: out of the learned span, so the delta fold drops
    # the table; the statement runs the sort kind and relearns
    b.exec("insert into f values (100000, 99991, 9, 5, 5)")
    r3 = b.query(Q)
    assert len(r3) == 201
    r4 = b.query(Q)
    assert _strs(r3) == _strs(r4)
    b.same_metrics()


def test_onehot_zero_slot_drop(kits):
    b = _Both(kits)
    b.query(Q)
    b.query(Q)
    b.exec("delete from f where g = 0")
    r = b.query(Q)
    assert 0 not in {x[0] for x in r}
    assert len(r) in (195, 196)          # 5 h-groups under g = 0
    assert b.same_metrics()["fused_onehot_agg"] == 2


def test_onehot_negative_and_wide_sums(kits):
    """Sums with negatives and 40-bit values, bit-exact to the host."""
    b = _Both(kits)
    sql = "select g, sum(v), sum(w) from f group by g order by g"
    dev = b.query(sql)
    dev2 = b.query(sql)
    assert b.same_metrics()["fused_onehot_agg"] == 1
    assert _strs(dev) == _strs(dev2) == _strs(b.port_host(sql))


def test_onehot_pipelined_miss_on_one_partition(kits):
    """A new key whose rows land in ONE partition only: the sibling
    partition dispatched with the table consumes it cleanly while the
    new key's partition drops it."""
    b = _Both(kits)
    for tk in kits:
        tk.domain.copr.device_rows = 8192      # 4 partitions
    b.query(Q)
    b.query(Q)
    assert b.same_metrics()["fused_onehot_agg"] == 4
    b.exec("insert into f values (100001, 97661207, 0, 1, 1)")
    r = b.query(Q)
    assert len(r) == 201
    r2 = b.query(Q)
    assert _strs(r) == _strs(r2)
    b.same_metrics()


def test_onehot_delta_fold_zero_rebuilds_on_append(kits):
    """An append of a known key and of a new key inside the learned
    spans extends the table at bind time: no miss, no rebuild, one
    fold, and the one-hot program keeps serving."""
    b = _Both(kits)
    b.query(Q)
    b.query(Q)
    served0 = b.same_metrics()["fused_onehot_agg"]
    assert served0 > 0
    # 500 is inside the learned span (977-multiples in [0, 38103]) but
    # not a learned key: a new slot
    b.exec("insert into f values (100000, 500, 3, 7, 7), "
           "(100001, 977, 0, 1, 1)")
    r = b.query(Q)
    m = b.same_metrics()
    assert m["fused_onehot_miss"] == m["fused_onehot_rebuild"] == 0
    assert m["fused_onehot_delta_fold"] == 1
    assert m["fused_onehot_agg"] > served0
    assert len(r) == 201
    assert _strs(r) == _strs(b.query(Q)) == _strs(b.port_host(Q))


def test_onehot_delta_fold_out_of_span_relearns(kits):
    b = _Both(kits)
    b.query(Q)
    b.query(Q)
    b.exec("insert into f values (100002, 99999977, 3, 1, 1)")
    r = b.query(Q)
    assert b.same_metrics()["fused_onehot_rebuild"] == 1
    assert len(r) == 201
    assert _strs(r) == _strs(b.query(Q))


def test_onehot_full_range_keys_rejected(kits):
    """Key spans past the 61-bit pack are refused before packing (no
    OverflowError): the shape keeps the exact sort kind."""
    b = _Both(kits)
    b.exec("create table wide (id bigint primary key, g bigint, v int)")
    b.exec(f"insert into wide values (1, {-(1 << 62)}, 1), "
           f"(2, {1 << 62}, 2), (3, 0, 3)")
    q = "select g, sum(v) from wide group by g order by g"
    r1 = b.query(q)
    r2 = b.query(q)
    assert _strs(r1) == _strs(r2) and len(r1) == 3
    assert b.same_metrics()["fused_onehot_agg"] == 0


def test_onehot_compacted_and_regrown(kits):
    """A selective filter: the sort kind learns a compact capacity, and
    the one-hot program then packs and looks up only the compacted
    rows; a capacity below the rows that pass reruns the partition
    (fused_compact_regrow) and regrows it. Rows equal the reference's
    (whose one-hot program runs at the partition's rows) every time."""
    b = _Both(kits)
    sql = ("select g, h, count(*), sum(v) from f where v > 900000 "
           "group by g, h order by g, h")
    b.query(sql)
    b.query(sql)
    assert b.same_metrics()["fused_onehot_agg"] == 1
    hc = kits[1].domain.copr._host_cache
    (key,) = [k for k, v in hc.items() if k[0] == "fcompact"]
    assert isinstance(hc[key], int)
    learned = hc[key]
    hc[key] = 16
    m = kits[1].domain.metrics
    regrow0 = m.get("fused_compact_regrow", 0)
    assert _strs(b.query(sql)) == _strs(b.port_host(sql))
    assert m.get("fused_compact_regrow", 0) == regrow0 + 1
    assert hc[key] == learned
    assert b.same_metrics()["fused_onehot_agg"] == 2


# ---- the program against the reference's, function by function ----

class A:
    def __init__(self, name, args):
        self.name, self.args, self.distinct = name, args, False


class _Copr:
    """What _oh_learn_table reads and writes of a CoprExecutor."""

    def __init__(self):
        self._host_cache = {}

    def _upload_padded(self, arr, cap):
        return torch.from_numpy(np.ascontiguousarray(arr))


# aggregates over column 2 (int64, with NULLs) and column 3 (no NULLs)
AGG_SPECS = (("count", None), ("sum", 2), ("avg", 3), ("count", 2),
             ("sum", 3))

# (name, value shape, key shape)
BODY_CASES = (
    ("small", "small", "plain"),
    ("near_limits", "near_limits", "plain"),     # sums wrap mod 2^64
    ("null_keys", "small", "null_keys"),
    ("out_of_span", "near_limits", "out_of_span"),
    ("not_learned", "small", "not_learned"),      # in span, not a slot
    ("empty_mask", "small", "empty_mask"),
)


def _body_inputs(vshape, kshape, cap=2048, seed=5):
    """numpy columns 0, 1 (group keys, 0 with NULLs), 2 (int, NULLs), 3
    (int); the mask; the rows the slot table is learned from."""
    rng = np.random.RandomState(seed)
    mask = rng.rand(cap) < 0.85
    k0 = rng.randint(-3, 9, cap).astype(np.int64) * 1000
    k0n = rng.rand(cap) < (0.2 if kshape == "null_keys" else 0.0)
    k1 = rng.randint(0, 4, cap).astype(np.int64)
    if vshape == "near_limits":
        base = np.where(rng.rand(cap) < 0.5, (1 << 62), -(1 << 62))
        v2 = base + rng.randint(-1000, 1000, cap)
        v3 = (1 << 62) + rng.randint(0, 1 << 30, cap).astype(np.int64)
    else:
        v2 = rng.randint(-10 ** 6, 10 ** 6, cap).astype(np.int64)
        v3 = rng.randint(0, 1 << 40, cap).astype(np.int64)
    v2n = rng.rand(cap) < 0.1
    learn = np.ones(cap, dtype=bool)
    if kshape == "out_of_span":
        k0[rng.rand(cap) < 0.05] = 10 ** 9       # past the spans
        learn = k0 < 10 ** 9
    elif kshape == "not_learned":
        learn = k0 != 3000                       # one in-span key missing
    elif kshape == "empty_mask":
        mask[:] = False
    cols = {0: (k0, k0n), 1: (k1, None), 2: (v2, v2n),
            3: (v3.astype(np.int64), None)}
    return mask, cols, learn


def _learned(cols, learn, cap):
    """The port's and the reference's slot tables over the same rows
    (the keys of the learning rows, as two one-partition partials)."""
    half = int(learn.sum()) // 2
    ks = [cols[0][0][learn], cols[1][0][learn]]
    kns = [cols[0][1][learn], np.zeros(int(learn.sum()), dtype=bool)]
    oh_learn = [([k[:half] for k in ks], [k[:half] for k in kns]),
                ([k[half:] for k in ks], [k[half:] for k in kns])]

    class Plan:
        group_items = [0, 1]
    pc, rc = _Copr(), _Copr()
    ppl._oh_learn_table(pc, "k", Plan, oh_learn, rows=cap, version=3)
    rpl._oh_learn_table(rc, "k", Plan, oh_learn, rows=cap, version=3)
    return pc._host_cache["k"], rc._host_cache["k"]


@pytest.mark.parametrize("case", BODY_CASES, ids=[c[0] for c in BODY_CASES])
def test_onehot_body_equals_reference(case):
    _name, vshape, kshape = case
    cap = 2048
    mask, cols, learn = _body_inputs(vshape, kshape, cap)
    pt, rt = _learned(cols, learn, cap)
    for key in ("skeys", "los", "spans"):
        assert np.array_equal(pt[key], rt[key]), key
    for a, b in zip(pt["key_vals"] + pt["key_nulls"],
                    rt["key_vals"] + rt["key_nulls"]):
        assert np.array_equal(a, b)
    assert (pt["nslots"], pt["scap"], pt["rows"], pt["version"]) == \
        (rt["nslots"], rt["scap"], rt["rows"], rt["version"])
    scap, nslots = pt["scap"], pt["nslots"]

    rctx = RefCtx(jnp, cap, {k: (jnp.asarray(d), None if n is None else
                                 jnp.asarray(n), None)
                             for k, (d, n) in cols.items()}, host=False)
    raggs = [A(nm, [] if c is None else [RefColumn(c, ref_bigint())])
             for nm, c in AGG_SPECS]
    rsargs = {"skeys": jnp.asarray(rt["skeys"]),
              "los": jnp.asarray(rt["los"]),
              "spans": jnp.asarray(rt["spans"]),
              "nslots": jnp.asarray([nslots], dtype=jnp.int64)}
    ref = jax.device_get(rde.onehot_agg_body(
        rctx, jnp.asarray(mask),
        [RefColumn(0, ref_bigint()), RefColumn(1, ref_bigint())], raggs,
        cap, scap, rsargs))
    rstates, rrows = rde.onehot_decode_states(np.asarray(ref["oh_acc"]),
                                              raggs, nslots)

    t = torch.from_numpy
    pctx = EvalCtx(TorchNS("cpu"), cap, {k: (t(d), None if n is None else
                                             t(n), None)
                                         for k, (d, n) in cols.items()},
                   host=False)
    paggs = [A(nm, [] if c is None else [Column(c, new_bigint_type())])
             for nm, c in AGG_SPECS]
    got = pde.onehot_agg_body(
        pctx, t(mask), [Column(0, new_bigint_type()),
                        Column(1, new_bigint_type())], paggs, cap, scap,
        pt["dev"])
    pstates, prows = pde.onehot_decode_states(got["oh_acc"].numpy(), paggs,
                                              nslots)
    assert int(got["miss"]) == int(ref["miss"])
    assert int(got["ngroups"]) == int(ref["ngroups"]) == nslots
    if kshape in ("out_of_span", "not_learned"):
        assert int(got["miss"]) > 0
    else:
        assert int(got["miss"]) == 0
    assert np.array_equal(prows, rrows)
    for ps, rs in zip(pstates, rstates):
        assert len(ps) == len(rs)
        for p, r in zip(ps, rs):
            assert p.dtype == np.int64 and np.array_equal(p, r)
    if vshape == "near_limits" and kshape == "plain":
        # sum(column 3) per slot: its exact total leaves int64, and the
        # state is that total mod 2^64
        wrapped = 0
        for s, (k0, k1) in enumerate(zip(*pt["key_vals"])):
            rows = mask & (cols[0][0] == k0) & (cols[1][0] == k1)
            exact = sum(int(x) for x in cols[3][0][rows])
            wrapped += not -(1 << 63) <= exact < (1 << 63)
            assert int(pstates[4][0][s]) == \
                (exact + (1 << 63)) % (1 << 64) - (1 << 63)
        assert wrapped > 0


def test_onehot_layout_refuses_other_aggregates():
    with pytest.raises(NotImplementedError):
        pde.onehot_agg_layout([A("min", [])])
    assert pde.onehot_agg_layout([A("count", []), A("avg", [])]) == \
        [(0, 0), (1, 0), (1, 1), (-1, -1)]

"""Early compaction of the fact filters' survivors (ecap) in the fused
pipeline (tidb_tpu_torch/copr/pipeline.py: _make_pipeline_body's ecap,
its learning through _compact_policy under ("fecompact", gc epoch, ...),
the overflow rerun) against the reference's, on the CPU. The reference
has no test of it; these hold the port to its functions and rows.

- The body: the fragment inputs of real statements (captured from both
  packages' runs at SF0.05: Q14's one-slot aggregate, Q12's dense group
  and a sort-kind group by a fact column, each behind a part or orders
  probe) go through the port's body without and with ecap and through
  the reference's body with ecap (jax on the CPU): the results, fnvalid
  included, equal exactly.
- The learning: the first statement learns ecap from fnvalid (the
  survivors' bucket when at most 1/8 of a partition passes), the next
  runs compacted (fused_ecap_run), a learned ecap too small reruns the
  partition (fused_compact_regrow, as the late compaction) and regrows, survivors past 1/4 pin it
  off; the values equal the reference's learned state.
- Zero-dim pipelines never compact (Q6, Q1, a zero-dim group-by),
  though they learn the key as the reference does.
- Q14 and Q19 (and Q4, Q12) from SQL at SF0.05, one partition and
  several: rows equal the reference TestKit's, cold and warm."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import tidb_tpu.copr.pipeline as rpl
from tidb_tpu.testkit import TestKit as RefKit
from tidb_tpu.bench import tpch as ref_tpch

import tidb_tpu_torch.copr.dag_exec as pde
import tidb_tpu_torch.copr.pipeline as ppl
from tidb_tpu_torch.testkit import TestKit as PortKit
from tidb_tpu_torch.bench import tpch as port_tpch
from tidb_tpu_torch.utils import phase as port_phase

SF, SEED = 0.05, 7
# a sort-kind group-by (a fact column, behind a probe) over one month
SORT_SQL = ("select l_suppkey, sum(l_quantity), count(*) from lineitem, part "
            "where l_partkey = p_partkey and l_shipdate >= '1995-09-01' and "
            "l_shipdate < '1995-10-01' and p_size < 30 group by l_suppkey "
            "order by l_suppkey")
# survivors past 1/4 of the partition: the learned ecap pins off
WIDE_SQL = ("select sum(l_quantity), count(*) from lineitem, part where "
            "l_partkey = p_partkey and l_shipdate >= '1993-01-01' and "
            "p_size < 30")


@pytest.fixture(autouse=True)
def _torch_registries():
    """The shared conftest resets tidb_tpu's registries only."""
    from tidb_tpu_torch.utils import metrics, device_guard
    metrics.reset_all()
    device_guard.reset()
    port_phase.reset()
    yield


@pytest.fixture(scope="module")
def kits():
    """(reference TestKit, port TestKit) with TPC-H SF0.05, seed 7."""
    ref, port = RefKit(), PortKit(device="cpu")
    ref_tpch.load_tpch(ref, sf=SF, seed=SEED)
    port_tpch.load_tpch(port, sf=SF, seed=SEED)
    # the reference runs fused fragments on its 8 virtual CPU devices'
    # mesh, which never compacts early: one device, as the port's CPU
    ref.must_exec("set @@tidb_enable_mpp = 0")
    return ref, port


def _sql(q):
    return port_tpch.ALL_QUERIES.get(q, q)


def _fresh(kits):
    """Forget every learned state of both packages (the kits are shared
    by the module's tests) and return to one partition."""
    for tk in kits:
        tk.domain.copr._host_cache.clear()
        tk.domain.copr.device_rows = 1 << 22


def _ecaps(tk):
    """{host cache key: learned ecap} of a kit (keys differ between the
    packages: table uids and expression fingerprints)."""
    return {k: v for k, v in tk.domain.copr._host_cache.items()
            if isinstance(k, tuple) and k and k[0] == "fecompact"}


def _set_new(kits, before, value):
    """Set each kit's one ecap key not in before[i] to `value` (kits and
    before in the same order: reference, port); -> those keys."""
    keys = []
    for tk, b in zip(kits, before):
        (k,) = [k for k in _ecaps(tk) if k not in b]
        if value is not None:
            tk.domain.copr._host_cache[k] = value
        keys.append(k)
    return keys


def _strs(rows):
    return [tuple(map(str, r)) for r in rows]


# ---- the body: captured fragment inputs through both bodies --------

class _Capture:
    """Records the body arguments and fragment inputs of the fused
    fragments both packages run for one statement."""

    def __init__(self, monkeypatch):
        self.port, self.ref = [], []
        make, run = ppl._make_pipeline_body, ppl.run_fragment
        last = {}

        def made(*args, **kw):
            last["args"], last["kw"] = args, kw
            return make(*args, **kw)

        def ran(kern, fjc, fvv, dargs):
            self.port.append((last["args"], last["kw"], fjc, fvv, dargs))
            return run(kern, fjc, fvv, dargs)
        monkeypatch.setattr(ppl, "_make_pipeline_body", made)
        monkeypatch.setattr(ppl, "run_fragment", ran)
        build = rpl._build_fused_kernel

        def built(*args, **kw):
            kern = build(*args, **kw)

            def call(fjc, fvv, kargs):
                self.ref.append((args, kw, jax.device_get(fjc),
                                 np.asarray(fvv), jax.device_get(kargs)))
                return kern(fjc, fvv, kargs)
            return call
        monkeypatch.setattr(rpl, "_build_fused_kernel", built)


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _jnp(x):
    if isinstance(x, dict):
        return {k: _jnp(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_jnp(v) for v in x)
    if isinstance(x, np.ndarray):
        return jnp.asarray(x)
    return x


def _equal_results(got, want, kind):
    """Exact equality of two fragment results of one agg kind (a sort
    result's arrays up to ngroups)."""
    assert int(got["fnvalid"]) == int(want["fnvalid"])
    if kind == "sort":
        ng = int(got["ngroups"])
        assert ng == int(want["ngroups"])
        assert int(got["nvalid"]) == int(want["nvalid"])
        for a, b in zip(got["keys"] + got["key_nulls"],
                        want["keys"] + want["key_nulls"]):
            assert np.array_equal(np.asarray(a)[:ng], np.asarray(b)[:ng])
        for sa, sb in zip(got["states"], want["states"]):
            for a, b in zip(sa, sb):
                assert np.array_equal(np.asarray(a)[:ng],
                                      np.asarray(b)[:ng])
        return
    assert np.array_equal(got["present"], want["present"])
    for sa, sb in zip(got["states"], want["states"]):
        for a, b in zip(sa, sb):
            assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("q,kind", [("q14", "dense"), ("q12", "dense"),
                                    (SORT_SQL, "sort")],
                         ids=["q14", "q12", "sort"])
def test_body_with_and_without_ecap_equals_reference(kits, q, kind,
                                                     monkeypatch):
    _fresh(kits)
    ref, port = kits
    cap = _Capture(monkeypatch)
    want = ref.must_query(_sql(q)).rows
    got = port.must_query(_sql(q)).rows
    assert _strs(got) == _strs(want)
    assert len(cap.port) == len(cap.ref) == 1
    pargs, pkw, fjc, fvv, dargs = cap.port[0]
    rargs, _rkw, rfjc, rfvv, rkargs = cap.ref[0]
    assert pargs[8] == rargs[7] == kind and pkw.get("ecap") is None
    plain = _np(ppl._make_pipeline_body(*pargs, **pkw)(fjc, fvv, dargs))
    fnvalid = int(plain["fnvalid"])
    assert 0 < fnvalid <= pargs[1] // 8
    for ecap in (pde.shape_bucket(fnvalid), 2 * pde.shape_bucket(fnvalid)):
        agg_param = pargs[9] if kind != "sort" else \
            pargs[9][:3] + (None,)
        args = pargs[:9] + (agg_param,) + pargs[10:]
        comp = _np(ppl._make_pipeline_body(*args, ecap=ecap)(
            fjc, fvv, dargs))
        rbody = rpl._make_pipeline_body(
            *rargs[:8], agg_param, rargs[9] if len(rargs) > 9 else (),
            ecap=ecap, want_fnvalid=True)
        want_res = jax.device_get(rbody(_jnp(rfjc), jnp.asarray(rfvv),
                                        _jnp(rkargs)))
        _equal_results(comp, want_res, kind)
        _equal_results(comp, plain, kind)


# ---- the learning ---------------------------------------------------

def test_learn_compact_then_regrow_and_pin_off(kits):
    _fresh(kits)
    ref, port = kits
    m = port.domain.metrics
    sql = _sql("q14")
    for run in range(2):
        r0 = dict(m)
        want = ref.must_query(sql).rows
        got = port.must_query(sql).rows
        assert _strs(got) == _strs(want)
        learned = list(_ecaps(port).values())
        assert learned == list(_ecaps(ref).values())
        assert len(learned) == 1 and isinstance(learned[0], int)
        # the first statement learns, the second runs compacted
        assert m.get("fused_ecap_run", 0) - r0.get("fused_ecap_run", 0) \
            == run
        assert m.get("fused_compact_regrow", 0) == 0
    # a learned ecap below the survivors: the partition reruns, regrown
    rk, pk = _set_new(kits, ({}, {}), 16)
    want = ref.must_query(sql).rows
    got = port.must_query(sql).rows
    assert _strs(got) == _strs(want)
    assert m.get("fused_compact_regrow", 0) == 1
    assert _ecaps(port).get(pk) == _ecaps(ref).get(rk) == learned[0], \
        (pk, rk, _ecaps(port), _ecaps(ref))
    # survivors past 1/8 of the partition: learned off at first sight;
    # an ecap forced on reruns (past 1/4) and pins it off again
    before = (dict(_ecaps(ref)), dict(_ecaps(port)))
    port.must_query(WIDE_SQL)
    ref.must_query(WIDE_SQL)
    rk, pk = _set_new(kits, before, None)
    assert _ecaps(port)[pk] == _ecaps(ref)[rk] == "off"
    port.domain.copr._host_cache[pk] = ref.domain.copr._host_cache[rk] = \
        1024
    regrow0 = m.get("fused_compact_regrow", 0)
    want = ref.must_query(WIDE_SQL).rows
    got = port.must_query(WIDE_SQL).rows
    assert _strs(got) == _strs(want)
    assert m.get("fused_compact_regrow", 0) == regrow0 + 1
    assert _ecaps(port)[pk] == _ecaps(ref)[rk] == "off"


@pytest.mark.parametrize("q", ["q6", "q1", "q15_revenue"])
def test_zero_dim_never_compacts(kits, q, monkeypatch):
    _fresh(kits)
    ref, port = kits
    sql = {"q15_revenue": "select l_suppkey, sum(l_extendedprice) from "
           "lineitem where l_shipdate >= '1996-01-01' and l_shipdate < "
           "'1996-04-01' group by l_suppkey order by l_suppkey"}.get(
               q, _sql(q))
    ecaps = []
    make = ppl._make_pipeline_body

    def made(*args, **kw):
        ecaps.append(kw.get("ecap"))
        return make(*args, **kw)
    monkeypatch.setattr(ppl, "_make_pipeline_body", made)
    for _run in range(3):
        assert _strs(port.must_query(sql).rows) == \
            _strs(ref.must_query(sql).rows)
    # learned as the reference learns it, never used
    assert list(_ecaps(port).values()) == list(_ecaps(ref).values())
    assert ecaps and all(e is None for e in ecaps)
    assert port.domain.metrics.get("fused_ecap_run", 0) == 0


# ---- SQL against the reference's rows -------------------------------

@pytest.mark.parametrize("device_rows", [1 << 22, 40000],
                         ids=["one_partition", "eight_partitions"])
@pytest.mark.parametrize("q", ["q14", "q19", "q4", "q12"])
def test_sql_rows_equal_reference(kits, q, device_rows):
    _fresh(kits)
    ref, port = kits
    for tk in kits:
        tk.domain.copr.device_rows = device_rows
    m = port.domain.metrics
    run0 = m.get("fused_ecap_run", 0)
    for _run in range(3):                  # learns, then compacted
        assert _strs(port.must_query(_sql(q)).rows) == \
            _strs(ref.must_query(_sql(q)).rows)
    assert m.get("fused_ecap_run", 0) > run0
    assert list(_ecaps(port).values()) == list(_ecaps(ref).values())

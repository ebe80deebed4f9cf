"""In-SQL inference in tidb_tpu_torch (tidb_tpu_torch/ml/,
executor/ml_predict.py) against the reference (tidb_tpu/ml/, JAX on the
CPU).

- Program parity: the reference's build_forward_kernel (jitted) and the
  port's on CPU tensors, and predict() as a fragment op with the port's
  TorchNS against the numpy EvalCtx, within rtol 1e-5 (float32 on both
  sides), decimal features included.
- SQL parity: a reference TestKit and a port TestKit over the same rows
  and model give values within rtol 1e-5 for standalone predict(), the
  same rows for predict() fused in a filter and its aggregate, and equal
  embed() vectors in a generated column.
- Mirrors of tests/test_ml.py, each with the same name, on a port
  TestKit(device="cpu"): a fused predict() runs its fragment on CPU
  tensors over resident weights, the standalone forward its numpy twin
  unless TIDB_TPU_ML_DEVICE=1, and a degrade takes the host twin as in
  the reference."""
import os

import numpy as np
import pytest

from tidb_tpu_torch.testkit import TestKit
from tidb_tpu_torch.utils import failpoint, phase
from tidb_tpu_torch.utils import metrics as mu
from tidb_tpu_torch.ml.kernels import host_forward


@pytest.fixture(autouse=True)
def _torch_registries():
    """The shared conftest resets tidb_tpu's registries only."""
    from tidb_tpu_torch.utils import device_guard
    mu.reset_all()
    device_guard.reset()
    phase.reset()
    yield
    failpoint.disable_all()


@pytest.fixture()
def tk():
    return TestKit(device="cpu")


def _mlp_npz(path, rng, nin=3, hidden=8):
    W0 = rng.randn(nin, hidden).astype(np.float32)
    b0 = rng.randn(hidden).astype(np.float32)
    W1 = rng.randn(hidden, 1).astype(np.float32)
    b1 = rng.randn(1).astype(np.float32)
    np.savez(path, W0=W0, b0=b0, W1=W1, b1=b1)
    return [W0, W1], [b0, b1]


def _embed_npz(path, rng, vocab=32, dim=4):
    table = rng.randn(vocab, dim).astype(np.float32)
    np.savez(path, table=table)
    return table


def _vec_text(v):
    return "[" + ",".join(f"{x:.3f}" for x in np.asarray(v).tolist()) + "]"


# ---- model DDL lifecycle ----------------------------------------------

def test_model_ddl_lifecycle(tk, tmp_path):
    rng = np.random.RandomState(1)
    p = str(tmp_path / "m.npz")
    _mlp_npz(p, rng)
    tk.must_exec(f"create model scorer from '{p}'")
    rows = tk.must_query("show models").rows
    assert [r[0] for r in rows] == ["scorer"]
    assert rows[0][1] == "mlp"
    # duplicate -> 1105; IF NOT EXISTS -> clean no-op
    assert tk.exec_err(f"create model scorer from '{p}'").code == 1105
    tk.must_exec(f"create model if not exists scorer from '{p}'")
    # bad uri fails FAST (before a job is enqueued)
    assert tk.exec_err(
        "create model nope from '/does/not/exist.npz'").code == 1105
    tk.must_exec("drop model scorer")
    assert tk.must_query("show models").rows == []
    assert tk.exec_err("drop model scorer").code == 1105
    tk.must_exec("drop model if exists scorer")
    # the DDL ran through the durable job runner
    jobs = [j.type for j in tk.domain.ddl_jobs.list_jobs()]
    assert "create model" in jobs


def test_model_drop_fences_plans(tk, tmp_path):
    rng = np.random.RandomState(2)
    p = str(tmp_path / "m.npz")
    _mlp_npz(p, rng, nin=1)
    tk.must_exec(f"create model m1 from '{p}'")
    tk.must_exec("create table t (a bigint primary key, x double)")
    tk.must_exec("insert into t values (1, 0.5)")
    assert len(tk.must_query("select predict(m1, x) from t").rows) == 1
    tk.must_exec("drop model m1")
    # schema_epoch fence: the cached plan must NOT survive the drop
    e = tk.exec_err("select predict(m1, x) from t")
    assert e.code == 1105 and "doesn't exist" in str(e)


def test_predict_validation_errors(tk, tmp_path):
    rng = np.random.RandomState(3)
    p = str(tmp_path / "m.npz")
    _mlp_npz(p, rng, nin=2)
    ep = str(tmp_path / "e.npz")
    _embed_npz(ep, rng)
    tk.must_exec(f"create model m2 from '{p}'")
    tk.must_exec(f"create model emb from '{ep}'")
    tk.must_exec("create table t (a bigint primary key, x double, "
                 "v vector(4))")
    assert tk.exec_err("select predict(nosuch, x) from t").code == 1105
    # wrong arity
    assert tk.exec_err("select predict(m2, x) from t").code == 1105
    # kind mismatches
    assert tk.exec_err("select predict(emb, x, x) from t").code == 1105
    assert tk.exec_err("select embed(m2, x) from t").code == 1105
    # vector-typed feature rejected
    assert tk.exec_err("select predict(m2, v, x) from t").code == 1235


# ---- inference correctness --------------------------------------------

def test_predict_standalone_matches_host_twin(tk, tmp_path):
    rng = np.random.RandomState(4)
    p = str(tmp_path / "m.npz")
    ws, bs = _mlp_npz(p, rng)
    tk.must_exec(f"create model sc from '{p}'")
    tk.must_exec("create table t (id bigint primary key, a double, "
                 "b double, c double)")
    n = 500
    A = np.round(rng.randn(n, 3), 6)
    tk.must_exec("insert into t values " + ",".join(
        f"({i}, {A[i, 0]}, {A[i, 1]}, {A[i, 2]})" for i in range(n)))
    os.environ["TIDB_TPU_ML_DEVICE"] = "1"
    try:
        rows = tk.must_query(
            "select id, predict(sc, a, b, c) from t order by id").rows
    finally:
        os.environ.pop("TIDB_TPU_ML_DEVICE", None)
    got = np.array([r[1] for r in rows])
    want = host_forward(A.astype(np.float32), ws, bs)
    assert np.abs(got - want).max() < 1e-4
    # the plan actually batched (PhysMLPredict), not per-chunk host
    ex = tk.must_query(
        "explain select id, predict(sc, a, b, c) from t").rows
    assert any("MLPredict" in r[0] for r in ex)
    # NULL feature -> NULL output
    tk.must_exec("insert into t values (99991, null, 1, 1)")
    r = tk.must_query(
        "select predict(sc, a, b, c) from t where id = 99991").rows
    assert r == [(None,)]


def test_predict_fused_in_filter_and_chaos_parity(tk, tmp_path):
    """predict() inside WHERE traces into the fused fragment; injected
    grant loss at the ml dispatch site degrades the standalone path to
    the numpy twin with identical values."""
    rng = np.random.RandomState(5)
    p = str(tmp_path / "m.npz")
    ws, bs = _mlp_npz(p, rng)
    tk.must_exec(f"create model sc from '{p}'")
    tk.must_exec("create table t (id bigint primary key, a double, "
                 "b double, c double)")
    A = np.round(rng.randn(300, 3), 6)
    tk.must_exec("insert into t values " + ",".join(
        f"({i}, {A[i, 0]}, {A[i, 1]}, {A[i, 2]})" for i in range(300)))
    y = host_forward(A.astype(np.float32), ws, bs)
    got = [r[0] for r in tk.must_query(
        "select id from t where predict(sc, a, b, c) > 0 "
        "order by id").rows]
    assert got == [i for i in range(300) if y[i] > 0]
    sql = "select id, predict(sc, a, b, c) from t order by id"
    os.environ["TIDB_TPU_ML_DEVICE"] = "1"
    try:
        clean = tk.must_query(sql).rows
        failpoint.enable("device_guard/ml/predict", "error:grant_lost")
        try:
            chaos = tk.must_query(sql).rows
        finally:
            failpoint.disable_all()
    finally:
        os.environ.pop("TIDB_TPU_ML_DEVICE", None)
    assert [r[0] for r in clean] == [r[0] for r in chaos]
    for (_, x), (_, y) in zip(clean, chaos):
        assert abs(x - y) < 1e-5
    assert mu.ML_PREDICT.labels("host_fallback").value >= 1


def test_predict_dirty_txn_overlay_serves_host(tk, tmp_path):
    rng = np.random.RandomState(6)
    p = str(tmp_path / "m.npz")
    ws, bs = _mlp_npz(p, rng)
    tk.must_exec(f"create model sc from '{p}'")
    tk.must_exec("create table t (id bigint primary key, a double, "
                 "b double, c double)")
    tk.must_exec("insert into t values (1, 0.1, 0.2, 0.3)")
    tk.must_exec("begin")
    tk.must_exec("insert into t values (2, 1.0, 2.0, 3.0)")
    rows = tk.must_query(
        "select id, predict(sc, a, b, c) from t order by id").rows
    tk.must_exec("rollback")
    assert [r[0] for r in rows] == [1, 2]
    want = host_forward(
        np.array([[1.0, 2.0, 3.0]], dtype=np.float32), ws, bs)
    assert abs(rows[1][1] - want[0]) < 1e-5


# ---- embed + computed VECTOR columns ----------------------------------

def test_embed_generated_column_and_delta_maintenance(tk, tmp_path):
    rng = np.random.RandomState(7)
    ep = str(tmp_path / "e.npz")
    _embed_npz(ep, rng, vocab=16, dim=4)
    tk.must_exec(f"create model emb from '{ep}'")
    tk.must_exec(
        "create table docs (id bigint primary key, txt varchar(64), "
        "v vector(4) generated always as (embed(emb, txt)) stored)")
    tk.must_exec("insert into docs (id, txt) values (1, 'alpha'), "
                 "(2, 'beta'), (3, 'alpha')")
    rows = tk.must_query("select id, v from docs order by id").rows
    assert rows[0][1] == rows[2][1] != rows[1][1]
    # ANN over the computed column; post-index inserts maintained
    # through the delta path with ZERO rebuilds
    tk.must_exec("create vector index vi on docs (v) using ivf lists=2")
    ann = ("select id from docs order by "
           "vec_l2_distance(v, embed(emb, 'alpha')) limit 3")
    tk.must_query(ann)               # first search trains the index
    before_rebuild = mu.VECTOR_INDEX_DELTA.labels("rebuild").value
    before_apply = mu.VECTOR_INDEX_DELTA.labels("applied").value
    tk.must_exec("insert into docs (id, txt) values (4, 'gamma'), "
                 "(5, 'alpha')")
    near = tk.must_query(ann).rows
    assert {r[0] for r in near} == {1, 3, 5}
    assert mu.VECTOR_INDEX_DELTA.labels("applied").value > before_apply
    assert mu.VECTOR_INDEX_DELTA.labels("rebuild").value == \
        before_rebuild


# ---- hybrid filtered retrieval ----------------------------------------

def _hybrid_corpus(tk, n=2000, dim=8, seed=8):
    tk.must_exec(f"create table h (id bigint primary key, grp bigint, "
                 f"e vector({dim}))")
    rng = np.random.RandomState(seed)
    mat = rng.randn(n, dim).astype(np.float32)
    # grp spreads 0..999: predicates pick 0.1% / 1% / 10% slices
    tk.must_exec("insert into h values " + ",".join(
        f"({i}, {i % 1000}, '{_vec_text(mat[i])}')" for i in range(n)))
    stored = np.array([np.fromstring(_vec_text(mat[i])[1:-1], sep=",")
                       for i in range(n)], dtype=np.float32)
    return stored, rng


def _hybrid_oracle(stored, q, mask, k):
    d = np.linalg.norm(stored.astype(np.float64) - q, axis=1)
    d = np.where(mask, d, np.inf)
    order = [int(i) for i in np.argsort(d, kind="stable")[:k]
             if d[i] < np.inf]
    return order


@pytest.mark.parametrize("pred,maskfn", [
    ("grp = 7", lambda g: g == 7),       # 0.1%: 2 rows of 2000
    ("grp < 10", lambda g: g < 10),      # 1%
    ("grp < 100", lambda g: g < 100),    # 10%
])
def test_hybrid_filtered_parity_exact_and_ivf(tk, pred, maskfn):
    stored, rng = _hybrid_corpus(tk)
    q = rng.randn(8).astype(np.float64)
    n = len(stored)
    mask = maskfn(np.arange(n) % 1000)
    k = 10
    sql = (f"select id from h where {pred} order by "
           f"vec_l2_distance(e, '{_vec_text(q)}') limit {k}")
    want = _hybrid_oracle(stored, q, mask, k)
    ex = tk.must_query("explain " + sql).rows
    assert any("VectorSearch" in r[0] and "prefilter" in r[2]
               for r in ex), ex
    os.environ["TIDB_TPU_VECTOR_DEVICE"] = "1"
    try:
        got = [r[0] for r in tk.must_query(sql).rows]
        assert got == want, (pred, got, want)
        # chaos: grant loss at the top-k site -> host twin, identical
        failpoint.enable("device_guard/vector/topk", "error:grant_lost")
        try:
            chaos = [r[0] for r in tk.must_query(sql).rows]
        finally:
            failpoint.disable_all()
        assert chaos == want, (pred, chaos, want)
        # IVF path with selectivity-widened probing: every surviving
        # row must still satisfy the predicate; recall vs exact >= 0.9
        # at tier-1 scale (the smoke gate enforces 0.95 at full scale)
        tk.must_exec("create vector index hv on h (e) using ivf "
                     "lists = 16")
        ivf = [r[0] for r in tk.must_query(sql).rows]
        assert all(mask[i] for i in ivf), (pred, ivf)
        if want:
            assert len(set(ivf) & set(want)) / len(want) >= 0.9
    finally:
        os.environ.pop("TIDB_TPU_VECTOR_DEVICE", None)


def test_hybrid_resolved_mode_excludes_uncommitted(tk):
    """An explicit txn's uncommitted rows must NOT leak into a
    resolved-mode hybrid scan (the overlay is dropped by design in
    resolved reads), while the default fresh mode serves them through
    the conventional fallback."""
    _hybrid_corpus(tk, n=400)
    sql = ("select id from h where grp < 100 order by "
           "vec_l2_distance(e, '[0,0,0,0,0,0,0,0]') limit 5")
    base = [r[0] for r in tk.must_query(sql).rows]
    tk.must_exec("begin")
    tk.must_exec("insert into h values (9999, 7, "
                 "'[0,0,0,0,0,0,0,0]')")  # exact match, grp passes
    fresh = [r[0] for r in tk.must_query(sql).rows]
    assert fresh[0] == 9999          # dirty read sees it (fallback)
    tk.must_exec("set @@tidb_tpu_analytic_read_mode = 'resolved'")
    try:
        resolved = [r[0] for r in tk.must_query(sql).rows]
    finally:
        tk.must_exec("set @@tidb_tpu_analytic_read_mode = 'leader'")
        tk.must_exec("rollback")
    assert 9999 not in resolved
    assert resolved == base


# ---- surfaces ---------------------------------------------------------

def test_show_models_and_tidb_models_vtable(tk, tmp_path):
    rng = np.random.RandomState(9)
    p = str(tmp_path / "m.npz")
    _mlp_npz(p, rng, nin=1)
    ep = str(tmp_path / "e.npz")
    _embed_npz(ep, rng)
    tk.must_exec(f"create model alpha from '{p}'")
    tk.must_exec(f"create model beta from '{ep}'")
    rows = tk.must_query("show models like 'al%'").rows
    assert len(rows) == 1 and rows[0][0] == "alpha"
    tk.must_exec("create table t (a bigint primary key, x double)")
    tk.must_exec("insert into t values (1, 0.5), (2, 1.5)")
    tk.must_query("select predict(alpha, x) from t")
    vt = tk.must_query(
        "select model_name, kind, weight_bytes, predict_calls, "
        "predict_rows from information_schema.tidb_models "
        "order by model_name").rows
    assert [r[0] for r in vt] == ["alpha", "beta"]
    assert vt[0][1] == "mlp" and vt[1][1] == "embedding"
    assert vt[0][2] > 0
    assert vt[0][3] >= 1 and vt[0][4] >= 2


def test_predict_metrics_and_topsql_phase_keys(tk, tmp_path):
    rng = np.random.RandomState(10)
    p = str(tmp_path / "m.npz")
    _mlp_npz(p, rng, nin=1)
    tk.must_exec(f"create model m from '{p}'")
    tk.must_exec("create table t (a bigint primary key, x double)")
    tk.must_exec("insert into t values (1, 1.0), (2, 2.0), (3, 3.0)")
    before = mu.ML_ROWS.labels().value
    phase.reset()
    tk.must_query("select predict(m, x) from t")
    snap = phase.snap()
    assert snap.get("ml_predicts", 0) >= 1
    assert snap.get("ml_rows", 0) == 3
    assert mu.ML_ROWS.labels().value - before == 3


# ---- program and SQL parity with the reference ------------------------

@pytest.mark.parametrize("dims", [[4, 1], [4, 32, 16, 1], [2, 8, 3]])
def test_forward_program_equals_reference(dims):
    import torch
    from tidb_tpu.ml.kernels import build_forward_kernel as ref_build
    from tidb_tpu_torch.ml.kernels import build_forward_kernel
    rng = np.random.default_rng(len(dims) * 7 + dims[-1])
    ws = [(rng.standard_normal((a, b)) * 0.4).astype(np.float32)
          for a, b in zip(dims, dims[1:])]
    bs = [rng.standard_normal(b).astype(np.float32) for b in dims[1:]]
    X = rng.standard_normal((777, dims[0])).astype(np.float32)
    want = np.asarray(ref_build(len(ws))(X, *ws, *bs))
    got = build_forward_kernel(len(ws))(
        torch.from_numpy(X), *map(torch.from_numpy, ws),
        *map(torch.from_numpy, bs))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(host_forward(X, ws, bs), want, rtol=1e-5,
                               atol=1e-6)


def _both_kits(tmp_path, n=2000):
    """The same table (a double, a decimal and a NULL-bearing int
    feature) and the same seeded MLP + embedding table in a reference
    TestKit and a port TestKit."""
    from tidb_tpu.testkit import TestKit as RefKit
    rng = np.random.RandomState(21)
    p = str(tmp_path / "m.npz")
    _mlp_npz(p, rng, nin=3, hidden=16)
    ep = str(tmp_path / "e.npz")
    _embed_npz(ep, rng, vocab=64, dim=4)
    vals = ",".join(
        f"({i}, {rng.randn():.6f}, {rng.randint(0, 100000) / 100:.2f}, "
        + ("null" if i % 53 == 0 else str(rng.randint(-5, 6))) + ")"
        for i in range(n))
    kits = []
    for kit in (RefKit(), TestKit(device="cpu")):
        kit.must_exec(f"create model sc from '{p}'")
        kit.must_exec(f"create model emb from '{ep}'")
        kit.must_exec("create table t (id bigint primary key, a double, "
                      "b decimal(10,2), c bigint)")
        kit.must_exec("insert into t values " + vals)
        kits.append(kit)
    return kits


def _close_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[0] == w[0]
        assert (g[1] is None) == (w[1] is None), (g, w)
        if w[1] is not None:
            assert abs(g[1] - w[1]) <= 1e-5 * abs(w[1]) + 1e-6, (g, w)


def test_sql_predict_equals_reference(tmp_path):
    ref, port = _both_kits(tmp_path)
    sql = "select id, predict(sc, a, b, c) from t order by id"
    want = ref.must_query(sql).rows
    _close_rows(port.must_query(sql).rows, want)
    os.environ["TIDB_TPU_ML_DEVICE"] = "1"
    try:
        _close_rows(port.must_query(sql).rows, want)
    finally:
        os.environ.pop("TIDB_TPU_ML_DEVICE", None)
    assert mu.ML_PREDICT.labels("device").value >= 1
    # fused in a filter and under an aggregate: rows whose score is not
    # within float32 reach of 0 decide the same way
    near0 = {r[0] for r in want if r[1] is not None and abs(r[1]) < 1e-4}
    f = "select id from t where predict(sc, a, b, c) > 0 order by id"
    got = {r[0] for r in port.must_query(f).rows}
    exp = {r[0] for r in ref.must_query(f).rows}
    assert got - near0 == exp - near0
    assert 0 < len(exp) < 2000
    for kit in (ref, port):
        kit.must_exec("set tidb_tpu_fragment_min_rows = 0")
    agg = ("select count(*), sum(b), sum(c) from t "
           "where predict(sc, a, b, c) > 0")
    m0 = port.domain.metrics.get("copr_device_exec", 0)
    rows = port.must_query(agg).rows
    assert port.domain.metrics.get("copr_device_exec", 0) == m0 + 1
    if not near0:
        assert rows == ref.must_query(agg).rows
    assert mu.ML_PREDICT.labels("fused").value >= 1


def test_fused_predict_weights_stay_resident(tmp_path):
    """A fused predict() takes its weights from MLRuntime.device_weights:
    the first statement uploads them once, a warm one uploads nothing."""
    _ref, port = _both_kits(tmp_path, n=300)
    port.must_exec("set tidb_tpu_fragment_min_rows = 0")
    sql = "select count(*) from t where predict(sc, a, b, c) > 0"
    phase.reset()
    port.must_query(sql)
    h = port.domain.ml.lookup("sc")
    nbytes = sum(a.nbytes for a in h.weights + h.biases)
    assert phase.snap().get("upload_bytes", 0) >= nbytes
    assert port.domain.ml.device_nbytes(h.id) == nbytes
    phase.reset()
    port.must_query(sql)
    s = phase.snap()
    assert s.get("upload_bytes", 0) == 0 and s.get("dispatches") == 1, s
    # DROP MODEL evicts them
    port.must_exec("drop model sc")
    assert port.domain.ml.device_nbytes(h.id) == 0


def test_sql_embed_generated_column_equals_reference(tmp_path):
    ref, port = _both_kits(tmp_path, n=10)
    for kit in (ref, port):
        kit.must_exec(
            "create table d (id bigint primary key, txt varchar(64), "
            "v vector(4) generated always as (embed(emb, txt)) stored)")
        kit.must_exec("insert into d (id, txt) values (1, 'alpha'), "
                      "(2, 'beta'), (3, 'gamma'), (4, null)")
    sql = "select id, v, embed(emb, txt) from d order by id"
    assert port.must_query(sql).rows == ref.must_query(sql).rows

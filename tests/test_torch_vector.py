"""Vector search in tidb_tpu_torch (tidb_tpu_torch/vector/,
executor/vector_search.py) against the reference (tidb_tpu/vector/,
JAX on the CPU).

- Program parity: seeded numpy inputs through the reference's jitted
  programs (build_topk_kernel, build_ivf_score_kernel,
  build_kmeans_step, build_assign_kernel) and the port's on CPU
  tensors, with NaN (NULL) rows, dead rows, duplicated rows straddling
  the k-th key and a zero vector. Keys within rtol 1e-5 (both sides
  float32), indices equal wherever a key is separated from every other
  row's by more than that (an exact tie orders by the lowest row on
  both sides), centroids within rtol 1e-5, assignments equal on
  well-separated clusters (an all-NaN row takes centroid 0 on both).
- SQL parity: the same corpus in a reference TestKit and a port
  TestKit gives equal rows for exact search in all three metrics,
  hybrid search, and IVF at nprobe = nlist.
- Mirrors of tests/test_vector.py, each with the same name, on a port
  TestKit(device="cpu"): exact search runs its torch program on CPU
  tensors, IVF scoring its numpy twin unless TIDB_TPU_VECTOR_DEVICE=1,
  and a degrade takes the host twin as in the reference."""
import numpy as np
import pytest

from tidb_tpu_torch.testkit import TestKit
from tidb_tpu_torch.utils import failpoint, phase
from tidb_tpu_torch.utils import metrics as mu


@pytest.fixture(autouse=True)
def _torch_registries():
    """The shared conftest resets tidb_tpu's registries only."""
    from tidb_tpu_torch.utils import device_guard
    mu.reset_all()
    device_guard.reset()
    phase.reset()
    yield
    failpoint.disable_all()


def _vec_text(v):
    return "[" + ",".join(f"{x:.3f}" for x in np.asarray(v).tolist()) + "]"


def _load(tk, n=2000, dim=8, seed=11, table="docs"):
    tk.must_exec(f"create table {table} "
                 f"(id bigint primary key, e vector({dim}))")
    rng = np.random.RandomState(seed)
    mat = rng.randn(n, dim).astype(np.float32)
    rows = ",".join(f"({i}, '{_vec_text(mat[i])}')" for i in range(n))
    tk.must_exec(f"insert into {table} values " + rows)
    return mat, rng


def _oracle_l2(mat, q, k):
    d = np.linalg.norm(mat.astype(np.float64) - np.asarray(q), axis=1)
    return list(np.argsort(d, kind="stable")[:k])


@pytest.fixture()
def tk():
    return TestKit(device="cpu")


# ---- type surface ------------------------------------------------------

def test_vector_type_and_error_codes(tk):
    tk.must_exec("create table v (id bigint primary key, e vector(4))")
    tk.must_exec("insert into v values (1, '[1,2,3,4]'), (2, null)")
    # canonical text round-trip
    assert tk.must_query("select e from v where id = 1").rows == \
        [("[1,2,3,4]",)]
    # wrong-k insert -> ER 6139, malformed -> ER 6138 (conformance)
    e = tk.exec_err("insert into v values (3, '[1,2]')")
    assert (e.code, e.sqlstate) == (6139, "22000")
    e = tk.exec_err("insert into v values (3, 'oops')")
    assert (e.code, e.sqlstate) == (6138, "22000")
    # distance between mismatched dims -> 6139 (declared column dim)
    e = tk.exec_err("select vec_l2_distance(e, '[1,2]') from v")
    assert e.code == 6139
    e = tk.exec_err("select vec_l2_distance('[1,2]', '[1,2,3]')")
    assert e.code == 6139
    # VECTOR in numeric contexts -> ER 1235, never a NaN coercion
    assert tk.exec_err("select e + 1 from v").code == 1235
    assert tk.exec_err("select sum(e) from v").code == 1235
    assert tk.exec_err("select avg(e) from v").code == 1235
    # vector(0) is not a dimension
    e = tk.exec_err("create table bad (a vector(0))")
    assert e.code == 6139
    # builtins still compute
    assert tk.must_query(
        "select vec_inner_product('[1,2]', '[3,4]'), "
        "vec_dims(e) from v where id = 1").rows == [(11.0, 4)]


def test_show_create_renders_vector(tk):
    tk.must_exec("create table v (id bigint primary key, e vector(3))")
    ddl = tk.must_query("show create table v").rows[0][1]
    assert "`e` vector(3)" in ddl
    tk.must_exec("create vector index vi on v (e) using ivf")
    ddl = tk.must_query("show create table v").rows[0][1]
    assert "VECTOR KEY `vi` (`e`) USING IVF" in ddl


# ---- exact path --------------------------------------------------------

def test_exact_topk_matches_oracle_and_single_dispatch(tk):
    mat, rng = _load(tk)
    q = rng.randn(8).astype(np.float32)
    sql = (f"select id from docs order by "
           f"vec_l2_distance(e, '{_vec_text(q)}') limit 10")
    plan = " ".join(str(r) for r in tk.must_query("explain " + sql).rows)
    assert "VectorSearch" in plan
    got = [r[0] for r in tk.must_query(sql).rows]
    # oracle over the canonicalized stored text (3-decimal round-trip)
    stored = np.array([np.fromstring(_vec_text(mat[i])[1:-1], sep=",")
                       for i in range(len(mat))], dtype=np.float32)
    assert got == _oracle_l2(stored, q.astype(np.float64), 10)
    assert mu.VECTOR_SEARCH.labels("exact").value >= 1
    # steady state: <= 2 dispatches, <= 1 host sync by phase counters
    tk.must_query(sql)
    phase.reset()
    tk.must_query(sql)
    s = phase.snap()
    assert s.get("dispatches", 0) <= 2, s
    assert s.get("syncs", 0) <= 1, s
    assert s.get("upload_bytes", 0) == 0, s   # warm: fully resident


def test_exact_chaos_parity_and_fallback_metric(tk):
    mat, rng = _load(tk, n=1500)
    q = rng.randn(8)
    sql = (f"select id, vec_cosine_distance(e, '{_vec_text(q)}') "
           f"from docs order by vec_cosine_distance(e, '{_vec_text(q)}') "
           "limit 7")
    clean = tk.must_query(sql).rows
    failpoint.enable("device_guard/vector/topk", "error:grant_lost")
    try:
        chaos = tk.must_query(sql).rows
    finally:
        failpoint.disable_all()
    assert clean == chaos
    assert mu.VECTOR_SEARCH.labels("host_fallback").value >= 1


def test_null_vectors_order_first_and_ties_stable(tk):
    tk.must_exec("create table v (id bigint primary key, e vector(2))")
    tk.must_exec("insert into v values (1, '[1,1]'), (2, null), "
                 "(3, '[1,1]'), (4, '[9,9]'), (5, null)")
    rows = tk.must_query(
        "select id from v order by vec_l2_distance(e, '[1,1]') "
        "limit 5").rows
    # MySQL ASC: NULLs first (in row order), then ties in row order
    assert [r[0] for r in rows] == [2, 5, 1, 3, 4]


def test_dirty_txn_overlay_falls_back_host(tk):
    _load(tk, n=600)
    tk.must_exec("begin")
    tk.must_exec("insert into docs values (9999, '[0,0,0,0,0,0,0,0]')")
    rows = tk.must_query(
        "select id from docs order by "
        "vec_l2_distance(e, '[0,0,0,0,0,0,0,0]') limit 1").rows
    tk.must_exec("rollback")
    assert rows[0][0] == 9999      # UnionScan semantics preserved
    assert mu.VECTOR_SEARCH.labels("host_fallback").value >= 1


def test_update_and_delete_visibility(tk):
    tk.must_exec("create table v (id bigint primary key, e vector(2))")
    tk.must_exec("insert into v values (1, '[0,0]'), (2, '[5,5]'), "
                 "(3, '[9,9]')")
    q = "select id from v order by vec_l2_distance(e, '[0,0]') limit 2"
    assert [r[0] for r in tk.must_query(q).rows] == [1, 2]
    tk.must_exec("update v set e = '[100,100]' where id = 1")
    assert [r[0] for r in tk.must_query(q).rows] == [2, 3]
    tk.must_exec("delete from v where id = 2")
    assert [r[0] for r in tk.must_query(q).rows] == [3, 1]


def test_resident_matrix_delta_patch(tk):
    """An append after a warm search tail-patches the resident matrix
    (O(delta) upload) instead of re-uploading it whole."""
    mat, rng = _load(tk, n=1000)
    q = _vec_text(rng.randn(8))
    sql = f"select id from docs order by vec_l2_distance(e, '{q}') limit 5"
    tk.must_query(sql)
    tk.must_query(sql)
    applied0 = mu.DELTA_APPLY.labels("applied").value
    tk.must_exec("insert into docs values (5000, '[9,9,9,9,9,9,9,9]')")
    phase.reset()
    rows = tk.must_query(sql).rows
    s = phase.snap()
    assert mu.DELTA_APPLY.labels("applied").value > applied0
    # the patch moved O(delta) bytes, nowhere near the full matrix
    full = 1024 * 8 * 4
    assert 0 < s.get("upload_bytes", 0) < full, s
    assert len(rows) == 5
    # and the new row is searchable
    got = tk.must_query("select id from docs order by "
                        "vec_l2_distance(e, '[9,9,9,9,9,9,9,9]') "
                        "limit 1").rows
    assert got[0][0] == 5000


# ---- IVF ---------------------------------------------------------------

def test_ivf_lifecycle_recall_and_delta(tk):
    mat, rng = _load(tk, n=3000, dim=8)
    tk.must_exec("create vector index vidx on docs (e) using ivf "
                 "lists = 16")
    q = rng.randn(8)
    sql = (f"select id from docs order by "
           f"vec_l2_distance(e, '{_vec_text(q)}') limit 10")
    ivf = [r[0] for r in tk.must_query(sql).rows]
    assert mu.VECTOR_SEARCH.labels("ivf").value == 1
    assert mu.VECTOR_NPROBE_PARTITIONS.labels().value > 0
    # nprobe=0 disables the index path -> exact
    tk.must_exec("set @@tidb_tpu_vector_nprobe = 0")
    exact = [r[0] for r in tk.must_query(sql).rows]
    assert mu.VECTOR_SEARCH.labels("exact").value == 1
    assert len(set(ivf) & set(exact)) >= 8      # recall@10 on 16 lists
    # probing every partition is exact by construction
    tk.must_exec("set @@tidb_tpu_vector_nprobe = 16")
    assert [r[0] for r in tk.must_query(sql).rows] == exact
    tk.must_exec("set @@tidb_tpu_vector_nprobe = 8")
    # delta path: insert folds, never rebuilds
    tk.must_exec(f"insert into docs values (8888, '{_vec_text(q)}')")
    got = tk.must_query(sql).rows
    assert got[0][0] == 8888
    assert mu.VECTOR_INDEX_DELTA.labels("applied").value >= 1
    assert mu.VECTOR_INDEX_DELTA.labels("rebuild").value == 0
    # tombstones advance without touching postings
    tk.must_exec("delete from docs where id = 8888")
    got = tk.must_query(sql).rows
    assert got[0][0] != 8888
    assert mu.VECTOR_INDEX_DELTA.labels("advanced").value >= 1
    assert mu.VECTOR_INDEX_DELTA.labels("rebuild").value == 0
    # vtable surface
    row = tk.must_query(
        "select table_name, index_name, column_name, centroids, rows "
        "from information_schema.tidb_vector_indexes").rows
    assert row[0][:3] == ("docs", "vidx", "e")
    assert row[0][3] == 16 and row[0][4] >= 3000
    # drop: meta + runtime gone, exact serves
    tk.must_exec("drop index vidx on docs")
    assert tk.must_query(
        "select count(*) from information_schema.tidb_vector_indexes"
    ).rows == [(0,)]
    assert [r[0] for r in tk.must_query(sql).rows][:10] != []


def test_ivf_short_slate_falls_back_exact(tk):
    """Probed partitions emptied by deletes must not shrink a LIMIT:
    when the ANN slate comes back short, the exact path owns the
    answer (review finding: a dead cluster near the query used to
    return 0 rows over a populated table)."""
    tk.must_exec("create table c (id bigint primary key, e vector(4))")
    rows = [f"({i}, '[{i % 2 * 50},{i},0,0]')" for i in range(200)]
    tk.must_exec("insert into c values " + ",".join(rows))
    tk.must_exec("create vector index vi on c (e) using ivf lists = 2")
    tk.must_exec("set @@tidb_tpu_vector_nprobe = 1")
    q = "select id from c order by vec_l2_distance(e, '[0,0,0,0]') limit 5"
    tk.must_query(q)                      # build the index
    tk.must_exec("delete from c where id % 2 = 0")   # kill one cluster
    got = tk.must_query(q).rows
    assert len(got) == 5, got
    # and the rows are the true nearest among the live ones
    assert [r[0] for r in got] == [1, 3, 5, 7, 9]


def test_ivf_chaos_parity_train_and_score(tk):
    """Grant loss injected at the train AND scoring sites: the index
    still builds (numpy Lloyd twin) and ANN answers stay valid."""
    import os
    mat, rng = _load(tk, n=1200)
    os.environ["TIDB_TPU_VECTOR_DEVICE"] = "1"
    failpoint.enable("device_guard/vector/train", "error:grant_lost")
    failpoint.enable("device_guard/vector/ivf", "error:grant_lost")
    try:
        tk.must_exec("create vector index vidx on docs (e) using ivf "
                     "lists = 8")
        q = rng.randn(8)
        rows = tk.must_query(
            f"select id from docs order by "
            f"vec_l2_distance(e, '{_vec_text(q)}') limit 5").rows
        assert len(rows) == 5
    finally:
        failpoint.disable_all()
        os.environ.pop("TIDB_TPU_VECTOR_DEVICE", None)
    st = tk.domain.vector.indexes()
    assert st and st[0][1].built


def test_ivf_device_scoring_matches_host(tk):
    """TIDB_TPU_VECTOR_DEVICE=1 routes candidate scoring through the
    gather+top-k kernel; rows must match the host twin's."""
    import os
    mat, rng = _load(tk, n=1500)
    tk.must_exec("create vector index vidx on docs (e) using ivf "
                 "lists = 8")
    q = rng.randn(8)
    sql = (f"select id from docs order by "
           f"vec_l2_distance(e, '{_vec_text(q)}') limit 10")
    host_rows = tk.must_query(sql).rows
    os.environ["TIDB_TPU_VECTOR_DEVICE"] = "1"
    try:
        dev_rows = tk.must_query(sql).rows
    finally:
        os.environ.pop("TIDB_TPU_VECTOR_DEVICE", None)
    assert host_rows == dev_rows


def test_vector_index_ddl_validation(tk):
    tk.must_exec("create table t (id bigint primary key, s varchar(10), "
                 "e vector(4), u vector)")
    assert tk.exec_err(
        "create vector index i1 on t (s) using ivf").code == 1235
    assert tk.exec_err(
        "create vector index i1 on t (u) using ivf").code == 6139
    assert tk.exec_err(
        "create vector index i1 on t (e) using hnsw").code == 1235
    tk.must_exec("create vector index i1 on t (e) using ivf")
    assert tk.exec_err(
        "create vector index i1 on t (e) using ivf").code == 1061
    # vector index never serves KV plans or write maintenance
    tk.must_exec("insert into t values (1, 'x', '[1,2,3,4]', '[1]')")
    tk.must_exec("admin check table t")
    tk.must_exec("drop index i1 on t")
    assert tk.exec_err("drop index i1 on t").code == 1176


def test_top_sql_attributes_vector_device_ms(tk):
    """Vector kernel time rides phase.snap() into Top SQL per-digest
    rows (the kernels run through the copr kernel cache's phase
    wrapper)."""
    mat, rng = _load(tk, n=1200)
    q = _vec_text(rng.randn(8))
    sql = f"select id from docs order by vec_l2_distance(e, '{q}') limit 3"
    tk.must_query(sql)
    tk.must_query(sql)
    rows = tk.must_query(
        "select sql_text, sum_ms, sum_device_ms from "
        "information_schema.tidb_top_sql").rows
    mine = [r for r in rows if "vec_l2_distance" in r[0]]
    assert mine and mine[0][2] > 0, rows


# ---- program parity with the reference --------------------------------

METRICS = ("vec_l2_distance", "vec_cosine_distance",
           "vec_negative_inner_product")


def _corpus(seed, n=600, dim=8):
    """Rows with NaN (NULL) rows, dead rows, a zero vector and groups of
    duplicated rows; -> (mat, valid, q, group id per row: duplicated
    rows share theirs)."""
    rng = np.random.default_rng(seed)
    mat = rng.standard_normal((n, dim)).astype(np.float32)
    group = np.arange(n)
    for src in rng.choice(n, 12, replace=False):
        dst = rng.choice(n, 3, replace=False)
        mat[dst] = mat[src]
        group[dst] = group[src]
    nan_rows = rng.choice(n, 9, replace=False)
    mat[nan_rows] = np.nan
    mat[rng.integers(0, n)] = 0.0
    valid = rng.random(n) > 0.1
    q = rng.standard_normal(dim).astype(np.float32)
    return mat, valid, q, group


def _keys_np(mat, valid, q, metric):
    from tidb_tpu_torch.vector import kernels as pk
    with np.errstate(invalid="ignore", divide="ignore"):
        return pk._select_key_xp(np, pk.host_distances(mat, q, metric),
                                 valid)


def _separated(key_all, group, rows, keys, rtol=1e-5):
    """Per slate position: every row whose key lies within rtol of it
    (and is not exactly equal: duplicated rows, infinite keys and a
    zero query's zeros tie exactly on both sides, lowest row first) is
    the row itself or one of its duplicates."""
    out = []
    for r, k in zip(rows, keys):
        if not np.isfinite(k):
            out.append(True)
            continue
        near = (np.abs(key_all - k) <= rtol * max(abs(k), 1e-30)) & \
            (key_all != k)
        out.append(bool(np.all(group[near] == group[r])))
    return np.array(out, dtype=bool)


def _check_slate(ref, got, key_all, group):
    rk, ri = (np.asarray(a) for a in ref)
    gk, gi = (a.numpy() for a in got)
    assert gk.dtype == np.float32 and gi.dtype == np.int32
    np.testing.assert_allclose(gk, rk, rtol=1e-5, atol=0)
    sep = _separated(key_all, group, ri, rk)
    assert sep.sum() > len(sep) // 2
    np.testing.assert_array_equal(gi[sep], ri[sep])


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("seed", [3, 4])
def test_topk_program_equals_reference(metric, seed):
    import torch
    from tidb_tpu.vector import kernels as rk
    from tidb_tpu_torch.vector import kernels as pk
    mat, valid, q, group = _corpus(seed)
    kcap = 64
    ref = rk.build_topk_kernel(metric, kcap)(mat, valid, q)
    got = pk.build_topk_kernel(metric, kcap)(
        torch.from_numpy(mat), torch.from_numpy(valid), torch.from_numpy(q))
    _check_slate(ref, got, _keys_np(mat, valid, q, metric), group)


@pytest.mark.parametrize("metric", METRICS)
def test_topk_program_zero_query_all_tied(metric):
    """A zero query vector: every cosine key is NaN -> +inf (all tied),
    so the slate is the lowest rows, as lax.top_k orders them."""
    import torch
    from tidb_tpu.vector import kernels as rk
    from tidb_tpu_torch.vector import kernels as pk
    mat, valid, _q, group = _corpus(5)
    q = np.zeros(mat.shape[1], dtype=np.float32)
    ref = rk.build_topk_kernel(metric, 32)(mat, valid, q)
    got = pk.build_topk_kernel(metric, 32)(
        torch.from_numpy(mat), torch.from_numpy(valid), torch.from_numpy(q))
    _check_slate(ref, got, _keys_np(mat, valid, q, metric), group)


@pytest.mark.parametrize("metric", METRICS)
def test_ivf_score_program_equals_reference(metric):
    import torch
    from tidb_tpu.vector import kernels as rk
    from tidb_tpu_torch.vector import kernels as pk
    mat, valid, q, group = _corpus(6)
    rng = np.random.default_rng(6)
    cand = rng.choice(len(mat), 300, replace=False).astype(np.int32)
    ccap = 512
    pc = np.zeros(ccap, dtype=np.int32)
    pc[:len(cand)] = cand
    cv = np.zeros(ccap, dtype=bool)
    cv[:len(cand)] = valid[cand]
    kcap = 32
    ref = rk.build_ivf_score_kernel(metric, kcap)(mat, pc, cv, q)
    got = pk.build_ivf_score_kernel(metric, kcap)(
        torch.from_numpy(mat), torch.from_numpy(pc), torch.from_numpy(cv),
        torch.from_numpy(q))
    key_all = np.full(len(mat), -np.inf, dtype=np.float32)
    key_all[cand] = _keys_np(mat[cand], valid[cand], q, metric)
    _check_slate(ref, got, key_all, group)


def test_topk_plain_version_equals_select_topk():
    import torch
    from tidb_tpu_torch.vector import kernels as pk
    rng = np.random.default_rng(8)
    key = rng.choice(np.array([-np.inf, -2.5, -0.0, 0.0, 1.5, np.inf],
                              dtype=np.float32), 5000)
    key = torch.from_numpy(key)
    for kcap in (1, 16, 300, 5000):
        a, b = pk.select_topk(key, kcap), pk.select_topk_plain(key, kcap)
        assert torch.equal(a[1], b[1]) and torch.equal(a[0], b[0])


def _clusters(seed, n=1500, dim=8, nlist=8):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((nlist, dim)).astype(np.float32) * 20
    lab = rng.integers(0, nlist, n)
    mat = (centers[lab] + rng.standard_normal((n, dim)) * 0.3).astype(
        np.float32)
    mat[rng.choice(n, 7, replace=False)] = np.nan
    # NULL rows are never live (the caller, IVFIndex._train_locked, ANDs
    # ~isnan into validity): the step zeroes them before its sums
    valid = (rng.random(n) > 0.05) & ~np.isnan(mat[:, 0])
    first = [int(np.nonzero((lab == c) & valid &
                            ~np.isnan(mat[:, 0]))[0][0])
             for c in range(nlist)]
    return mat, valid, mat[first].copy()


def test_kmeans_step_equals_reference():
    import torch
    from tidb_tpu.vector import kernels as rk
    from tidb_tpu_torch.vector import kernels as pk
    mat, valid, cent = _clusters(9)
    rstep, pstep = rk.build_kmeans_step(), pk.build_kmeans_step()
    rc, pc = cent, torch.from_numpy(cent)
    for _ in range(3):
        rc = rstep(mat, valid, rc)
        pc = pstep(torch.from_numpy(mat), torch.from_numpy(valid), pc)
        assert pc.dtype == torch.float32
        np.testing.assert_allclose(pc.numpy(), np.asarray(rc), rtol=1e-5,
                                   atol=0)
    # an empty cluster keeps its centroid on both sides
    far = np.vstack([cent, np.full((1, cent.shape[1]), 1e4, np.float32)])
    np.testing.assert_allclose(
        pstep(torch.from_numpy(mat), torch.from_numpy(valid),
              torch.from_numpy(far)).numpy(),
        np.asarray(rstep(mat, valid, far)), rtol=1e-5, atol=0)


def test_assign_program_equals_reference():
    import torch
    from tidb_tpu.vector import kernels as rk
    from tidb_tpu_torch.vector import kernels as pk
    mat, _valid, cent = _clusters(10)
    ref = np.asarray(rk.build_assign_kernel()(mat, cent))
    got = pk.build_assign_kernel()(torch.from_numpy(mat),
                                   torch.from_numpy(cent))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    nan = np.isnan(mat[:, 0])
    assert nan.any() and (got.numpy()[nan] == 0).all()
    # in row chunks (as at 1 M rows) the ids are the same
    np.testing.assert_array_equal(
        pk.assign_rows(torch.from_numpy(mat), torch.from_numpy(cent),
                       chunk=97).numpy(), ref)
    np.testing.assert_array_equal(
        np.asarray(pk.host_assign(mat, cent)), ref)


def test_tail_patch_leaves_old_buffer():
    import torch
    from tidb_tpu_torch.vector import kernels as pk
    buf = torch.full((8, 2), float("nan"))
    upd = torch.arange(6, dtype=torch.float32).reshape(3, 2)
    new = pk.patch_rows(buf, upd, 4)
    assert torch.isnan(buf).all()
    assert torch.equal(new[4:7], upd) and torch.isnan(new[:4]).all()


# ---- SQL parity with the reference ------------------------------------

def _both(n=1500, dim=8, seed=12):
    from tidb_tpu.testkit import TestKit as RefKit
    rng = np.random.RandomState(seed)
    mat = rng.randn(n, dim).astype(np.float32)
    mat[rng.randint(0, n, 40)] = mat[7]          # ties with row 7
    rows = ",".join(
        f"({i}, {i % 100}, " +
        ("null" if i % 97 == 5 else f"'{_vec_text(mat[i])}'") + ")"
        for i in range(n))
    kits = []
    for kit in (RefKit(), TestKit(device="cpu")):
        kit.must_exec(f"create table h (id bigint primary key, grp bigint, "
                      f"e vector({dim}))")
        kit.must_exec("insert into h values " + rows)
        kits.append(kit)
    return kits, mat, rng


@pytest.mark.parametrize("metric", METRICS)
def test_sql_exact_and_hybrid_equal_reference(metric):
    (ref, port), mat, rng = _both()
    for q in (rng.randn(8), mat[7]):
        for where in ("", "where grp < 10 ", "where grp = 7 "):
            sql = (f"select id, {metric}(e, '{_vec_text(q)}') from h "
                   f"{where}order by {metric}(e, '{_vec_text(q)}') "
                   "limit 12")
            plan = " ".join(map(str, port.must_query("explain " + sql).rows))
            assert "VectorSearch" in plan
            assert port.must_query(sql).rows == ref.must_query(sql).rows, sql
    assert mu.VECTOR_SEARCH.labels("exact").value >= 2
    assert mu.VECTOR_SEARCH.labels("hybrid_exact").value >= 4


@pytest.mark.parametrize("metric", METRICS)
def test_sql_ivf_full_probe_equals_reference(metric):
    (ref, port), _mat, rng = _both(seed=13)
    for kit in (ref, port):
        kit.must_exec("create vector index hv on h (e) using ivf lists = 8")
        kit.must_exec("set @@tidb_tpu_vector_nprobe = 8")
    q = _vec_text(rng.randn(8))
    for where in ("", "where grp < 30 "):
        sql = (f"select id from h {where}order by {metric}(e, '{q}') "
               "limit 10")
        assert port.must_query(sql).rows == ref.must_query(sql).rows
    assert mu.VECTOR_SEARCH.labels("ivf").value >= 1


def test_sql_duplicates_straddle_kth_key():
    """Rows equal to the k-th nearest straddle the LIMIT boundary: both
    engines keep the lowest ids of the tied group."""
    (ref, port), mat, _rng = _both(seed=14)
    for metric in METRICS:
        sql = (f"select id from h order by {metric}(e, "
               f"'{_vec_text(mat[7] * 1.01)}') limit 20")
        got = port.must_query(sql).rows
        assert got == ref.must_query(sql).rows, metric

"""Vector search and a fused predict() over the port's MPP mesh
(tidb_tpu_torch/vector/runtime.py, vector/kernels.py mesh programs,
ml/runtime.py device_weights) against the reference (tidb_tpu, whose
TestKit shards the vector matrix over its 8 virtual CPU devices) and the
port's single-device route. ~25 s on the CPU.

- Program parity: build_topk_mesh_kernel / build_ivf_score_mesh_kernel
  over a Sharded matrix of 8 shards against the reference's jitted
  programs over its row-sharded array (keys rtol 1e-5, rows equal where
  a key is separated from every other row's; exact ties order by the
  lowest global row on both sides), and exactly equal to the port's
  single-device programs' slates where both read the same rows.
- SQL parity: TestKit(device="cpu", mesh=8), a single-device port
  TestKit and the reference's TestKit over the same seeded rows give
  equal rows for exact search in three metrics (ties straddling a shard
  boundary, NULL vectors in every shard, a slate wider than a shard),
  hybrid search at 1 % and IVF (>= 4,096 rows: the device assignment
  runs; IVF scoring forced onto the device program).
- The mesh route's bookkeeping: the matrix and its validity mask are
  "sharded" entries, a tail patch straddling a shard boundary folds
  into them (one delta apply, no whole upload) and its rows are found,
  a warm statement takes <= 2 dispatches, <= 1 sync and 0 upload bytes,
  and IVF training over the gathered shards equals the single-device
  training of the same table.
- predict() fused in a filter with MPP on: the fused-mpp route, the
  reference's rows, weights resident per device, 0 upload bytes warm."""
import contextlib
import os

import numpy as np
import pytest

from tidb_tpu_torch.testkit import TestKit
from tidb_tpu_torch.utils import failpoint, phase
from tidb_tpu_torch.utils import metrics as mu

METRICS = ("vec_l2_distance", "vec_cosine_distance",
           "vec_negative_inner_product")
NDEV = 8
# 4,470 rows: capacity 5,120 on the mesh (shape_bucket, a multiple of
# 128 x 8), 640 rows per shard, so the shard boundaries are at multiples
# of 640 and a 20-row insert at 4,470 straddles the one at 4,480
N_ROWS, DIM = 4470, 8
LOCAL = 640


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
def device_scoring():
    """IVF scoring on the device program (the CPU's default is its
    numpy twin)."""
    os.environ["TIDB_TPU_VECTOR_DEVICE"] = "1"
    yield
    os.environ.pop("TIDB_TPU_VECTOR_DEVICE", None)


def _vec_text(v):
    return "[" + ",".join(f"{x:.3f}" for x in np.asarray(v).tolist()) + "]"


def _stored(mat):
    """The float32 rows the engines parse from _vec_text."""
    return np.array([np.fromstring(_vec_text(r)[1:-1], sep=",")
                     for r in mat], dtype=np.float32)


def _table(seed=12, n=N_ROWS):
    """Seeded rows: ties with row 7 straddling the shard boundary at
    1,280 (rows 1,270-1,289) and the k-th key of a query near row 7,
    NULL vectors in every shard (i % 97 == 5), grp = i % 100."""
    rng = np.random.RandomState(seed)
    mat = rng.randn(n, DIM).astype(np.float32)
    mat[2 * LOCAL - 10:2 * LOCAL + 10] = mat[7]
    nulls = np.arange(n) % 97 == 5
    rows = ",".join(
        f"({i}, {i % 100}, " +
        ("null" if nulls[i] else f"'{_vec_text(mat[i])}'") + ")"
        for i in range(n))
    return mat, nulls, rows, rng


NNULL = len(range(5, N_ROWS, 97))      # NULL vectors: first in every slate


def _non_null(rows):
    return [r[0] for r in rows if r[0] >= N_ROWS or r[0] % 97 != 5]


def _kit(kit, rows):
    kit.must_exec(f"create table h (id bigint primary key, grp bigint, "
                  f"e vector({DIM}))")
    kit.must_exec("insert into h values " + rows)
    return kit


def _kits(seed=12, n=N_ROWS):
    """(reference, port single-device, port mesh of 8), mat, rng."""
    from tidb_tpu.testkit import TestKit as RefKit
    mat, _nulls, rows, rng = _table(seed, n)
    kits = [_kit(k, rows) for k in (RefKit(), TestKit(device="cpu"),
                                    TestKit(device="cpu", mesh=NDEV))]
    return kits, mat, rng


@contextlib.contextmanager
def _single(kit):
    """The kit's copr without its mesh (every route on one device)."""
    copr = kit.domain.copr
    copr._mesh = False
    try:
        yield
    finally:
        copr._mesh = None


def _warm_ok(kit, sql):
    kit.must_query(sql)
    phase.reset()
    rows = kit.must_query(sql).rows
    s = phase.snap()
    assert s.get("dispatches", 0) <= 2, s
    assert s.get("syncs", 0) <= 1, s
    assert s.get("upload_bytes", 0) == 0, s
    return rows


# ---- the mesh programs against the reference's sharded programs -------

def _corpus(seed, n=2048):
    rng = np.random.default_rng(seed)
    mat = rng.standard_normal((n, DIM)).astype(np.float32)
    group = np.arange(n)
    # a tied group straddling the boundary between shards 3 and 4
    lo = 4 * (n // NDEV) - 3
    mat[lo:lo + 6] = mat[11]
    group[lo:lo + 6] = 11
    mat[rng.choice(n, 9, replace=False)] = np.nan
    valid = rng.random(n) > 0.1
    q = rng.standard_normal(DIM).astype(np.float32)
    return mat, valid, q, group


def _keys_np(mat, valid, q, metric):
    from tidb_tpu_torch.vector import kernels as pk
    with np.errstate(invalid="ignore", divide="ignore"):
        return pk._select_key_xp(np, pk.host_distances(mat, q, metric),
                                 valid)


def _separated(key_all, group, rows, keys, rtol=1e-5):
    out = []
    for r, k in zip(rows, keys):
        if not np.isfinite(k):
            out.append(True)
            continue
        near = (np.abs(key_all - k) <= rtol * max(abs(k), 1e-30)) & \
            (key_all != k)
        out.append(bool(np.all(group[near] == group[r])))
    return np.array(out, dtype=bool)


def _ref_sharded(*arrays):
    import jax
    from tidb_tpu.parallel import make_mesh, row_sharding
    mesh = make_mesh(NDEV)
    return [jax.device_put(a, row_sharding(mesh)) for a in arrays]


def _port_mesh():
    from tidb_tpu_torch.parallel.mesh import Mesh
    return Mesh(["cpu"] * NDEV)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("kcap", [64, 512])
def test_topk_mesh_program_equals_reference(metric, kcap):
    """kcap 512 is wider than a shard's 256 rows."""
    import torch
    from tidb_tpu.vector import kernels as rk
    from tidb_tpu_torch.parallel.mesh import place_replicated, \
        place_sharded
    from tidb_tpu_torch.vector import kernels as pk
    mat, valid, q, group = _corpus(3)
    dmat, dvalid = _ref_sharded(mat, valid)
    ref = rk.build_topk_kernel(metric, kcap)(dmat, dvalid, q)
    mesh = _port_mesh()
    local = len(mat) // NDEV
    got = pk.build_topk_mesh_kernel(metric, kcap, mesh, local,
                                    torch.device("cpu"))(
        place_sharded(mesh, mat), place_sharded(mesh, valid),
        place_replicated(mesh, q))
    rkeys, ridx = (np.asarray(a) for a in ref)
    gk, gi = (a.numpy() for a in got)
    assert gk.dtype == np.float32 and gi.dtype == np.int32
    np.testing.assert_allclose(gk, rkeys, rtol=1e-5, atol=0)
    sep = _separated(_keys_np(mat, valid, q, metric), group, ridx, rkeys)
    assert sep.sum() > len(sep) // 2
    np.testing.assert_array_equal(gi[sep], ridx[sep])
    # the single-device program over the same rows: the same slate
    one = pk.build_topk_kernel(metric, kcap)(
        torch.from_numpy(mat), torch.from_numpy(valid), torch.from_numpy(q))
    np.testing.assert_allclose(gk, one[0].numpy(), rtol=1e-5, atol=0)
    np.testing.assert_array_equal(gi[sep], one[1].numpy()[sep])


def test_topk_mesh_program_ties_across_shards():
    """Every row tied (a zero query under cosine: all keys NaN -> +inf):
    the slate is rows 0..kcap-1 in order, across shard boundaries, as
    lax.top_k over the whole array orders them."""
    import torch
    from tidb_tpu.vector import kernels as rk
    from tidb_tpu_torch.parallel.mesh import place_replicated, \
        place_sharded
    from tidb_tpu_torch.vector import kernels as pk
    mat, _valid, _q, _group = _corpus(4)
    valid = np.ones(len(mat), dtype=bool)
    q = np.zeros(DIM, dtype=np.float32)
    kcap = 600                          # over two shards of 256 rows
    dmat, dvalid = _ref_sharded(mat, valid)
    ref = rk.build_topk_kernel("vec_cosine_distance", kcap)(dmat, dvalid, q)
    mesh = _port_mesh()
    got = pk.build_topk_mesh_kernel(
        "vec_cosine_distance", kcap, mesh, len(mat) // NDEV,
        torch.device("cpu"))(place_sharded(mesh, mat),
                             place_sharded(mesh, valid),
                             place_replicated(mesh, q))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[1].numpy(), np.arange(kcap))


@pytest.mark.parametrize("metric", METRICS)
def test_ivf_score_mesh_program_equals_reference(metric):
    import torch
    from tidb_tpu.vector import kernels as rk
    from tidb_tpu_torch.parallel.mesh import place_replicated, \
        place_sharded
    from tidb_tpu_torch.vector import kernels as pk
    mat, valid, q, group = _corpus(6)
    rng = np.random.default_rng(6)
    cand = rng.choice(len(mat), 700, replace=False).astype(np.int32)
    ccap = 1024
    pc = np.zeros(ccap, dtype=np.int32)
    pc[:len(cand)] = cand
    cv = np.zeros(ccap, dtype=bool)
    cv[:len(cand)] = valid[cand]
    kcap = 64
    (dmat,) = _ref_sharded(mat)
    ref = rk.build_ivf_score_kernel(metric, kcap)(dmat, pc, cv, q)
    mesh = _port_mesh()
    got = pk.build_ivf_score_mesh_kernel(
        metric, kcap, mesh, len(mat) // NDEV, torch.device("cpu"))(
        place_sharded(mesh, mat), place_replicated(mesh, pc),
        place_replicated(mesh, cv), place_replicated(mesh, q))
    one = pk.build_ivf_score_kernel(metric, kcap)(
        torch.from_numpy(mat), torch.from_numpy(pc), torch.from_numpy(cv),
        torch.from_numpy(q))
    rkeys, ridx = (np.asarray(a) for a in ref)
    np.testing.assert_allclose(got[0].numpy(), rkeys, rtol=1e-5, atol=0)
    key_all = np.full(len(mat), -np.inf, dtype=np.float32)
    key_all[cand] = _keys_np(mat[cand], valid[cand], q, metric)
    sep = _separated(key_all, group, ridx, rkeys)
    assert sep.sum() > len(sep) // 2
    np.testing.assert_array_equal(got[1].numpy()[sep], ridx[sep])
    # the owner's key is the single-device program's key, bit for bit
    assert torch.equal(got[0], one[0]) and torch.equal(got[1], one[1])


def _apart(sh):
    """The same shards as separate tensors (no common buffer): the
    layout of shards on distinct devices."""
    from tidb_tpu_torch.parallel.mesh import Sharded
    return Sharded(sh.mesh, [s.clone() for s in sh.shards])


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("kcap", [64, 600])
def test_topk_mesh_program_one_buffer_equals_apart(metric, kcap):
    """The batched form (every shard a row block of one buffer: one
    scoring launch, one top-k over the [shards, local] view) and the
    per-shard form (shards apart) give the same slate bit for bit, and
    it is the single-device program's slate over the same rows."""
    import torch
    from tidb_tpu_torch.parallel.mesh import place_replicated, \
        place_sharded
    from tidb_tpu_torch.vector import kernels as pk
    mat, valid, q, _group = _corpus(7)
    mesh = _port_mesh()
    prog = pk.build_topk_mesh_kernel(metric, kcap, mesh, len(mat) // NDEV,
                                     torch.device("cpu"))
    smat, svalid = place_sharded(mesh, mat), place_sharded(mesh, valid)
    dq = place_replicated(mesh, q)
    assert smat.full is not None
    whole = prog(smat, svalid, dq)
    apart = prog(_apart(smat), _apart(svalid), dq)
    one = pk.build_topk_kernel(metric, kcap)(
        torch.from_numpy(mat), torch.from_numpy(valid), torch.from_numpy(q))
    for got in (apart, one):
        assert torch.equal(whole[0], got[0].to(whole[0].dtype))
        assert torch.equal(whole[1], got[1].to(whole[1].dtype))


@pytest.mark.parametrize("metric", METRICS)
def test_ivf_score_mesh_program_one_buffer_equals_apart(metric):
    """IVF scoring reads each candidate from its owner shard: one gather
    from the common buffer, or one gather per shard apart; equal slates
    bit for bit."""
    import torch
    from tidb_tpu_torch.parallel.mesh import place_replicated, \
        place_sharded
    from tidb_tpu_torch.vector import kernels as pk
    mat, valid, q, _group = _corpus(8)
    rng = np.random.default_rng(8)
    pc = np.zeros(1024, dtype=np.int32)
    pc[:700] = rng.choice(len(mat), 700, replace=False)
    cv = np.zeros(1024, dtype=bool)
    cv[:700] = valid[pc[:700]]
    mesh = _port_mesh()
    prog = pk.build_ivf_score_mesh_kernel(metric, 64, mesh,
                                          len(mat) // NDEV,
                                          torch.device("cpu"))
    smat = place_sharded(mesh, mat)
    args = [place_replicated(mesh, a) for a in (pc, cv, q)]
    whole, apart = prog(smat, *args), prog(_apart(smat), *args)
    assert torch.equal(whole[0], apart[0])
    assert torch.equal(whole[1], apart[1])


def test_sharded_patch_straddling_a_boundary_leaves_old_buffer():
    """Sharded.patched over one contiguous buffer and over separate
    shard tensors (shards on distinct devices): rows 13..18 straddle the
    boundary of shards 0 and 1; the old buffer is never written."""
    from tidb_tpu_torch.parallel.mesh import Mesh, Sharded, place_sharded
    mat = np.arange(64 * 3, dtype=np.float32).reshape(64, 3)
    mesh = Mesh(["cpu"] * 4)
    whole = place_sharded(mesh, mat)
    apart = Sharded(mesh, [s.clone() for s in whole.shards])
    tail = -np.ones((6, 3), dtype=np.float32)
    want = mat.copy()
    want[13:19] = tail
    for sh in (whole, apart):
        new = sh.patched(tail, 13)
        np.testing.assert_array_equal(new.numpy(), want)
        np.testing.assert_array_equal(sh.numpy(), mat)
        np.testing.assert_array_equal(new.gather("cpu").numpy(), want)
    # untouched shards of separate tensors are shared, not copied
    new = apart.patched(tail, 13)
    assert new.shards[2] is apart.shards[2]
    assert new.shards[0] is not apart.shards[0]


# ---- SQL over the mesh -------------------------------------------------

@pytest.mark.parametrize("metric", METRICS)
def test_sql_exact_on_mesh_equals_reference_and_single(metric):
    (ref, one, mesh), mat, rng = _kits()
    for q, limit in ((rng.randn(DIM), 12), (mat[7] * 1.01, 20),
                     (mat[7], 40), (rng.randn(DIM), 300)):
        sql = (f"select id, {metric}(e, '{_vec_text(q)}') from h order by "
               f"{metric}(e, '{_vec_text(q)}') limit {limit}")
        want = ref.must_query(sql).rows
        assert one.must_query(sql).rows == want, sql
        assert mesh.must_query(sql).rows == want, sql
    # NULL vectors first (ascending), one per shard
    sql = (f"select id from h order by {metric}(e, '{_vec_text(mat[3])}') "
           "limit 10")
    got = [r[0] for r in mesh.must_query(sql).rows]
    assert got[:8] == [i for i in range(N_ROWS) if i % 97 == 5][:8]
    assert mu.VECTOR_SEARCH.labels("exact").value >= 9
    stats = mesh.domain.copr._dev_store.stats()
    # the matrix (5,120 x 8 float32) and its validity mask
    assert stats["bytes_by_spec"]["sharded"] >= 5120 * DIM * 4 + 5120, stats
    assert stats["bytes_by_spec"]["local"] == 0, stats


def test_sql_ties_straddle_shard_boundary():
    """Row 7's copies at rows 1,270-1,289 straddle the boundary at 1,280
    and the LIMIT: every engine keeps 7 and the lowest copies."""
    (ref, one, mesh), mat, _rng = _kits()
    for metric in METRICS:
        sql = (f"select id from h order by {metric}(e, "
               f"'{_vec_text(mat[7])}') limit 15")
        got = mesh.must_query(sql).rows
        assert got == ref.must_query(sql).rows == one.must_query(sql).rows
    sql = (f"select id from h order by vec_l2_distance(e, "
           f"'{_vec_text(mat[7])}') limit {NNULL + 15}")
    assert _non_null(mesh.must_query(sql).rows) == \
        [7] + list(range(1270, 1284))


def test_sql_hybrid_on_mesh_equals_reference():
    (ref, one, mesh), mat, rng = _kits()
    for metric in METRICS:
        for where in ("where grp = 7 ", "where grp < 30 ", ""):
            q = _vec_text(rng.randn(DIM))
            sql = (f"select id from h {where}order by {metric}(e, '{q}') "
                   "limit 10")
            want = ref.must_query(sql).rows
            assert one.must_query(sql).rows == want
            assert mesh.must_query(sql).rows == want
    assert mu.VECTOR_SEARCH.labels("hybrid_exact").value >= 6
    _warm_ok(mesh, sql)


def test_sql_warm_mesh_statement_is_resident():
    (_ref, _one, mesh), mat, _rng = _kits()
    sql = (f"select id from h order by vec_l2_distance(e, "
           f"'{_vec_text(mat[100])}') limit {NNULL + 10}")
    rows = _warm_ok(mesh, sql)
    assert _non_null(rows)[0] == 100
    store = mesh.domain.copr._dev_store
    specs = {k[1]: store.spec_of(k) for k in list(store._entries)
             if isinstance(k, tuple) and len(k) > 1}
    assert specs.get("vecvalid") == "sharded", specs
    mats = [k for k in store._entries if k[0] == "vecmat"]
    assert len(mats) == 1 and store.spec_of(mats[0]) == "sharded"
    assert mats[0][-2:] == (NDEV, 5120)


def test_sql_ivf_on_mesh(device_scoring):
    """IVF on the mesh: rows == the reference's at nprobe = nlist; the
    training over the gathered shards == the same table's single-device
    training (centroids and postings); rows at nprobe 4 == the
    single-device route's; warm <= 2 dispatches, <= 1 sync, 0 upload."""
    (ref, _one, mesh), _mat, rng = _kits(seed=13)
    qs = [_vec_text(rng.randn(DIM)) for _ in range(3)]
    with _single(mesh):
        mesh.must_exec("create vector index hv on h (e) using ivf lists = 16")
        mesh.must_exec("set @@tidb_tpu_vector_nprobe = 4")
        single = [mesh.must_query(f"select id from h order by "
                                  f"vec_l2_distance(e, '{q}') limit 10").rows
                  for q in qs]
        idx = mesh.domain.vector.indexes()[0][1]
        cent1 = idx.centroids.copy()
        post1 = [np.concatenate(p) if p else np.empty(0, np.int64)
                 for p in idx._post]
    mesh.must_exec("drop index hv on h")
    mesh.must_exec("create vector index hv on h (e) using ivf lists = 16")
    got = [mesh.must_query(f"select id from h order by "
                           f"vec_l2_distance(e, '{q}') limit 10").rows
           for q in qs]
    idx = mesh.domain.vector.indexes()[0][1]
    np.testing.assert_array_equal(idx.centroids, cent1)
    post = [np.concatenate(p) if p else np.empty(0, np.int64)
            for p in idx._post]
    assert all(np.array_equal(a, b) for a, b in zip(post, post1))
    assert got == single
    assert mu.VECTOR_SEARCH.labels("ivf").value >= 6
    _warm_ok(mesh, f"select id from h order by vec_l2_distance(e, "
                   f"'{qs[0]}') limit 10")
    # against the reference at full probe (the answer is the exact one)
    ref.must_exec("create vector index hv on h (e) using ivf lists = 16")
    for kit in (ref, mesh):
        kit.must_exec("set @@tidb_tpu_vector_nprobe = 16")
    for metric in METRICS:
        for where in ("", "where grp < 30 "):
            sql = (f"select id from h {where}order by {metric}(e, "
                   f"'{qs[1]}') limit 10")
            assert mesh.must_query(sql).rows == ref.must_query(sql).rows


def test_sql_tail_patch_straddles_shard_boundary(device_scoring):
    """20 rows appended at 4,470..4,489 straddle the shard boundary at
    4,480: the sharded matrix folds them (one delta apply, no whole
    upload), exact and IVF searches find them, and the rows equal the
    reference's."""
    (ref, _one, mesh), mat, _rng = _kits()
    mesh.must_exec("create vector index hv on h (e) using ivf lists = 8")
    ref.must_exec("create vector index hv on h (e) using ivf lists = 8")
    q0 = _vec_text(mat[5])
    mesh.must_query(f"select id from h order by vec_l2_distance(e, '{q0}') "
                    "limit 10")
    new = mat[:20] + np.float32(0.25)
    ins = "insert into h values " + ",".join(
        f"({N_ROWS + i}, 1, '{_vec_text(v)}')" for i, v in enumerate(new))
    for kit in (ref, mesh):
        kit.must_exec(ins)
        kit.must_exec("set @@tidb_tpu_vector_nprobe = 0")
    applied = mu.DELTA_APPLY.labels("applied").value
    for i in (3, 12, 19):               # both sides of the boundary
        sql = (f"select id from h order by vec_l2_distance(e, "
               f"'{_vec_text(new[i])}') limit {NNULL + 5}")
        phase.reset()
        got = mesh.must_query(sql).rows
        s = phase.snap()
        assert _non_null(got)[0] == N_ROWS + i, got
        assert got == ref.must_query(sql).rows
        if i == 3:
            assert s.get("delta_applies", 0) == 1, s
            # the fold's rows and the new version's validity mask (5,120
            # bools), no whole matrix
            assert s.get("upload_bytes", 0) == \
                s.get("delta_bytes") + 5120, s
    assert mu.DELTA_APPLY.labels("applied").value == applied + 1
    mats = [k for k in mesh.domain.copr._dev_store._entries
            if k[0] == "vecmat"]
    assert len(mats) == 1 and mats[0][-1] == 5120
    for kit in (ref, mesh):
        kit.must_exec("set @@tidb_tpu_vector_nprobe = 8")
    sql = (f"select id from h where grp = 1 order by vec_l2_distance(e, "
           f"'{_vec_text(new[9])}') limit 5")
    got = mesh.must_query(sql).rows
    assert got[0][0] == N_ROWS + 9, got
    assert got == ref.must_query(sql).rows


# ---- predict() over the mesh -------------------------------------------

def _ml_kits(tmp_path, n=5000):
    from tidb_tpu.testkit import TestKit as RefKit
    rng = np.random.RandomState(21)
    p = str(tmp_path / "m.npz")
    W0 = rng.randn(3, 16).astype(np.float32)
    b0 = rng.randn(16).astype(np.float32)
    W1 = rng.randn(16, 1).astype(np.float32)
    b1 = np.zeros(1, dtype=np.float32)
    a = np.round(rng.randn(n), 6)
    b = rng.randint(0, 100000, n) / 100
    c = rng.randint(-5, 6, n)
    vals = ",".join(f"({i}, {a[i]:.6f}, {b[i]:.2f}, " +
                    ("null" if i % 53 == 0 else str(c[i])) + ")"
                    for i in range(n))
    # the last bias centres the scores: about half the rows pass
    X = np.c_[a, b, c].astype(np.float32)
    h = np.maximum(X @ W0 + b0, 0)
    b1[0] = -np.median(h @ W1[:, 0])
    np.savez(p, W0=W0, b0=b0, W1=W1, b1=b1)
    kits = []
    for kit in (RefKit(), TestKit(device="cpu", mesh=NDEV)):
        kit.must_exec(f"create model sc from '{p}'")
        kit.must_exec("create table t (id bigint primary key, a double, "
                      "b decimal(10,2), c bigint)")
        kit.must_exec("insert into t values " + vals)
        kit.must_exec("set @@tidb_enable_mpp = on")
        kit.must_exec("set @@tidb_mpp_min_rows = 0")
        kits.append(kit)
    return kits


def test_fused_predict_on_mesh_equals_reference(tmp_path):
    ref, port = _ml_kits(tmp_path)
    scores = "select id, predict(sc, a, b, c) from t order by id"
    near0 = {r[0] for r in ref.must_query(scores).rows
             if r[1] is not None and abs(r[1]) < 1e-4}
    dom = port.domain
    for sql in ("select count(*), sum(b), sum(c) from t where "
                "predict(sc, a, b, c) > 0",
                "select c, count(*), sum(b) from t where "
                "predict(sc, a, b, c) > 0 group by c order by c"):
        h0 = dom.metrics.get("fused_pipeline_mpp_hit", 0) + \
            dom.metrics.get("copr_mpp_exec", 0)
        f0 = mu.ML_PREDICT.labels("fused").value
        got = port.must_query(sql).rows
        assert dom.metrics.get("fused_pipeline_mpp_hit", 0) + \
            dom.metrics.get("copr_mpp_exec", 0) == h0 + 1, \
            dom.last_fused_reason
        # predict() ran in every shard's fragment body
        assert mu.ML_PREDICT.labels("fused").value - f0 == NDEV
        if not near0:
            assert got == ref.must_query(sql).rows
    assert 1000 < port.must_query(
        "select count(*) from t where predict(sc, a, b, c) > 0"
    ).rows[0][0] < 4000
    # weights: one resident copy per distinct device (one here), keyed
    # by device, dropped with the model
    h = dom.ml.lookup("sc")
    store = dom.copr._dev_store
    keys = [k for k in store._entries if k[0] == "mlw"]
    assert len(keys) == 4 and {k[-1] for k in keys} == {"cpu"}
    nbytes = sum(a.nbytes for a in h.weights + h.biases)
    assert dom.ml.device_nbytes(h.id) == nbytes
    phase.reset()
    port.must_query(sql)
    s = phase.snap()
    assert s.get("upload_bytes", 0) == 0 and s.get("dispatches") == 1, s
    assert s.get("syncs", 0) <= 1, s
    port.must_exec("drop model sc")
    assert not [k for k in store._entries if k[0] == "mlw"]


def test_device_weights_per_device(tmp_path):
    """device_weights keeps one copy per device it is asked for, under
    the model's one uid; a fragment on a device outside the copr's mesh
    takes the host weights."""
    import torch
    from tidb_tpu_torch.ml.lowering import _fragment_device
    _ref, port = _ml_kits(tmp_path, n=50)
    dom = port.domain
    h = dom.ml.lookup("sc")
    copr = dom.copr
    phase.reset()
    a = dom.ml.device_weights(copr, h)
    b = dom.ml.device_weights(copr, h, torch.device("cpu"))
    assert all(x is y for x, y in zip(a[0] + a[1], b[0] + b[1]))
    meta = dom.ml.device_weights(copr, h, torch.device("meta"))
    assert all(t.device.type == "meta" for t in meta[0] + meta[1])
    keys = [k for k in copr._dev_store._entries if k[0] == "mlw"]
    assert {k[-1] for k in keys} == {"cpu", "meta"} and len(keys) == 8
    assert _fragment_device(copr, torch.device("cpu"))
    assert not _fragment_device(copr, torch.device("meta"))
    dom.ml.invalidate(h.id)
    assert not [k for k in copr._dev_store._entries if k[0] == "mlw"]

"""The multi-process mesh of tidb_tpu_torch on the CPU: twins of the four
tests of tests/test_distributed_mesh.py. Three worker processes
(`--cpu`) join ONE torch.distributed group over gloo with two shards
each (a 6-shard global mesh); each binds its LOCAL store shard into the
group's mesh, the coordinator broadcasts the pickled CoprDAG, and every
rank runs the identical program, merged by dist.all_reduce /
all_to_all_single. Parity with the reference on the same seeded rows:
spmd_agg against the numpy oracle, the cross-process shuffle against the
reference's mpp_shuffle_join_agg on a 6-device virtual mesh in this
process with the same cap (sums and counts exact), and the refused
shapes (a dict-coded column, MIN, two GROUP BY columns) raising on every
rank with no rank left waiting in a collective."""
import os
import subprocess
import sys

import numpy as np
import pytest

import jax

from tidb_tpu.mpp import exec as ref_exec
from tidb_tpu_torch.mpp.exec import _round_capacity, _shuffle_capacity

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PROCS = 3
LOCAL_SHARDS = 2
ROWS = 600


@pytest.fixture(autouse=True)
def _torch_registries():
    """The shared conftest resets tidb_tpu's registries only."""
    from tidb_tpu_torch.utils import device_guard, metrics, phase
    metrics.reset_all()
    device_guard.reset()
    phase.reset()
    yield


def spawn_worker(procs):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    p = subprocess.Popen(
        [sys.executable, "-m", "tidb_tpu_torch.cluster.worker", "0",
         "--cpu"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        env=env, cwd=REPO, text=True)
    procs.append(p)
    line = p.stdout.readline().strip()
    assert line.startswith("WORKER_READY"), line
    return int(line.split()[1])


def stop_all(cl, procs):
    try:
        if cl is not None:
            cl.stop()
    finally:
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=30)


@pytest.fixture(scope="module")
def cluster():
    from tidb_tpu_torch.cluster import Cluster
    procs, cl = [], None
    try:
        ports = [spawn_worker(procs) for _ in range(N_PROCS)]
        cl = Cluster(ports, device="cpu")
        cl.layouts = cl.spmd_init(local_shards=LOCAL_SHARDS)
        yield cl
    finally:
        stop_all(cl, procs)


def _rows(seed=11):
    rng = np.random.RandomState(seed)
    k = rng.randint(0, 100, ROWS)
    g = rng.randint(0, 8, ROWS)
    v = rng.randint(0, 1000, ROWS)
    return k, g, v


@pytest.fixture(scope="module")
def loaded(cluster):
    k, g, v = _rows()
    cluster.ddl("create table t (id int primary key, k int, g int, "
                "v int, s varchar(8))")
    for w in range(N_PROCS):
        sl = slice(w * ROWS // N_PROCS, (w + 1) * ROWS // N_PROCS)
        vals = ",".join(
            f"({i + 1},{k[i]},{g[i]},{v[i]},'s{g[i]}')"
            for i in range(sl.start, sl.stop))
        cluster.workers[w].call(
            {"op": "load_sql", "sqls": [f"insert into t values {vals}"]})
    return cluster


def _scalar(x):
    a = np.asarray(x).ravel()
    assert a.size == 1, a.shape
    return int(a[0])


def test_group_layout(cluster):
    """Three ranks x two shards = one 6-shard mesh, over gloo by the
    layout rule (CPU ranks)."""
    outs = cluster.layouts
    assert [o["global_devices"] for o in outs] == [6] * N_PROCS
    assert [o["local_devices"] for o in outs] == [2] * N_PROCS
    assert {o["backend"] for o in outs} == {"gloo"}
    assert {o["device"] for o in outs} == {"cpu"}


def test_spmd_global_agg_fragment(loaded):
    """Broadcast DAG, per-rank shard binding, all_reduce exchange: the
    global SUM/COUNT over every rank's shard equals the host oracle, and
    every rank returned the identical result (spmd_agg asserts it)."""
    k, g, v = _rows()
    res = loaded.spmd_agg("select sum(v), count(*) from t where k < 50")
    m = k < 50
    assert _scalar(res["sums"][0]) == int(v[m].sum())
    assert _scalar(res["sums"][1]) == int(m.sum())
    assert _scalar(res["counts"]) == int(m.sum())


@pytest.mark.parametrize("where", [
    "k >= 10 and k < 60 and v <= 700",       # lowers to column bounds
    "k + g < 50",                            # evaluator filter only
    "k < 70 and k * 2 > g"])                 # bounds and a rest filter
def test_spmd_global_filter_routes(loaded, where):
    """The three global shapes of the per-rank body (range_filter_sums'
    bounds, masked_sums' evaluated mask, both) == the numpy oracle."""
    k, g, v = _rows()
    res = loaded.spmd_agg(f"select sum(v), count(v), count(*) from t "
                          f"where {where}")
    m = {"k >= 10 and k < 60 and v <= 700":
         (k >= 10) & (k < 60) & (v <= 700),
         "k + g < 50": k + g < 50,
         "k < 70 and k * 2 > g": (k < 70) & (k * 2 > g)}[where]
    assert _scalar(res["sums"][0]) == int(v[m].sum())
    assert _scalar(res["sums"][1]) == int(m.sum())
    assert _scalar(res["sums"][2]) == int(m.sum())
    assert _scalar(res["counts"]) == int(m.sum())


def test_spmd_grouped_fragment(loaded):
    """Dense all-reduced grouped fragment across ranks (Q1 class)."""
    k, g, v = _rows()
    res = loaded.spmd_agg("select g, sum(v) from t group by g",
                          n_groups=8)
    want = np.zeros(8, dtype=np.int64)
    np.add.at(want, g, v)
    assert res["sums"][0].tolist() == want.tolist()
    cnt = np.zeros(8, dtype=np.int64)
    np.add.at(cnt, g, 1)
    assert res["counts"].tolist() == cnt.tolist()


@pytest.mark.parametrize("payload", ["int64", "float64"])
def test_spmd_shuffle_join_hot_key_across_hosts(loaded, payload):
    """Hash-exchange join fragment across the process group with 90% of
    probe rows on one key: frames sized by the coordinator's capacity,
    the hot rank receives every row, every rank agrees on the exact
    group sums and counts, and they equal the reference's function on a
    6-device virtual mesh with the same cap. The payload keeps its
    type across the exchange: float64 quarters (exact sums in any
    order) come back unrounded, as the reference's do."""
    rng = np.random.RandomState(77)
    n, nd, n_groups = 480, 60, 7   # divisible by N_PROCS
    hot = 13
    pk = np.where(rng.rand(n) < 0.9, hot,
                  rng.randint(0, nd, size=n)).astype(np.int64)
    pv = rng.randint(0, 100, size=n).astype(np.int64)
    if payload == "float64":
        pv = pv + rng.randint(0, 4, size=n) / 4.0
    pok = rng.rand(n) < 0.95
    bk = np.arange(nd, dtype=np.int64)
    bp = rng.randint(0, n_groups, size=nd).astype(np.int64)
    bok = np.ones(nd, dtype=bool)
    ndev = LOCAL_SHARDS * N_PROCS
    cap = _round_capacity(max(_shuffle_capacity(pk, pok, ndev),
                              _shuffle_capacity(bk, bok, ndev), 1))
    half, bhalf = n // N_PROCS, nd // N_PROCS

    def call(i, w):
        arrs = {"pk": pk[i * half:(i + 1) * half],
                "pv": pv[i * half:(i + 1) * half],
                "pok": pok[i * half:(i + 1) * half],
                "bk": bk[i * bhalf:(i + 1) * bhalf],
                "bp": bp[i * bhalf:(i + 1) * bhalf],
                "bok": bok[i * bhalf:(i + 1) * bhalf]}
        return w.call({"op": "spmd_shuffle", "local_cap": half,
                       "local_cap_build": bhalf,
                       "n_groups": n_groups, "cap": cap}, arrs)
    outs = loaded._fanout(call)
    want_s = np.zeros(n_groups, dtype=pv.dtype)
    want_c = np.zeros(n_groups, dtype=np.int64)
    payload_of = {int(kk): int(gg) for kk, gg in zip(bk, bp)}
    for kk, vv, ok in zip(pk, pv, pok):
        if ok and int(kk) in payload_of:
            want_s[payload_of[int(kk)]] += vv
            want_c[payload_of[int(kk)]] += 1
    if payload == "float64":
        assert (want_s != np.floor(want_s)).any()
    from jax.sharding import Mesh as JMesh
    jmesh = JMesh(np.array(jax.devices()[:ndev]), ("dp",))
    ref_s, ref_c = ref_exec.mpp_shuffle_join_agg(
        jmesh, pk, pv, pok, bk, bp, bok, n_groups=n_groups, cap=cap)
    assert np.asarray(ref_c).tolist() == want_c.tolist()
    for _meta, arrs in outs:
        assert arrs["sums"].dtype == pv.dtype
        assert arrs["counts"].tolist() == want_c.tolist()
        assert arrs["sums"].tolist() == want_s.tolist()
        assert arrs["sums"].tolist() == np.asarray(ref_s).tolist()
        assert arrs["counts"].tolist() == np.asarray(ref_c).tolist()


@pytest.mark.parametrize("sql, n_groups, match", [
    ("select sum(v) from t where s = 's1'", None, "dict-coded"),
    ("select min(v), count(*) from t", None, "agg min"),
    ("select k, g, sum(v) from t group by k, g", 8, "multi-column")])
def test_refused_shapes_raise_on_every_rank(loaded, sql, n_groups, match):
    """A refused shape raises on every rank before any collective: each
    worker answers with the error (none hangs in a collective), and the
    group still runs the next fragment."""
    outs = loaded._fanout(lambda i, w: _err_of(
        lambda: w.call({"op": "spmd_frag", "local_cap": ROWS,
                        "n_groups": n_groups},
                       {"dag": _dag_blob(loaded, sql)})))
    assert all(o is not None and match in o for o in outs), outs
    k, _g, v = _rows()
    res = loaded.spmd_agg("select sum(v), count(*) from t where k < 50")
    assert _scalar(res["sums"][0]) == int(v[k < 50].sum())


def _err_of(fn):
    try:
        fn()
    except RuntimeError as e:
        return str(e)
    return None


def _dag_blob(cluster, sql):
    import pickle
    from tidb_tpu_torch.parser import parse
    from tidb_tpu_torch.planner.optimize import optimize
    from tidb_tpu_torch.planner.physical import PhysTableReader
    plan = optimize(parse(sql)[0], cluster.sess._plan_ctx())
    stack = [plan]
    while stack:
        p = stack.pop()
        if isinstance(p, PhysTableReader) and p.dag.aggs:
            return np.frombuffer(pickle.dumps(p.dag), dtype=np.uint8)
        stack.extend(p.children)
    raise AssertionError(f"no pushed aggregation in {sql}")


def test_spmd_after_update_version_rows(loaded):
    """An UPDATE appends a new version row (physical rows > live rows):
    the broadcast capacity must cover what snapshot() binds, and the
    fragment must aggregate the NEW value only."""
    k, g, v = _rows()
    loaded.workers[0].call(
        {"op": "load_sql", "sqls": ["update t set v = v + 1000 "
                                    "where id = 1"]})
    res = loaded.spmd_agg("select sum(v), count(*) from t where k < 50")
    m = k < 50
    want = int(v[m].sum()) + (1000 if m[0] else 0)
    assert _scalar(res["sums"][0]) == want
    assert _scalar(res["counts"]) == int(m.sum())


_ALIAS_RANK = r"""
import sys, torch, torch.distributed as dist
from tidb_tpu_torch.parallel import mesh as M
rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + sys.argv[2],
                        world_size=2, rank=rank)

def staged(mesh, tensors):
    # the stage's copy-once (utils/fetch.py prefetch): entries that are
    # one tensor come back as one host buffer
    copies = {}
    return [copies.setdefault(id(t), t.clone()) for t in tensors]

M._stage = staged
cnt = torch.tensor([rank + 1, 10], dtype=torch.int64)
out = M.merge_parts([([cnt], "sum"), ([cnt], "sum"), ([cnt], "max")],
                    M.GroupMesh(["cpu"], rank, 2, "gloo"))
print("OUT", [o.tolist() for o in out], cnt.tolist(), flush=True)
dist.destroy_process_group()
"""


def test_staged_batch_sharing_a_tensor_reduces_each_entry_once():
    """A merged batch whose entries are one tensor (a count state and the
    row count) is staged as one host buffer; every entry is all-reduced
    once, into its own copy (on the card the shared buffer was reduced
    twice: counts came back 3x over 3 ranks)."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", _ALIAS_RANK, str(r),
                               port], cwd=REPO, env=env, text=True,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.DEVNULL) for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, text in enumerate(outs):
        line = [ln for ln in text.splitlines() if ln.startswith("OUT")]
        assert line, text
        assert line[0] == f"OUT [[3, 20], [3, 20], [2, 10]] " \
            f"[{r + 1}, 10]", line


@pytest.mark.parametrize("cards, want", [
    (["cpu"] * 3, "gloo"), (["cpu"], "gloo"), (["A"] * 3, "gloo"),
    (["A"], "nccl"), (["A", "B", "C"], "nccl"), (["A", "A", "B"], "gloo"),
    (["A", "cpu"], "gloo")])
def test_backend_is_a_layout_rule(cards, want):
    """nccl exactly when every rank has a card of its own (the ranks'
    card UUIDs all differ); gloo for CPU ranks and for several ranks on
    one card (NCCL refuses them:
    test_torch_cuda.py::test_nccl_refuses_two_ranks_on_one_card)."""
    from tidb_tpu_torch.parallel.dist import backend_for
    assert backend_for(cards) == want


def test_world_of_one_binding_and_its_errors():
    """init_distributed is idempotent per process; global_mesh is this
    process's shards; local_row_cap rounds to the local shard count;
    bind_host_rows pads with zero rows and keeps the reference's two
    errors (rows over the cap, a cap the shards do not divide)."""
    import socket
    from tidb_tpu_torch.parallel import dist as D
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        addr = f"127.0.0.1:{s.getsockname()[1]}"
    try:
        g = D.init_distributed(addr, 1, 0, "cpu", local_shards=2)
        assert g == {"rank": 0, "world": 1, "backend": "gloo",
                     "device": "cpu", "local_shards": 2}
        assert D.init_distributed("127.0.0.1:1", 5, 3, "cpu") == g
        mesh = D.global_mesh()
        assert mesh.size == 2 and len(mesh.devices) == 2
        assert D.local_row_cap(5, mesh) == 6 and D.local_row_cap(0, mesh) == 2
        b = D.bind_host_rows(mesh, np.arange(1, 6), 6)
        assert [s.tolist() for s in b.shards] == [[1, 2, 3], [4, 5, 0]]
        assert len(b) == 6
        with pytest.raises(ValueError, match="exceed local_cap"):
            D.bind_host_rows(mesh, np.arange(7), 6)
        with pytest.raises(ValueError, match="must divide"):
            D.bind_host_rows(mesh, np.arange(3), 5)
    finally:
        D.shutdown_distributed()

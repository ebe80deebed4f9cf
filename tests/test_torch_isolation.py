"""tidb_tpu_torch stands alone: it runs SQL (TPC-H Q6; Q3, fused
with its dimension probes; Q17, with a materialized dimension; a
reader-DAG top-n; an ORDER BY, a window function and a hash join through
the executor's device hooks; an exact vector search; CREATE MODEL and
predict(), standalone and fused in a filter; a BACKUP/RESTORE round trip,
a statement routed to a read replica, and Q6 and Q3 over a four-shard
MPP mesh), its range lowering and its
wire server with jax and tidb_tpu blocked from import, no module of it
(nor chip_smoke.py) imports them,
and its entry points refuse to run on the host unless asked to."""
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_RUN = r"""
import importlib.abc, sys

class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name in ("jax", "jaxlib", "tidb_tpu") or \
                name.startswith(("jax.", "jaxlib.", "tidb_tpu.")):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, _Block())
from tidb_tpu_torch.testkit import TestKit
from tidb_tpu_torch.bench import tpch
from tidb_tpu_torch.copr import range_lowering  # noqa: F401
from tidb_tpu_torch.ops import scan_kernels
from tidb_tpu_torch.server import Server, protocol, status  # noqa: F401
from tidb_tpu_torch import __main__  # noqa: F401
calls = []
_rfs = scan_kernels.range_filter_sums
scan_kernels.range_filter_sums = lambda *a: calls.append(1) or _rfs(*a)
tk = TestKit(device="cpu")
tpch.load_tpch(tk, sf=0.01, seed=7)
srv = Server(tk.domain, port=0).start()
st = status.start_status_server(tk.domain, port=0)
rows = tk.must_query(tpch.Q6)._norm()
assert rows == tpch.q6_oracle(tk), rows
assert tk.domain.metrics.get("fused_pipeline_hit") == 1
assert calls, "Q6 did not reach range_filter_sums"
rows3 = tk.must_query(tpch.Q3)._norm()
assert rows3 == tpch.q3_oracle(tk), rows3
assert tk.domain.metrics.get("fused_pipeline_hit") == 2
assert tk.domain.last_fused_reason is None
# a materialized dim: Q17's per-part average runs as a subplan
rows17 = tk.must_query(tpch.ALL_QUERIES["q17"])._norm()
assert tk.domain.metrics.get("fused_matdim_build") == 1, rows17
assert tk.domain.metrics.get("fused_pipeline_fallback", 0) == 0
# a reader-DAG top-n on the device route
tk.must_exec("set tidb_tpu_fragment_min_rows = 0")
d0 = tk.domain.metrics.get("copr_device_exec", 0)
top = tk.must_query("select l_quantity from lineitem where l_discount < "
                    "0.03 order by l_quantity desc limit 5")._norm()
assert tk.domain.metrics.get("copr_device_exec", 0) == d0 + 1, top
assert len(top) == 5
# the executor's device hooks: an ORDER BY, a window, a hash join
import os
os.environ["TIDB_TPU_SORT_MIN"] = os.environ["TIDB_TPU_WINDOW_MIN"] = "1000"
m = tk.domain.metrics
hooks0 = {c: m.get(c, 0) for c in ("sort_device", "window_device",
                                   "device_join")}
srt = tk.must_query("select o_orderkey from orders order by o_totalprice "
                    "desc, o_orderkey")._norm()
win = tk.must_query("select count(*) from (select row_number() over "
                    "(partition by o_custkey order by o_orderdate, "
                    "o_orderkey) as rn from orders) t where rn = 1")._norm()
tk.must_exec("set tidb_join_exec = 'device'")
jn = tk.must_query("select o_orderkey, c_name from orders join customer on "
                   "o_custkey = c_custkey where o_orderdate < '1992-03-01' "
                   "order by o_orderkey")._norm()
assert {c: m.get(c, 0) - n for c, n in hooks0.items()} == \
    {"sort_device": 1, "window_device": 1, "device_join": 1}, m
assert len(srt) == 15000 and int(win[0][0]) > 0 and jn, (win, len(jn))
# vector search: an exact top-k through the vector runtime
tk.must_exec("create table docs (id bigint primary key, e vector(3))")
tk.must_exec("insert into docs values (1, '[0,0,1]'), (2, '[5,5,5]'), "
             "(3, '[0,1,1]'), (4, null)")
vs = "select id from docs order by vec_l2_distance(e, '[0,0,1]') limit 3"
assert "VectorSearch" in str(tk.must_query("explain " + vs).rows)
assert [r[0] for r in tk.must_query(vs).rows] == [4, 1, 3]
# in-SQL inference: CREATE MODEL, predict() standalone and fused
import tempfile
import numpy as np
npz = os.path.join(tempfile.mkdtemp(), "m.npz")
np.savez(npz, coef=np.array([1.0, -1.0], dtype=np.float32),
         intercept=np.array([0.5], dtype=np.float32))
tk.must_exec(f"create model lin from '{npz}'")
pr = tk.must_query("select o_orderkey, predict(lin, o_shippriority, "
                   "o_custkey) from orders where o_orderkey < 10 "
                   "order by o_orderkey").rows
assert pr and all(abs(y - (0.5 - c)) < 1e-3 for (_k, y), c in zip(
    pr, [r[0] for r in tk.must_query(
        "select o_custkey from orders where o_orderkey < 10 order by "
        "o_orderkey").rows])), pr
cnt = tk.must_query("select count(*) from orders where predict(lin, "
                    "o_shippriority, o_custkey) > -100").rows
assert cnt == tk.must_query("select count(*) from orders where "
                            "o_custkey < 100.5").rows, cnt
# BR: a snapshot of two tables restored into a fresh store
bk = os.path.join(tempfile.mkdtemp(), "bk")
tk.must_exec(f"backup database test to 'local://{bk}'")
tk2 = TestKit(device="cpu")
tk2.must_exec(f"restore database test from 'local://{bk}'")
for q in ("select count(*), sum(o_totalprice) from orders",
          "select * from docs order by id"):
    assert tk2.must_query(q).rows == tk.must_query(q).rows, q
# the read-replica fabric: a mirror on the leader's device serves a
# resolved read of a table written through DML
import time
reps = tk.domain.replicas.provision(1)
t0 = time.time()
while reps[0].state != "serving" and time.time() - t0 < 30:
    time.sleep(0.02)
assert reps[0].mirror.copr.device.type == "cpu", reps[0].state
tk.must_exec("set tidb_tpu_analytic_read_mode = 'resolved'")
rq = "select count(*), sum(id) from docs"
want = tk.must_query(rq).rows
for _ in range(200):
    got = tk.must_query(rq).rows
    if tk.sess._stmt_route.startswith("replica"):
        break
    time.sleep(0.02)
assert tk.sess._stmt_route == "replica-0" and got == want, got
# the MPP mesh: Q6 and Q3 over four shards, with their exchanges
from tidb_tpu_torch.mpp import exec as _mpp_exec  # noqa: F401
from tidb_tpu_torch.parallel import make_mesh  # noqa: F401
tkm = TestKit(device="cpu", mesh=4)
tpch.load_tpch(tkm, sf=0.01, seed=7)
tkm.must_exec("set @@tidb_mpp_min_rows = 0")
assert tkm.must_query(tpch.Q6)._norm() == rows
assert tkm.must_query(tpch.Q3)._norm() == rows3
assert tkm.domain.metrics.get("fused_pipeline_mpp_hit") == 2, \
    tkm.domain.metrics
assert "ExchangeSender" in str(tkm.must_query("explain " + tpch.Q3).rows)
tk.domain.close()
srv.shutdown()
st.shutdown()
bad = [m for m in sys.modules if m in ("jax", "jaxlib", "tidb_tpu")
       or m.startswith(("jax.", "jaxlib.", "tidb_tpu."))]
assert not bad, bad
print("Q6", rows[0][0], "Q3", rows3[0][0])
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_q6_runs_with_jax_and_reference_blocked():
    out = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().startswith("Q6 ")


def test_cli_one_shot_on_cpu():
    out = subprocess.run([sys.executable, "-m", "tidb_tpu_torch", "--cpu",
                          "-e", "select 1 + 1"], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "2"


_IMPORT_RE = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|tidb_tpu)(\.|\s|$)", re.MULTILINE)


def _sources():
    for dirpath, _dirs, files in os.walk(os.path.join(ROOT,
                                                      "tidb_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_no_jax_or_reference_imports():
    paths = [os.path.relpath(p, ROOT) for p in _sources()]
    for hook in ("executor/sort_device.py", "executor/window_device.py",
                 "ops/device_join.py", "vector/runtime.py",
                 "vector/kernels.py", "ml/runtime.py", "ml/kernels.py",
                 "replica/manager.py", "br/snapshot.py", "br/restore.py",
                 "br/logformat.py", "tools/br.py", "tools/objstore.py",
                 "tools/dump.py", "mpp/fragment.py", "mpp/exec.py",
                 "parallel/mesh.py", "parallel/dist.py"):
        assert os.path.join("tidb_tpu_torch", hook) in paths
    found = []
    for path in _sources():
        with open(path) as f:
            found += [(os.path.relpath(path, ROOT), m.group(0).strip())
                      for m in _IMPORT_RE.finditer(f.read())]
    assert found == []


def test_testkit_refuses_host_without_cuda(monkeypatch):
    import torch
    from tidb_tpu_torch.testkit import TestKit
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TestKit()
    assert TestKit(device="cpu").domain.copr.device.type == "cpu"


@pytest.mark.parametrize("surface", ["cluster_transport"])
def test_unported_surfaces_fail_clearly(surface):
    """A surface the port does not carry yet fails with a clear error
    instead of reaching for tidb_tpu."""
    from tidb_tpu_torch.errors import UnsupportedError
    from tidb_tpu_torch.owner import manager
    with pytest.raises(UnsupportedError, match="not yet ported"):
        manager._RemoteLeaseStore(worker_client=None)


@pytest.mark.parametrize("case", ["create_model", "vector_index",
                                  "predict", "backup", "replica_sink"])
def test_ported_surfaces_run(case, tmp_path):
    """Vector indexes, CREATE MODEL, predict(), BACKUP (restored into a
    fresh store) and a replica:// changefeed run and give their
    result."""
    import numpy as np
    from tidb_tpu_torch.testkit import TestKit
    tk = TestKit(device="cpu")
    tk.must_exec("create table v (id int primary key, a int, e vector(3))")
    tk.must_exec("insert into v values (1, 2, '[1,0,0]'), "
                 "(2, 5, '[0,1,0]'), (3, 7, '[0,0,1]')")
    npz = str(tmp_path / "m.npz")
    np.savez(npz, coef=np.array([2.0], dtype=np.float32),
             intercept=np.array([1.0], dtype=np.float32))
    if case == "vector_index":
        tk.must_exec("create vector index vi on v (e) using ivf")
        assert tk.must_query(
            "select index_name, column_name from "
            "information_schema.tidb_vector_indexes").rows == [("vi", "e")]
        assert [r[0] for r in tk.must_query(
            "select id from v order by vec_l2_distance(e, '[0,1,0]') "
            "limit 1").rows] == [2]
        return
    if case == "backup":
        bk = str(tmp_path / "bk")
        assert tk.must_exec(
            f"backup database test to 'local://{bk}'").affected == 1
        tk2 = TestKit(device="cpu")
        tk2.must_exec(f"restore database test from 'local://{bk}'")
        assert tk2.must_query("select id, a, e from v order by id").rows \
            == tk.must_query("select id, a, e from v order by id").rows
        return
    if case == "replica_sink":
        import time
        rep = tk.domain.replicas.provision(1)[0]
        tk.must_exec("admin changefeed create cf sink 'replica://0'")
        assert "cf" in tk.domain.cdc.feeds
        leader = tk.must_query("select * from v order by id").rows
        deadline = time.time() + 10
        while time.time() < deadline and \
                rep.sink.mirror_rows("test", "v") != leader:
            time.sleep(0.02)
        assert rep.sink.mirror_rows("test", "v") == leader
        assert len(leader) == 3
        tk.domain.close()
        return
    tk.must_exec(f"create model m from '{npz}'")
    if case == "create_model":
        assert [r[:2] for r in tk.must_query("show models").rows] == \
            [("m", "linear")]
        return
    assert tk.must_query("select id, predict(m, a) from v order by "
                         "id").rows == [(1, 5.0), (2, 11.0), (3, 15.0)]

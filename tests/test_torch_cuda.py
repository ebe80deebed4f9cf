"""tidb_tpu_torch on a CUDA card: the three scan kernels against their plain
PyTorch versions (range_filter_sums with folded product pairs too), the
rule that a failed fused fragment fails its statement there, and the
sort and runs lowerings of the general group-by against the CPU, with
no blocking wait inside a fragment; the delta fold against the CPU and
under the sync guard, a replica's mirror on the card (and a grant loss
there retried on the leader), and a restored table's first upload; what
torch.distributed does with the card (gloo's collectives on CUDA
tensors, NCCL refusing two ranks on one card) and, on a machine with
three cards, the cluster over NCCL. This file imports nothing of
tidb_tpu or jax, so it also runs on a machine that has the card and no
JAX:
    python -m pytest tests/test_torch_cuda.py -q
Without a CUDA device every test skips (a CUDA kernel has no CPU mode)."""
import os
import sys

import numpy as np
import pytest
import torch

from tidb_tpu_torch.ops import scan_kernels as sk

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import (LAYOUT_CASES, RANGE_NPREDS, layout_case,  # noqa: E402
                        range_layout_case)

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif(not torch.cuda.is_available(),
                       reason="needs a CUDA device: the kernels have no "
                              "CPU mode"),
]


@pytest.fixture(autouse=True)
def _torch_registries():
    """The shared conftest resets tidb_tpu's registries only."""
    from tidb_tpu_torch.utils import metrics, phase, device_guard, failpoint
    metrics.reset_all()
    device_guard.reset()
    phase.reset()
    sk.reset_launches()
    yield
    failpoint.disable_all()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n,k,nslots", [(4096, 1, 1), (100003, 7, 12),
                                        (1 << 20, 16, 64)])
def test_kernels_match_plain_on_card(n, k, nslots):
    rng = np.random.default_rng(n)
    cols = [_t(rng.integers(-(1 << 40), 1 << 40, n)).cuda()
            for _ in range(k)]
    mask = _t(rng.random(n) < 0.5).cuda()
    slots = _t(rng.integers(-2, nslots + 2, n)).cuda()
    preds = [_t(rng.integers(-50, 50, n)).cuda() for _ in range(nslots % 5)]
    bounds = [(-20, 30), (-(1 << 63), 0), (10, 5), (-7, (1 << 63) - 1)][
        :len(preds)]
    for got, want in ((sk.masked_sums(cols, mask),
                       sk.masked_sums_plain(cols, mask)),
                      (sk.dense_group_sums(cols, slots, nslots, mask),
                       sk.dense_group_sums_plain(cols, slots, nslots, mask)),
                      (sk.range_filter_sums(cols, preds, bounds, mask),
                       sk.range_filter_sums_plain(cols, preds, bounds,
                                                  mask))):
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert sk.COUNTS["masked_sums"] == 1 == sk.COUNTS["dense_group_sums"]
    assert sk.COUNTS["range_filter_sums"] == 1


@pytest.mark.parametrize("case", LAYOUT_CASES,
                         ids=["-".join(map(str, c)) for c in LAYOUT_CASES])
def test_layouts_match_plain_on_card(case):
    """The redesigned kernels' layout paths (vector and bulk heads and
    tails, unaligned views, aliased buffers, the largest tables, values
    at +-2^62; range_filter_sums at 0, 1, 3 and 16 predicates with
    product pairs, one of them on a predicate's column, wrapping) equal
    the plain versions exactly."""
    cols, mask, slots, nslots = layout_case(*case)
    runs = [(sk.masked_sums(cols, mask), sk.masked_sums_plain(cols, mask)),
            (sk.dense_group_sums(cols, slots, nslots, mask),
             sk.dense_group_sums_plain(cols, slots, nslots, mask))]
    for npred in RANGE_NPREDS:
        rc = range_layout_case(*case, npred)
        runs.append((sk.range_filter_sums(*rc),
                     sk.range_filter_sums_plain(*rc)))
    for got, want in runs:
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert g.shape == w.shape and torch.equal(g, w), (g, w)
    assert sk.COUNTS["masked_sums"] == 1 == sk.COUNTS["dense_group_sums"]
    assert sk.COUNTS["range_filter_sums"] == len(RANGE_NPREDS)


def test_fused_error_fails_statement_on_card():
    """On the card nothing degrades to the host: a fused fragment that
    fails fails its statement, and none of its work runs on the host."""
    from tidb_tpu_torch.bench import tpch
    from tidb_tpu_torch.errors import DeviceUnavailableError
    from tidb_tpu_torch.testkit import TestKit
    from tidb_tpu_torch.utils import failpoint, phase
    tk = TestKit()
    tpch.load_tpch(tk, sf=0.01, seed=3)
    assert not tk.domain.copr.degrade_to_host
    assert tk.must_query(tpch.QUERIES["q6"])._norm() == tpch.q6_oracle(tk)
    failpoint.enable("device_guard/fused", "error:generic")
    phase.reset()
    with pytest.raises(DeviceUnavailableError, match="generic"):
        tk.must_query(tpch.QUERIES["q6"])
    snap = phase.snap()
    for key in ("fused_fallbacks", "device_fallbacks", "host_execs"):
        assert snap.get(key, 0) == 0, (key, snap)


def test_probe_out_of_range_keys_on_card():
    """The dimension probe's gathers stay inside their tables on the
    card (torch raises a device-side assert on an index out of range,
    which would poison the context): keys below lo, past the lut, at the
    int64 ends and in the sorted keys' padding miss."""
    from tidb_tpu_torch.copr.pipeline import _probe
    big = (1 << 63) - 1
    pv = torch.tensor([-(1 << 63), -1, 0, 3, 9, 10, 11, big],
                      dtype=torch.int64, device="cuda")
    miss = torch.zeros(8, dtype=torch.bool, device="cuda")
    want = [False, False, False, True, True, True, False, False]
    lut = torch.tensor([0, 1, 2, 3, 4, 5, 6, 7, 8, 8], device="cuda")
    pos, hit = _probe({"lut": lut, "lsize": 8, "lo": 3}, pv, miss, 8, 8, 8)
    torch.cuda.synchronize()
    assert hit.tolist() == want and 0 <= int(pos.min()) <= int(pos.max()) < 8
    sk_ = torch.tensor([3, 9, 10, big], device="cuda")
    pos, hit = _probe({"sk": sk_, "ord": torch.tensor([2, 0, 1, 0],
                                                      device="cuda")},
                      pv, miss, 4, 3, 3)
    torch.cuda.synchronize()
    assert hit.tolist() == want and pos[3:6].tolist() == [2, 0, 1]


def test_join_queries_on_card():
    """TPC-H Q3 and Q5 through TestKit on the card equal their numpy
    oracles, fused with their dimension probes; Q5's 25 nation slots
    reach dense_group_sums once per partition."""
    from tidb_tpu_torch.bench import tpch
    from tidb_tpu_torch.testkit import TestKit
    tk = TestKit()
    tpch.load_tpch(tk, sf=0.01, seed=3)
    for q, oracle in (("q3", tpch.q3_oracle), ("q5", tpch.q5_oracle)):
        hits = tk.domain.metrics.get("fused_pipeline_hit", 0)
        sk.reset_launches()
        assert tk.must_query(tpch.QUERIES[q])._norm() == oracle(tk)
        assert tk.domain.metrics.get("fused_pipeline_hit", 0) == hits + 1
        assert tk.domain.last_fused_reason is None
        if q == "q5":
            assert sk.COUNTS["dense_group_sums"] == 1


@pytest.mark.parametrize("impl", ["scatter", "sorted", "runs"])
def test_sort_lowerings_match_cpu_on_card(impl):
    """sort_agg_body under each lowering gives on the card what it gives
    on the CPU (the same code over CPU tensors, tested there against the
    reference): keys and int states exactly, float states within rtol
    1e-9 (atomic float sums add in any order)."""
    from tidb_tpu_torch.copr import dag_exec as de
    from tidb_tpu_torch.expression import EvalCtx
    from tidb_tpu_torch.expression.expr import Column
    from tidb_tpu_torch.expression.torch_ns import TorchNS
    from tidb_tpu_torch.types.field_type import (new_bigint_type,
                                                 new_double_type)

    class A:
        def __init__(self, name, args):
            self.name, self.args, self.distinct = name, args, False
    rng = np.random.RandomState(11)
    n = 1 << 16
    mask = rng.rand(n) < 0.8
    cols = {0: (rng.randint(0, 500, n), rng.rand(n) < 0.1),
            1: (rng.randint(-100, 100, n), None),
            2: (rng.randn(n), rng.rand(n) < 0.2)}
    ci, cf = Column(1, new_bigint_type()), Column(2, new_double_type())
    aggs = [A("count", []), A("sum", [ci]), A("avg", [cf]), A("min", [cf]),
            A("max", [ci]), A("first_row", [ci]), A("count", [cf])]
    out = {}
    for dev in ("cpu", "cuda"):
        ctx = EvalCtx(TorchNS(dev), n, {
            k: (_t(d).to(dev), None if nl is None else _t(nl).to(dev), None)
            for k, (d, nl) in cols.items()}, host=False)
        r = de.sort_agg_body(ctx, _t(mask).to(dev),
                             [Column(0, new_bigint_type())], aggs, n, n,
                             impl=impl)
        ng = int(r["ngroups"])
        out[dev] = (ng, [k[:ng].cpu() for k in r["keys"] + r["key_nulls"]],
                    [[s[:ng].cpu() for s in st] for st in r["states"]])
    (nc, kc, sc), (ng, kg, sg) = out["cpu"], out["cuda"]
    assert nc == ng
    for a, b in zip(kc, kg):
        assert torch.equal(a, b)
    for sta, stb in zip(sc, sg):
        for a, b in zip(sta, stb):
            if a.dtype.is_floating_point:
                torch.testing.assert_close(a, b, rtol=1e-9, atol=0)
            else:
                assert torch.equal(a, b)


def test_sort_kind_queries_on_card_without_syncs():
    """Q3 (its join positions over 64 slots: the runs lowering on the
    card), Q9 and Q18 (the sort kind) through TestKit on the card equal
    the CPU's rows, every fragment enqueue under
    set_sync_debug_mode("error"); a warm statement makes one dispatch
    and one sync per partition."""
    from tidb_tpu_torch.bench import tpch
    from tidb_tpu_torch.copr import pipeline
    from tidb_tpu_torch.testkit import TestKit
    from tidb_tpu_torch.utils import phase
    gpu, cpu = TestKit(), TestKit(device="cpu")
    for kit in (gpu, cpu):
        tpch.load_tpch(kit, sf=0.01, seed=3)
    run = pipeline.run_fragment

    def guarded(*a):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return run(*a)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    pipeline.run_fragment = guarded
    try:
        for q in ("q3", "q9", "q18"):
            want = cpu.must_query(tpch.ALL_QUERIES[q])._norm()
            for _ in range(2):
                phase.reset()
                assert gpu.must_query(tpch.ALL_QUERIES[q])._norm() == want
            snap = phase.snap()
            assert snap["dispatches"] == snap["syncs"] >= 1, (q, snap)
    finally:
        pipeline.run_fragment = run


# ---- the executor's device hooks ---------------------------------------

HOOK_SQL = {
    "sort": "select a from t order by b desc, c, a",
    "window": "select a, sum(c) over (partition by b order by a) from t "
              "order by a",
    "join": "select t.a, d.tag from t, d where t.b = d.id order by t.a",
}


@pytest.mark.parametrize("site", list(HOOK_SQL))
def test_hook_grant_loss_fails_statement_on_card(monkeypatch, site):
    """On the card a hook whose dispatch degrades fails its statement
    (no host sort, window or join carries on), where the CPU takes the
    host path; after the failpoint the same statement runs on the card
    with the CPU's rows."""
    from tidb_tpu_torch.errors import DeviceUnavailableError
    from tidb_tpu_torch.testkit import TestKit
    from tidb_tpu_torch.utils import failpoint
    monkeypatch.setenv("TIDB_TPU_SORT_MIN", "1")
    monkeypatch.setenv("TIDB_TPU_WINDOW_MIN", "1")
    kits = TestKit(), TestKit(device="cpu")
    for kit in kits:
        kit.must_exec("create table t (a int primary key, b int, c int)")
        kit.must_exec("insert into t values " + ",".join(
            f"({i}, {i % 7}, {i % 13})" for i in range(400)))
        kit.must_exec("create table d (id int primary key, tag int)")
        kit.must_exec("insert into d values " + ",".join(
            f"({i}, {i % 3})" for i in range(7)))
        kit.must_exec("set tidb_join_exec = 'device'")
    gpu, cpu = kits
    failpoint.enable(f"device_guard/{site}", "error:grant_lost")
    with pytest.raises(DeviceUnavailableError, match="grant_lost"):
        gpu.must_query(HOOK_SQL[site])
    failpoint.disable_all()
    m = gpu.domain.metrics
    for c in ("sort_device_error", "window_device_error",
              "device_join_fallback"):
        assert m.get(c, 0) == 0, c
    counter = {"sort": "sort_device", "window": "window_device",
               "join": "device_join"}[site]
    n0 = m.get(counter, 0)
    assert gpu.must_query(HOOK_SQL[site]).rows == \
        cpu.must_query(HOOK_SQL[site]).rows
    assert m.get(counter, 0) > n0


def test_hook_programs_match_cpu_on_card():
    """Each hook's program on CUDA tensors equals the same program on
    the CPU, on the same inputs: the sort permutation, every window
    function (floats within rtol 1e-9), the join's pairs and semi
    mask; each with no wait on the card before its fetch."""
    from tidb_tpu_torch.executor import sort_device, window_device
    from tidb_tpu_torch.ops import device_join
    rng = np.random.default_rng(17)
    n = 100_003
    keys = [rng.integers(-5, 5, n), rng.normal(size=n).round(2),
            rng.integers(0, 1 << 40, n)]
    k64 = sort_device.host_keys(keys)

    def both(fn, *arrays):
        out = []
        for dev in ("cuda", "cpu"):
            args = [_t(a).to(dev) if isinstance(a, np.ndarray) else
                    [_t(x).to(dev) for x in a] for a in arrays]
            torch.cuda.set_sync_debug_mode("error")
            try:
                res = fn(*args)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            out.append([r.cpu() for r in (res if isinstance(res, tuple)
                                          else (res,))])
        return out
    g, c = both(sort_device.lexsort_permutation, k64)
    assert torch.equal(g[0], c[0])
    vals_i, vals_f = rng.integers(-(1 << 40), 1 << 40, n), rng.random(n)
    ok = rng.random(n) < 0.9
    wkeys = [k64[0], k64[2] % 1000]
    for name in sorted(window_device.DEVICE_FNS):
        for vals in (vals_i, vals_f):
            for has_order in (False, True):
                g, c = both(
                    lambda ks, v, o: window_device.window_program(
                        name, ks, 1, has_order, v, o,
                        shift=2 if name == "lead" else -1,
                        default=None if name == "lag" else 7),
                    wkeys, vals, ok)
                assert torch.equal(g[1], c[1]), name
                live = ~c[1]
                if g[0].dtype.is_floating_point:
                    torch.testing.assert_close(g[0][live], c[0][live],
                                               rtol=1e-9, atol=0)
                else:
                    assert torch.equal(g[0][live], c[0][live]), name
    bk, pk = rng.integers(0, 5000, 20_000), rng.integers(0, 6000, 30_000)
    bv, pv = rng.random(20_000) < 0.95, rng.random(30_000) < 0.95
    g, c = both(device_join.join_counts, bk, bv, pk, pv)
    for a, b in zip(g, c):
        assert torch.equal(a, b)
    total = int(c[0].sum())
    for dev, res in (("cuda", g), ("cpu", c)):
        pairs = device_join.expand_pairs(*(r.to(dev) for r in res), total)
        if dev == "cuda":
            gp = [p.cpu() for p in pairs]
        else:
            cp = pairs
    for a, b in zip(gp, cp):
        assert torch.equal(a, b)
    for semi in (False, True):
        got = device_join.device_join_index(bk, ~bv, pk, ~pv, "cuda",
                                            semi_only=semi)
        want = device_join.device_join_index(bk, ~bv, pk, ~pv, "cpu",
                                             semi_only=semi)
        for a, b in zip(got, want):
            assert (a is None and b is None) or np.array_equal(a, b)


# ---- vector search and in-SQL inference ---------------------------------

def test_tf32_off_on_card():
    """float32 products run in full float32 on the card (TF32 keeps
    about three digits): both switches off, matmul precision highest."""
    import tidb_tpu_torch.utils.torchcfg  # noqa: F401
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"


def test_vector_and_forward_programs_match_cpu_on_card():
    """The top-k, IVF score, k-means step, assign, tail patch and forward
    programs on CUDA tensors against the same programs on the CPU, with
    NaN (NULL) rows, dead rows, duplicated rows and a zero vector: keys
    within rtol 1e-5 and positions equal where a key is separated from
    the next, exact ties by the lowest row, assignments equal on
    well-separated clusters (an all-NaN row takes centroid 0), each
    enqueued with no wait on the card. The top-k inputs lie around the
    origin and the query is not close to any row: L2 in matmul form
    loses digits to cancellation where a distance is small against the
    norms (far-off clusters, a query next to a row), and the executor's
    float64 re-rank, not the key, decides the rows there. The 500 copies
    of row 7, nearest to the query, straddle the 256th key."""
    from tidb_tpu_torch.ml import kernels as mk
    from tidb_tpu_torch.vector import kernels as vk
    rng = np.random.default_rng(19)
    n, dim = 200_003, 16
    centers = rng.standard_normal((32, dim)).astype(np.float32) * 20
    mat = (centers[rng.integers(0, 32, n)] +
           rng.standard_normal((n, dim)) * 0.3).astype(np.float32)
    mat[rng.choice(n, 500, replace=False)] = mat[7]     # ties with row 7
    mat[rng.choice(n, 50, replace=False)] = np.nan
    mat[11] = 0.0
    valid = rng.random(n) > 0.05
    near = rng.standard_normal((n, dim)).astype(np.float32)
    near[np.isnan(mat[:, 0])] = np.nan
    near[rng.choice(n, 500, replace=False)] = near[7]
    near[11] = 0.0
    q = near[7] + rng.standard_normal(dim).astype(np.float32) * 0.5

    def both(fn, *arrays):
        out = []
        for dev in ("cuda", "cpu"):
            args = [_t(a).to(dev) if isinstance(a, np.ndarray) else a
                    for a in arrays]
            torch.cuda.set_sync_debug_mode("error")
            try:
                res = fn(*args)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            out.append([r.cpu() for r in (res if isinstance(res, tuple)
                                          else (res,))])
        return out

    def same_slate(g, c):
        torch.testing.assert_close(g[0], c[0], rtol=1e-5, atol=0)
        k = c[0].numpy()
        gap = np.abs(np.diff(k)) > 1e-5 * np.maximum(np.abs(k[1:]), 1e-30)
        sep = np.concatenate([[True], gap]) & np.concatenate([gap, [True]])
        sep |= ~np.isfinite(k) | np.concatenate(
            [[False], k[1:] == k[:-1]]) | np.concatenate(
            [k[:-1] == k[1:], [False]])
        assert sep.mean() > 0.5
        assert torch.equal(g[1][torch.from_numpy(sep)],
                           c[1][torch.from_numpy(sep)])

    for metric in ("vec_l2_distance", "vec_cosine_distance",
                   "vec_negative_inner_product"):
        for qq in (q, np.zeros(dim, np.float32)):
            g, c = both(vk.build_topk_kernel(metric, 256), near, valid, qq)
            same_slate(g, c)
        cand = rng.choice(n, 30_000, replace=False).astype(np.int32)
        g, c = both(vk.build_ivf_score_kernel(metric, 256), near, cand,
                    valid[cand], q)
        same_slate(g, c)
    live = valid & ~np.isnan(mat[:, 0])
    cent = centers + np.float32(0.5)
    g, c = both(vk.build_kmeans_step(), mat, live, cent)
    torch.testing.assert_close(g[0], c[0], rtol=1e-5, atol=1e-5)
    g, c = both(vk.build_assign_kernel(), mat, centers)
    assert torch.equal(g[0], c[0])
    assert (c[0].numpy()[np.isnan(mat[:, 0])] == 0).all()
    g, c = both(lambda b, u: vk.patch_rows(b, u, 1000), mat, mat[:77])
    torch.testing.assert_close(g[0], c[0], rtol=0, atol=0, equal_nan=True)
    ws = [rng.standard_normal((4, 256)).astype(np.float32) * 0.3,
          rng.standard_normal((256, 128)).astype(np.float32) * 0.1,
          rng.standard_normal((128, 1)).astype(np.float32) * 0.1]
    bs = [rng.standard_normal(w.shape[1]).astype(np.float32) for w in ws]
    X = rng.standard_normal((n, 4)).astype(np.float32)
    g, c = both(mk.build_forward_kernel(3), X, *ws, *bs)
    torch.testing.assert_close(g[0], c[0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("site", ["vector/topk", "ml/predict"])
def test_vector_ml_grant_loss_fails_statement_on_card(site, tmp_path):
    """On the card a degraded vector or inference program fails its
    statement (no host twin carries on); without the failpoint the
    same statement gives the CPU's rows."""
    from tidb_tpu_torch.errors import DeviceUnavailableError
    from tidb_tpu_torch.testkit import TestKit
    from tidb_tpu_torch.utils import failpoint
    rng = np.random.default_rng(23)
    npz = str(tmp_path / "m.npz")
    np.savez(npz, W0=rng.standard_normal((2, 8)).astype(np.float32),
             b0=rng.standard_normal(8).astype(np.float32),
             W1=rng.standard_normal((8, 1)).astype(np.float32))
    kits = TestKit(), TestKit(device="cpu")
    for kit in kits:
        kit.must_exec("create table t (id int primary key, a double, "
                      "b double, e vector(3))")
        kit.must_exec("insert into t values " + ",".join(
            f"({i}, {i * 0.25}, {i % 5}, '[{i % 7},{i % 3},1]')"
            for i in range(300)))
        kit.must_exec(f"create model m from '{npz}'")
    sql = {"vector/topk": "select id from t order by "
                          "vec_l2_distance(e, '[2,1,1]') limit 5",
           "ml/predict": "select id, predict(m, a, b) from t order by id"
           }[site]
    gpu, cpu = kits
    failpoint.enable(f"device_guard/{site}", "error:grant_lost")
    with pytest.raises(DeviceUnavailableError, match="grant_lost"):
        gpu.must_query(sql)
    failpoint.disable_all()
    got, want = gpu.must_query(sql).rows, cpu.must_query(sql).rows
    assert [r[0] for r in got] == [r[0] for r in want]
    for g, w in zip(got, want):
        for a, b in zip(g[1:], w[1:]):
            assert abs(a - b) <= 1e-5 * abs(b) + 1e-6


# ---- HTAP serving: the fold, the replica fabric, BR ---------------------

def _lines_kit(device=None, n=3000):
    from tidb_tpu_torch.testkit import TestKit
    tk = TestKit(device=device)
    tk.must_exec("create table t (id int primary key, k int, v int, "
                 "s varchar(16))")
    tk.must_exec("insert into t values " + ",".join(
        f"({i}, {i % 7}, {i * 3}, 's{i % 11}')" for i in range(n)))
    return tk


LINES_Q = "select k, count(*), sum(v) from t group by k order by k"


def test_fold_on_card_matches_cpu():
    """copr/delta.py's fold program on CUDA tensors (deltas sent up
    pinned and non-blocking) equals the same fold on CPU tensors."""
    from tidb_tpu_torch.chunk.device import upload
    from tidb_tpu_torch.copr.delta import _fold
    rng = np.random.default_rng(5)
    bufs = [_t(rng.integers(-1000, 1000, 4096)),
            _t(rng.random(2048) < 0.5), _t(rng.standard_normal(1024))]
    upds = [rng.integers(-9, 9, 512), rng.random(64) < 0.5,
            rng.standard_normal(100)]
    offs = [3000, 1984, 0]
    want = _fold(bufs, [_t(u) for u in upds], offs)
    got = _fold([b.cuda() for b in bufs],
                [upload(u, torch.device("cuda")) for u in upds], offs)
    for g, w, b in zip(got, want, bufs):
        assert g.device.type == "cuda" and torch.equal(g.cpu(), w)
        assert not torch.equal(w, b)            # the fold wrote a copy


def test_folding_statement_under_sync_guard_on_card():
    """A warm statement whose bind folds an insert into its resident
    buffers makes no blocking copy: bind, fold and enqueue run under
    set_sync_debug_mode("error") (only the result fetch waits), and the
    rows equal the host twin's."""
    from chip_smoke import StatementGuard
    from tidb_tpu_torch.utils import phase
    tk = _lines_kit()
    tk.must_query(LINES_Q)
    tk.must_exec("insert into t values " + ",".join(
        f"({i}, {i % 7}, {i * 3}, 'n')" for i in range(3000, 3040)))
    phase.reset()
    with StatementGuard():
        got = tk.must_query(LINES_Q).rows
    assert phase.snap().get("delta_applies", 0) > 0
    tk.domain.copr.use_device = False
    assert got == tk.must_query(LINES_Q).rows


def test_mirror_runs_on_card_and_serves():
    """A replica's mirror Domain runs on the leader's card and serves
    routed resolved reads with the leader's rows."""
    import time
    tk = _lines_kit()
    try:
        rep = tk.domain.replicas.provision(1)[0]
        assert rep.mirror.copr.device.type == "cuda"
        deadline = time.time() + 30
        while rep.state != "serving" and time.time() < deadline:
            time.sleep(0.02)
        want = tk.must_query(LINES_Q).rows
        tk.must_exec("set tidb_tpu_analytic_read_mode = 'resolved'")
        for _ in range(200):
            got = tk.must_query(LINES_Q).rows
            if tk.sess._stmt_route.startswith("replica"):
                break
            time.sleep(0.02)
        assert tk.sess._stmt_route == "replica-0" and got == want
        # a 3,000-row group-by is a reader DAG on the mirror's card
        assert rep.mirror.metrics.get("copr_device_exec", 0) > 0
    finally:
        tk.domain.close()


def test_replica_grant_loss_retries_on_leader_on_card():
    """A grant loss at replica/mid-stmt is reported to supervision and
    the statement retries once on the leader, on the card, with the
    leader's rows."""
    import time
    from tidb_tpu_torch.utils import failpoint
    from tidb_tpu_torch.utils import metrics as mu
    tk = _lines_kit()
    try:
        rep = tk.domain.replicas.provision(1)[0]
        deadline = time.time() + 30
        while rep.state != "serving" and time.time() < deadline:
            time.sleep(0.02)
        want = tk.must_query(LINES_Q).rows
        tk.must_exec("set tidb_tpu_analytic_read_mode = 'resolved'")
        before = mu.REPLICA_ROUTE.labels("degraded_midstmt").value
        d0 = tk.domain.metrics.get("copr_device_exec", 0)
        failpoint.enable("replica/mid-stmt", "error:grant_lost")
        try:
            got = tk.must_query(LINES_Q).rows
        finally:
            failpoint.disable("replica/mid-stmt")
        assert got == want
        assert tk.sess._stmt_route == "degraded_midstmt"
        assert mu.REPLICA_ROUTE.labels("degraded_midstmt").value > before
        assert any(v for k, v in tk.domain.metrics.items()
                   if k.startswith("replica_midstmt_"))
        assert tk.domain.metrics.get("copr_device_exec", 0) > d0
    finally:
        tk.domain.close()


def test_restored_table_first_statement_uploads_on_card(tmp_path):
    """DROP TABLE and RESTORE bring the old table id back; the resident
    store keys on the table's uid, so the first statement uploads the
    restored columns and returns the restored rows."""
    from tidb_tpu_torch.utils import phase
    tk = _lines_kit()
    want = tk.must_query(LINES_Q).rows
    tid = tk.domain.infoschema().table_by_name("test", "t").id
    tk.must_exec(f"backup database test to 'local://{tmp_path}/bk'")
    tk.must_exec("drop table t")
    tk.must_exec(f"restore database test from 'local://{tmp_path}/bk'")
    assert tk.domain.infoschema().table_by_name("test", "t").id == tid
    phase.reset()
    assert tk.must_query(LINES_Q).rows == want
    assert phase.snap().get("upload_bytes", 0) > 0


def test_mesh_of_four_shards_on_card():
    """The MPP mesh on the card: four shards of one H100. Q6, Q1 and Q5
    equal their numpy oracles on the mesh route; each shard launches the
    scan kernel its layout takes; a shuffle join equals the broadcast
    one; a mesh failure fails the statement and runs nothing on one
    device; a Domain given no mesh on one card has none."""
    from tidb_tpu_torch.bench import tpch
    from tidb_tpu_torch.errors import DeviceUnavailableError
    from tidb_tpu_torch.testkit import TestKit
    from tidb_tpu_torch.utils import failpoint, phase
    if torch.cuda.device_count() == 1:
        assert TestKit().domain.copr._get_mesh() is None
    tk = TestKit(mesh=4)
    tpch.load_tpch(tk, sf=0.01, seed=3)
    tk.must_exec("set @@tidb_mpp_min_rows = 0")
    m = tk.domain.metrics
    for q, kernel, oracle in (("q6", "range_filter_sums", tpch.q6_oracle),
                              ("q1", "dense_group_sums", tpch.q1_oracle),
                              ("q5", "dense_group_sums", tpch.q5_oracle)):
        hits = m.get("fused_pipeline_mpp_hit", 0)
        tk.must_query(tpch.QUERIES[q])               # cold
        sk.reset_launches()
        phase.reset()
        assert tk.must_query(tpch.QUERIES[q])._norm() == oracle(tk)
        snap = phase.snap()
        assert m.get("fused_pipeline_mpp_hit", 0) == hits + 2, q
        assert sk.COUNTS[kernel] == 4, (q, dict(sk.COUNTS))
        assert snap.get("dispatches") == 1 and snap.get("syncs") == 1, snap
        assert snap.get("upload_bytes", 0) == 0, snap
    sql = ("select n_name, sum(c_acctbal), count(*) from customer, nation "
           "where c_nationkey = n_nationkey group by n_name")
    base = tk.must_query(sql)._norm()
    tk.must_exec("set tidb_broadcast_join_threshold_count = 10")
    tk.domain.invalidate_plan_cache()
    n0 = m.get("fused_shuffle_join", 0)
    assert tk.must_query(sql)._norm() == base
    assert m.get("fused_shuffle_join", 0) == n0 + 1
    failpoint.enable("device_guard/fused/mpp", "error:generic")
    single = m.get("fused_pipeline_hit", 0)
    with pytest.raises(DeviceUnavailableError, match="generic"):
        tk.must_query(tpch.QUERIES["q6"])
    assert m.get("fused_pipeline_hit", 0) == single


def test_spmd_fragment_gloo_world_of_one_on_card():
    """run_dag_spmd in one process as a gloo world of one, two shards of
    the card: the whole fragment (the shard binding, the per-shard
    bodies, the staged all_reduce) runs under set_sync_debug_mode("error")
    but for its one fetch, which is the stage; the global shapes launch
    range_filter_sums and masked_sums and the grouped one
    dense_group_sums, once per shard; the results equal numpy."""
    import socket
    import torch.distributed as dist
    from chip_smoke import StatementGuard
    from tidb_tpu_torch.mpp.spmd import run_dag_spmd
    from tidb_tpu_torch.parallel import GroupMesh
    from tidb_tpu_torch.parser import parse
    from tidb_tpu_torch.planner.optimize import optimize
    from tidb_tpu_torch.planner.physical import PhysTableReader
    from tidb_tpu_torch.testkit import TestKit, import_columns
    from tidb_tpu_torch.utils import phase
    rng = np.random.default_rng(12)
    n = 20000
    k, g, v = (rng.integers(0, 100, n), rng.integers(0, 8, n),
               rng.integers(0, 1000, n))
    tk = TestKit()
    tk.must_exec("create table t (id int primary key, k int, g int, v int)")
    import_columns(tk, "t", {"id": (np.arange(n), None, None),
                             "k": (k, None, None), "g": (g, None, None),
                             "v": (v, None, None)})

    # the coordinator's plan: its Domain holds the schema and no rows, so
    # the aggregation stays a pushed reader DAG (a loaded table fuses)
    planner = TestKit(device="cpu")
    planner.must_exec("create table t (id int primary key, k int, g int, "
                      "v int)")

    def dag_of(sql):
        stack = [optimize(parse(sql)[0], planner.sess._plan_ctx())]
        while stack:
            p = stack.pop()
            if isinstance(p, PhysTableReader) and p.dag.aggs:
                return p.dag
            stack.extend(p.children)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        mesh = GroupMesh([torch.device("cuda")] * 2, 0, 1, "gloo")
        for sql, n_groups, kernel, want in (
                ("select sum(v), count(*) from t where k >= 10 and k < 60",
                 None, "range_filter_sums",
                 [v[(k >= 10) & (k < 60)].sum(), ((k >= 10) & (k < 60)).sum()]),
                ("select sum(v), count(*) from t where k + g < 50", None,
                 "masked_sums", [v[k + g < 50].sum(), (k + g < 50).sum()]),
                ("select g, sum(v) from t group by g", 8, "dense_group_sums",
                 [np.bincount(g, weights=v, minlength=8).astype(np.int64)])):
            dag = dag_of(sql)
            run_dag_spmd(tk.domain, dag, mesh, n, n_groups)     # cold
            sk.reset_launches()
            phase.reset()
            with StatementGuard():
                out = run_dag_spmd(tk.domain, dag, mesh, n, n_groups)
            snap = phase.snap()
            assert snap.get("syncs") == 1, (sql, snap)
            assert snap.get("collective_stages") == 1, (sql, snap)
            assert sk.COUNTS[kernel] == 2, (sql, dict(sk.COUNTS))
            for got, w in zip(out["sums"], want):
                assert np.asarray(got).tolist() == np.asarray(w).tolist()
    finally:
        dist.destroy_process_group()


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _collective(name, t):
    import torch.distributed as dist
    if name == "all_reduce":
        dist.all_reduce(t)
        return t
    if name == "all_to_all_single":
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t)
        return out
    if name == "all_gather_into_tensor":
        out = torch.empty_like(t)
        dist.all_gather_into_tensor(out, t)
        return out
    dist.broadcast(t, 0)
    return t


@pytest.mark.parametrize("name", ["all_reduce", "all_to_all_single",
                                  "all_gather_into_tensor", "broadcast"])
def test_gloo_collective_takes_cuda_tensors(name):
    """gloo takes CUDA tensors in each collective the cluster could use
    (a world of one on the card) and gives the CPU tensor's result. The
    port stages them through pinned host memory all the same
    (parallel/mesh.py:_stage), so that the copy to the host is one
    counted sync."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        want = _collective(name, torch.arange(8, dtype=torch.int64))
        got = _collective(name, torch.arange(8, dtype=torch.int64,
                                             device="cuda"))
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), want)
    finally:
        dist.destroy_process_group()


_NCCL_RANK = r"""
import sys, torch, torch.distributed as dist
from datetime import timedelta
torch.cuda.set_device(0)
dist.init_process_group("nccl", init_method="tcp://127.0.0.1:" + sys.argv[2],
                        world_size=2, rank=int(sys.argv[1]),
                        timeout=timedelta(seconds=40))
t = torch.ones(4, device="cuda")
dist.all_reduce(t)
torch.cuda.synchronize()
print("RESULT", t.tolist(), flush=True)
"""


def test_nccl_refuses_two_ranks_on_one_card():
    """Two processes on one card cannot form an NCCL group (NCCL:
    "Duplicate GPU detected"): the reason parallel/dist.py:backend_for
    gives several ranks on one card gloo, by the layout and never after
    an NCCL error."""
    import subprocess
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", _NCCL_RANK, str(r),
                               port], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    assert [p.returncode for p in procs] != [0, 0], outs
    assert any("Duplicate GPU" in text for text in outs), outs


@pytest.mark.skipif(torch.cuda.device_count() < 3,
                    reason="needs three cards: one worker on each")
def test_cluster_over_nccl_one_card_per_worker(tmp_path):
    """Three workers, each shown a card of its own (CUDA_VISIBLE_DEVICES),
    form their group over NCCL by the layout rule, each on the card its
    Domain runs on. spmd_agg (global and grouped) and query_agg equal
    numpy, the float64 shuffle equals the Python join, every rank's
    reply comes from its card, one sync a fragment, and no collective
    is staged through the host."""
    import subprocess
    from tidb_tpu_torch.cluster import Cluster
    from tidb_tpu_torch.mpp.exec import _round_capacity, _shuffle_capacity
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    nw, rows = 3, 3000
    procs, cl = [], None
    try:
        ports = []
        for i in range(nw):
            env = dict(os.environ, CUDA_VISIBLE_DEVICES=str(i),
                       PYTHONPATH=repo + os.pathsep +
                       os.environ.get("PYTHONPATH", ""))
            with open(tmp_path / f"worker{i}.log", "w") as err:
                p = subprocess.Popen([sys.executable, "-m",
                                      "tidb_tpu_torch.cluster.worker", "0"],
                                     cwd=repo, env=env,
                                     stdout=subprocess.PIPE, stderr=err,
                                     text=True)
            procs.append(p)
            line = p.stdout.readline().strip()
            assert line.startswith("WORKER_READY"), line
            ports.append(int(line.split()[1]))
        cl = Cluster(ports, device="cpu")
        layouts = cl.spmd_init()
        assert [o["backend"] for o in layouts] == ["nccl"] * nw, layouts
        assert all(o["device"].startswith("cuda") for o in layouts)
        rng = np.random.default_rng(5)
        k, g, v = (rng.integers(0, 100, rows), rng.integers(0, 8, rows),
                   rng.integers(0, 1000, rows))
        cl.ddl("create table t (id int primary key, k int, g int, v int)")
        per = rows // nw
        for w in range(nw):
            cl.workers[w].call({"op": "load_sql", "sqls": [
                "insert into t values " + ",".join(
                    f"({i + 1},{k[i]},{g[i]},{v[i]})"
                    for i in range(w * per, (w + 1) * per))]})
        replies = []
        for w in cl.workers:
            call = w.call

            def recorded(msg, arrays=None, call=call, **kw):
                out, arrs = call(msg, arrays, **kw)
                if msg.get("op") == "spmd_frag":
                    replies.append(out)
                return out, arrs
            w.call = recorded
        res = cl.spmd_agg("select sum(v), count(*) from t where k < 50")
        m = k < 50
        assert np.asarray(res["sums"][0]).ravel().tolist() == \
            [int(v[m].sum())]
        assert np.asarray(res["counts"]).ravel().tolist() == [int(m.sum())]
        res = cl.spmd_agg("select g, sum(v) from t group by g", n_groups=8)
        assert res["sums"][0].tolist() == \
            np.bincount(g, weights=v, minlength=8).astype(np.int64).tolist()
        assert len(replies) == 2 * nw
        for meta in replies:
            ph = meta["phase"]
            assert meta["device"].startswith("cuda"), meta
            assert ph.get("syncs") == 1, ph
            assert not ph.get("collective_stages"), ph
        got = sorted(tuple(r) for r in cl.query_agg(
            "select g, sum(v), count(*) from t group by g"))
        assert [(int(a), int(b), int(c)) for a, b, c in got] == [
            (gg, int(v[g == gg].sum()), int((g == gg).sum()))
            for gg in range(8) if (g == gg).any()]
        # the shuffle: float64 quarters keep their type through NCCL
        n, nd = 480, 60
        pk = rng.integers(0, nd, n).astype(np.int64)
        pv = rng.integers(0, 400, n) / 4.0
        pok = np.ones(n, dtype=bool)
        bk = np.arange(nd, dtype=np.int64)
        bp = rng.integers(0, 7, nd).astype(np.int64)
        bok = np.ones(nd, dtype=bool)
        cap = _round_capacity(max(_shuffle_capacity(pk, pok, nw),
                                  _shuffle_capacity(bk, bok, nw), 1))
        lc, lb = n // nw, nd // nw
        outs = cl._fanout(lambda i, w: w.call(
            {"op": "spmd_shuffle", "local_cap": lc, "local_cap_build": lb,
             "n_groups": 7, "cap": cap},
            {"pk": pk[i * lc:(i + 1) * lc], "pv": pv[i * lc:(i + 1) * lc],
             "pok": pok[i * lc:(i + 1) * lc], "bk": bk[i * lb:(i + 1) * lb],
             "bp": bp[i * lb:(i + 1) * lb],
             "bok": bok[i * lb:(i + 1) * lb]}))
        want_s, want_c = np.zeros(7), np.zeros(7, dtype=np.int64)
        np.add.at(want_s, bp[pk], pv)
        np.add.at(want_c, bp[pk], 1)
        for _meta, arrs in outs:
            assert arrs["sums"].dtype == np.float64
            assert arrs["sums"].tolist() == want_s.tolist()
            assert arrs["counts"].tolist() == want_c.tolist()
    except Exception:
        for i in range(len(procs)):        # shown with the failure
            print(f"worker {i}:", (tmp_path / f"worker{i}.log").read_text()
                  [-3000:])
        raise
    finally:
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

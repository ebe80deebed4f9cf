"""tidb_tpu_torch on a CUDA card: the three scan kernels against their plain
PyTorch versions (range_filter_sums with folded product pairs too), the
rule that a failed fused fragment fails its statement there, and the
sort and runs lowerings of the general group-by against the CPU, with
no blocking wait inside a fragment. This file imports nothing of
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

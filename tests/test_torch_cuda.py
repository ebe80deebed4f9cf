"""tidb_tpu_torch on a CUDA card: the three scan kernels against their plain
PyTorch versions (range_filter_sums with folded product pairs too), and
the rule that a failed fused fragment fails its statement there. This file imports nothing of tidb_tpu or jax, so it
also runs on a machine that has the card and no JAX:
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

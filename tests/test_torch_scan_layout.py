"""tidb_tpu_torch.ops.scan_kernels' argument layout on the CPU: the map
from aggregate arguments to the distinct buffers the kernels read
(distinct_buffers), the wrappers' results with aliased arguments against
tidb_tpu.ops' Pallas kernels (interpret mode, as tests/test_ops.py runs
them) and a numpy int64 oracle, the layouts chip_smoke.py drives on the
card, and the build hash over every kernel source. All comparisons are
exact: the functions are int64 sums."""
import os
import sys

import numpy as np
import pytest
import torch

from tidb_tpu.ops import dense_group_sums as jax_dense_group_sums
from tidb_tpu.ops import masked_sums as jax_masked_sums
from tidb_tpu_torch.ops import build
from tidb_tpu_torch.ops import scan_kernels as sk

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import (LAYOUT_CASES, RANGE_NPREDS, layout_case,  # noqa: E402
                        range_layout_case)


@pytest.fixture(autouse=True)
def _torch_registries():
    """The shared conftest resets tidb_tpu's registries only."""
    from tidb_tpu_torch.utils import metrics, phase, device_guard
    metrics.reset_all()
    device_guard.reset()
    phase.reset()
    sk.reset_launches()
    yield


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---- distinct_buffers ---------------------------------------------------

def test_same_tensor_is_one_buffer():
    a, b = torch.arange(8), torch.arange(8, 16)
    distinct, index = sk.distinct_buffers([a, b, a, a, b])
    assert index == [0, 1, 0, 0, 1]
    assert distinct[0] is a and distinct[1] is b


def test_equal_but_distinct_tensors_are_two_buffers():
    a = torch.arange(8)
    distinct, index = sk.distinct_buffers([a, a.clone()])
    assert index == [0, 1] and len(distinct) == 2


@pytest.mark.parametrize("shift", [1, 3])
def test_overlapping_views_at_different_offsets_are_two_buffers(shift):
    base = torch.arange(32)
    v0, v1 = base[:16], base[shift:shift + 16]
    distinct, index = sk.distinct_buffers([v0, v1, base[:16]])
    assert index == [0, 1, 0] and len(distinct) == 2


def test_same_pointer_other_length_dtype_or_stride_is_another_buffer():
    base = torch.arange(32)
    cols = [base[:16], base[:8], base[:16].view(torch.float64),
            base[0:32:2], base[:16]]
    distinct, index = sk.distinct_buffers(cols)
    assert index == [0, 1, 2, 3, 0]


def test_no_columns():
    assert sk.distinct_buffers([]) == ([], [])


def test_expand_is_a_view_without_repeats_and_a_copy_with():
    rows = torch.arange(12).view(4, 3)
    same = sk._expand(rows, [0, 1, 2])
    assert same.data_ptr() == rows.data_ptr() and same.shape == (3, 3)
    rep = sk._expand(rows, [1, 0, 1])
    assert torch.equal(rep, rows[[1, 0, 1]])
    assert sk._expand(rows, []).shape == (0, 3)


# ---- aliased arguments: wrappers == JAX (interpret) == numpy -------------

def _aliased(n, shift, rng, lo, hi):
    """[a, b, a, b'] with b' the view of b's storage `shift` on: numpy
    arrays (for JAX and the oracle) and the tensors the wrappers get."""
    a = rng.integers(lo, hi, n)
    bb = rng.integers(lo, hi, n + shift)
    ta, tbb = _t(a), _t(bb)
    tb, tb2 = tbb[:n], tbb[shift:shift + n]
    arrays = [a, bb[:n], a, bb[shift:shift + n]]
    return arrays, [ta, tb, ta, tb2]


@pytest.mark.parametrize("n,shift,density", [(20000, 1, 0.3), (8191, 3, 0.9),
                                             (1, 1, 1.0), (4097, 1, 0.0)])
def test_masked_sums_aliased_args_match_pallas(n, shift, density):
    rng = np.random.default_rng(n + shift)
    arrays, tensors = _aliased(n, shift, rng, -(1 << 20), 1 << 20)
    mask = rng.random(n) < density
    want_s, want_c = jax_masked_sums(arrays, mask, interpret=True)
    got_s, got_c = sk.masked_sums(tensors, _t(mask))
    assert got_s.shape == (4,) and got_s.dtype == torch.int64
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(
        got_s.numpy(), [int(v[mask].sum()) for v in arrays])
    assert int(got_c) == int(want_c) == int(mask.sum())


def _group_oracle(vals, slots, nslots, valid):
    live = valid & (slots >= 0) & (slots < nslots)
    sums = np.zeros((len(vals), nslots), dtype=np.int64)
    for j, v in enumerate(vals):
        np.add.at(sums[j], slots[live], v[live])
    cnts = np.bincount(slots[live], minlength=nslots).astype(np.int64)
    return sums, cnts


@pytest.mark.parametrize("n,shift,nslots", [(30000, 1, 12), (9001, 3, 64),
                                            (4097, 1, 1)])
def test_dense_group_sums_aliased_args_match_pallas(n, shift, nslots):
    """Values inside the JAX kernel's float32-exact range."""
    rng = np.random.default_rng(n * 3 + nslots)
    arrays, tensors = _aliased(n, shift, rng, 0, 300)
    slots = rng.integers(0, nslots, n)
    valid = rng.random(n) < 0.8
    want_s, want_c = jax_dense_group_sums(arrays, slots, nslots, valid,
                                          interpret=True)
    got_s, got_c = sk.dense_group_sums(tensors, _t(slots), nslots,
                                       _t(valid))
    assert got_s.shape == (4, nslots) and got_c.shape == (nslots,)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    o_s, o_c = _group_oracle(arrays, slots, nslots, valid)
    np.testing.assert_array_equal(got_s.numpy(), o_s)
    np.testing.assert_array_equal(got_c.numpy(), o_c)


# ---- chip_smoke's layout cases, on the CPU --------------------------------

_CPU_LAYOUTS = [c for c in LAYOUT_CASES if c[0] <= 100_003]


@pytest.mark.parametrize("case", _CPU_LAYOUTS,
                         ids=["-".join(map(str, c)) for c in _CPU_LAYOUTS])
def test_layout_cases_match_numpy(case):
    """The inputs chip_smoke.py and test_torch_cuda.py hold the kernels to
    on the card: offsets, aliases and mask kinds as described, and the
    wrappers' results equal to a numpy int64 oracle (wrapping at 2^64
    as the kernels do)."""
    n, moff, coff, mask_kind, alias, nslots, extreme = case
    cols, mask, slots, ns = layout_case(*case, device="cpu")
    assert ns == nslots and mask.shape == (n,) and slots.shape == (n,)
    assert mask.storage_offset() == moff
    assert all(c.storage_offset() in (coff, coff + 1) for c in cols)
    ndist = len(sk.distinct_buffers(cols)[0])
    assert (len(cols), ndist) == {"same": (3, 2), "views": (4, 3),
                                  "wide": (16, 16)}[alias]
    m = mask.numpy()
    if mask_kind != "random":
        assert m.sum() == {"clear": 0, "set": n, "last": 1}[mask_kind]
        assert mask_kind != "last" or m[-1]
    vals = [c.numpy() for c in cols]
    with np.errstate(over="ignore"):
        want = [v[m].sum(dtype=np.int64) for v in vals]
        got_s, got_c = sk.masked_sums(cols, mask)
        np.testing.assert_array_equal(got_s.numpy(), want)
        assert int(got_c) == int(m.sum())
        o_s, o_c = _group_oracle(vals, slots.numpy(), nslots, m)
        g_s, g_c = sk.dense_group_sums(cols, slots, nslots, mask)
    np.testing.assert_array_equal(g_s.numpy(), o_s)
    np.testing.assert_array_equal(g_c.numpy(), o_c)
    assert sk.COUNTS["masked_sums"] == 0 == sk.COUNTS["dense_group_sums"]


@pytest.mark.parametrize("npred", RANGE_NPREDS)
@pytest.mark.parametrize("case", _CPU_LAYOUTS,
                         ids=["-".join(map(str, c)) for c in _CPU_LAYOUTS])
def test_range_layout_cases_match_numpy(case, npred):
    """range_filter_sums' inputs for the same layouts: predicate and
    operand views at the case's offsets, an operand that is predicate
    1's column, and the wrapper's sums equal to a numpy int64 oracle
    (products and sums wrapping at 2^64 as the kernel's do)."""
    n, moff, coff, mask_kind, alias, nslots, extreme = case
    sums, preds, bounds, valid, products = range_layout_case(
        *case, npred, device="cpu")
    assert len(preds) == len(bounds) == npred
    assert valid.storage_offset() == moff
    assert all(t.storage_offset() in (coff, coff + 1)
               for t in sums + preds + [x for p in products for x in p])
    assert len(sums) + len(products) == (16 if alias == "wide" else 4)
    if npred > 1 and alias != "wide":
        assert products[0][1] is preds[1]
    m = valid.numpy().copy()
    for c, (lo, hi) in zip(preds, bounds):
        m &= (c.numpy() >= lo) & (c.numpy() <= hi)
    with np.errstate(over="ignore"):
        terms = [c.numpy() for c in sums] + \
            [a.numpy() * b.numpy() for a, b in products]
        want = [v[m].sum(dtype=np.int64) for v in terms]
    got_s, got_c = sk.range_filter_sums(sums, preds, bounds, valid, products)
    np.testing.assert_array_equal(got_s.numpy(), want)
    assert int(got_c) == int(m.sum())
    assert sk.COUNTS["range_filter_sums"] == 0


# ---- the build hash -------------------------------------------------------

def test_build_hash_covers_every_source_and_header(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "_SRC_DIR", str(tmp_path))
    (tmp_path / "k.cu").write_text("#include \"k.cuh\"\n")
    d0 = build.source_digest()
    (tmp_path / "k.cuh").write_text("// v1\n")
    d1 = build.source_digest()
    (tmp_path / "k.cuh").write_text("// v2\n")
    d2 = build.source_digest()
    (tmp_path / "notes.txt").write_text("not read by nvcc\n")
    d3 = build.source_digest()
    assert len({d0, d1, d2}) == 3 and d3 == d2
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ["-G"])
    assert build.source_digest() != d2


@pytest.mark.parametrize("name", ["tree", "ring_only", "aggregate_only",
                                  "blocks=2", "masked_blocks=3",
                                  "rf_ring", "rf_stream_only", "rf_blocks=3",
                                  "rf_no_keep",
                                  "rf_stream_only+rf_ring"])
def test_kernel_variants_edit_the_tree_source(name):
    """bench/kernel_variants' text variants still find their anchors in
    scan_kernels.cu, and each changes the source (but `tree`)."""
    from tidb_tpu_torch.bench import kernel_variants as kv
    with open(os.path.join(kv.ROOT, kv.SRC)) as f:
        src = f.read()
    out = kv.variant_source(src, name)
    assert (out == src) == (name == "tree")
    if "rf_ring" in name:      # the source holds no ring; the variant adds it
        assert "range_filter_sums_ring_kernel" not in src
        assert out.count("range_filter_sums_ring_kernel<KC>") == 4
    if "+" in name:            # both edits
        assert "  const int k = 0;\n" in out
    with pytest.raises(ValueError):
        kv.variant_source(src, "no_such_variant")

"""Scan-side reductions of the fused coprocessor fragment: hand-written
CUDA kernels (ops/csrc/scan_kernels.cu) with their plain PyTorch twins.

masked_sums       <- tidb_tpu/ops/pallas_scan.py:masked_sums (the
                     global reduce of an aggregate without range
                     filters: int64 sums of k columns where mask, plus
                     the count)
dense_group_sums  <- tidb_tpu/ops/pallas_scan.py:dense_group_sums (Q1's
                     small-domain group sums: per-slot int64 sums of k
                     columns plus per-slot counts)
range_filter_sums <- tidb_tpu/ops/pallas_scan.py:range_filter_sums (Q6's
                     whole fragment: inclusive [lo, hi] tests on npred
                     int64 columns ANDed with valid, then int64 sums of
                     k columns plus the count); it also sums wrapped
                     int64 products of column pairs (`products`), so
                     Q6's sum(l_extendedprice * l_discount) needs no
                     product column

The wrappers keep the JAX entry points' argument order and return
layout. They route on the device of the tensors they are given: CPU
tensors run the plain version, CUDA tensors launch the kernel, and a
wrong dtype, device or shape raises. A kernel that does not build or
whose launch is refused raises KernelError; nothing falls back.

The wrappers pass each distinct column buffer (range_filter_sums: each
distinct term) to their kernel once (distinct_buffers: Q1's sum and avg
of one column name one buffer) and copy its sums into every output row
that names it.

COUNTS holds, under each wrapper's name, the launches of its kernel, so
a run can show that its main path went through the kernel, and under
"product_pairs" the product pairs range_filter_sums was handed (on
either device), so a run can show that Q6 took the fold. The counters
live in the module, not on the wrapper functions, so a caller that
rebinds a wrapper's name (a test's spy) leaves them in place. The source
notes (bounds, designs) are in scan_kernels.cu."""
from __future__ import annotations

import ctypes
import threading

import torch

from ..errors import TiDBError

MAX_COLS = 16          # kMaxCols in scan_kernels.cu
MAX_SLOTS = 64         # kMaxSlots in scan_kernels.cu (shared-memory tables)
MAX_PREDS = 16         # kMaxPreds in scan_kernels.cu (kernel parameters)
_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1


class KernelError(TiDBError):
    """A CUDA kernel launch was refused; the statement fails."""


_FNS: dict = {}
# the library is loaded once; connection threads of a cold server can
# reach their first launch together, and the counters are read across
# threads
_LOCK = threading.Lock()
COUNTS = {"masked_sums": 0, "dense_group_sums": 0, "range_filter_sums": 0,
          "product_pairs": 0}


def _lib():
    lib = _FNS.get("lib")
    if lib is not None:
        return lib
    with _LOCK:
        lib = _FNS.get("lib")
        if lib is None:
            lib = _load_lib()
            _FNS["lib"] = lib
    return lib


def _load_lib():
    from .build import load
    lib = load("scan_kernels")
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.tidb_masked_sums.argtypes = [ctypes.POINTER(vp), i, vp, ll, vp, vp]
    lib.tidb_masked_sums.restype = i
    lib.tidb_dense_group_sums.argtypes = [ctypes.POINTER(vp), i, vp, vp,
                                          ll, i, vp, vp]
    lib.tidb_dense_group_sums.restype = i
    lib.tidb_range_filter_sums.argtypes = [
        ctypes.POINTER(vp), i, ctypes.POINTER(ll), ctypes.POINTER(ll),
        ctypes.POINTER(vp), ctypes.POINTER(vp), i, vp, ll, vp, vp]
    lib.tidb_range_filter_sums.restype = i
    for fn in (lib.tidb_scan_max_cols, lib.tidb_scan_max_slots,
               lib.tidb_scan_max_preds):
        fn.restype = i
    if (lib.tidb_scan_max_cols(), lib.tidb_scan_max_slots(),
            lib.tidb_scan_max_preds()) != (MAX_COLS, MAX_SLOTS, MAX_PREDS):
        raise KernelError("scan_kernels.cu kMaxCols/kMaxSlots/kMaxPreds != "
                          "MAX_COLS/MAX_SLOTS/MAX_PREDS")
    return lib


def _count(key, n=1):
    with _LOCK:
        COUNTS[key] += n


def reset_launches():
    """Sets every counter to 0."""
    with _LOCK:
        for key in COUNTS:
            COUNTS[key] = 0


def _check_vec(name, t, dtype, n, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.ndim != 1 or (n is not None and t.shape[0] != n):
        raise ValueError(f"{name}: expected shape [{n}], got "
                         f"{list(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _ptr_array(cols):
    """Device pointers of `cols` as a C array; None stays a null pointer."""
    arr = (ctypes.c_void_p * max(len(cols), 1))()
    for j, c in enumerate(cols):
        arr[j] = None if c is None else c.data_ptr()
    return arr


def _check_rc(rc, what):
    if rc != 0:
        raise KernelError("%s: CUDA launch failed (cudaError %d)", what, rc)


def distinct_buffers(cols):
    """-> (distinct, index): the tensors of `cols` that are distinct
    buffers, in first-seen order, and for each argument the position of
    its buffer in `distinct`. Two arguments are one buffer when they have
    the same data_ptr(), dtype, length and stride: an aggregate's
    argument that is a bare column evaluates to the column itself, so
    sum(x) and avg(x) pass one buffer twice. Views that overlap but start
    at different offsets are different buffers."""
    seen, distinct, index = {}, [], []
    for c in cols:
        key = (c.data_ptr(), c.dtype, tuple(c.shape), tuple(c.stride()))
        if key not in seen:
            seen[key] = len(distinct)
            distinct.append(c)
        index.append(seen[key])
    return distinct, index


def _expand(rows, index):
    """The per-argument rows of a result computed over the distinct
    buffers: rows[:k] itself when no argument repeats a buffer, else one
    copy (torch.stack) with each buffer's row wherever it is named."""
    if index == list(range(len(index))):
        return rows[:len(index)]
    return torch.stack([rows[i] for i in index])


# ---- masked_sums ----------------------------------------------------

def masked_sums_plain(columns, mask):
    """Plain PyTorch masked_sums: (sums int64 [k], count int64 [])."""
    dev = mask.device
    sums = [torch.where(mask, c, torch.zeros((), dtype=torch.int64,
                                              device=dev)).sum()
            for c in columns]
    sums = torch.stack(sums) if sums else \
        torch.zeros(0, dtype=torch.int64, device=dev)
    return sums, mask.sum(dtype=torch.int64)


def masked_sums(columns, mask):
    """int64 sums of `columns` (k int64 [n] tensors) over the rows where
    `mask` (bool [n]) is set, plus the count of those rows.
    -> (sums int64 [k], count int64 [])."""
    _check_vec("mask", mask, torch.bool, None, mask.device
               if isinstance(mask, torch.Tensor) else None)
    n, dev = mask.shape[0], mask.device
    columns = list(columns)
    if len(columns) > MAX_COLS:
        raise ValueError(f"masked_sums takes at most {MAX_COLS} columns")
    for j, c in enumerate(columns):
        _check_vec(f"columns[{j}]", c, torch.int64, n, dev)
    distinct, index = distinct_buffers(columns)
    if dev.type == "cpu":
        sums, count = masked_sums_plain(distinct, mask)
        return _expand(sums, index), count
    if dev.type != "cuda":
        raise ValueError(f"masked_sums: unsupported device {dev}")
    k = len(distinct)
    out = torch.zeros(k + 1, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib().tidb_masked_sums(_ptr_array(distinct), k, mask.data_ptr(),
                                 n, out.data_ptr(), stream)
    _check_rc(rc, "masked_sums")
    _count("masked_sums")
    return _expand(out, index), out[k]


# ---- dense_group_sums ---------------------------------------------------

def dense_group_sums_plain(value_cols, slots, nslots, valid):
    """Plain PyTorch dense_group_sums: one masked sum per slot.
    -> (sums int64 [k, nslots], counts int64 [nslots])."""
    dev = slots.device
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    k = len(value_cols)
    sums = torch.zeros((k, nslots), dtype=torch.int64, device=dev)
    counts = torch.zeros(nslots, dtype=torch.int64, device=dev)
    for s in range(nslots):
        sel = valid & (slots == s)
        counts[s] = sel.sum(dtype=torch.int64)
        for j, c in enumerate(value_cols):
            sums[j, s] = torch.where(sel, c, zero).sum()
    return sums, counts


def dense_group_sums(value_cols, slots, nslots, valid):
    """Per-slot int64 sums of `value_cols` (k int64 [n] tensors) plus
    per-slot counts over slots [0, nslots); rows with !valid (bool [n])
    or a slot (int64 [n]) outside the domain are dropped. Exact at any
    magnitude. -> (sums int64 [k, nslots], counts int64 [nslots])."""
    _check_vec("slots", slots, torch.int64, None, slots.device
               if isinstance(slots, torch.Tensor) else None)
    n, dev = slots.shape[0], slots.device
    nslots = int(nslots)
    value_cols = list(value_cols)
    if not 1 <= nslots <= MAX_SLOTS:
        raise ValueError(f"dense_group_sums takes 1..{MAX_SLOTS} slots")
    if len(value_cols) > MAX_COLS:
        raise ValueError(
            f"dense_group_sums takes at most {MAX_COLS} columns")
    _check_vec("valid", valid, torch.bool, n, dev)
    for j, c in enumerate(value_cols):
        _check_vec(f"value_cols[{j}]", c, torch.int64, n, dev)
    distinct, index = distinct_buffers(value_cols)
    if dev.type == "cpu":
        sums, counts = dense_group_sums_plain(distinct, slots, nslots, valid)
        return _expand(sums, index), counts
    if dev.type != "cuda":
        raise ValueError(f"dense_group_sums: unsupported device {dev}")
    k = len(distinct)
    out = torch.zeros((k + 1, nslots), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib().tidb_dense_group_sums(
        _ptr_array(distinct), k, slots.data_ptr(), valid.data_ptr(), n,
        nslots, out.data_ptr(), stream)
    _check_rc(rc, "dense_group_sums")
    _count("dense_group_sums")
    return _expand(out, index), out[k]


# ---- range_filter_sums --------------------------------------------------

def _range_mask(pred_cols, bounds, valid):
    mask = valid
    for c, (lo, hi) in zip(pred_cols, bounds):
        mask = mask & (c >= lo) & (c <= hi)
    return mask


def range_filter_sums_plain(sum_cols, pred_cols, bounds, valid, products=()):
    """Plain PyTorch range_filter_sums: the per-predicate range tests
    ANDed into valid, each pair's product a * b (int64, wrapping), then
    masked sums. -> (sums int64 [k + len(products)], count int64 [])"""
    return masked_sums_plain(list(sum_cols) + [a * b for a, b in products],
                             _range_mask(pred_cols, bounds, valid))


def _distinct_terms(sum_cols, products):
    """-> (terms, index): the distinct terms, each (a, b) with b None for
    a plain sum, and for each argument (the sum columns, then the pairs)
    the position of its term. Terms are one when their operands are the
    same buffers (distinct_buffers), in the same order."""
    args = [(c, None) for c in sum_cols] + [tuple(p) for p in products]
    _, buf = distinct_buffers([c for c in sum_cols] +
                              [t for p in products for t in p])
    ns = len(sum_cols)
    keys = [(buf[j], -1) for j in range(ns)] + \
        [(buf[ns + 2 * i], buf[ns + 2 * i + 1]) for i in range(len(products))]
    seen, terms, index = {}, [], []
    for key, arg in zip(keys, args):
        if key not in seen:
            seen[key] = len(terms)
            terms.append(arg)
        index.append(seen[key])
    return terms, index


def range_filter_sums(sum_cols, pred_cols, bounds, valid, products=()):
    """int64 sums of `sum_cols` (int64 [n] tensors), then of the wrapped
    int64 product a * b of each pair (a, b) of int64 [n] tensors in
    `products`, plus the count, over the rows where `valid` (bool [n]) is
    set and every predicate column (npred int64 [n] tensors) lies in its
    inclusive bound (`bounds`: npred (lo, hi) pairs; lo > hi passes no
    row). At most MAX_COLS sums and products together.
    -> (sums int64 [len(sum_cols) + len(products)], count int64 [])."""
    _check_vec("valid", valid, torch.bool, None, valid.device
               if isinstance(valid, torch.Tensor) else None)
    n, dev = valid.shape[0], valid.device
    sum_cols, pred_cols = list(sum_cols), list(pred_cols)
    products = [tuple(p) for p in products]
    bounds = [(int(lo), int(hi)) for lo, hi in bounds]
    if len(sum_cols) + len(products) > MAX_COLS:
        raise ValueError(f"range_filter_sums takes at most {MAX_COLS} "
                         "sum columns and products")
    if len(pred_cols) > MAX_PREDS:
        raise ValueError(f"range_filter_sums takes at most {MAX_PREDS} "
                         "predicate columns")
    if len(bounds) != len(pred_cols):
        raise ValueError(f"range_filter_sums: {len(bounds)} bounds for "
                         f"{len(pred_cols)} predicate columns")
    for lo, hi in bounds:
        if not (_I64_MIN <= lo <= _I64_MAX and _I64_MIN <= hi <= _I64_MAX):
            raise ValueError(f"range_filter_sums: bound ({lo}, {hi}) is "
                             "not int64")
    for j, c in enumerate(sum_cols):
        _check_vec(f"sum_cols[{j}]", c, torch.int64, n, dev)
    for j, c in enumerate(pred_cols):
        _check_vec(f"pred_cols[{j}]", c, torch.int64, n, dev)
    for j, p in enumerate(products):
        if len(p) != 2:
            raise ValueError(f"products[{j}]: expected a pair, got "
                             f"{len(p)} tensors")
        for t, c in zip("ab", p):
            _check_vec(f"products[{j}].{t}", c, torch.int64, n, dev)
    terms, index = _distinct_terms(sum_cols, products)
    _count("product_pairs", len(products))
    if dev.type == "cpu":
        sums, count = masked_sums_plain(
            [a if b is None else a * b for a, b in terms],
            _range_mask(pred_cols, bounds, valid))
        return _expand(sums, index), count
    if dev.type != "cuda":
        raise ValueError(f"range_filter_sums: unsupported device {dev}")
    k, npred = len(terms), len(pred_cols)
    out = torch.zeros(k + 1, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lo = (ctypes.c_longlong * max(npred, 1))(*(b[0] for b in bounds))
    hi = (ctypes.c_longlong * max(npred, 1))(*(b[1] for b in bounds))
    rc = _lib().tidb_range_filter_sums(
        _ptr_array(pred_cols), npred, lo, hi,
        _ptr_array([a for a, _b in terms]), _ptr_array([b for _a, b in terms]),
        k, valid.data_ptr(), n, out.data_ptr(), stream)
    _check_rc(rc, "range_filter_sums")
    _count("range_filter_sums")
    return _expand(out, index), out[k]


KERNELS = (masked_sums, dense_group_sums, range_filter_sums)

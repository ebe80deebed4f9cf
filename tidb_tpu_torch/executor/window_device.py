"""Window functions on the device (reference
tidb_tpu/executor/window_device.py; pkg/executor/window.go upstream).

One PyTorch program per call computes the sort, the partition and peer
boundaries and the windowed value on the domain's device, with no host
read before its one fetch:

- the sort is `sort_device.lexsort_permutation` (chained stable sorts);
- partition and peer starts and ends come from a table of segment
  starts, scattered by the running count of changes and gathered by
  it, where the reference gathered from `nonzero(size=cap)` (a
  dynamic-shape nonzero would wait on the card);
- segmented running MIN/MAX is a log-step doubling scan that never
  combines rows of two partitions (exact; the reference used
  `lax.associative_scan` with reset flags);
- sums and counts are prefix-sum differences (int64 exact; float sums
  differ from the reference's only in association);
- the result goes back to input order by a scatter through the unique
  permutation.

The host keeps the sort-KEY evaluation (one linear pass; string keys are
already rank arrays, float keys are rank-encoded below), decimal AVG and
every frame or other function: the caller (window.py `_try_device`)
routes only `DEVICE_FNS` without a frame here.
"""
from __future__ import annotations

import numpy as np
import torch

from ..chunk.device import upload
from ..utils import phase
from ..utils.fetch import host_array, prefetch
from .sort_device import lexsort_permutation

DEVICE_FNS = {"row_number", "rank", "dense_rank", "sum", "count",
              "avg", "min", "max", "lag", "lead"}


def _changes(sorted_keys, first):
    """`first` OR'd with "this row's key differs from the previous row's"
    for each of `sorted_keys`."""
    chg = first
    for k in sorted_keys:
        chg = chg | torch.cat([first[:1], k[1:] != k[:-1]])
    return chg


def _segments(chg, idx):
    """-> (start, end): each row's segment start and exclusive end, the
    segments beginning where `chg` is set (row 0 always is). Segment k's
    start is scattered to slot k of a table whose other slots hold n;
    rows that start nothing write the spare slot n, which a segment
    reads (as the end of the last one) only when every row starts one."""
    n = idx.numel()
    seg = torch.cumsum(chg, 0) - 1
    first = torch.full((n + 1,), n, dtype=idx.dtype, device=idx.device)
    first.scatter_(0, torch.where(chg, seg, n), idx)
    return first[seg], first[seg + 1]


def seg_running_minmax(x, part_id, is_min):
    """Inclusive running min/max of `x` within each partition (part_id
    non-decreasing), by log-step doubling: after the step of offset d
    each row holds the extremum of its 2d last rows of its own
    partition; a row whose row d back lies in an earlier partition
    keeps its value, which already covers every earlier row of its
    own. Exact for every dtype; the reference used
    `lax.associative_scan` with reset flags."""
    op = torch.minimum if is_min else torch.maximum
    d = 1
    while d < x.numel():
        x = torch.cat([x[:d], torch.where(part_id[d:] == part_id[:-d],
                                          op(x[d:], x[:-d]), x[d:])])
        d *= 2
    return x


def window_program(name, keys, npart, has_order, vals, ok, shift=0,
                   default=None):
    """-> (out, nulls) tensors in input-row order. keys: int64 tensors,
    partition keys first; vals, ok: the argument's values and non-NULL
    mask; all of one length and on one device."""
    n = vals.numel()
    idx = torch.arange(n, device=vals.device)
    order = lexsort_permutation(keys) if keys else idx
    sk = [k[order] for k in keys]
    svals, sok = vals[order], ok[order]
    first = idx == 0
    part_chg = _changes(sk[:npart], first)
    peer_chg = _changes(sk[npart:], part_chg) if has_order else part_chg
    part_start, part_end = _segments(part_chg, idx)
    has_base = part_start > 0
    base_idx = (part_start - 1).clamp(min=0)
    onulls = None
    if name == "row_number":
        out = idx - part_start + 1
    elif name == "rank":
        out = _segments(peer_chg, idx)[0] - part_start + 1
    elif name == "dense_rank":
        # peer starts in the partition up to this row's peer group
        peers = torch.cumsum(peer_chg, 0)
        out = peers - torch.where(has_base, peers[base_idx], 0)
    elif name in ("lag", "lead"):
        tgt = idx + shift
        valid = (tgt >= part_start) & (tgt < part_end)
        tgt = tgt.clamp(0, max(n - 1, 0))
        out = svals[tgt]
        onulls = ~sok[tgt] | ~valid
        if default is not None:
            if isinstance(default, float) and not out.is_floating_point():
                out = out.to(torch.float64)
            out = torch.where(valid, out, default)
            onulls = onulls & valid
    else:
        # aggregates over the partition, or up to the peer group with
        # ORDER BY (running totals)
        end = part_end - 1
        if has_order:
            end = torch.minimum(_segments(peer_chg, idx)[1], part_end) - 1
        cnt = torch.cumsum(sok, 0)
        c = cnt[end] - torch.where(has_base, cnt[base_idx], 0)
        onulls = c == 0
        if name == "count":
            out, onulls = c, None
        elif name in ("sum", "avg"):
            acc = torch.cumsum(torch.where(sok, svals, 0), 0)
            s = acc[end] - torch.where(has_base, acc[base_idx], 0)
            out = s if name == "sum" else \
                s.to(torch.float64) / c.clamp(min=1)
        else:                                # min / max
            if svals.is_floating_point():
                ident = float("inf") if name == "min" else float("-inf")
            else:
                big = torch.iinfo(torch.int64).max
                ident = big if name == "min" else -big
            filled = torch.where(sok, svals, ident)
            part_id = torch.cumsum(part_chg, 0) - 1
            out = seg_running_minmax(filled, part_id, name == "min")[end]
    res = torch.empty_like(out).scatter_(0, order, out)
    if onulls is None:
        return res, torch.zeros(n, dtype=torch.bool, device=vals.device)
    return res, torch.empty_like(onulls).scatter_(0, order, onulls)


def run_window_device(name, key_arrays, n_part_keys, has_order, svals,
                      sok, n, device, shift=0, default=None):
    """-> (out, nulls) numpy arrays in input-row order (nulls None when
    no row is NULL). key_arrays: sort keys, partition keys first; all
    arrays length n, in input order."""
    keys = []
    for a in key_arrays:
        a = np.asarray(a)
        if a.dtype.kind == "f":
            # float sort keys (incl. +-inf NULL sentinels): rank-encode
            # on the host, so order AND equality survive exactly (bit
            # tricks would split -0.0 from 0.0)
            a = np.unique(a, return_inverse=True)[1].reshape(-1)
        keys.append(a.astype(np.int64, copy=False))
    sv, okv = np.asarray(svals), np.asarray(sok, dtype=bool)
    phase.add("hook_upload_bytes",
              sum(a.nbytes for a in keys) + sv.nbytes + okv.nbytes)
    # supervised by the caller: window.py _try_device runs this under
    # guarded_dispatch(site="window")
    out, nulls = prefetch(window_program(
        name, [upload(a, device) for a in keys], n_part_keys,
        bool(has_order), upload(sv, device), upload(okv, device),
        shift=shift, default=default))
    out, nulls = host_array(out), host_array(nulls)
    return out, (nulls if nulls.any() else None)

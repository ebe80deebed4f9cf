"""Equi-join index on the device (reference tidb_tpu/ops/device_join.py;
HashJoinV2's partitioned build/probe upstream), sort-based: no hash
tables.

Phase 1 (count): order the build rows by (invalid, key) with two stable
sorts; a left and a right searchsorted of each probe key over the sorted
keys, both clamped to the count of valid build rows, give each probe
row's match range. An invalid build row (a NULL key) sits past every
valid one and so never matches, whatever the probe key: the reference
gives invalid rows the key 2^63-1, so a valid probe key of 2^63-1
matches them all.
Phase 2 (expand): output slot r finds its probe row by searchsorted of r
over the running match counts, and its build row by its offset into that
probe row's range: the duplicate expansion as two gathers, at exactly
the true total.

The total is the one scalar the host reads between the phases (a counted
sync); the pairs come back in one pinned fetch. An inner or outer join
makes 2 syncs, a semi or anti join (phase 1 only) makes 1. Pairs come
in probe-row order and, within a probe row, in build-row order, as the
host hash join emits them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..chunk.device import upload
from ..utils import phase
from ..utils.fetch import host_array, host_int, prefetch

_I64_MAX = np.iinfo(np.int64).max


def join_counts(bk, bvalid, pk, pvalid):
    """Phase 1 -> (counts, lo, border): each probe row's match count and
    the start of its range in `border`, the build rows ordered by
    (invalid, key)."""
    skey = torch.where(bvalid, bk, _I64_MAX)
    border = torch.argsort(skey, stable=True)
    border = border[torch.argsort((~bvalid[border]).to(torch.uint8),
                                  stable=True)]
    sbk = skey[border]
    nvalid = bvalid.sum()
    lo = torch.minimum(torch.searchsorted(sbk, pk), nvalid)
    hi = torch.minimum(torch.searchsorted(sbk, pk, right=True), nvalid)
    return torch.where(pvalid, hi - lo, 0), lo, border


def expand_pairs(counts, lo, border, total):
    """Phase 2 -> (pi, bpos): the probe and build row of each of the
    `total` matched pairs. Every gather is clamped."""
    ends = torch.cumsum(counts, 0)
    starts = ends - counts
    r = torch.arange(total, device=counts.device)
    pi = torch.searchsorted(ends, r, right=True).clamp(
        0, counts.numel() - 1)
    j = r - starts[pi]
    bpos = border[(lo[pi] + j).clamp(0, border.numel() - 1)]
    return pi, bpos


def device_join_index(bk: np.ndarray, bnull: np.ndarray,
                      pk: np.ndarray, pnull: np.ndarray, device,
                      semi_only: bool = False):
    """-> (pi, bi) int64 arrays of matched pairs (or (matched_mask,
    None) when semi_only). Keys are int64; NULL rows never match."""
    nb, npr = len(bk), len(pk)
    if nb == 0 or npr == 0:
        if semi_only:
            return np.zeros(npr, dtype=bool), None
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
    host = [np.asarray(bk, dtype=np.int64), ~np.asarray(bnull, dtype=bool),
            np.asarray(pk, dtype=np.int64), ~np.asarray(pnull, dtype=bool)]
    phase.add("hook_upload_bytes", sum(a.nbytes for a in host))
    # supervised by the caller: executors.HashJoinExec runs this under
    # guarded_dispatch(site="join")
    counts, lo, border = join_counts(*(upload(a, device) for a in host))
    if semi_only:
        return host_array(prefetch(counts > 0)), None
    total = host_int(prefetch(counts.sum()))
    if total == 0:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
    pi, bpos = prefetch(expand_pairs(counts, lo, border, total))
    return host_array(pi), host_array(bpos)

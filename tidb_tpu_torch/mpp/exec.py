"""MPP execution: plan fragments as programs over a device mesh, ported
from tidb_tpu's mpp/exec.py.

Reference mapping: a TiFlash MPP plan is a tree of Fragments split at
Exchange operators (physicalop/fragment.go:49); exchange types
PassThrough / Broadcast / Hash (fragment.go:78). Here a fragment is ONE
mesh program (parallel/mesh.py shard_map: the per-shard body on every
shard, then a collective), counted as one dispatch:

  - Hash exchange + small group domain  -> dense partial tables + psum
  - Hash exchange, large domain         -> all_to_all by key % ndev
  - Broadcast exchange                  -> a replicated build side

These building blocks produce the partial-agg layout of the single-device
copr, so the session layer routes a CoprDAG or a fused pipeline to a
mesh without changing the final merge. The copr's own mesh routes
(copr/dag_exec.py _try_execute_mpp, copr/pipeline.py _run_fused_mpp)
run their single-device fragment bodies per shard, so a shard launches
the same scan kernels a partition does.

Every gather and scatter here clamps its index, as jax's do and torch's
do not: group keys into [0, n_groups), join positions into the sorted
build side.
"""
from __future__ import annotations

import os
import threading

import numpy as np
import torch

from ..expression import EvalCtx, eval_expr, eval_bool_mask
from ..expression.vec import materialize_nulls
from ..expression.torch_ns import TorchNS
from ..parallel.mesh import (Mesh, Sharded, all_to_all_frames,
                             merge_parts, psum, shard_map, shard_rows)
from ..utils import device_guard
from ..utils import phase
from ..utils import metrics as _metrics
from ..utils.fetch import prefetch, host_array, host_int
from ..utils.torchcfg import INT64

_I64_MAX = np.iinfo(np.int64).max

# Exchange-program cache: a program is built once per mesh topology +
# fragment semantics + argument shapes, and wrapped by
# phase.timed_kernel so mesh dispatches land in the same dispatch and
# build counters as single-device fragments.
_KERN_CACHE: dict = {}
_KERN_MU = threading.Lock()
_KERN_CACHE_MAX = 256

# Hash-exchange capacity cache: (table uid, version, ndev)-style keys
# -> per-(sender, destination) bucket capacity. A repeated shuffle join
# over an unchanged table never re-sizes.
_CAP_CACHE: dict = {}
_CAP_MU = threading.Lock()
_CAP_CACHE_MAX = 4096


def _arg_sig(args):
    """Static shape/dtype signature of positional program args."""
    out = []
    for a in args:
        if isinstance(a, Sharded):
            out.append(("sharded", a.local, str(a.dtype)))
        else:
            out.append((tuple(a.shape), str(a.dtype)))
    return tuple(out)


def _lru_touch(cache: dict, key):
    """Hit path of a bounded insertion-ordered cache: re-insert so
    insertion order tracks recency. Caller holds the cache's lock."""
    val = cache.pop(key, None)
    if val is not None:
        cache[key] = val
    return val


def _lru_put(cache: dict, key, val, cap: int):
    """Insert into a bounded insertion-ordered cache, dropping the
    least-recently-touched half at capacity. Caller holds the lock."""
    if len(cache) >= cap:
        for k in list(cache)[:cap // 2]:
            cache.pop(k, None)
    cache[key] = val


def _cached_kernel(key, build):
    """Get-or-build an exchange program under the module lock."""
    with _KERN_MU:
        kern = _lru_touch(_KERN_CACHE, key)
        if kern is None:
            kern = phase.timed_kernel("mpp", build())
            _lru_put(_KERN_CACHE, key, kern, _KERN_CACHE_MAX)
    return kern


def _cap_cache_get(cap_key):
    if cap_key is None:
        return None
    with _CAP_MU:
        return _lru_touch(_CAP_CACHE, cap_key)


def _cap_cache_put(cap_key, cap):
    if cap_key is None:
        return
    with _CAP_MU:
        _lru_put(_CAP_CACHE, cap_key, cap, _CAP_CACHE_MAX)


def exchange_observed(kind: str, nbytes: int):
    """Exchange observability: one exchange executed as a collective
    over the mesh, and the aggregate bytes it moved (summed over
    shards). Phase counters ride the statement's thread-local dict, so
    Top SQL attributes collective traffic per digest."""
    _metrics.MPP_EXCHANGE.labels(kind).inc()
    _metrics.MPP_EXCHANGE_BYTES.labels(kind).inc(max(int(nbytes), 0))
    phase.inc("mpp_exchanges")
    phase.add("mpp_exchange_bytes", max(int(nbytes), 0))


def tree_nbytes(tree) -> int:
    """Aggregate byte size of a result tree (shape and dtype metadata
    only: never a device sync)."""
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return int(getattr(tree, "nbytes", 0) or 0)


def _sharded(mesh, arr, pad_fill=0):
    """An input as a Sharded buffer: placed ones as they are, host
    arrays row-sharded here (padded rows must be masked off by the
    caller's validity input, whose padding is False)."""
    if isinstance(arr, Sharded):
        return arr
    out = shard_rows(mesh, np.asarray(arr), pad_fill)
    phase.add("shuffle_upload_bytes", out.numel() * out.element_size())
    return out


def _dispatch(kern, args, site, ectx):
    from ..copr import dag_exec as _de
    return device_guard.guarded_dispatch(
        lambda: _de.run_fragment(kern, *args), site=site, ectx=ectx,
        fallback_is_host=False)


def _dense(x, n, xp):
    """An evaluator result as an n-row tensor (constants broadcast)."""
    if np.isscalar(x) or getattr(x, "ndim", 1) == 0:
        return xp.full(n, x)
    return x


def mpp_global_sum(mesh: Mesh, cols_sharded: dict, sdicts: dict,
                   filters: list, sum_exprs: list, ectx=None):
    """Fragment: sharded scan -> fused filter -> local masked sums ->
    psum. cols_sharded maps a column idx to (data, nulls or None,
    valid); the first column's valid is the row mask. Returns (sums per
    expr..., count) as tensors on the coordinator.

    The PassThrough exchange (partials -> coordinator) is the psum: the
    merge happens inside the program and the host fetches one merged
    result."""
    names_static = sorted(cols_sharded.keys())
    has_nulls = {k: cols_sharded[k][1] is not None for k in names_static}
    args = []
    for k in names_static:
        data, nulls = cols_sharded[k][0], cols_sharded[k][1]
        args.append(_sharded(mesh, data))
        if nulls is not None:
            args.append(_sharded(mesh, nulls, True))
    args.append(_sharded(mesh, cols_sharded[names_static[0]][2], False))

    def build():
        def body_for(dev):
            xp = TorchNS(dev)

            def frag(*vals):
                local_n = vals[0].shape[0]
                cols = {}
                i = 0
                for k in names_static:
                    nulls = vals[i + 1] if has_nulls[k] else None
                    cols[k] = (vals[i], nulls, sdicts.get(k))
                    i += 2 if has_nulls[k] else 1
                ctx = EvalCtx(xp, local_n, cols, host=False)
                mask = vals[-1]
                for f in filters:
                    mask = mask & eval_bool_mask(ctx, f)
                outs = []
                for e in sum_exprs:
                    d, nl, _ = eval_expr(ctx, e)
                    d = _dense(d, local_n, xp)
                    ok = mask & ~materialize_nulls(ctx, nl)
                    outs.append(torch.where(ok, d, torch.zeros(
                        (), dtype=d.dtype, device=dev)).sum())
                outs.append(mask.sum(dtype=INT64))
                return outs
            return frag

        def merge(outs):
            return tuple(psum([o[j] for o in outs], mesh)
                         for j in range(len(sum_exprs) + 1))
        return shard_map(mesh, body_for, merge)

    # dict identity rides (id, len): the cached program holds a strong
    # ref to each captured dict, so a live id() match IS the same
    # object, and len catches append growth
    key = ("gsum", mesh.fingerprint(),
           tuple(names_static), tuple(sorted(has_nulls.items())),
           tuple((k, id(sdicts[k]), len(sdicts[k].values))
                 for k in names_static if sdicts.get(k) is not None),
           tuple(f.fingerprint() for f in filters),
           tuple(e.fingerprint() for e in sum_exprs),
           _arg_sig(args))
    kern = _cached_kernel(key, build)
    res = _dispatch(kern, args, "mpp/global_sum", ectx)
    exchange_observed("passthrough", tree_nbytes(res))
    return res


def mpp_filter_agg(mesh: Mesh, key_arr, val_arr, valid, n_groups: int,
                   ectx=None):
    """Fragment: sharded grouped aggregation over a SMALL group domain.
    The hash exchange becomes dense partial tables + psum: each shard
    adds into its local [n_groups] table, one psum merges. Returns
    (sums[n_groups], counts[n_groups]) on the coordinator."""
    args = (_sharded(mesh, key_arr), _sharded(mesh, val_arr),
            _sharded(mesh, valid, False))

    def build():
        def body_for(dev):
            def frag(keys, vals, ok):
                seg = torch.clamp(keys.to(INT64), 0, n_groups - 1)
                sums = torch.zeros(n_groups, dtype=vals.dtype, device=dev)
                sums.index_add_(0, seg, torch.where(
                    ok, vals, torch.zeros((), dtype=vals.dtype,
                                          device=dev)))
                cnts = torch.zeros(n_groups, dtype=INT64, device=dev)
                cnts.index_add_(0, seg, ok.to(INT64))
                return sums, cnts
            return frag

        def merge(outs):
            return (psum([o[0] for o in outs], mesh),
                    psum([o[1] for o in outs], mesh))
        return shard_map(mesh, body_for, merge)

    kern = _cached_kernel(("fagg", mesh.fingerprint(),
                           n_groups, _arg_sig(args)), build)
    res = _dispatch(kern, args, "mpp/filter_agg", ectx)
    exchange_observed("passthrough", tree_nbytes(res))
    return res


def _shuffle_capacity(keys, ok, ndev):
    """Exact per-(sender, destination) bucket maximum for a hash
    exchange, computed on the host (the TIDB_TPU_MPP_HOST_CAP=1 debug
    path). Sizing frames to it makes overflow impossible by
    construction. Returns 0 for an empty side."""
    keys = np.asarray(keys)
    ok = np.asarray(ok)
    n = keys.shape[0]
    local = n // ndev
    mx = 0
    for d in range(ndev):
        sl = slice(d * local, (d + 1) * local)
        dk = keys[sl][ok[sl]] % ndev
        if dk.size:
            mx = max(mx, int(np.bincount(dk, minlength=ndev).max()))
    return mx


def _round_capacity(cap):
    """Quarter-pow2 bucketing so repeated runs with similar skew reuse
    one program."""
    if cap <= 128:
        return 128
    p = 1 << (int(cap - 1).bit_length())
    for q in (p // 2 + p // 4, p // 2 + p // 2):
        if cap <= q:
            return q
    return p


def _exchange_frames(keys, vals, ok, ndev, cap, dev):
    """One shard's send side of the hash exchange: rows sorted stably
    by destination (key % ndev; invalid rows to the dropped bucket
    ndev), each destination's first `cap` rows written into its
    [cap] slots. -> (key frame, value frames, valid frame, this shard's
    largest per-destination count — the overflow observable)."""
    local_n = keys.shape[0]
    dest = torch.remainder(keys, ndev)
    dest = torch.where(ok, dest, torch.full((), ndev, dtype=INT64,
                                            device=dev))
    counts = torch.zeros(ndev + 1, dtype=INT64, device=dev)
    counts.index_add_(0, dest, torch.ones(local_n, dtype=INT64,
                                          device=dev))
    local_max = counts[:ndev].max()
    order = torch.argsort(dest, stable=True)
    sdest = dest[order]
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(local_n, dtype=INT64, device=dev) - starts[sdest]
    keep = (slot < cap) & (sdest < ndev)
    # kept rows land at (dest, slot); the rest go to a scratch row
    # (ndev) that is sliced off, never onto a real slot
    flat = torch.where(keep, sdest * cap + slot,
                       torch.full((), ndev * cap, dtype=INT64,
                                  device=dev))

    def frame(col, fill):
        f = torch.full(((ndev + 1) * cap,), fill, dtype=col.dtype,
                       device=dev)
        f[flat] = col[order]
        return f[:ndev * cap].view(ndev, cap)

    fo = torch.zeros(((ndev + 1) * cap,), dtype=torch.bool, device=dev)
    fo[flat] = keep
    return (frame(keys, 0), [frame(v, 0) for v in vals],
            fo[:ndev * cap].view(ndev, cap), local_max)


def _local_join_agg(pk, pvs, pok, bk, bp, bok, n_groups, dev):
    """One shard's receive side: a sort-merge equi-join of the probe
    rows against the build rows that arrived, then a dense grouped
    aggregation on the build payload. Invalid build rows sort after
    every valid row of an equal key and never match, so a probe key of
    2^63-1 does not meet a pad row."""
    # valid rows first, then a stable sort by key: among equal keys a
    # valid row precedes the invalid ones, so the left searchsorted
    # lands on it
    pre = torch.argsort((~bok).to(torch.uint8), stable=True)
    keyed = torch.where(bok, bk, torch.full((), _I64_MAX, dtype=bk.dtype,
                                            device=dev))[pre]
    korder = torch.argsort(keyed, stable=True)
    border = pre[korder]
    sbk = keyed[korder]
    sbp = bp[border]
    sbok = bok[border]
    idx = torch.clamp(torch.searchsorted(sbk, pk), 0, sbk.shape[0] - 1)
    matched = pok & sbok[idx] & (sbk[idx] == pk)
    seg = torch.clamp(sbp[idx].to(INT64), 0, n_groups - 1)
    sums = []
    for pv in pvs:
        s = torch.zeros(n_groups, dtype=pv.dtype, device=dev)
        s.index_add_(0, seg, torch.where(
            matched, pv, torch.zeros((), dtype=pv.dtype, device=dev)))
        sums.append(s)
    cnts = torch.zeros(n_groups, dtype=INT64, device=dev)
    cnts.index_add_(0, seg, matched.to(INT64))
    return sums, cnts


def mpp_shuffle_join_agg(mesh: Mesh, probe_keys, probe_vals, probe_valid,
                         build_keys, build_payload, build_valid,
                         n_groups: int, cap=None,
                         ectx=None, cap_key=None, cap_hint=0):
    """Fragment pair with a HASH exchange: both sides all_to_all'd by
    key % ndev so matching keys land on one shard, then a local
    sort-merge join feeds a grouped aggregation on the build payload,
    merged with psum (the TiFlash shuffle-join fragment,
    ExchangeType_Hash), chosen over a Broadcast exchange when the build
    side is too large to replicate.

    Frames are [ndev, cap] per side per shard, so a hot key grows the
    frame instead of overflowing it. The capacity is, in order:
      * an explicit `cap`, trusted as is (no overflow loop);
      * the capacity cache under `cap_key` (the steady state: a
        repeated shuffle join over unchanged tables re-sizes nothing);
      * TIDB_TPU_MPP_HOST_CAP=1: the exact host bound (still cached);
      * else a balanced-load guess (or `cap_hint`, sysvar
        tidb_tpu_mpp_shuffle_cap); the program returns the exact
        per-(sender, destination) maximum (pmax over the shards'
        counts) and an overflowed guess runs ONCE more at that bound.
    Reading that bound is the statement's one host sync.

    probe_vals may be one array or a list; returns (sums[n_groups] per
    val, counts[n_groups]) as host arrays."""
    ndev = int(mesh.size)
    single = not isinstance(probe_vals, (list, tuple))
    pvals = [probe_vals] if single else list(probe_vals)
    nvals = len(pvals)
    explicit_cap = cap is not None
    if cap is None:
        cap = _cap_cache_get(cap_key)
    if cap is None and os.environ.get("TIDB_TPU_MPP_HOST_CAP") == "1":
        cap = _round_capacity(max(
            _shuffle_capacity(probe_keys, probe_valid, ndev),
            _shuffle_capacity(build_keys, build_valid, ndev), 1))
        _cap_cache_put(cap_key, cap)
    if cap is None:
        local = max(len(probe_keys), len(build_keys)) // max(ndev, 1)
        cap = _round_capacity(max(int(cap_hint), 128,
                                  2 * (local // max(ndev, 1))))
    # every input placed row-sharded once: an overflow rerun reuses the
    # placed shards
    args = (_sharded(mesh, probe_keys), _sharded(mesh, probe_valid, False),
            _sharded(mesh, build_keys), _sharded(mesh, build_payload),
            _sharded(mesh, build_valid, False)) + \
        tuple(_sharded(mesh, v) for v in pvals)

    def build_kern(cap):
        def body_for(dev):
            def frag(pk, pok, bk, bp, bok, *pvs):
                return (_exchange_frames(pk, list(pvs), pok, ndev, cap,
                                         dev),
                        _exchange_frames(bk, [bp], bok, ndev, cap, dev))
            return frag

        def merge(sent):
            # the exchange: all_to_all of every frame (on a group mesh
            # one collective across the processes)
            kinds = [[s[0][0] for s in sent], [s[0][2] for s in sent],
                     [s[1][0] for s in sent], [s[1][2] for s in sent],
                     [s[1][1][0] for s in sent]] + \
                [[s[0][1][j] for s in sent] for j in range(nvals)]
            pk2, pok2, bk2, bok2, bp2, *pv2 = [
                [f.reshape(-1) for f in recv]
                for recv in all_to_all_frames(kinds, mesh)]
            parts = [
                _local_join_agg(pk2[d], [pv[d] for pv in pv2], pok2[d],
                                bk2[d], bp2[d], bok2[d], n_groups,
                                mesh.devices[d])
                for d in range(len(mesh.devices))]
            # the sums, the counts and the exact global capacity bound
            # (computed where the data is) in one merge
            return tuple(merge_parts(
                [([p[0][j] for p in parts], "sum") for j in range(nvals)] +
                [([p[1] for p in parts], "sum"),
                 ([torch.maximum(s[0][3], s[1][3]) for s in sent], "max")],
                mesh))
        return shard_map(mesh, body_for, merge)

    mesh_fp = mesh.fingerprint()
    while True:
        kern = _cached_kernel(
            ("shuf", mesh_fp, n_groups, nvals, cap,
             _arg_sig(args)), lambda: build_kern(cap))
        res = prefetch(_dispatch(kern, args, "mpp/shuffle_join", ectx))
        if explicit_cap:
            break
        needed = host_int(res[-1])
        if needed <= cap:
            # remember the capacity that WORKED (not the tight bound:
            # re-keying to a smaller cap would rebuild for nothing)
            _cap_cache_put(cap_key, cap)
            break
        cap = _round_capacity(needed)
        _cap_cache_put(cap_key, cap)
    out = [host_array(r) for r in res[:-1]]
    # aggregate all_to_all payload: [ndev, cap] frames per side per
    # shard (keys, validity and value columns of both sides), across
    # ndev shards
    row_bytes = sum(a.element_size() for a in args)
    exchange_observed("hash", ndev * ndev * cap * row_bytes)
    if single:
        return out[0], out[-1]
    return out[:-1], out[-1]


"""Coordinator-broadcast CoprDAG execution over a multi-process mesh,
ported from tidb_tpu's mpp/spmd.py.

Reference mapping: the TiDB coordinator serializes a plan fragment as a
tipb.DAGRequest and dispatches one MPP task per store
(pkg/store/copr/mpp.go:94 DispatchMPPTask). Here the SAME pickled
CoprDAG arrives at every cluster worker over the RPC control plane, each
worker binds its LOCAL store shard as its shards of the group's mesh
(parallel/dist.bind_host_rows), and every worker runs the identical
program: the per-shard body, then one torch.distributed collective that
merges the partials (parallel/mesh.merge_parts).

SPMD invariant: the program must be identical on every process.
Everything that parametrizes it (filters, agg exprs, n_groups,
local_cap) comes from the coordinator's broadcast; nothing host-local
(like a per-process dictionary) may leak into it: dict-coded columns
are refused until dictionary broadcast lands.

The per-shard body is the single-card copr's, through the port's
evaluator over TorchNS, and takes the scan kernel the copr picks by its
shape rule (dag_exec: int64 arguments without NULLs, at most
scan_kernels.MAX_SLOTS slots): a global aggregate whose filters lower
to column bounds (copr/range_lowering.py) runs range_filter_sums, one
whose filters do not masked_sums, a grouped one dense_group_sums; any
other shape the plain torch lowerings.
"""
from __future__ import annotations

import numpy as np
import torch

from ..copr.dag_exec import (dense_agg_states, dense_agg_states_range,
                             _dense_agg_states_reduce, fold_pairs,
                             run_fragment)
from ..copr.range_lowering import lower_filters
from ..expression import EvalCtx, eval_expr, eval_bool_mask
from ..expression.torch_ns import TorchNS
from ..expression.vec import materialize_nulls
from ..parallel.dist import bind_host_rows
from ..parallel.mesh import merge_parts, shard_map
from ..utils import device_guard
from ..utils.fetch import prefetch, host_array
from ..utils.torchcfg import INT64
from .exec import _cached_kernel, _arg_sig, exchange_observed, tree_nbytes


def _refuse(dag, n_groups):
    """The fragment shapes this path does not take. Each depends on the
    broadcast DAG alone, so every rank raises before any collective and
    no peer is left waiting in one."""
    groups = list(dag.group_items)
    if groups and n_groups is None:
        raise ValueError("grouped SPMD fragment needs n_groups")
    if len(groups) > 1:
        # a single-key segment over groups[0] would silently merge
        # distinct (a, b, ...) groups identically on every host
        raise ValueError("multi-column GROUP BY not supported in SPMD "
                         "fragment yet")
    for a in dag.aggs:
        # only additive partials: min/max/first_row/avg states need the
        # full state-merge contract; refusing beats a SUM silently
        # mislabeled as MIN on every host identically
        if a.name not in ("sum", "count"):
            raise ValueError(f"agg {a.name} not supported in SPMD "
                             f"fragment yet")


def _body_for(filters, groups, aggs, idxs, has_nulls, n_groups, ranges,
              folds):
    """-> body_for(dev): one shard's fragment, returning the per-agg
    outputs and the row count (reference frag, before its psum)."""
    def body_for(dev):
        xp = TorchNS(dev)

        def frag(valid_l, *flat):
            n = valid_l.shape[0]
            cols = {}
            i = 0
            for ix in idxs:
                cols[ix] = (flat[i], flat[i + 1] if has_nulls[ix] else None,
                            None)
                i += 2 if has_nulls[ix] else 1
            ctx = EvalCtx(xp, n, cols, host=False)
            mask = valid_l
            if not groups:
                if ranges is not None:
                    for f in ranges.rest:
                        mask = mask & eval_bool_mask(ctx, f)
                    res = dense_agg_states_range(ctx, mask, aggs, ranges, n,
                                                 folds)
                else:
                    for f in filters:
                        mask = mask & eval_bool_mask(ctx, f)
                    res = _dense_agg_states_reduce(ctx, mask, aggs, n)
                return [st[0][0] for st in res["states"]] + \
                    [res["present"][0]]
            for f in filters:
                mask = mask & eval_bool_mask(ctx, f)
            gd, gn, _ = eval_expr(ctx, groups[0])
            if np.isscalar(gd) or getattr(gd, "ndim", 1) == 0:
                gd = xp.full(n, gd)
            gok = mask & ~materialize_nulls(ctx, gn)
            seg = torch.clamp(gd.to(INT64), 0, n_groups - 1)
            slot = torch.where(gok, seg, n_groups)   # the spill slot
            res = dense_agg_states(ctx, gok, aggs, slot, n_groups, n)
            return [st[0] for st in res["states"]] + [res["present"]]
        return frag
    return body_for


def run_dag_spmd(domain, dag, mesh, local_cap, n_groups=None):
    """Execute a broadcast scan->filter->partial-agg CoprDAG over the
    group's mesh, this process contributing its local shard.

    Supported fragment shapes (the Q6/Q1 classes):
      - no group items: global aggregation, result replicated;
      - one group item that evaluates to int64 in [0, n_groups): dense
        partial tables merged with one collective (the allreduce
        exchange of mpp/exec.py, across processes).
    Returns {"sums": [np per agg], "counts": np} (counts = rows per
    group / matching rows)."""
    _refuse(dag, n_groups)
    tbl_local = domain.infoschema().table_by_name(
        dag.db_name or "test", dag.table_info.name)
    if tbl_local is None:
        raise ValueError(f"table {dag.table_info.name} not on this host")
    ctab = domain.columnar.table(tbl_local)
    col_ids = []
    for sc in dag.cols:
        ci = tbl_local.find_column(sc.name)
        if ci is None:
            raise ValueError(f"column {sc.name} not in local schema")
        col_ids.append(ci.id)
    arrays, valid = ctab.snapshot(col_ids)
    for cid in col_ids:
        if arrays[cid][2] is not None:
            raise ValueError(
                "dict-coded column in SPMD fragment: per-process codes "
                "cannot cross the program (dictionary broadcast TBD)")

    bound = {}
    for sc, cid in zip(dag.cols, col_ids):
        data, nulls, _ = arrays[cid]
        bound[sc.col.idx] = (
            bind_host_rows(mesh, data, local_cap),
            None if nulls is None
            else bind_host_rows(mesh, nulls, local_cap))
    vpad = np.zeros(local_cap, dtype=bool)
    vpad[:len(valid)] = valid
    gvalid = bind_host_rows(mesh, vpad, local_cap)

    idxs = sorted(bound.keys())
    has_nulls = {ix: bound[ix][1] is not None for ix in idxs}
    filters = list(dag.filters)
    groups = list(dag.group_items)
    aggs = list(dag.aggs)
    ranges = None if groups else lower_filters(filters)
    folds = fold_pairs(aggs) if ranges is not None else None

    flat_args = [gvalid]
    for ix in idxs:
        d, nl = bound[ix]
        flat_args.append(d)
        if nl is not None:
            flat_args.append(nl)
    nouts = len(aggs) + 1

    def build():
        def merge(outs):
            return tuple(merge_parts(
                [([o[j] for o in outs], "sum") for j in range(nouts)],
                mesh))
        return shard_map(mesh, _body_for(filters, groups, aggs, idxs,
                                         has_nulls, n_groups, ranges,
                                         folds), merge)

    # the program cache is keyed by the SAME broadcast state that
    # parametrizes the program (SPMD invariant above), so every process
    # resolves an identical program and a repeated fragment reuses it
    kern = _cached_kernel(
        ("spmd", mesh.fingerprint(), n_groups,
         tuple(f.fingerprint() for f in filters),
         tuple(g.fingerprint() for g in groups),
         tuple(a.fingerprint() for a in aggs),
         tuple(idxs), tuple(ix for ix in idxs if has_nulls[ix]),
         _arg_sig(flat_args)), build)
    # supervised mesh launch: without the guard a dropped grant
    # mid-collective is an unclassified worker crash instead of a
    # retryable error the coordinator can reason about.
    # fallback_is_host=False: a degrade propagates to the coordinator
    # (a topology retreat, not a host fallback)
    res = device_guard.guarded_dispatch(
        lambda: run_fragment(kern, *flat_args), site="mpp/spmd",
        domain=domain, fallback_is_host=False)
    exchange_observed("passthrough", tree_nbytes(res))
    res = prefetch(res)
    return {"sums": [host_array(r) for r in res[:-1]],
            "counts": host_array(res[-1])}

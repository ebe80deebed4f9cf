"""MPP fragment planner (reference
pkg/planner/core/operator/physicalop/fragment.go:49 — a TiFlash plan
splits into Fragments at Exchange operators; exchange types PassThrough /
Broadcast / Hash, fragment.go:78,168), ported from tidb_tpu's
mpp/fragment.py.

A fragment is one mesh program (mpp/exec.py, copr/pipeline.py) and an
exchange is a collective over the mesh (parallel/mesh.py) or a sharded
/ replicated resident placement at the leaves:

    PassThrough  partial results -> coordinator     psum merges dense
                                                    partials; the sort
                                                    layout ships
                                                    per-shard partials
                                                    in one fetch
    Broadcast    replicate build side everywhere    replicated entries
                                                    in the residency
                                                    store
    Hash         re-key rows across devices         all_to_all with
                                                    learned frame
                                                    capacity, or
                                                    collapsed into psum
                                                    for small group
                                                    domains

The fragmenter is a physical-plan rewrite: it inserts
ExchangeSender/ExchangeReceiver nodes so EXPLAIN shows the fragment
structure, and flags the wrapped operators for mesh execution. It runs
whenever tidb_enable_mpp is on, on any device count: plans stay
executable without a mesh — every receiver runs its child's
single-device path."""
from __future__ import annotations

from ..planner.physical import (PhysPlan, PhysHashAgg, PhysTableReader,
                                PhysFusedPipeline)


class PhysExchangeSender(PhysPlan):
    """Fragment boundary, producer side (fragment.go:78 ExchangeSender)."""

    def __init__(self, child, exch_type: str, keys=(), fragment=0):
        super().__init__([child], child.schema)
        self.exch_type = exch_type      # PassThrough | Broadcast | Hash
        self.keys = list(keys)
        self.fragment = fragment
        self.stats_rows = child.stats_rows

    def explain_info(self):
        s = f"type:{self.exch_type}, fragment:{self.fragment}"
        if self.keys:
            s += f", keys:[{', '.join(map(repr, self.keys))}]"
        return s


class PhysExchangeReceiver(PhysPlan):
    """Fragment boundary, consumer side."""

    def __init__(self, child):
        super().__init__([child], child.schema)
        self.stats_rows = child.stats_rows

    def explain_info(self):
        return ""


def fragment_plan(plan: PhysPlan) -> PhysPlan:
    """Insert exchange boundaries into a physical plan. Applied when
    tidb_enable_mpp is on; the wrapped operators execute on the mesh
    when one exists and on their single-device paths otherwise."""
    counter = [0]

    def walk(p):
        if isinstance(p, PhysHashAgg) and p.mode == "final" and p.children:
            child = p.children[0]
            if isinstance(child, PhysFusedPipeline):
                counter[0] += 1
                frag_id = counter[0]
                child.mpp = True
                # each dimension arrives over a Broadcast exchange: the
                # build side replicates to every device
                from ..planner.schema import Schema
                dim_nodes = []
                for d in child.dims:
                    rd = PhysTableReader(d.dag, Schema(list(d.dag.cols)))
                    counter[0] += 1
                    snd = PhysExchangeSender(rd, "Broadcast",
                                             fragment=counter[0])
                    dim_nodes.append(PhysExchangeReceiver(snd))
                # display-only: the fused fragment reads its dims
                # directly; the executor ignores these children
                child.children = dim_nodes
                snd = PhysExchangeSender(child, "PassThrough",
                                         fragment=frag_id)
                p.children = [PhysExchangeReceiver(snd)]
                return p
            if isinstance(child, PhysTableReader) and child.dag.aggs:
                counter[0] += 1
                # hash exchange on the group keys collapses into the
                # dense psum (mpp/exec.py) for small domains; general
                # domains return per-shard partials (PassThrough)
                snd = PhysExchangeSender(child, "Hash",
                                         keys=list(child.dag.group_items),
                                         fragment=counter[0])
                p.children = [PhysExchangeReceiver(snd)]
                return p
        p.children = [walk(c) for c in p.children]
        return p

    return walk(plan)

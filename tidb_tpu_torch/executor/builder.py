"""Executor builder (reference pkg/executor/builder.go:193)."""
from __future__ import annotations

from ..planner.physical import (PhysBatchPointGet, PhysIndexMerge, PhysIndexRange, PhysPointGet, PhysTableReader, PhysSelection, PhysProjection,
                                PhysHashAgg, PhysHashJoin, PhysSort, PhysTopN,
                                PhysLimit, PhysUnion, PhysDual, PhysShell,
                                PhysWindow)
from .executors import (TableReaderExec, SelectionExec, ProjectionExec,
                        HashAggExec, HashJoinExec, SortExec, TopNExec,
                        LimitExec, UnionExec, DualExec, ShellExec,
                        PointGetExec, IndexRangeExec, BatchPointGetExec)
from .window import WindowExec


def build_executor(ctx, plan):
    ex = _build(ctx, plan)
    if getattr(ctx, "collect_stats", False):
        from .runtime_stats import TimedExec
        ex = TimedExec(ex)
    return ex


def _build(ctx, plan):
    if isinstance(plan, PhysPointGet):
        return PointGetExec(ctx, plan)
    if isinstance(plan, PhysIndexMerge):
        from .executors import IndexMergeExec
        return IndexMergeExec(ctx, plan)
    if isinstance(plan, PhysIndexRange):
        return IndexRangeExec(ctx, plan)
    if isinstance(plan, PhysBatchPointGet):
        return BatchPointGetExec(ctx, plan)
    if isinstance(plan, PhysTableReader):
        return TableReaderExec(ctx, plan)
    from ..planner.physical import PhysFusedPipeline
    if isinstance(plan, PhysFusedPipeline):
        from .executors import FusedPipelineExec
        return FusedPipelineExec(ctx, plan)
    from ..mpp.fragment import PhysExchangeReceiver, PhysExchangeSender
    if isinstance(plan, PhysExchangeReceiver):
        # the sender is a display-level fragment boundary; the receiver
        # drives the fragment body directly (in one process the
        # exchange is a placement or a collective, not a stream)
        from .executors import ExchangeReceiverExec
        inner = plan.child
        if isinstance(inner, PhysExchangeSender):
            inner = inner.child
        return ExchangeReceiverExec(ctx, plan, build_executor(ctx, inner))
    if isinstance(plan, PhysSelection):
        return SelectionExec(ctx, plan, build_executor(ctx, plan.child))
    if isinstance(plan, PhysProjection):
        return ProjectionExec(ctx, plan, build_executor(ctx, plan.child))
    if isinstance(plan, PhysHashAgg):
        return HashAggExec(ctx, plan, build_executor(ctx, plan.child))
    if isinstance(plan, PhysHashJoin):
        return HashJoinExec(ctx, plan, build_executor(ctx, plan.children[0]),
                            build_executor(ctx, plan.children[1]))
    from ..planner.physical import PhysIndexLookupJoin, PhysMergeJoin
    if isinstance(plan, PhysIndexLookupJoin):
        from .executors import IndexLookupJoinExec
        return IndexLookupJoinExec(ctx, plan,
                                   build_executor(ctx, plan.children[0]))
    if isinstance(plan, PhysMergeJoin):
        from .executors import MergeJoinExec
        return MergeJoinExec(ctx, plan,
                             build_executor(ctx, plan.children[0]),
                             build_executor(ctx, plan.children[1]))
    from ..planner.physical import PhysVectorSearch
    if isinstance(plan, PhysVectorSearch):
        from .vector_search import VectorSearchExec
        return VectorSearchExec(ctx, plan)
    from ..planner.physical import PhysMLPredict
    if isinstance(plan, PhysMLPredict):
        from .ml_predict import MLPredictExec
        return MLPredictExec(ctx, plan)
    if isinstance(plan, PhysSort):
        return SortExec(ctx, plan, build_executor(ctx, plan.child))
    if isinstance(plan, PhysTopN):
        return TopNExec(ctx, plan, build_executor(ctx, plan.child))
    if isinstance(plan, PhysLimit):
        return LimitExec(ctx, plan, build_executor(ctx, plan.child))
    if isinstance(plan, PhysUnion):
        return UnionExec(ctx, plan,
                         [build_executor(ctx, c) for c in plan.children])
    if isinstance(plan, PhysDual):
        return DualExec(ctx, plan)
    if isinstance(plan, PhysShell):
        return ShellExec(ctx, plan, build_executor(ctx, plan.child))
    if isinstance(plan, PhysWindow):
        return WindowExec(ctx, plan, build_executor(ctx, plan.child))
    raise NotImplementedError(f"no executor for {type(plan).__name__}")

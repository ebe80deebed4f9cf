"""Vector search on the domain's torch device (reference
tidb_tpu/vector/; docs/VECTOR.md is the protocol reference).

VECTOR(k) columns live in the columnar engine as dict-encoded text with
a fixed-width float32[rows, k] twin (storage/columnar.py
vector_matrix). This package keeps that twin device-resident —
delta-maintained like any base column — and serves
`ORDER BY vec_*_distance(col, const) LIMIT k` as:

  * EXACT: one matmul + top-k program under guarded_dispatch (site
    vector/topk) meeting the single-dispatch contract, with a host
    twin for chaos parity on the CPU;
  * ANN: an IVF index (CREATE VECTOR INDEX ... USING IVF) — k-means
    centroids trained on the device, per-partition posting lists,
    tidb_tpu_vector_nprobe picking the recall/speed trade — folded
    incrementally from commits (never a full rebuild on write).
"""
from .runtime import VectorRuntime, METRIC_OPS

__all__ = ["VectorRuntime", "METRIC_OPS"]

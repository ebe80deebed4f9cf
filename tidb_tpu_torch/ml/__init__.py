"""In-SQL model inference on the shared tensor runtime (reference
tidb_tpu/ml/).

One runtime serves relational, retrieval, AND model operators ("Query
Processing on Tensor Computation Runtimes"): models are schema objects
(CREATE MODEL / DROP MODEL / SHOW MODELS — durable meta rows + a
resumable DDL job, ml/ddl.py), inference is an expression (predict()/
embed() lower through the shared registry and fuse into copr fragments,
ml/lowering.py), and the standalone full-table path rides the same
kernel cache, residency store, phase accounting, and device guard as
every other operator (ml/runtime.py, ml/kernels.py), on the domain's
torch device.
"""
from .registry import ModelHandle, ModelRegistry, parse_npz
from .runtime import MLRuntime
from . import lowering  # noqa: F401  (predict/embed op registration)

__all__ = ["ModelHandle", "ModelRegistry", "MLRuntime", "parse_npz"]

"""Model forward-pass programs + numpy host twins (reference
tidb_tpu/ml/kernels.py, whose programs are jitted XLA; none reaches a
Pallas kernel).

The forward pass is a dense matmul chain (linear / ReLU-MLP): plain
torch.matmul products, TF32 off (utils/torchcfg.py). `forward_xp` is
xp-generic so the SAME op sequence serves three call shapes:

  * the fused fragment (xp = the port's TorchNS, inside a copr
    fragment: the weights are the MLRuntime's resident tensors, so a
    warm fused statement uploads nothing),
  * the standalone full-table program from `build_forward_kernel`
    (weights ride in as device-resident arguments, uploaded once),
  * the numpy host twin `host_forward` (same float32 op order).

NULL handling lives outside the program (any NULL feature nulls the
output row, computed by the caller's mask).
"""
from __future__ import annotations

import numpy as np


def forward_xp(xp, X, weights, biases):
    """Dense forward chain: X [n, f] float32 through len(weights)
    layers, ReLU between hidden layers, linear last. Returns [n] when
    the final width is 1, else [n, out]."""
    h = X
    last = len(weights) - 1
    for i, (W, b) in enumerate(zip(weights, biases)):
        h = h @ xp.asarray(W, dtype=xp.float32) \
            + xp.asarray(b, dtype=xp.float32)
        if i != last:
            h = xp.maximum(h, xp.float32(0.0))
    if h.ndim == 2 and h.shape[1] == 1:
        h = h[:, 0]
    return h


def build_forward_kernel(nlayers: int):
    """Standalone full-table inference: ONE program = the whole matmul
    chain over the resident feature matrix. Weights/biases are passed
    as arguments (device-resident under the model's uid — uploaded
    once, never per statement)."""

    def kern(X, *params):
        from ..expression.torch_ns import TorchNS
        ws = params[:nlayers]
        bs = params[nlayers:]
        return forward_xp(TorchNS(X.device), X, ws, bs)

    return kern


def host_forward(X, weights, biases) -> np.ndarray:
    """Numpy twin of `build_forward_kernel` (same float32 op order)."""
    return np.asarray(
        forward_xp(np, np.asarray(X, dtype=np.float32), weights, biases))


def embed_lookup(table: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Embedding-table gather (host-side: embed() runs at ingest /
    host eval and folds into the resident vector matrix through the
    delta path — its device story is the computed VECTOR column)."""
    n = len(table)
    return table[np.asarray(ids, dtype=np.int64) % n]

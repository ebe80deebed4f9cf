"""ORDER BY permutation on the device (reference
tidb_tpu/executor/sort_device.py; pkg/executor/sortexec upstream).

The O(n log n) work, the sort PERMUTATION, runs on the domain's device
as a chain of stable `torch.sort`s over int64 key arrays, from the
least significant key to the most significant, each gathered by the
running permutation (torch has no lexsort; a stable sort per key gives
the same order). The host keeps the linear work: the key arrays
(`executors._sort_key_arrays`: collation ranks, NULL sentinels) and the
payload gather, which streams from disk in the external path.

The reference pads to a shape bucket with a pad flag as the primary key
because XLA compiles one program per shape; eager PyTorch sorts exactly
n rows, and the permutation is the same.

Float keys map on the host into an order-preserving int64 (sign-flip),
so the device sorts int64 only. -0.0 orders strictly before +0.0 (host
numpy ties them), as in the reference; SQL floats carry no NaNs here.

The keys go up in one pinned, non-blocking copy each (counted as
`hook_upload_bytes`), and the permutation comes back in one pinned
fetch: one counted sync (utils/fetch.py).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..chunk.device import upload
from ..utils import phase
from ..utils.fetch import host_array, prefetch


def _float_to_ordered_int(a: np.ndarray) -> np.ndarray:
    """IEEE-754 double -> int64 with the same total order (negatives:
    flip the low 63 bits; positives: raw bits)."""
    b = a.view(np.int64)
    return np.where(b >= 0, b, b ^ np.int64(0x7FFFFFFFFFFFFFFF))


def lexsort_permutation(keys):
    """-> the stable lexicographic permutation of int64 tensors `keys`
    (primary first), on their device, without a host read."""
    perm = torch.arange(keys[0].numel(), device=keys[0].device)
    for k in reversed(keys):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


def host_keys(keys):
    """The sort key arrays as int64 (float keys order-mapped)."""
    out = []
    for a in keys:
        a = np.asarray(a)
        if a.dtype.kind == "f":
            a = _float_to_ordered_int(a.astype(np.float64, copy=False))
        out.append(a.astype(np.int64, copy=False))
    return out


def device_sort_permutation(keys, n, device):
    """-> int64 permutation of the n input rows in sorted order, or None
    when the input is below the size floor (TIDB_TPU_SORT_MIN, default
    2^15: a tiny sort is not worth a device round trip). keys: arrays
    from _sort_key_arrays (primary first), numeric dtypes only."""
    min_rows = int(os.environ.get("TIDB_TPU_SORT_MIN", 1 << 15))
    if n < min_rows or not keys:
        return None
    hk = host_keys(keys)
    phase.add("hook_upload_bytes", sum(a.nbytes for a in hk))
    # supervised by the caller: executors.SortExec._order runs this
    # under guarded_dispatch(site="sort")
    order = lexsort_permutation([upload(a, device) for a in hk])
    return host_array(prefetch(order))

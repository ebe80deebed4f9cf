"""ML runtime: device-resident weights + the standalone full-table
forward path (reference tidb_tpu/ml/runtime.py).

Two serving shapes share the programs (ml/kernels.py):

  * FUSED — predict() inside a filter/agg fragment runs through the
    expression registry in the fragment body (ml/lowering.py), with the
    weights this runtime keeps resident (`device_weights`): a warm
    fused statement uploads nothing.
  * STANDALONE — `SELECT predict(m, ...) FROM t` over a bare table
    scan lowers to PhysMLPredict (planner/physical.py): the feature
    matrix and the weights are device-resident (features under the
    table uid like every column buffer; weights under their own
    ("mlw", model_id) uid so they upload ONCE, never per statement),
    and the whole chain is one dispatch + one fetch sync. Guarded via
    guarded_dispatch site="ml/predict": on the CPU the numpy twin
    serves a degrade, on the card the statement fails.

Placement mirrors the vector runtime: the numpy twin serves on the CPU
unless TIDB_TPU_ML_DEVICE forces the device path (the tests force it to
exercise residency + phase budgets on CPU tensors).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..chunk.device import upload
from ..copr import dag_exec
from ..utils import device_guard, phase
from ..utils.fetch import host_array, prefetch
from . import kernels
from .registry import ModelRegistry


def _device_inference(copr) -> bool:
    """Standalone forward placement: same contract as the vector
    runtime's `_device_scoring` — numpy twin on the CPU, the device on
    the card or under the force env the tests use."""
    mode = os.environ.get("TIDB_TPU_ML_DEVICE", "auto")
    if mode == "0" or not copr.use_device:
        return False
    if mode == "1":
        return True
    return copr.device.type == "cuda"


def _cap_of(n: int) -> int:
    """Power-of-2 row bucket for the padded feature matrix, so one
    program-cache key serves a growing table."""
    cap = 1024
    while cap < n:
        cap <<= 1
    return cap


class MLRuntime:
    """Model registry + device residency + standalone inference."""

    def __init__(self, domain):
        self.domain = domain
        self.registry = ModelRegistry(domain)
        self._dev_nbytes: dict = {}    # model id -> resident bytes

    # ---- registry passthrough -----------------------------------------
    def lookup(self, name: str):
        return self.registry.lookup(name)

    def handles(self):
        return self.registry.handles()

    def device_nbytes(self, mid: int) -> int:
        return self._dev_nbytes.get(mid, 0)

    def invalidate(self, mid: int):
        """DROP MODEL / replacement: evict the weight buffers."""
        copr = self.domain.copr
        copr._dev_store.invalidate(("mlw", mid))
        self._dev_nbytes.pop(mid, None)

    # ---- device residency ---------------------------------------------
    def device_weights(self, copr, h, device=None):
        """Weight/bias tensors on `device` (default: the copr's), resident
        under uid ("mlw", id) and keyed ("mlw", id, version, i, device):
        one copy per distinct device a fragment runs on (each shard's
        device of a mesh: the reference's weights are constants of
        every shard's program), so invalidate(id) drops them all. Exact
        shapes (matmul operands must NOT be padded), uploaded once as
        pinned non-blocking copies — warm statements take pool hits
        only."""
        device = copr.device if device is None else torch.device(device)
        store = copr._dev_store
        out = []
        total = 0
        for i, arr in enumerate(list(h.weights) + list(h.biases)):
            key = ("mlw", h.id, h.version, i, str(device))
            dev = store.get(key)
            if dev is None:
                a32 = np.asarray(arr, dtype=np.float32)
                dev = upload(a32, device)
                store.put(key, dev, a32.nbytes, uid=("mlw", h.id),
                          version=h.version)
                phase.inc("uploads")
                phase.add("upload_bytes", a32.nbytes)
            else:
                phase.inc("upload_hits")
            total += int(arr.nbytes)
            out.append(dev)
        self._dev_nbytes[h.id] = total
        nw = len(h.weights)
        return out[:nw], out[nw:]

    # ---- standalone full-table forward --------------------------------
    def predict_rows(self, copr, ctab, h, feats_np, read_ts, fids,
                     ectx=None, served=None):
        """Forward the [n, nf] float32 feature matrix through model h.
        -> float32 [n]. Device path: resident padded features (keyed
        like every derived snapshot buffer: version + read_ts + gc
        epoch) + resident weights + ONE program; host twin on the CPU
        (and on a degrade there)."""
        n, nf = feats_np.shape

        def host():
            if served is not None:
                served["host"] = True
            return kernels.host_forward(feats_np, h.weights, h.biases)

        if n == 0 or not _device_inference(copr):
            return host()

        def dev():
            cap = _cap_of(n)
            # pre-pad: the shared upload tail pads 1-D buffers only
            Xp = np.asarray(feats_np, dtype=np.float32)
            if len(Xp) != cap:
                Xp = np.concatenate(
                    [Xp, np.zeros((cap - n, nf), dtype=np.float32)])
            dX = copr._dev_put(
                (ctab.uid, "mlfeat", fids, ctab.version, read_ts,
                 ctab.gc_epoch, cap),
                Xp, pad_fill=0, uid=ctab.uid,
                version=ctab.version)
            ws, bs = self.device_weights(copr, h)
            kc = copr._kernel_cache
            shapes = tuple(tuple(w.shape) for w in h.weights)
            ck = ("ml_fwd", h.fingerprint(), cap, nf, shapes)
            kern = kc.get(ck) or kc.put(
                ck, kernels.build_forward_kernel(len(h.weights)))
            y = prefetch(dag_exec.run_fragment(kern, dX, *ws, *bs))
            return host_array(y)[:n]

        to_host = copr.degrade_to_host
        out = device_guard.guarded_dispatch(
            dev, site="ml/predict", ectx=ectx, domain=self.domain,
            host_fallback=host if to_host else None,
            fallback_is_host=to_host)
        return np.asarray(out, dtype=np.float32)

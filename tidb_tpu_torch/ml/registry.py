"""Model registry: npz weight parsing + the epoch-keyed lookup cache
(reference tidb_tpu/ml/registry.py, host code copied with its imports
pointed here).

Models are schema objects (meta rows, see models/mlmodel.py). The
registry materializes them into `ModelHandle`s — parsed weight arrays
plus the lowering metadata the expression rewriter needs — and caches
the set keyed by `domain.schema_epoch`: any model DDL commits meta rows,
the commit hook bumps the epoch, and the next lookup reloads. That is
the SAME fence the plan cache rides, so a cached lowered `predict()`
can never outlive the model version it embedded (the MLFunc fingerprint
carries `name#v{version}`).

npz layout conventions (kind is inferred from the key set):

  embedding:  table [vocab, dim] float            -> embed(m, col)
  linear:     coef [f] or [f, o], intercept [o]?  -> predict(m, cols...)
  mlp:        W0 [f, h0], b0 [h0], W1, b1, ...    -> predict(m, cols...)
"""
from __future__ import annotations

import io
import threading
import zlib

import numpy as np

from ..errors import TiDBError
from ..models import ModelInfo


class ModelHandle:
    """A loaded model: durable info + parsed float32 weight arrays +
    runtime counters. Immutable once built (replacement mints a new
    handle at a new version)."""

    def __init__(self, info: ModelInfo, weights, biases, table=None):
        self.info = info
        self.weights = weights      # [W_i float32] (empty for embedding)
        self.biases = biases        # [b_i float32]
        self.table = table          # float32 [vocab, dim] | None
        # the domain's MLRuntime (set by the registry): a fused
        # predict() takes its resident weights from there
        self.runtime = None
        self.predict_calls = 0
        self.predict_rows = 0

    @property
    def id(self):
        return self.info.id

    @property
    def name(self):
        return self.info.name

    @property
    def kind(self):
        return self.info.kind

    @property
    def version(self):
        return self.info.version

    @property
    def in_features(self) -> int:
        return int(self.info.params.get("in_dim", 0))

    @property
    def dim(self) -> int:
        return int(self.info.params.get("dim", 0))

    def fingerprint(self) -> str:
        """Keys kernel caches, fragment plans, and derived residency
        entries — version-qualified so replacement fences them all."""
        return f"{self.info.name}#v{self.info.version}"

    def embed_ids(self, tokens) -> np.ndarray:
        """Stable token -> row hash for the embedding table (crc32:
        deterministic across processes, unlike hash())."""
        vocab = max(1, len(self.table) if self.table is not None else 1)
        out = np.empty(len(tokens), dtype=np.int64)
        for i, t in enumerate(tokens):
            if t is None:
                out[i] = 0
            else:
                out[i] = zlib.crc32(str(t).encode("utf-8")) % vocab
        return out


def parse_npz(blob: bytes):
    """-> (kind, params, weights, biases, table). Raises TiDBError on
    an unrecognized key layout (surfaces as the CREATE MODEL error)."""
    try:
        with np.load(io.BytesIO(blob), allow_pickle=False) as z:
            arrays = {k: np.asarray(z[k]) for k in z.files}
    except Exception as e:  # noqa: BLE001 - any load failure is the user's
        raise TiDBError("invalid model weights (not a loadable npz): %s",
                        e)
    if not arrays:
        raise TiDBError("invalid model weights: empty npz archive")
    nbytes = int(sum(a.nbytes for a in arrays.values()))

    if "table" in arrays:
        table = np.asarray(arrays["table"], dtype=np.float32)
        if table.ndim != 2 or not table.size:
            raise TiDBError("embedding 'table' must be 2-D [vocab, dim]")
        params = {"kind": "embedding", "vocab": int(table.shape[0]),
                  "dim": int(table.shape[1]), "nbytes": nbytes}
        return "embedding", params, [], [], table

    if "coef" in arrays:
        W = np.asarray(arrays["coef"], dtype=np.float32)
        if W.ndim == 1:
            W = W[:, None]
        if W.ndim != 2 or not W.size:
            raise TiDBError("linear 'coef' must be [features] or "
                            "[features, outputs]")
        b = np.asarray(arrays.get("intercept", np.zeros(W.shape[1])),
                       dtype=np.float32).reshape(-1)
        if b.shape[0] != W.shape[1]:
            raise TiDBError("linear 'intercept' width %d != outputs %d",
                            b.shape[0], W.shape[1])
        params = {"kind": "linear", "in_dim": int(W.shape[0]),
                  "out_dim": int(W.shape[1]), "layers": [list(W.shape)],
                  "nbytes": nbytes}
        return "linear", params, [W], [b], None

    ws, bs, i = [], [], 0
    while f"W{i}" in arrays:
        W = np.asarray(arrays[f"W{i}"], dtype=np.float32)
        if W.ndim != 2:
            raise TiDBError("mlp 'W%d' must be 2-D", i)
        b = np.asarray(arrays.get(f"b{i}", np.zeros(W.shape[1])),
                       dtype=np.float32).reshape(-1)
        if b.shape[0] != W.shape[1]:
            raise TiDBError("mlp 'b%d' width %d != 'W%d' outputs %d",
                            i, b.shape[0], i, W.shape[1])
        if ws and ws[-1].shape[1] != W.shape[0]:
            raise TiDBError("mlp layer %d input %d != layer %d output %d",
                            i, W.shape[0], i - 1, ws[-1].shape[1])
        ws.append(W)
        bs.append(b)
        i += 1
    if not ws:
        raise TiDBError(
            "unrecognized model layout: expected 'table' (embedding), "
            "'coef' (linear), or 'W0','b0',... (mlp); got keys %s",
            sorted(arrays))
    params = {"kind": "mlp", "in_dim": int(ws[0].shape[0]),
              "out_dim": int(ws[-1].shape[1]),
              "layers": [list(W.shape) for W in ws], "nbytes": nbytes}
    return "mlp", params, ws, bs, None


class ModelRegistry:
    """Epoch-keyed cache over the durable model rows. Thread-safe;
    handles (and their parsed arrays) are shared across sessions —
    callers must treat them as immutable."""

    def __init__(self, domain):
        self.domain = domain
        self._mu = threading.Lock()
        self._epoch = -1
        self._by_name: dict[str, ModelHandle] = {}

    def _load_locked(self):
        epoch = self.domain.schema_epoch
        if epoch == self._epoch:
            return
        txn = self.domain.storage.begin()
        try:
            from ..meta.meta import Mutator
            m = Mutator(txn)
            fresh = {}
            for info in m.list_models():
                if not info.public:
                    continue
                old = self._by_name.get(info.name.lower())
                if old is not None and old.info.id == info.id and \
                        old.info.version == info.version:
                    fresh[info.name.lower()] = old   # keep parsed arrays
                    continue
                blob = m.get_model_weights(info.id)
                if blob is None:
                    continue                         # mid-rollback row
                _, _, ws, bs, table = parse_npz(bytes(blob))
                h = ModelHandle(info, ws, bs, table)
                h.runtime = getattr(self.domain, "ml", None)
                fresh[info.name.lower()] = h
        finally:
            txn.rollback()
        self._by_name = fresh
        self._epoch = epoch

    def lookup(self, name: str) -> ModelHandle | None:
        with self._mu:
            self._load_locked()
            return self._by_name.get(name.lower())

    def handles(self) -> list[ModelHandle]:
        with self._mu:
            self._load_locked()
            return sorted(self._by_name.values(), key=lambda h: h.id)

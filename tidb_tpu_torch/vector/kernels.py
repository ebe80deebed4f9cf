"""Vector-search programs: distance products + top-k over tensors on the
domain's device, with numpy host twins sharing the same selection-key
construction (reference tidb_tpu/vector/kernels.py, whose programs are
jitted XLA; none reaches a Pallas kernel).

Device/host parity contract: both paths rank by the SAME key
    dead/pad row        -> -inf   (never selected while live rows remain)
    NULL/invalid vector -> +inf   (MySQL ORDER BY ASC: NULLs first)
    live row            -> -distance (float32)
and both break ties by lowest row index. torch.topk promises no tie
order, so `select_topk` ranks an int64 composite: the key mapped to an
order-preserving int32 in the high word, the complement of the row in
the low word (-0.0 is first folded into +0.0, which the reference's
float compare ties with it). The host twin sorts with kind='stable'.
The executor re-ranks the returned candidate slate on host with the
statement's own expression evaluator, so a float32 ulp at the k-th
boundary (cuBLAS, torch's CPU and XLA's products differ there) can
shuffle candidates but never the final rows (the slate carries slack
past k).

Distances are float32 via the matmul forms (||m||^2 - 2 m.q + ||q||^2
for L2), so the whole scan is one [rows, dim] x [dim] product
(torch.matmul; TF32 stays off, utils/torchcfg.py).

k-means without the reference's one-hot products: the nearest centroid
comes from row chunks of the [rows, nlist] distance matrix (each row's
argmin is its own, so chunking changes nothing; a one-hot at 1 M rows x
2,048 lists would take 8 GiB), and the segment sums are `index_add_`
into float64 accumulators, cast to float32 after the division: float64
atomics leave an order-dependent error far below float32's rounding.
"""
from __future__ import annotations

import numpy as np
import torch

# rows per chunk of the [rows, nlist] distance matrix (assignment)
ASSIGN_CHUNK = 1 << 16
_LOW32 = (1 << 32) - 1


def _distances_xp(xp, mat, q, metric):
    """Metric distances of every matrix row to q, in float32, via the
    matmul form. Shared between the torch programs (xp=torch) and the
    host twins (xp=np) so both see the same op sequence."""
    s = mat @ q                                     # [rows]
    if metric == "vec_l2_distance":
        m2 = (mat * mat).sum(1)
        q2 = (q * q).sum()
        return xp.sqrt(xp.maximum(m2 - 2.0 * s + q2, _zero(xp, s)))
    if metric == "vec_cosine_distance":
        m2 = (mat * mat).sum(1)
        q2 = (q * q).sum()
        den = xp.sqrt(m2) * xp.sqrt(q2)
        # zero vector -> 0/0 -> NaN -> NULL (sorts first, like host)
        return 1.0 - s / den
    if metric == "vec_negative_inner_product":
        return -s
    raise ValueError(f"unsupported vector metric {metric}")


def _zero(xp, like):
    if xp is np:
        return np.float32(0.0)
    return like.new_zeros(())


def _select_key_xp(xp, d, valid):
    """The shared selection key (module docstring). NULL vectors are
    NaN rows in the fixed-width matrix, so their distance is NaN."""
    if xp is np:
        inf = np.float32(np.inf)
        return np.where(valid, np.where(np.isnan(d), inf, -d), -inf)
    inf = torch.full((), float("inf"), dtype=d.dtype, device=d.device)
    return torch.where(valid, torch.where(torch.isnan(d), inf, -d), -inf)


def _ordered_int(key):
    """float32 -> int64 with the same order (-0.0 folded into +0.0:
    negatives flip their low 31 bits, positives keep their bits)."""
    b = (key + 0.0).view(torch.int32)
    return torch.where(b >= 0, b, b ^ 0x7FFFFFFF).to(torch.int64)


def select_topk(key, kcap):
    """-> (keys[kcap] f32, pos[kcap] i64): the kcap largest keys, ties
    by the lowest position (lax.top_k's order)."""
    pos = torch.arange(key.numel(), device=key.device, dtype=torch.int64)
    comp = (_ordered_int(key) << 32) | (_LOW32 - pos)
    top = torch.topk(comp, kcap).values
    idx = _LOW32 - (top & _LOW32)
    return key[idx], idx


def select_topk_plain(key, kcap):
    """The plain version of select_topk: a stable descending sort."""
    order = torch.sort(key + 0.0, descending=True, stable=True).indices
    idx = order[:kcap]
    return key[idx], idx


def build_topk_kernel(metric: str, kcap: int):
    """Exact brute-force top-k: ONE program = distances over the whole
    resident matrix + the tie-ordered top-k. -> (keys[kcap] f32,
    idx[kcap] i32); keys <= -inf mark dead padding the host must drop,
    keys == +inf mark NULL rows (ordered first, ASC semantics)."""

    def kern(mat, valid, q):
        d = _distances_xp(torch, mat, q, metric)
        vals, idx = select_topk(_select_key_xp(torch, d, valid), kcap)
        return vals, idx.to(torch.int32)

    return kern


def build_ivf_score_kernel(metric: str, kcap: int):
    """ANN candidate scoring: gather the probed posting lists' rows
    from the RESIDENT matrix (only the candidate index vector rides
    host->device per query) and top-k them. cand is padded with 0s and
    clamped into the matrix (an out-of-range gather is a device
    assert); cvalid gates padding and MVCC-dead rows off."""

    def kern(mat, cand, cvalid, q):
        c = cand.to(torch.int64).clamp_(0, mat.shape[0] - 1)
        d = _distances_xp(torch, mat[c], q, metric)
        vals, pos = select_topk(_select_key_xp(torch, d, cvalid), kcap)
        return vals, cand[pos].to(torch.int32)

    return kern


def assign_rows(mat, cent, chunk=ASSIGN_CHUNK):
    """Nearest-centroid id (int64) per row, in row chunks. A row whose
    distances hold a NaN (a NULL vector) takes the first NaN's centroid,
    as np.argmin and jnp.argmin do (0 for an all-NaN row)."""
    c2 = (cent * cent).sum(1)[None, :]
    out = []
    for lo in range(0, mat.shape[0], chunk):
        m = mat[lo:lo + chunk]
        d2 = _pair_d2(m, cent, c2)
        bad = torch.isnan(d2)
        a = torch.argmin(torch.where(bad, 0.0, d2), dim=1)
        out.append(torch.where(bad.any(1), torch.argmax(bad.to(torch.int8),
                                                        dim=1), a))
    if not out:
        return torch.zeros(0, dtype=torch.int64, device=mat.device)
    return out[0] if len(out) == 1 else torch.cat(out)


def build_kmeans_step():
    """One Lloyd iteration: nearest-centroid assignment (matmul
    distance form, row chunks) + segment means by float64 index_add_.
    Empty clusters keep their previous centroid."""

    def step(mat, valid, cent):
        # zero the dead/NULL (NaN) rows BEFORE the sums: their weight
        # is 0, but 0 * NaN = NaN and one poisoned row would NaN every
        # centroid
        m = torch.where(valid[:, None], mat, 0.0)
        a = assign_rows(m, cent)
        nlist = cent.shape[0]
        sums = torch.zeros((nlist, m.shape[1]), dtype=torch.float64,
                           device=m.device).index_add_(0, a, m.double())
        cnts = torch.zeros(nlist, dtype=torch.float64,
                           device=m.device).index_add_(0, a, valid.double())
        mean = (sums / cnts.clamp(min=1.0)[:, None]).float()
        return torch.where(cnts[:, None] > 0, mean, cent)

    return step


def build_assign_kernel():
    """Nearest-centroid id per row (posting-list construction and the
    incremental delta fold)."""

    def kern(mat, cent):
        return assign_rows(mat, cent).to(torch.int32)

    return kern


def _pair_d2(mat, cent, c2=None):
    """Squared L2 distance matrix [rows, nlist] in matmul form. NaN
    (NULL) rows produce NaN everywhere; callers gate them with the
    valid mask."""
    m2 = (mat * mat).sum(1)[:, None]
    if c2 is None:
        c2 = (cent * cent).sum(1)[None, :]
    return m2 - 2.0 * (mat @ cent.T) + c2


def patch_rows(buf, upd, off: int):
    """The 2-D tail patch: a copy of `buf` with rows [off, off+len(upd))
    replaced (the old buffer is never written: a statement still
    reading it keeps its snapshot)."""
    nb = buf.clone()
    nb[off:off + upd.shape[0]] = upd
    return nb


# ---- host twins --------------------------------------------------------

def host_distances(mat, q, metric):
    """The numpy twin of the device distance computation (float32, same
    matmul form)."""
    return _distances_xp(np, np.asarray(mat, dtype=np.float32),
                         np.asarray(q, dtype=np.float32), metric)


def host_topk(mat, valid, q, metric, k):
    """Full host ranking with the shared selection key; ties broken by
    row index (stable sort) exactly like select_topk. -> positions of
    the k best live rows (may be shorter than k)."""
    with np.errstate(invalid="ignore", divide="ignore"):
        d = host_distances(mat, q, metric)
        key = _select_key_xp(np, d, np.asarray(valid, dtype=bool))
    order = np.argsort(-key, kind="stable")[:k]
    return order[key[order] > -np.inf]


def host_kmeans(mat, valid, cent, iters):
    """Numpy Lloyd twin of build_kmeans_step (the vector/train host
    fallback)."""
    mat = mat.astype(np.float32)
    v = np.asarray(valid, dtype=bool)
    for _ in range(iters):
        with np.errstate(invalid="ignore"):
            a = np.argmin(_pair_d2_np(mat, cent), axis=1)
        a = np.where(v, a, -1)
        sums = np.zeros_like(cent)
        cnts = np.zeros(len(cent), dtype=np.float32)
        live = a >= 0
        np.add.at(sums, a[live], mat[live])
        np.add.at(cnts, a[live], 1.0)
        cent = np.where(cnts[:, None] > 0,
                        sums / np.maximum(cnts, 1.0)[:, None], cent)
    return cent


def host_assign(mat, cent):
    with np.errstate(invalid="ignore"):
        return np.argmin(_pair_d2_np(mat.astype(np.float32), cent),
                         axis=1).astype(np.int32)


def _pair_d2_np(mat, cent):
    m2 = (mat * mat).sum(axis=1)[:, None]
    c2 = (cent * cent).sum(axis=1)[None, :]
    return m2 - 2.0 * (mat @ cent.T) + c2

"""ML smoke: the in-SQL inference + hybrid retrieval gate (reference
scripts/ml_smoke.py, docs/ML.md).

On a clustered VECTOR corpus with a scalar attribute column and an
MLP model registered through CREATE MODEL, the gate holds five
properties:

  1. FILTERED RECALL — hybrid queries (scalar predicate + ORDER BY
     distance LIMIT k) at 0.1%, 1% and 10% predicate selectivity:
     the exact hybrid path returns rows identical to the masked
     float64 host oracle (on the CPU also under injected grant loss at
     the vector dispatch site; on the card the injected statement
     fails with a clean 9013 and the cleared one returns the oracle's
     rows), and the IVF hybrid path — predicate mask applied BEFORE
     top-k, with selectivity-widened probing — holds recall@10 >= 0.95
     averaged over ML_SMOKE_QUERIES queries per selectivity level.
  2. WARM HYBRID BUDGET — a repeated hybrid search costs <= 2 device
     dispatches, <= 1 host sync, and ZERO upload bytes (the
     filter-fingerprinted validity mask and the corpus are both
     residency-pool hits).
  3. WARM PREDICT BUDGET — a repeated standalone SELECT predict()
     over the full table costs <= 2 dispatches / <= 1 sync / 0 upload
     bytes (features AND weights resident), and the batched forward
     is >= 10x the row-at-a-time point-query loop in rows/s.
  4. CHAOS, NON-VACUOUS — on the CPU grant loss injected at
     device_guard/ml/predict degrades predict to the numpy twin with
     values identical to the clean run, and both fallback counters
     (ml_predict_total{outcome="host_fallback"},
     vector_search_total{path="host_fallback"}) actually moved. The
     card has no host twin: there each injected statement fails with a
     clean 9013 naming its site (no open txn, no lock left), the cleared
     statement returns the clean values, and both sites were reached.
  5. COMPUTED COLUMN DELTA — an OLTP write stream against a table
     whose VECTOR column is GENERATED ALWAYS AS (embed(model, txt))
     folds into the IVF index through the delta path
     (vector_index_delta_total{outcome="applied"} > 0, rebuild == 0
     at quiesce) and freshly committed rows are immediately
     retrievable.

The vector and ML device paths are forced (TIDB_TPU_VECTOR_DEVICE=1,
TIDB_TPU_ML_DEVICE=1) for the run: the gate holds the residency and
dispatch budgets, which the numpy twins would trivially satisfy.

Usage:  python -m tidb_tpu_torch.tools.ml_smoke [--cpu] [--quick]
Env:    ML_SMOKE_ROWS (20000; --quick 6000), ML_SMOKE_DIM (32),
        ML_SMOKE_QUERIES (20), ML_SMOKE_RECALL (0.95),
        ML_SMOKE_PREDICT_RATIO (10)
Exit:   0 all gates pass; 1 otherwise.
"""
from __future__ import annotations

import os
import sys
import tempfile
import time
import zlib

import numpy as np

from .gates import card_fault, device_of

FORCE = {"TIDB_TPU_VECTOR_DEVICE": "1", "TIDB_TPU_ML_DEVICE": "1"}


def _vec_text(v):
    return "[" + ",".join(f"{x:.4f}" for x in v.tolist()) + "]"


# the three acceptance selectivities over a grp column spread 0..999
LEVELS = (("0.1%", "grp = 7", lambda g: g == 7),
          ("1%", "grp < 10", lambda g: g < 10),
          ("10%", "grp < 100", lambda g: g < 100))


def run(device="cuda", quick=False, out=sys.stderr, report=None, tk=None):
    """-> list of failure strings. report, when a dict, receives the
    measured figures. tk: an empty TestKit to run in (else one is made
    on `device`); the card's branches follow its copr's
    degrade_to_host."""
    saved = {k: os.environ.get(k) for k in FORCE}
    os.environ.update(FORCE)
    try:
        with tempfile.TemporaryDirectory(prefix="ml_smoke_") as mdir:
            return _run(device, quick, out, report, tk, mdir)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _run(device, quick, out, report, tk, mdir):
    """run()'s body; mdir holds the models' weight files."""
    rows = int(os.environ.get("ML_SMOKE_ROWS",
                              "6000" if quick else "20000"))
    dim = int(os.environ.get("ML_SMOKE_DIM", "32"))
    nq = int(os.environ.get("ML_SMOKE_QUERIES", "20"))
    recall_floor = float(os.environ.get("ML_SMOKE_RECALL", "0.95"))
    pred_ratio = float(os.environ.get("ML_SMOKE_PREDICT_RATIO", "10"))

    from tidb_tpu_torch.testkit import TestKit
    from tidb_tpu_torch.ml.kernels import host_forward
    from tidb_tpu_torch.utils import failpoint, phase
    from tidb_tpu_torch.utils import metrics as mu

    failures = []
    tk = tk or TestKit(device=device)
    card = not tk.domain.copr.degrade_to_host
    rng = np.random.RandomState(42)
    reached = {"vector/topk": 0, "ml/predict": 0}

    # ---- corpus: clustered vectors + a 0..999 attribute ----------------
    tk.must_exec("create table corpus (id bigint primary key, "
                 f"grp bigint, e vector({dim}))")
    ncent = 128
    centers = rng.randn(ncent, dim).astype(np.float32) * 4.0
    assign = rng.randint(0, ncent, rows)
    mat = (centers[assign] +
           rng.randn(rows, dim).astype(np.float32) * 0.35)
    texts = np.array([_vec_text(mat[i]) for i in range(rows)],
                     dtype=object)
    grp = (np.arange(rows, dtype=np.int64) * 7919) % 1000
    tbl = tk.domain.infoschema().table_by_name("test", "corpus")
    ctab = tk.domain.columnar.table(tbl)
    ctab.bulk_append({"id": np.arange(rows, dtype=np.int64),
                      "grp": grp, "e": texts}, rows,
                     handles=np.arange(1, rows + 1, dtype=np.int64))
    stored = np.array([np.array(t[1:-1].split(","), dtype=np.float64)
                       for t in texts], dtype=np.float32)
    print(f"# ml_smoke: rows={rows} dim={dim} queries={nq} "
          f"device={tk.domain.copr.device}", file=out)

    queries = (mat[rng.randint(0, rows, nq)] +
               rng.randn(nq, dim).astype(np.float32) * 0.15)

    def oracle(q, mask, k=10):
        d = np.linalg.norm(
            stored.astype(np.float64) - q.astype(np.float64), axis=1)
        d = np.where(mask, d, np.inf)
        return [int(i) for i in np.argsort(d, kind="stable")[:k]
                if d[i] < np.inf]

    def sql_for(q, pred, k=10):
        return (f"select id from corpus where {pred} order by "
                f"vec_l2_distance(e, '{_vec_text(q)}') limit {k}")

    def chaos_of(sql, site):
        """The injected run's rows (CPU: the numpy twin's), or on the
        card the cleared rerun's after a clean 9013."""
        if card:
            hit, bad = card_fault(tk, sql, site)
            reached[site] += hit
            if bad:
                failures.append(bad)
            return tk.must_query(sql).rows
        failpoint.enable("device_guard/" + site, "error:grant_lost")
        try:
            return tk.must_query(sql).rows
        finally:
            failpoint.disable_all()

    # ---- 1a. exact hybrid == masked oracle, with and without chaos ----
    mism = 0
    for lbl, pred, maskfn in LEVELS:
        mask = maskfn(grp)
        for i in range(min(nq, 5)):
            want = oracle(queries[i], mask)
            clean = [r[0] for r in tk.must_query(
                sql_for(queries[i], pred)).rows]
            if clean != want:
                mism += 1
            chaos = [r[0] for r in chaos_of(sql_for(queries[i], pred),
                                            "vector/topk")]
            if chaos != want:
                mism += 1
    if mism:
        failures.append(f"exact hybrid parity: {mism} mismatched runs")

    # ---- 2. warm hybrid budget ----------------------------------------
    tk.must_query(sql_for(queries[0], "grp < 100"))
    phase.reset()
    tk.must_query(sql_for(queries[0], "grp < 100"))
    hyb = phase.snap()
    if hyb.get("dispatches", 0) > 2 or hyb.get("syncs", 0) > 1:
        failures.append(f"hybrid dispatch budget blown: {hyb}")
    if hyb.get("upload_bytes", 0) > 0:
        failures.append(
            f"warm hybrid re-uploaded {hyb['upload_bytes']} B")

    # ---- 1b. IVF hybrid recall per selectivity level ------------------
    tk.must_exec("create vector index vidx on corpus (e) using ivf")
    tk.must_query(sql_for(queries[0], "grp < 100"))    # train
    recalls = {}
    for lbl, pred, maskfn in LEVELS:
        mask = maskfn(grp)
        hits = total = 0
        for i in range(nq):
            want = oracle(queries[i], mask)
            got = [r[0] for r in tk.must_query(
                sql_for(queries[i], pred)).rows]
            if any(not mask[g] for g in got):
                failures.append(
                    f"{lbl}: row violating the predicate surfaced")
                break
            hits += len(set(want) & set(got))
            total += len(want)
        recalls[lbl] = hits / max(total, 1)
        if recalls[lbl] < recall_floor:
            failures.append(f"filtered recall@10 at {lbl} "
                            f"{recalls[lbl]:.3f} < {recall_floor}")

    # ---- 3. predict: warm budget + batched vs row-at-a-time -----------
    nf = 4
    W0 = rng.randn(nf, 16).astype(np.float32)
    b0 = rng.randn(16).astype(np.float32)
    W1 = rng.randn(16, 1).astype(np.float32)
    b1 = rng.randn(1).astype(np.float32)
    npz = os.path.join(mdir, "m.npz")
    np.savez(npz, W0=W0, b0=b0, W1=W1, b1=b1)
    tk.must_exec(f"create model scorer from '{npz}'")
    tk.must_exec("create table feat (id bigint primary key, "
                 "a double, b double, c double, d double)")
    F = rng.randn(rows, nf).astype(np.float64)
    ftbl = tk.domain.infoschema().table_by_name("test", "feat")
    fctab = tk.domain.columnar.table(ftbl)
    fctab.bulk_append(
        {"id": np.arange(rows, dtype=np.int64),
         "a": F[:, 0], "b": F[:, 1], "c": F[:, 2], "d": F[:, 3]},
        rows, handles=np.arange(1, rows + 1, dtype=np.int64))
    psql = "select id, predict(scorer, a, b, c, d) from feat"
    got = tk.must_query(psql).rows
    want = host_forward(F.astype(np.float32), [W0, W1], [b0, b1])
    err = max(abs(float(r[1]) - float(want[i]))
              for i, r in enumerate(got))
    if err > 1e-3:
        failures.append(f"predict batched vs host twin: max err {err}")
    phase.reset()
    tk.must_query(psql)
    prd = phase.snap()
    if prd.get("dispatches", 0) > 2 or prd.get("syncs", 0) > 1:
        failures.append(f"predict dispatch budget blown: {prd}")
    if prd.get("upload_bytes", 0) > 0:
        failures.append(
            f"warm predict re-uploaded {prd['upload_bytes']} B")

    t0 = time.perf_counter()
    tk.must_query(psql)
    batched_rps = rows / (time.perf_counter() - t0)
    npoint = 50 if quick else 100
    tk.must_query("select predict(scorer, a, b, c, d) from feat "
                  "where id = 0")              # warm the point path
    t0 = time.perf_counter()
    for i in range(npoint):
        tk.must_query("select predict(scorer, a, b, c, d) from feat "
                      f"where id = {i}")
    point_rps = npoint / (time.perf_counter() - t0)
    if batched_rps < pred_ratio * point_rps:
        failures.append(
            f"batched predict {batched_rps:.0f} rows/s < "
            f"{pred_ratio}x row-at-a-time ({point_rps:.0f})")

    # ---- 4. predict chaos, non-vacuous --------------------------------
    chaos_rows = chaos_of(psql, "ml/predict")
    cerr = max(abs(float(a[1]) - float(b[1]))
               for a, b in zip(got, chaos_rows))
    if cerr > 1e-5:
        failures.append(f"predict chaos parity: max err {cerr}")
    if card:
        for site, n in reached.items():
            if n == 0:
                failures.append(f"{site} chaos never reached the site "
                                "(vacuous)")
    else:
        if mu.ML_PREDICT.labels("host_fallback").value == 0:
            failures.append("ml/predict chaos never degraded (vacuous)")
        if mu.VECTOR_SEARCH.labels("host_fallback").value + \
                mu.VECTOR_SEARCH.labels("hybrid_host_fallback").value == 0:
            failures.append("vector chaos never degraded (vacuous)")

    # ---- 5. computed VECTOR column: delta folds, zero rebuilds --------
    vocab = 64
    etbl = rng.randn(vocab, 8).astype(np.float32)
    enpz = os.path.join(mdir, "e.npz")
    np.savez(enpz, table=etbl)
    tk.must_exec(f"create model emb from '{enpz}'")
    tk.must_exec(
        "create table docs (id bigint primary key, txt varchar(64), "
        "v vector(8) generated always as (embed(emb, txt)) stored)")
    words = [f"w{j}" for j in range(40)]
    used = {zlib.crc32(w.encode()) % vocab for w in words}
    # a write-stream word whose embedding row no base word shares, so
    # fresh rows are at distance 0 from the probe and base rows are not
    fresh = next(f"fresh{j}" for j in range(10000)
                 if zlib.crc32(f"fresh{j}".encode()) % vocab not in used)
    base_docs = 400 if quick else 1000
    for off in range(0, base_docs, 200):
        tk.must_exec("insert into docs (id, txt) values " + ",".join(
            f"({i}, '{words[i % 40]}')"
            for i in range(off, min(off + 200, base_docs))))
    tk.must_exec("create vector index dvi on docs (v) using ivf "
                 "lists = 8")
    ann = ("select id from docs order by "
           f"vec_l2_distance(v, embed(emb, '{fresh}')) limit 5")
    tk.must_query(ann)                      # train the index
    applied0 = mu.VECTOR_INDEX_DELTA.labels("applied").value
    rebuild0 = mu.VECTOR_INDEX_DELTA.labels("rebuild").value
    nwrites = 10 if quick else 25
    for b in range(nwrites):
        bid = base_docs + b * 4
        tk.must_exec("insert into docs (id, txt) values " + ",".join(
            f"({bid + j}, '{fresh}')" for j in range(4)))
        got5 = tk.must_query(ann).rows
        if not any(r[0] >= base_docs for r in got5):
            failures.append(
                f"doc write batch {b}: fresh embeds not retrievable")
            break
    applied = mu.VECTOR_INDEX_DELTA.labels("applied").value - applied0
    rebuilds = mu.VECTOR_INDEX_DELTA.labels("rebuild").value - rebuild0
    if applied <= 0:
        failures.append("computed-column writes never took the delta "
                        "path")
    if rebuilds != 0:
        failures.append(f"{rebuilds} index rebuild(s) on computed-"
                        "column writes")

    rstr = " ".join(f"{lbl}={recalls.get(lbl, 0):.3f}"
                    for lbl, _, _ in LEVELS)
    ratio = batched_rps / max(point_rps, 1e-9)
    print(f"# filtered recall@10 {rstr}; hybrid warm {hyb}; predict "
          f"warm {prd}; batched {batched_rps:.0f} rows/s vs point "
          f"{point_rps:.0f} q/s ({ratio:.0f}x); delta applied="
          f"{applied:.0f} rebuilds={rebuilds:.0f}", file=out)
    if report is not None:
        report.update(rows=rows, recalls=recalls, hybrid_warm=hyb,
                      predict_warm=prd, batched_rps=batched_rps,
                      point_rps=point_rps, ratio=ratio,
                      delta_applied=applied, rebuilds=rebuilds,
                      fault_reached=dict(reached) if card else None)
    return failures


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    os.environ.setdefault("TIDB_TPU_LOCKRANK", "1")   # sanitizer armed
    os.environ.setdefault("TIDB_TPU_MUTATION_CHECK", "0")
    device = device_of(argv)
    rep = {}
    failures = run(device=device, quick="--quick" in argv, report=rep)
    if failures:
        print("ML SMOKE FAILED:", file=sys.stderr)
        for f in failures:
            print(f"  {f}", file=sys.stderr)
        return 1
    how = "hybrid==oracle under chaos" if device == "cpu" else \
        "hybrid==oracle, clean 9013 under chaos and rows back once cleared"
    rstr = " ".join(f"{k}={v:.3f}" for k, v in rep["recalls"].items())
    print(f"ML SMOKE OK: {how} at "
          f"{'/'.join(lbl for lbl, _, _ in LEVELS)} selectivity "
          f"(recall {rstr}), warm hybrid "
          f"{rep['hybrid_warm'].get('dispatches', 0)} dispatch/0 upload, "
          f"warm predict {rep['predict_warm'].get('dispatches', 0)} "
          f"dispatch/0 upload at {rep['ratio']:.0f}x row-at-a-time, "
          f"{rep['delta_applied']:.0f} computed-column delta folds, "
          "0 rebuilds", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

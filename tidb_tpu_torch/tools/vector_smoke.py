"""Vector smoke: the vector search gate (reference
scripts/vector_smoke.py, docs/VECTOR.md).

On a >= 50k-row VECTOR corpus (clustered embeddings — a mixture of
gaussians, the shape real embedding spaces have) the gate holds five
properties:

  1. EXACT == HOST UNDER CHAOS — the exact device top-k (one matmul +
     top-k program) returns the float64 host oracle's rows. With grant
     loss injected at the vector dispatch site (device_guard/vector/topk)
     on every query, the CPU degrades to the numpy twin with identical
     rows, as the reference does. The card has no host twin: there the
     statement must fail with a clean 9013 naming the site (no open
     txn, no lock left), the same session must return the clean rows
     once the failpoint is cleared, and the anti-vacuity check is that
     the injected site was reached.
  2. SINGLE-DISPATCH CONTRACT — a warm exact search costs <= 2 device
     dispatches and <= 1 host sync by phase counters, with zero upload
     bytes over the unchanged corpus.
  3. IVF RECALL — recall@10 of the ANN path vs the exact float64 host
     scan averaged over VECTOR_SMOKE_QUERIES queries >= 0.95 at the
     default nprobe.
  4. ANN SPEED — IVF searches/s >= 10x the exact-scan searches/s,
     measured at the runtime seam (the entry the executor calls, so
     per-statement parse/plan cost doesn't mask the engine ratio).
  5. DELTA MAINTENANCE — an OLTP write stream folds into the index
     through the capture-seam delta path with ZERO full rebuilds
     (vector_index_delta_total{outcome="applied"} > 0, rebuild == 0 at
     quiesce) and freshly committed vectors are immediately searchable.

Usage:  python -m tidb_tpu_torch.tools.vector_smoke [--cpu] [--quick]
Env:    VECTOR_SMOKE_ROWS (50000; --quick 8000), VECTOR_SMOKE_DIM (32),
        VECTOR_SMOKE_QUERIES (50), VECTOR_SMOKE_QPS_RATIO (10),
        VECTOR_SMOKE_RECALL (0.95)
Exit:   0 all gates pass; 1 otherwise.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

from .gates import card_fault, device_of


def _vec_text(v):
    return "[" + ",".join(f"{x:.4f}" for x in v.tolist()) + "]"


def run(device="cuda", quick=False, out=sys.stderr, report=None, tk=None):
    """-> list of failure strings. report, when a dict, receives the
    measured figures. tk: an empty TestKit to run in (else one is made
    on `device`); the card's branches follow its copr's
    degrade_to_host."""
    rows = int(os.environ.get("VECTOR_SMOKE_ROWS",
                              "8000" if quick else "50000"))
    dim = int(os.environ.get("VECTOR_SMOKE_DIM", "32"))
    nq = int(os.environ.get("VECTOR_SMOKE_QUERIES", "50"))
    qps_ratio = float(os.environ.get("VECTOR_SMOKE_QPS_RATIO", "10"))
    recall_floor = float(os.environ.get("VECTOR_SMOKE_RECALL", "0.95"))

    from tidb_tpu_torch.testkit import TestKit
    from tidb_tpu_torch.utils import failpoint, phase
    from tidb_tpu_torch.utils import metrics as mu

    failures = []
    tk = tk or TestKit(device=device)
    card = not tk.domain.copr.degrade_to_host
    tk.must_exec("create table corpus (id bigint primary key, "
                 f"e vector({dim}))")

    # clustered corpus: 256 centers, tight clusters (embedding-shaped)
    rng = np.random.RandomState(42)
    ncent = 256
    centers = rng.randn(ncent, dim).astype(np.float32) * 4.0
    assign = rng.randint(0, ncent, rows)
    mat = (centers[assign] +
           rng.randn(rows, dim).astype(np.float32) * 0.35)
    texts = np.array([_vec_text(mat[i]) for i in range(rows)],
                     dtype=object)
    # direct columnar ingest (the lightning/IMPORT INTO path): the
    # vector engine serves from the columnar store, so a 50k corpus
    # need not pay 50k row-KV writes to exercise it
    tbl = tk.domain.infoschema().table_by_name("test", "corpus")
    ctab = tk.domain.columnar.table(tbl)
    ctab.bulk_append({"id": np.arange(rows, dtype=np.int64),
                      "e": texts}, rows,
                     handles=np.arange(1, rows + 1, dtype=np.int64))
    # re-read the stored float32 form for the oracle
    stored = np.array([np.array(t[1:-1].split(","), dtype=np.float64)
                       for t in texts], dtype=np.float32)
    print(f"# vector_smoke: rows={rows} dim={dim} queries={nq} "
          f"device={tk.domain.copr.device}", file=out)

    queries = (mat[rng.randint(0, rows, nq)] +
               rng.randn(nq, dim).astype(np.float32) * 0.15)

    def oracle(q, k=10):
        d = np.linalg.norm(stored.astype(np.float64) - q.astype(
            np.float64), axis=1)
        return list(np.argsort(d, kind="stable")[:k])

    def sql_for(q, k=10):
        return ("select id from corpus order by "
                f"vec_l2_distance(e, '{_vec_text(q)}') limit {k}")

    # ---- 1. exact == host, with and without chaos ---------------------
    mism = reached = 0
    for i in range(min(nq, 10)):
        clean = tk.must_query(sql_for(queries[i])).rows
        if [r[0] for r in clean] != oracle(queries[i]):
            mism += 1
        if card:
            hit, bad = card_fault(tk, sql_for(queries[i]), "vector/topk")
            reached += hit
            if bad:
                failures.append(f"query {i}: {bad}")
            if tk.must_query(sql_for(queries[i])).rows != clean:
                mism += 1
            continue
        failpoint.enable("device_guard/vector/topk", "error:grant_lost")
        try:
            chaos = tk.must_query(sql_for(queries[i])).rows
        finally:
            failpoint.disable_all()
        if chaos != clean:
            mism += 1
    if mism:
        failures.append(f"exact/chaos parity: {mism} mismatched runs")
    if card:
        if reached == 0:
            failures.append("chaos injection never reached "
                            "device_guard/vector/topk (vacuous)")
    elif mu.VECTOR_SEARCH.labels("host_fallback").value == 0:
        failures.append("chaos injection never degraded (vacuous)")

    # ---- 2. single-dispatch contract ----------------------------------
    tk.must_query(sql_for(queries[0]))
    phase.reset()
    tk.must_query(sql_for(queries[0]))
    s = phase.snap()
    if s.get("dispatches", 0) > 2 or s.get("syncs", 0) > 1:
        failures.append(f"dispatch budget blown: {s}")
    if s.get("upload_bytes", 0) > 0:
        failures.append(
            f"warm exact search re-uploaded {s['upload_bytes']} B")

    # ---- 3 + 4. IVF recall and speed ----------------------------------
    tk.must_exec("create vector index vidx on corpus (e) using ivf")
    rt = tk.domain.vector
    copr = tk.domain.copr
    from tidb_tpu_torch.executor.exec_base import ExecContext
    ectx = ExecContext(tk.sess)
    tbl = tk.domain.infoschema().table_by_name("test", "corpus")
    ci = tbl.find_column("e")
    idx = rt.index_for(tbl, "e")
    # warm both seams (train + residency + kernels)
    rt.ivf_topk(copr, ctab, idx, "vec_l2_distance", queries[0], 10,
                None, ectx=ectx)
    rt.exact_topk(copr, ctab, ci.id, dim, "vec_l2_distance",
                  queries[0], 10, None, ectx=ectx)

    hits = total = 0
    for i in range(nq):
        cand = rt.ivf_topk(copr, ctab, idx, "vec_l2_distance",
                           queries[i], 10, None, ectx=ectx)[:10]
        want = set(oracle(queries[i]))
        hits += len(want & set(np.asarray(cand).tolist()))
        total += len(want)
    recall = hits / max(total, 1)
    if recall < recall_floor:
        failures.append(f"recall@10 {recall:.3f} < {recall_floor}")

    # interleaved best-of-rounds: background load must hit both paths
    # alike, not whichever ran second
    exact_qps = ivf_qps = 0.0
    reps = max(nq * 2, 100)
    for _round in range(3):
        t0 = time.perf_counter()
        for i in range(nq):
            rt.exact_topk(copr, ctab, ci.id, dim, "vec_l2_distance",
                          queries[i % nq], 10, None, ectx=ectx)
        exact_qps = max(exact_qps, nq / (time.perf_counter() - t0))
        t0 = time.perf_counter()
        for i in range(reps):
            rt.ivf_topk(copr, ctab, idx, "vec_l2_distance",
                        queries[i % nq], 10, None, ectx=ectx)
        ivf_qps = max(ivf_qps, reps / (time.perf_counter() - t0))
    if ivf_qps < qps_ratio * exact_qps:
        failures.append(f"ANN qps {ivf_qps:.0f} < {qps_ratio}x exact "
                        f"({exact_qps:.0f})")

    # ---- 5. delta maintenance under an OLTP write stream --------------
    applied0 = mu.VECTOR_INDEX_DELTA.labels("applied").value
    nwrites = 40 if quick else 100
    base = rows + 10
    for b in range(nwrites):
        probe = centers[b % ncent] + \
            rng.randn(dim).astype(np.float32) * 0.05
        vals = ",".join(
            f"({base + b * 8 + j}, "
            f"'{_vec_text(probe + rng.randn(dim).astype(np.float32) * 0.01)}')"
            for j in range(8))
        tk.must_exec("insert into corpus values " + vals)
        if b % 10 == 0:
            got = tk.must_query(sql_for(probe, 3)).rows
            if not any(r[0] >= base for r in got):
                failures.append(
                    f"write batch {b}: fresh vectors not searchable")
                break
    applied = mu.VECTOR_INDEX_DELTA.labels("applied").value - applied0
    rebuilds = mu.VECTOR_INDEX_DELTA.labels("rebuild").value
    if applied <= 0:
        failures.append("write stream never took the delta path")
    if rebuilds != 0:
        failures.append(f"{rebuilds} full index rebuild(s) on writes")

    stats = tk.must_query(
        "select centroids, rows, pending_delta_rows from "
        "information_schema.tidb_vector_indexes").rows
    ratio = ivf_qps / max(exact_qps, 1e-9)
    print(f"# recall@10={recall:.3f} exact_qps={exact_qps:.0f} "
          f"ivf_qps={ivf_qps:.0f} ({ratio:.1f}x) "
          f"delta_applied={applied:.0f} rebuilds={rebuilds:.0f} "
          f"index={stats}", file=out)
    if report is not None:
        report.update(rows=rows, recall=recall, exact_qps=exact_qps,
                      ivf_qps=ivf_qps, ratio=ratio, warm=s,
                      delta_applied=applied, rebuilds=rebuilds,
                      fault_reached=reached if card else None)
    return failures


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    os.environ.setdefault("TIDB_TPU_LOCKRANK", "1")   # sanitizer armed
    os.environ.setdefault("TIDB_TPU_MUTATION_CHECK", "0")
    device = device_of(argv)
    rep = {}
    failures = run(device=device, quick="--quick" in argv, report=rep)
    if failures:
        print("VECTOR SMOKE FAILED:", file=sys.stderr)
        for f in failures:
            print(f"  {f}", file=sys.stderr)
        return 1
    how = "exact==host under chaos" if device == "cpu" else \
        "exact==host, clean 9013 under chaos and rows back once cleared"
    w = rep["warm"]
    print(f"VECTOR SMOKE OK: {how}, warm search at "
          f"{w.get('dispatches', 0)} dispatch/{w.get('syncs', 0)} sync, "
          f"recall@10 {rep['recall']:.3f}, ANN {rep['ratio']:.1f}x "
          f"exact, {rep['delta_applied']:.0f} delta folds, 0 rebuilds",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

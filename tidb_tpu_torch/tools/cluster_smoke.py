"""Cluster fault-tolerance gate (reference scripts/cluster_smoke.py;
docs/ROBUSTNESS.md "Cluster fault tolerance"). Every worker, the
replacements that supervision spawns included, and the coordinator's
own Domain run on the device the command line names: the card by
default (all workers on one card), the host with --cpu.

Sustained commit load (4 writer threads, round-robin over the workers)
plus a distributed aggregation reader, crossed with:

  * every registered network fault seam (utils/failpoint_sites.NET_SITES
    + cluster/rpc), prob-gated in the coordinator process — drop, reply
    loss, duplicate frames, peer-close mid-frame, trickle;
  * kill -9 of a worker mid-phase with heartbeat supervision engaged
    (suspect -> down -> fenced failover, epoch bump, follower-log
    promotion);
  * a partition phase: a live primary is declared down, and the deposed
    zombie must NEVER ack a write (stale-epoch fence), then rejoin as a
    demoted follower.

Asserts, ledger-checked at the end:
  * ZERO acked-commit loss — every key a writer saw acked is present in
    the cluster;
  * ZERO double-applies — no duplicate-key error ever surfaced (a
    retried insert that re-executed would collide with itself) and no
    key appears twice cluster-wide (per-worker count == distinct);
  * every distributed query either succeeds or fails with a CLEAN
    retryable error (transport / stale-epoch class), never an internal
    error or a wedge;
  * dedup hits actually observed (anti-vacuity for the reply-loss seam);
  * the coordinator never wedges (per-phase watchdog).

Usage: python -m tidb_tpu_torch.tools.cluster_smoke [--cpu] [--quick]
       [seconds-per-phase]   (6; --quick 1.5)
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

from .gates import device_of

# the checkout's root: the workers import the package from it
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# per-seam action specs: prob-gated so load keeps flowing THROUGH the
# faults (a deterministic every-hit fault would just starve the phase)
FAULT_SPECS = {
    "cluster/net/send": "prob:0.12->error:conn_reset",
    "cluster/net/recv": "prob:0.10->error:conn_reset",
    "cluster/net/dup": "prob:0.15->error",
    "cluster/net/partial-close": "prob:0.06->error",
    "cluster/net/trickle": "prob:0.05->error",
    "cluster/rpc": "prob:0.08->error:conn_reset",
}

PHASE_WATCHDOG_S = 60.0


def run(device="cuda", phase_s: float = 6.0, verbose: bool = True,
        out=sys.stderr) -> dict:
    """-> the run's figures, with its failures under "violations"."""
    from tidb_tpu_torch.cluster import Cluster
    from tidb_tpu_torch.cluster.coordinator import _WorkerClient
    from tidb_tpu_torch.cluster.rpc import ClusterTransportError
    from tidb_tpu_torch.errors import ClusterEpochStaleError
    from tidb_tpu_torch.utils import failpoint
    from tidb_tpu_torch.utils import metrics as _metrics
    from tidb_tpu_torch.utils.failpoint_sites import NET_SITES

    def say(msg):
        if verbose:
            print(f"# {msg}", file=out, flush=True)

    from tidb_tpu_torch.utils.torchcfg import resolve_device
    resolve_device(device)      # no card: fail here, not in a worker
    env = dict(os.environ,
               PYTHONPATH=REPO + os.pathsep + os.environ.get(
                   "PYTHONPATH", ""))
    procs = []
    worker_argv = [sys.executable, "-m", "tidb_tpu_torch.cluster.worker",
                   "0"] + (["--cpu"] if device == "cpu" else [])

    def spawn():
        p = subprocess.Popen(
            worker_argv,
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            env=env, cwd=REPO, text=True)
        line = p.stdout.readline().strip()
        assert line.startswith("WORKER_READY"), line
        p._tidb_port = int(line.split()[1])
        procs.append(p)
        return p._tidb_port

    ports = [spawn(), spawn(), spawn()]
    cl = Cluster(ports, spawn_worker=spawn, device=device)
    cl.enable_replication()
    cl.ddl("create table smoke (a int primary key, b int)")
    mon = cl.start_supervision(interval_s=0.25, suspect_after_s=0.6,
                               down_after_s=1.5)

    mu = threading.Lock()
    acked: set = set()
    violations: list = []
    clean_write_fails = [0]
    q_ok = [0]
    q_fail = [0]
    seq = [0]
    stop_ev = threading.Event()
    CLEAN = (ClusterTransportError, ClusterEpochStaleError,
             ConnectionError, TimeoutError, OSError)

    def writer(tid):
        while not stop_ev.is_set():
            with mu:
                seq[0] += 1
                k = seq[0]
            w = cl.workers[k % len(cl.workers)]
            try:
                w.call({"op": "load_sql",
                        "sqls": [f"insert into smoke values "
                                 f"({k}, {tid})"]})
            except CLEAN:
                clean_write_fails[0] += 1
                continue            # un-acked: the key is burned,
                #                     never reused — no durability claim
            except RuntimeError as e:
                if "Duplicate" in str(e):
                    # the ONE way a double-apply can manifest on a pk
                    # insert: a retried request that re-executed
                    # collides with its own first application
                    violations.append(
                        f"DOUBLE-APPLY key {k}: {e}")
                clean_write_fails[0] += 1
                continue
            except Exception as e:      # noqa: BLE001
                violations.append(
                    f"dirty writer error ({type(e).__name__}): {e}")
                continue
            with mu:
                acked.add(k)

    def reader():
        while not stop_ev.is_set():
            try:
                rows = cl.query_agg(
                    "select count(*), sum(b) from smoke")
                assert rows
                q_ok[0] += 1
            except CLEAN:
                q_fail[0] += 1      # clean retryable: allowed
            except RuntimeError:
                q_fail[0] += 1      # worker-side error string (clean
                #                     statement error, not a wedge)
            except Exception as e:      # noqa: BLE001
                violations.append(
                    f"dirty query error ({type(e).__name__}): {e}")
            time.sleep(0.05)

    threads = [threading.Thread(target=writer, args=(i,), daemon=True)
               for i in range(4)]
    threads.append(threading.Thread(target=reader, daemon=True))
    for t in threads:
        t.start()

    def wait_stable(deadline_s):
        """All slots answer pings at the current epoch."""
        end = time.time() + deadline_s
        while time.time() < end:
            try:
                oks = 0
                for w in list(cl.workers):
                    out, _ = w.call({"op": "ping"}, retries=1,
                                    deadline_s=5)
                    if out.get("epoch") == cl.epoch \
                            and not out.get("fenced"):
                        oks += 1
                if oks == len(cl.workers):
                    return True
            except Exception:           # noqa: BLE001
                pass
            time.sleep(0.3)
        return False

    phases = []
    seam_list = list(NET_SITES) + ["cluster/rpc"]
    t_run0 = time.time()
    for si, site in enumerate(seam_list):
        say(f"phase {si + 1}/{len(seam_list)}: seam {site} "
            f"({FAULT_SPECS[site]}) + kill slot {si % 3}")
        t0 = time.time()
        a0, f0 = len(acked), mon.failovers
        failpoint.enable(site, FAULT_SPECS[site])
        try:
            time.sleep(phase_s / 2)
            victim_slot = si % 3
            vport = cl.workers[victim_slot].port
            vproc = next(p for p in procs
                         if p.poll() is None and p._tidb_port == vport)
            vproc.kill()
            vproc.wait(timeout=30)
            # failover must engage within the watchdog or the
            # coordinator counts as wedged
            end = time.time() + PHASE_WATCHDOG_S
            while mon.failovers == f0 and time.time() < end:
                time.sleep(0.1)
            if mon.failovers == f0:
                violations.append(
                    f"phase {site}: failover never engaged (wedged)")
            time.sleep(phase_s / 2)
        finally:
            failpoint.disable_all()
        if not wait_stable(PHASE_WATCHDOG_S):
            violations.append(
                f"phase {site}: cluster never re-stabilized (wedged)")
        phases.append({
            "seam": site, "seconds": round(time.time() - t0, 1),
            "acked": len(acked) - a0,
            "failovers": mon.failovers - f0, "epoch": cl.epoch})
        say(f"  acked +{len(acked) - a0}, failovers "
            f"+{mon.failovers - f0}, epoch {cl.epoch}, "
            f"queries ok={q_ok[0]} clean-fail={q_fail[0]}")

    # ---- partition phase: fenced zombie + stale-epoch write ------------
    say("partition phase: mark_down a live primary, probe the fence")
    old_port = cl.workers[0].port
    epoch0 = cl.epoch
    cl.mark_down(0)
    stale_write_refused = False
    try:
        zombie = _WorkerClient(old_port)
        try:
            zombie.call({"op": "load_sql",
                         "sqls": ["insert into smoke values "
                                  "(1000000000, -1)"]})
            violations.append(
                "STALE-EPOCH WRITE ACCEPTED by deposed primary")
        except (ClusterEpochStaleError, RuntimeError, CLEAN[0],
                ConnectionError, OSError):
            stale_write_refused = True
    except OSError:
        # could not even reach the zombie — fence trivially holds but
        # the probe is vacuous; record it
        violations.append("partition phase: zombie unreachable, "
                          "fence probe vacuous")
    # rejoin: the monitor demotes the zombie to slot 0's follower
    end = time.time() + PHASE_WATCHDOG_S
    while cl._follower_port.get(0) != old_port and time.time() < end:
        time.sleep(0.2)
    rejoined = cl._follower_port.get(0) == old_port
    if not rejoined:
        violations.append("partition phase: deposed primary never "
                          "rejoined as follower")
    assert cl.epoch > epoch0

    stop_ev.set()
    for t in threads:
        t.join(timeout=60)

    # ---- final ledger --------------------------------------------------
    say("ledger check")
    wait_stable(PHASE_WATCHDOG_S)
    have: set = set()
    per_worker_dupes = []
    for wi in range(len(cl.workers)):
        rows = cl.query(
            "select count(*), count(distinct a) from smoke", worker=wi)
        if rows[0][0] != rows[0][1]:
            per_worker_dupes.append((wi, rows[0]))
        have |= {r[0] for r in cl.query(
            "select a from smoke", worker=wi)}
    lost = sorted(acked - have)
    if lost:
        violations.append(
            f"ACKED-COMMIT LOSS: {len(lost)} keys, e.g. {lost[:10]}")
    if per_worker_dupes:
        violations.append(f"DOUBLE-APPLIED rows: {per_worker_dupes}")
    if 1000000000 in have:
        violations.append("stale-epoch write LANDED in the cluster")
    snap = _metrics.REGISTRY.snapshot()
    dedup_hits = sum(v for k, v in snap.items()
                     if k.startswith("tidb_tpu_cluster_rpc_dedup_total"))
    if dedup_hits == 0:
        violations.append("no dedup hits observed — the reply-loss "
                          "seam never exercised the window (vacuous)")
    if q_ok[0] == 0:
        violations.append("no distributed query ever succeeded")
    if len(acked) < 50:
        violations.append(f"write load too thin: {len(acked)} acked")

    res = {
        "device": device, "phase_s": phase_s,
        "seconds": round(time.time() - t_run0, 1),
        "phases": phases,
        "acked": len(acked), "lost": len(lost),
        "clean_write_fails": clean_write_fails[0],
        "queries_ok": q_ok[0], "queries_clean_fail": q_fail[0],
        "failovers": mon.failovers, "epoch": cl.epoch,
        "dedup_hits": int(dedup_hits),
        "stale_write_refused": bool(stale_write_refused),
        "rejoined_as_follower": bool(rejoined),
        "violations": violations,
    }

    cl.stop()
    for p in procs:
        if p.poll() is None:
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
    return res


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    os.environ.setdefault("TIDB_TPU_LOCKRANK", "1")   # sanitizer armed
    rest = [a for a in argv if not a.startswith("--")]
    phase_s = float(rest[0]) if rest else \
        (1.5 if "--quick" in argv else 6.0)
    out = run(device=device_of(argv), phase_s=phase_s)
    print(json.dumps(out, indent=1))
    if out["violations"]:
        print("CLUSTER SMOKE FAILED", file=sys.stderr)
        return 1
    print("CLUSTER SMOKE OK: "
          f"{out['acked']} acked / {out['lost']} lost, "
          f"{out['failovers']} failovers, "
          f"{out['dedup_hits']} dedup hits, "
          f"{out['queries_ok']} queries ok", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

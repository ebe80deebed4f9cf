"""Durable online-DDL job runner (reference pkg/ddl: the owner-driven
job framework — ddl_worker.go runJobStep + job_scheduler.go + the
rollback machinery in rollingback.go).

Every multi-step DDL (ADD INDEX, DROP INDEX, EXCHANGE PARTITION and
MODIFY COLUMN reorgs) is a persisted :class:`~tidb_tpu_torch.models.job.DDLJob`
in the meta namespace (meta/meta.py), WAL-framed like every other meta
row. Each F1 ladder transition commits the schema mutation AND the job
record in ONE storage transaction, so a kill -9 anywhere leaves a
resumable record instead of a stranded half-state index:

  * restart recovery (``resume_pending``, called by Domain after
    checkpoint+WAL replay) re-enters running jobs at the recorded
    ``schema_state`` — a WRITE_REORG backfill continues at the
    checkpointed handle range, not row 0 — and drives
    cancelling/rollingback jobs down the reverse ladder;
  * aborted or dropped indexes register a delete-range row in the SAME
    transaction that removes the index meta, and the delete-range queue
    is drained after every job (and at restart), so no orphaned index
    KV survives either outcome;
  * non-PUBLIC index states with no owning job (stores written before
    the framework existed) are swept into synthesized rollback jobs at
    restart.

The submitting session's thread doubles as the owner worker (the
in-process collapse of the reference's owner election): it campaigns
for the ``ddl-owner`` lease (owner/manager.py), drains the durable
queue FIFO, and resigns. ``ADMIN CANCEL DDL JOB`` flips the durable
record to ``cancelling``; the runner observes it transactionally at
every ladder step and backfill checkpoint and rolls back through
``rollingback`` rather than best-effort exception unwind — KILL of the
driving session takes the same path.

Backfill runs through the normal transactional write path (2PC with
conflict detection) in handle-ordered batches: a concurrent DML commit
that touches a batch's index keys surfaces as WriteConflict and the
batch retries with a fresh snapshot — a blind bulk ingest could
resurrect a stale entry the DML had just rewritten.
"""
from __future__ import annotations

import threading
import time

from ..meta import Mutator
from ..models import SchemaState, DDLJob
from ..models.job import (
    STATE_QUEUEING, STATE_RUNNING, STATE_CANCELLING, STATE_ROLLINGBACK,
    STATE_SYNCED, STATE_CANCELLED,
    TYPE_ADD_INDEX, TYPE_DROP_INDEX, TYPE_EXCHANGE_PARTITION,
    TYPE_MODIFY_COLUMN, TYPE_RESTORE, TYPE_CREATE_MODEL)
from ..errors import (TiDBError, WriteConflictError, TableNotExistsError,
                      DatabaseNotExistsError, DDLJobCancelledError,
                      DDLJobNotFoundError, CancelFinishedDDLError,
                      QueryKilledError, IndexExistsError,
                      IndexNotExistsError, ColumnNotExistsError)
from ..utils import failpoint
from ..utils import metrics as metrics_util
from .manager import OwnerManager, LocalLeaseStore
from ..utils import lockrank


class _CancelRequested(Exception):
    """Internal: a durable cancel request (or KILL of the driving
    session) was observed mid-job; carries the user-facing error to
    raise once the rollback ladder completes."""

    def __init__(self, user_error):
        super().__init__(str(user_error))
        self.user_error = user_error


def _record_error(e) -> str:
    """'ClassName: message' — survives restarts and maps back to the
    typed error for a waiting session (see _error_from_record)."""
    return "%s: %s" % (type(e).__name__, getattr(e, "msg", str(e)))


def _error_from_record(job: DDLJob) -> TiDBError:
    from .. import errors as _errors
    name, _, msg = (job.error or "").partition(": ")
    cls = getattr(_errors, name, None)
    if isinstance(cls, type) and issubclass(cls, TiDBError):
        return cls("%s", msg or name)
    return DDLJobCancelledError(
        "DDL job %d rolled back: %s", job.id, job.error or "cancelled")


class DDLJobRunner:
    """Domain-owned owner worker for the durable DDL job queue."""

    # states a drop-index job cannot be rolled back from: once the
    # index reached DELETE_ONLY, inserts stopped maintaining it, so
    # restoring PUBLIC would surface missing entries — the job must
    # roll forward to absent instead (reference rollingback.go
    # convertNotRollbackableJob)
    _DROP_POINT_OF_NO_RETURN = SchemaState.DELETE_ONLY

    def __init__(self, domain):
        self.domain = domain
        self._mu = lockrank.ranked_rlock("ddl.runner")
        self.owner = OwnerManager(LocalLeaseStore(), "ddl-owner",
                                  "domain-%x" % id(domain), ttl=10.0)
        # job_id -> callable returning True when the driving session
        # was KILLed (session-side flag; observed at ladder steps and
        # backfill checkpoints like the durable cancel request)
        self._cancel_checks: dict = {}
        self._driver = None     # thread id currently draining the queue

    # ---- meta txn helpers ---------------------------------------------
    def _txn(self, fn, bump_version=False):
        txn = self.domain.storage.begin()
        try:
            m = Mutator(txn)
            r = fn(m)
            if bump_version:
                m.gen_schema_version()
            txn.commit()
            return r
        except BaseException:
            txn.rollback()
            raise

    def _retry_txn(self, fn, bump_version=False, what="job"):
        """THE conflict-retry meta-txn wrapper every job-record write
        rides (steps, terminal moves, enqueue, cancel, and the
        coordinator's distributed records via Cluster._job_txn):
        begin/Mutator/fn/commit with a bounded WriteConflict retry —
        fn re-runs against a fresh snapshot, so it must be idempotent
        and re-read any state it depends on inside the txn."""
        for _attempt in range(16):
            txn = self.domain.storage.begin()
            try:
                m = Mutator(txn)
                r = fn(m)
                if bump_version:
                    m.gen_schema_version()
                txn.commit()
                return r
            except WriteConflictError:
                txn.rollback()
                continue
            except BaseException:
                txn.rollback()
                raise
        raise TiDBError("DDL %s meta txn kept conflicting", what)

    def _cancel_guard(self, m, job):
        """Raise _CancelRequested when the DURABLE record says
        cancelling — called inside a job txn, so a concurrent ADMIN
        CANCEL conflicts with this txn on the job key and one of the
        two orders wins cleanly."""
        cur = m.get_ddl_job(job.id)
        if cur is not None and cur.state == STATE_CANCELLING:
            raise _CancelRequested(DDLJobCancelledError(
                "Cancelled DDL job %d", job.id))

    def _step_txn(self, job, fn, bump_version=True, honor_cancel=True):
        """One ladder step: fn(m) mutates schema meta and the in-memory
        ``job``; the job row persists in the SAME txn. Each step is a
        span under the job's trace (survives resume: the trace_id is
        the durable job id), stamped with the schema state it left."""
        from ..utils import tracing as _tracing

        def body(m):
            if honor_cancel:
                self._cancel_guard(m, job)
            r = fn(m)
            m.put_ddl_job(job)
            return r
        with _tracing.span("ddl_step", job=job.id):
            r = self._retry_txn(body, bump_version=bump_version,
                                what="job %d" % job.id)
            _tracing.tag(schema_state=str(job.schema_state))
            return r

    def _get_tbl(self, m, job):
        for db in m.list_databases():
            if db.name.lower() == job.db_name.lower():
                tbl = m.get_table(db.id, job.table_id)
                if tbl is None:
                    raise TableNotExistsError(
                        "Unknown table '%s'", job.table_name)
                return db, tbl
        raise DatabaseNotExistsError("Unknown database '%s'", job.db_name)

    def _mark(self, job, state):
        metrics_util.DDL_JOBS.labels(job.type, state).inc()

    def _batch_size(self, job) -> int:
        b = job.args.get("batch")
        if b:
            return max(int(b), 1)
        v = self.domain.global_vars.get("tidb_tpu_ddl_reorg_batch_size")
        if v is None:
            from ..session.sysvars import get_sysvar
            v = get_sysvar("tidb_tpu_ddl_reorg_batch_size").default
        return max(int(v), 1)

    # ---- public API ----------------------------------------------------
    def submit(self, job: DDLJob, cancel_check=None) -> DDLJob:
        """Enqueue a job durably and drive the queue until it reaches a
        terminal state. Raises the job's typed error when it rolled
        back; returns the synced history record on success."""
        job.state = STATE_QUEUEING
        job.start_wall = time.time()

        def enq(m):
            job.id = 0          # retries re-enqueue with a fresh id
            m.enqueue_ddl_job(job)
        self._retry_txn(enq, what="enqueue")
        self._mark(job, STATE_QUEUEING)
        failpoint.inject("ddl-job-enqueued")
        if cancel_check is not None:
            self._cancel_checks[job.id] = cancel_check
        try:
            err = self.run_queue(raise_for=job.id)
        finally:
            self._cancel_checks.pop(job.id, None)
        if err is not None:
            raise err
        final = self._txn(lambda m: m.get_history_ddl_job(job.id) or
                          m.get_ddl_job(job.id))
        if final is None:
            raise TiDBError("DDL job %d vanished from the queue", job.id)
        if final.state != STATE_SYNCED:
            raise _error_from_record(final)
        return final

    def run_queue(self, raise_for=None):
        """Drain the durable queue FIFO as the ddl-owner. Returns the
        error to surface for ``raise_for`` (the submitting session's
        job), or None. Distributed jobs (cluster/coordinator.py) are
        skipped — the coordinator owns their ladder."""
        surfaced = None
        with self._mu:
            self._driver = threading.get_ident()
            self.owner.campaign()
            # a job whose ROLLBACK also failed stays live in the queue
            # (the record is the restart's to-do list) — park it for
            # this drain instead of re-picking it in a tight loop: the
            # driver must terminate and surface the error, not livelock
            # holding the runner lock
            parked: set = set()
            try:
                while True:
                    jobs = self._txn(lambda m: m.list_ddl_jobs())
                    job = next((j for j in jobs
                                if not j.args.get("distributed") and
                                j.id not in parked), None)
                    if job is None:
                        break
                    err = self._run_job(job)
                    if err is not None:
                        if job.id == raise_for:
                            surfaced = err
                        parked.add(job.id)
            finally:
                self._driver = None
                self.owner.resign()
        return surfaced

    def cancel(self, jid: int) -> str:
        """ADMIN CANCEL DDL JOB: flip the durable record to
        ``cancelling``. The owner observes it at the next ladder step /
        backfill checkpoint; if no owner is driving (the DDL session
        died), the rollback runs here."""
        def fn(m):
            job = m.get_ddl_job(jid)
            if job is None:
                if m.get_history_ddl_job(jid) is not None:
                    raise CancelFinishedDDLError(
                        "This job:%d is finished, so can't be "
                        "cancelled now", jid)
                raise DDLJobNotFoundError("DDL Job:%d not found", jid)
            if job.state in (STATE_CANCELLING, STATE_ROLLINGBACK):
                return job     # already on its way down
            # the drop ladder DESCENDS (public 4 -> write-only 2 ->
            # delete-only 1): at/below DELETE_ONLY inserts stopped
            # maintaining the index, so the job must roll forward
            if job.type == TYPE_DROP_INDEX and \
                    job.schema_state <= self._DROP_POINT_OF_NO_RETURN:
                raise CancelFinishedDDLError(
                    "This job:%d is almost finished, can't be "
                    "cancelled now", jid)
            job.state = STATE_CANCELLING
            m.put_ddl_job(job)
            return job
        # retry races a ladder-step commit on the job key: fn re-reads
        # the fresh record (the step txn re-checks the cancelling flag
        # transactionally, so whichever order wins is observed)
        job = self._retry_txn(fn, what="cancel %d" % jid)
        self._mark(job, STATE_CANCELLING)
        # no driver? process the rollback inline (non-blocking probe:
        # a live driver will observe the durable flag itself). The
        # _driver check keeps a re-entrant call — the RLock would let
        # the DRIVING thread back in mid-job — from recursing into the
        # job it is cancelling
        if self._driver != threading.get_ident() and \
                self._mu.acquire(blocking=False):
            try:
                self.run_queue()
            finally:
                self._mu.release()
        return "successful"

    def list_jobs(self):
        """Live queue jobs + recent history, newest-ish first (the
        ADMIN SHOW DDL JOBS / information_schema.ddl_jobs source)."""
        def fn(m):
            return m.list_ddl_jobs(), m.list_history_ddl_jobs()
        live, hist = self._txn(fn)
        return list(reversed(live)) + hist

    def resume_pending(self):
        """Restart recovery (Domain._open_wal tail): sweep orphaned
        non-PUBLIC index states into rollback jobs, re-enter every live
        local job, drain leftover delete-ranges. Every job leaves here
        terminal: resumed-to-PUBLIC or rolled-back-to-absent."""
        self.sweep_orphan_indexes()
        jobs = self._txn(lambda m: m.list_ddl_jobs())
        if any(not j.args.get("distributed") for j in jobs):
            self.run_queue()
        self.process_delete_ranges()

    def sweep_orphan_indexes(self):
        """A non-PUBLIC index state with no owning job is a stranded
        half-DDL from a store written before the job framework (or a
        lost record): synthesize a rollback job. Absent is the only
        always-safe terminal state — a DELETE_ONLY index skipped insert
        maintenance, so promoting it to PUBLIC could surface missing
        entries, while removal + delete-range is correct for both a
        crashed ADD and a crashed DROP."""
        def live_targets(m):
            out = set()
            for j in m.list_ddl_jobs():
                iname = (j.args.get("index") or {}).get("name", "")
                if iname:
                    out.add((j.table_id, iname.lower()))
            return out

        def scan(m):
            covered = live_targets(m)
            orphans = []
            for db in m.list_databases():
                for tbl in m.list_tables(db.id):
                    for idx in tbl.indexes:
                        if idx.state != SchemaState.PUBLIC and \
                                (tbl.id, idx.name.lower()) not in covered:
                            orphans.append((db.name, tbl, idx))
            return orphans
        orphans = self._txn(scan)
        for db_name, tbl, idx in orphans:
            job = DDLJob(
                type=TYPE_ADD_INDEX, state=STATE_ROLLINGBACK,
                schema_state=idx.state, db_name=db_name,
                table_name=tbl.name, table_id=tbl.id,
                args={"index": {"name": idx.name,
                                "columns": list(idx.columns),
                                "unique": idx.unique,
                                "primary": idx.primary},
                      "index_id": idx.id, "orphan_sweep": True},
                error="orphan non-PUBLIC index state swept at restart",
                start_wall=time.time())
            self._retry_txn(lambda m, j=job: m.enqueue_ddl_job(j),
                            what="orphan sweep")
            self._mark(job, STATE_ROLLINGBACK)
            self.domain.inc_metric("ddl_orphan_index_sweeps")

    def process_delete_ranges(self):
        """Drain the delete-range queue: purge each registered index
        key range and unregister it in ONE txn (idempotent — a crash
        between jobs re-runs the purge at the next resume)."""
        from ..codec.tablecodec import index_prefix
        recs = self._txn(lambda m: m.delete_ranges())
        for rec in recs:
            failpoint.inject("ddl-delete-range")

            def purge(m, rec=rec):
                pref = index_prefix(rec["table_id"], rec["index_id"])
                n = 0
                for k, _v in m.txn.scan(pref, pref + b"\xff" * 9):
                    m.txn.delete(k)
                    n += 1
                m.remove_delete_range(rec["id"])
                return n
            n = self._txn(purge)
            self.domain.inc_metric("ddl_delete_range_keys", n)

    # ---- job execution -------------------------------------------------
    def _run_job(self, job: DDLJob):
        """Drive one job to a terminal state. Returns the error to
        surface to the submitting session (None on success); never
        raises except for process death. Runs under an always-sampled
        trace whose trace_id is derived from the DURABLE job id
        ("ddljob-<id>"), so a job resumed after restart keeps
        correlating with its pre-crash spans; each ladder step records
        a child span (_step_txn)."""
        with self.domain.tracer.span("ddl_job", sampled=True,
                                     trace_id=f"ddljob-{job.id}",
                                     job=job.id, type=job.type,
                                     state=job.state):
            return self._run_job_traced(job)

    def _run_job_traced(self, job: DDLJob):
        cancel_check = self._cancel_checks.get(job.id)
        if job.state in (STATE_CANCELLING, STATE_ROLLINGBACK):
            return self._rollback(job, None)
        if job.state == STATE_QUEUEING:
            job.state = STATE_RUNNING
            try:
                self._step_txn(job, lambda m: None, bump_version=False)
            except _CancelRequested as c:
                return self._rollback(job, c.user_error)
            self._mark(job, STATE_RUNNING)
        handler = {
            TYPE_ADD_INDEX: self._run_add_index,
            TYPE_DROP_INDEX: self._run_drop_index,
            TYPE_EXCHANGE_PARTITION: self._run_exchange_partition,
            TYPE_MODIFY_COLUMN: self._run_modify_column,
            TYPE_RESTORE: self._run_restore,
            TYPE_CREATE_MODEL: self._run_create_model,
        }.get(job.type)
        if handler is None:
            return self._rollback(job, TiDBError(
                "unknown DDL job type '%s'", job.type))
        try:
            handler(job, cancel_check)
            return None
        except _CancelRequested as c:
            return self._rollback(job, c.user_error)
        except (SystemExit, KeyboardInterrupt):
            raise
        except BaseException as e:        # job failed: reverse ladder
            job.error = _record_error(e)
            return self._rollback(job, e)

    def _check_cancel(self, job, cancel_check):
        """Between-step cancellation probe: the durable record (ADMIN
        CANCEL from any session) and the driving session's KILL flag."""
        cur = self._txn(lambda m: m.get_ddl_job(job.id))
        if cur is not None and cur.state == STATE_CANCELLING:
            raise _CancelRequested(DDLJobCancelledError(
                "Cancelled DDL job %d", job.id))
        if cancel_check is not None and cancel_check():
            raise _CancelRequested(QueryKilledError(
                "Query execution was interrupted"))

    # ---- ADD INDEX -----------------------------------------------------
    def _run_add_index(self, job, cancel_check):
        iargs = job.args["index"]
        name = iargs["name"]

        if job.schema_state < SchemaState.DELETE_ONLY:
            def create(m):
                db, tbl = self._get_tbl(m, job)
                if tbl.find_index(name) is not None:
                    raise IndexExistsError(
                        "Duplicate key name '%s'", name)
                for cn in iargs["columns"]:
                    if tbl.find_column(cn) is None:
                        raise ColumnNotExistsError(
                            "Key column '%s' doesn't exist in table", cn)
                from ..models import IndexInfo
                idx = IndexInfo(
                    id=max((i.id for i in tbl.indexes), default=0) + 1,
                    name=name, columns=list(iargs["columns"]),
                    unique=bool(iargs.get("unique")),
                    primary=bool(iargs.get("primary")),
                    state=SchemaState.DELETE_ONLY)
                tbl.indexes.append(idx)
                m.update_table(db.id, tbl)
                job.schema_state = SchemaState.DELETE_ONLY
                job.args["index_id"] = idx.id
            self._step_txn(job, create)
            failpoint.inject("ddl-index-delete-only")
            self._check_cancel(job, cancel_check)

        for state, fp in ((SchemaState.WRITE_ONLY, "ddl-index-write-only"),
                          (SchemaState.WRITE_REORG,
                           "ddl-index-write-reorg")):
            if job.schema_state < state:
                self._set_index_state(job, name, state)
                failpoint.inject(fp)
                self._check_cancel(job, cancel_check)

        self._backfill(job, name, cancel_check)

        failpoint.inject("ddl-pre-public")
        self._check_cancel(job, cancel_check)

        def publish(m):
            db, tbl = self._get_tbl(m, job)
            idx = tbl.find_index(name)
            if idx is None:
                raise TiDBError("index %s vanished mid-job", name)
            idx.state = SchemaState.PUBLIC
            m.update_table(db.id, tbl)
            job.schema_state = SchemaState.PUBLIC
            job.state = STATE_SYNCED
            m.finish_ddl_job(job)
        # finish_ddl_job replaces put_ddl_job for the terminal txn:
        # _step_txn's put would resurrect the queue row, so run the
        # terminal step through its cancel-honoring core manually
        self._terminal_txn(job, publish)
        self._mark(job, STATE_SYNCED)

    def _run_restore(self, job, cancel_check):
        """RESTORE DATABASE as a resumable job — the phase machine
        lives in br/restore.py (schema -> import -> replay); this
        runner contributes the durable queue, the checkpointed step
        txns and restart re-entry via resume_pending."""
        from ..br import restore as br_restore
        br_restore.run_restore_job(self, job, cancel_check)

    def _run_create_model(self, job, cancel_check):
        """CREATE MODEL as a resumable job — the weight-blob/registry/
        publish ladder lives in ml/ddl.py; this runner contributes the
        durable queue, the step txns and restart re-entry."""
        from ..ml import ddl as ml_ddl
        ml_ddl.run_create_model_job(self, job, cancel_check)

    def _set_index_state(self, job, name, state):
        def step(m):
            db, tbl = self._get_tbl(m, job)
            idx = tbl.find_index(name)
            if idx is None:
                raise TiDBError("index %s vanished mid-job", name)
            idx.state = state
            m.update_table(db.id, tbl)
            job.schema_state = state
        self._step_txn(job, step)

    def _terminal_txn(self, job, fn, honor_cancel=True):
        """Like _step_txn but fn moves the job to history itself
        (finish_ddl_job replaces the put — a put would resurrect the
        queue row)."""
        from ..utils import tracing as _tracing

        def body(m):
            if honor_cancel:
                self._cancel_guard(m, job)
            fn(m)
        with _tracing.span("ddl_terminal", job=job.id):
            self._retry_txn(body, bump_version=True,
                            what="job %d" % job.id)

    def _backfill(self, job, name, cancel_check):
        """Handle-ordered transactional backfill with durable
        checkpoints: each batch commits through 2PC (concurrent DML
        conflicts retry the batch with a fresh snapshot), then the job
        row records the high-water handle so a restarted job continues
        at the recorded range."""
        from ..utils import tracing as _tracing
        with _tracing.span("ddl_backfill", job=job.id):
            return self._backfill_traced(job, name, cancel_check)

    def _backfill_traced(self, job, name, cancel_check):
        from ..session.ddl import backfill_index_batch
        dom = self.domain
        info = dom.infoschema().table_by_id(job.table_id)
        if info is None:
            raise TableNotExistsError("Unknown table '%s'",
                                      job.table_name)
        idx = info.find_index(name)
        if idx is None:
            raise TiDBError("index %s vanished mid-job", name)
        phys_ids = dom._physical_ids(info)
        if not job.row_total:
            total = 0
            for pid in phys_ids:
                ctab = dom.columnar.tables.get(pid)
                total += ctab.live_count() if ctab is not None else 0
            job.row_total = total
        batch = self._batch_size(job)
        done_pids = set(job.args.get("pids_done") or [])
        for pid in phys_ids:
            if pid in done_pids:
                continue
            if job.args.get("checkpoint_pid") != pid:
                # starting a fresh physical table: reset the handle
                job.args["checkpoint_pid"] = pid
                job.checkpoint_handle = None
            while True:
                self._check_cancel(job, cancel_check)
                start_after = job.checkpoint_handle
                n = last = None
                for _retry in range(32):
                    try:
                        n, last = backfill_index_batch(
                            dom, info, pid, idx,
                            start_after=start_after, limit=batch)
                        break
                    except WriteConflictError:
                        # concurrent DML rewrote a key in this batch:
                        # fresh snapshot, same handle range
                        continue
                if n is None:
                    raise TiDBError(
                        "DDL job %d: backfill batch kept conflicting "
                        "with concurrent DML", job.id)
                if n == 0:
                    break
                job.checkpoint_handle = last
                job.row_done += n
                self._step_txn(job, lambda m: None, bump_version=False)
                metrics_util.DDL_BACKFILL.labels("done").set(job.row_done)
                metrics_util.DDL_BACKFILL.labels("total").set(
                    max(job.row_total, job.row_done))
                failpoint.inject("ddl-backfill-checkpoint")
            done_pids.add(pid)
            job.args["pids_done"] = sorted(done_pids)
            job.args.pop("checkpoint_pid", None)
            self._step_txn(job, lambda m: None, bump_version=False)

    # ---- DROP INDEX ----------------------------------------------------
    def _run_drop_index(self, job, cancel_check):
        name = job.args["index"]["name"]

        def current_state(m):
            _db, tbl = self._get_tbl(m, job)
            idx = tbl.find_index(name)
            return None if idx is None else (idx.state, idx.id)
        cur = self._txn(current_state)
        if cur is None:
            # NOT a resume artifact — the removal txn finishes the job
            # atomically, so a live drop job over a missing index means
            # another session's concurrent DROP won the race (or the
            # index never existed when the job was enqueued): surface
            # MySQL 1091/1176 semantics instead of silently succeeding
            raise IndexNotExistsError("index %s doesn't exist", name)
        job.args["index_id"] = cur[1]

        ladder = ((SchemaState.WRITE_ONLY, "ddl-drop-write-only"),
                  (SchemaState.DELETE_ONLY, "ddl-drop-delete-only"))
        for state, fp in ladder:
            if cur[0] > state:
                # cancel is honored up to (and including) the check
                # BEFORE the DELETE_ONLY commit — rollback from
                # WRITE_ONLY restores a fully-maintained index. Once
                # DELETE_ONLY commits, inserts stop maintaining it, so
                # no check runs after (the job rolls forward; cancel()
                # refuses on the durable schema_state)
                self._check_cancel(job, cancel_check)

                def step(m, state=state):
                    db, tbl = self._get_tbl(m, job)
                    idx = tbl.find_index(name)
                    if idx is None:
                        raise TiDBError("index %s vanished mid-job",
                                        name)
                    idx.state = state
                    m.update_table(db.id, tbl)
                    job.schema_state = state
                self._step_txn(job, step)
                cur = (state, cur[1])
                failpoint.inject(fp)

        failpoint.inject("ddl-drop-before-remove")

        def remove(m):
            db, tbl = self._get_tbl(m, job)
            idx = tbl.find_index(name)
            if idx is not None:
                tbl.indexes = [i for i in tbl.indexes if i is not idx]
                m.update_table(db.id, tbl)
                m.add_delete_range(tbl.id, idx.id)
            job.schema_state = SchemaState.NONE
            job.state = STATE_SYNCED
            m.finish_ddl_job(job)
        self._terminal_txn(job, remove, honor_cancel=False)
        self._mark(job, STATE_SYNCED)
        self.process_delete_ranges()

    # ---- EXCHANGE PARTITION -------------------------------------------
    def _run_exchange_partition(self, job, cancel_check):
        """The row swap + meta bump + job completion commit as ONE
        transaction: a crash before it re-runs the whole handler at
        resume (nothing applied), a crash after finds the job synced in
        history — never a half-exchanged partition."""
        from ..session.ddl import exchange_partition_apply
        self._check_cancel(job, cancel_check)
        failpoint.inject("ddl-reorg-before-swap")
        exchange_partition_apply(self, job)
        self._mark(job, STATE_SYNCED)

    # ---- MODIFY COLUMN (reorg) ----------------------------------------
    def _run_modify_column(self, job, cancel_check):
        from ..session.ddl import modify_column_apply
        self._check_cancel(job, cancel_check)
        failpoint.inject("ddl-reorg-before-swap")
        modify_column_apply(self, job)
        self._mark(job, STATE_SYNCED)

    # ---- rollback (reverse ladder) -------------------------------------
    def _rollback(self, job, user_err):
        """Drive the job down the reverse ladder to clean absence and
        into history as ``cancelled``. Returns the error to surface (a
        resumed job has no waiter — the record keeps it). A failure
        mid-rollback leaves the job ``rollingback`` for the next
        restart to finish; it never silently disappears."""
        try:
            if user_err is not None and not job.error:
                job.error = _record_error(user_err)
            if job.state != STATE_ROLLINGBACK:
                job.state = STATE_ROLLINGBACK
                self._step_txn(job, lambda m: None, bump_version=False,
                               honor_cancel=False)
                self._mark(job, STATE_ROLLINGBACK)
            if job.type == TYPE_ADD_INDEX:
                self._rollback_add_index(job)
            elif job.type == TYPE_DROP_INDEX:
                self._rollback_drop_index(job)
            elif job.type == TYPE_RESTORE:
                from ..br import restore as br_restore
                br_restore.rollback_restore(self, job)
            elif job.type == TYPE_CREATE_MODEL:
                from ..ml import ddl as ml_ddl
                ml_ddl.rollback_create_model(self, job)
            # exchange partition / modify column apply in one terminal
            # txn — a rolling-back job has nothing durable to undo
            job.state = STATE_CANCELLED
            self._terminal_txn(job, lambda m: m.finish_ddl_job(job),
                               honor_cancel=False)
            self._mark(job, STATE_CANCELLED)
            self.process_delete_ranges()
        except (SystemExit, KeyboardInterrupt):
            raise
        except BaseException as e:
            return user_err if user_err is not None else e
        if user_err is not None:
            return user_err
        return _error_from_record(job)

    def _rollback_add_index(self, job):
        """Step the half-built index down write_reorg -> write_only ->
        delete_only -> absent; the removal txn registers the
        delete-range so committed backfill KVs are purged too."""
        name = job.args["index"]["name"]
        while True:
            def step(m):
                db, tbl = self._get_tbl(m, job)
                idx = tbl.find_index(name)
                if idx is None or idx.state == SchemaState.PUBLIC:
                    return "done"   # nothing (left) to roll back
                if idx.state <= SchemaState.DELETE_ONLY:
                    tbl.indexes = [i for i in tbl.indexes
                                   if i is not idx]
                    m.update_table(db.id, tbl)
                    m.add_delete_range(tbl.id, idx.id)
                    job.schema_state = SchemaState.NONE
                    return "done"
                idx.state = SchemaState(int(idx.state) - 1)
                m.update_table(db.id, tbl)
                job.schema_state = idx.state
                return "again"
            try:
                r = self._step_txn(job, step, honor_cancel=False)
            except (TableNotExistsError, DatabaseNotExistsError):
                # table dropped while the job was stranded: the drop
                # already purged the columnar side; register the range
                # purge for the index KVs if we know the id
                iid = job.args.get("index_id")
                if iid:
                    self._txn(lambda m: m.add_delete_range(
                        job.table_id, iid))
                return
            failpoint.inject("ddl-rollback-step")
            if r == "done":
                return

    def _rollback_drop_index(self, job):
        """Un-drop: restore PUBLIC. Only reachable before DELETE_ONLY
        (cancel() refuses later) — at WRITE_ONLY every write still
        maintained the index, so the entries are complete."""
        name = job.args["index"]["name"]

        def step(m):
            db, tbl = self._get_tbl(m, job)
            idx = tbl.find_index(name)
            if idx is None:
                return
            idx.state = SchemaState.PUBLIC
            m.update_table(db.id, tbl)
            job.schema_state = SchemaState.PUBLIC
        try:
            self._step_txn(job, step, honor_cancel=False)
        except (TableNotExistsError, DatabaseNotExistsError):
            pass

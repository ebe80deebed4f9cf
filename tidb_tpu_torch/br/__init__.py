"""Online backup/restore + point-in-time recovery (reference br/ —
PAPER.md layer T), three legs:

  * snapshot backup (snapshot.py) — columnar-direct chunked export of
    every table at ONE ``mvcc.resolved_floor`` ts, checksummed, with a
    per-table-checkpointed manifest;
  * continuous log backup (logformat.py + the ``logbackup://`` sink in
    cdc/sinks.py) — a changefeed whose sink is a durable WAL-framed
    log, giving an unbroken (backup_ts, now] commit-ts stream;
  * PITR restore (restore.py) — RESTORE ... [UNTIL TS n] as a durable
    DDL job: schema recreate -> bulk import -> log replay, resumable
    from its checkpoint after kill -9.

Format/consistency contracts live in docs/BACKUP.md; the chaos gate is
scripts/backup_smoke.py.
"""
from . import logformat, snapshot, restore          # noqa: F401
from .snapshot import run_backup                     # noqa: F401
from .restore import submit_restore                  # noqa: F401

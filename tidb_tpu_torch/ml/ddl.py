"""CREATE MODEL as a durable, resumable DDL job (reference
tidb_tpu/ml/ddl.py, host code copied with its imports pointed here).

Ladder (each rung is one idempotent meta txn; the job row persists in
the SAME txn, so kill -9 between any two rungs resumes exactly where it
left off via resume_pending):

    1. weights blob row  m[Model:{id}:Weights]   (seam: ml-weights-write)
    2. registry row      m[Model:{id}], public=False
                                                 (seam: ml-registry-commit)
    3.                                           (seam: ml-pre-public)
       publish: public=True + finish_ddl_job     (one terminal txn)

The registry only surfaces public rows, so a crash mid-ladder never
exposes a half-created model; rollback (job error / ADMIN CANCEL) drops
the blob and the registry row in one txn — zero orphaned weight rows
(the reference's scripts/ddl_smoke.py CREATE MODEL kill cases).
"""
from __future__ import annotations

import time

from ..errors import TiDBError
from ..models import ModelInfo
from ..models.job import STATE_SYNCED
from ..utils import failpoint
from .registry import parse_npz


def read_model_uri(uri: str) -> bytes:
    """Fetch the weight archive. Local filesystem only ('file://p' or a
    plain path) — remote schemes are the serving-stack roadmap."""
    path = uri[7:] if uri.startswith("file://") else uri
    try:
        with open(path, "rb") as f:
            return f.read()
    except OSError as e:
        raise TiDBError("cannot read model weights '%s': %s", uri, e)


def run_create_model_job(runner, job, cancel_check):
    """Job handler (owner/ddl_runner.py dispatch, TYPE_CREATE_MODEL)."""
    margs = job.args["model"]
    name = margs["name"]
    uri = margs["uri"]
    # host IO + parse are re-done on resume (the blob itself is the
    # idempotence token: rung 1 rewrites the same bytes)
    blob = read_model_uri(uri)
    kind, params, _ws, _bs, _table = parse_npz(blob)

    if not margs.get("weights_done"):
        def put_weights(m):
            mid = margs.get("model_id")
            if not mid:
                mid = m.gen_global_id()
                margs["model_id"] = mid
            for info in m.list_models():
                if info.name.lower() == name.lower() and info.public:
                    raise TiDBError("Model '%s' already exists", name)
            m.put_model_weights(mid, blob)
            margs["weights_done"] = True
        runner._step_txn(job, put_weights, bump_version=False)
        failpoint.inject("ml-weights-write")
    runner._check_cancel(job, cancel_check)

    if not margs.get("meta_done"):
        def put_meta(m):
            info = ModelInfo(
                id=margs["model_id"], name=name, uri=uri, kind=kind,
                params=params, nbytes=int(params.get("nbytes", 0)),
                version=1, public=False)
            m.create_model(info)
            margs["meta_done"] = True
        runner._step_txn(job, put_meta)
        failpoint.inject("ml-registry-commit")
    runner._check_cancel(job, cancel_check)
    failpoint.inject("ml-pre-public")

    def publish(m):
        info = m.get_model(margs["model_id"])
        if info is None:
            raise TiDBError("model row for '%s' vanished mid-job", name)
        info.public = True
        info.created_ts = int(time.time() * 1_000_000)
        m.update_model(info)
        job.state = STATE_SYNCED
        m.finish_ddl_job(job)
    runner._terminal_txn(job, publish)
    runner._mark(job, STATE_SYNCED)


def rollback_create_model(runner, job):
    """Reverse ladder: ONE txn removes the registry row, the id-list
    entry, and the weights blob — whatever subset of rungs committed.
    Idempotent (deletes of absent keys are no-ops), so a crash
    mid-rollback re-runs cleanly."""
    margs = (job.args or {}).get("model") or {}
    mid = margs.get("model_id")
    if not mid:
        return

    def step(m):
        m.drop_model(mid)
    runner._step_txn(job, step, honor_cancel=False)
    failpoint.inject("ddl-rollback-step")

"""The port's utils/lockrank (tidb_tpu_torch/utils/lockrank.py): twins
of tests/test_lockrank.py, the runtime lock-rank sanitizer. ~2 s on the
CPU.

Covers both halves of the contract: under TIDB_TPU_LOCKRANK=1 a rank
inversion raises LockRankError at the offending acquire; with the
sanitizer off, ranked_lock() returns a BARE threading.Lock — zero
wrapper overhead in production builds.

conftest.py arms the sanitizer for the whole suite, so the
"disabled" tests spawn a subprocess with the variable unset (one in
which jax and tidb_tpu cannot be imported: the port's sanitizer needs
neither).
"""
import os
import subprocess
import sys
import threading

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tidb_tpu_torch.utils import lockrank  # noqa: E402
from tidb_tpu_torch.utils.lockrank_ranks import RANKS  # noqa: E402


def _ranked(name, rank):
    assert lockrank.enabled(), "conftest must arm TIDB_TPU_LOCKRANK"
    return lockrank._RankedLock(name, rank, threading.Lock())


# ---- ordering ---------------------------------------------------------

def test_increasing_rank_acquisition_passes():
    lo, hi = _ranked("t.lo", 10), _ranked("t.hi", 20)
    with lo:
        with hi:
            assert [n for _, n in lockrank.held()] == ["t.lo", "t.hi"]
    assert lockrank.held() == []


def test_rank_inversion_raises():
    """The deliberate inversion: acquiring a LOWER rank while holding a
    higher one raises at the acquire, naming both locks and the held
    stack."""
    lo, hi = _ranked("t.lo", 10), _ranked("t.hi", 20)
    with hi:
        with pytest.raises(lockrank.LockRankError) as ei:
            with lo:
                pass
    msg = str(ei.value)
    assert "t.lo" in msg and "t.hi" in msg and "held stack" in msg
    # the failed acquire must not leak a held-stack entry
    assert lockrank.held() == []


def test_equal_rank_is_an_inversion():
    a, b = _ranked("t.a", 10), _ranked("t.b", 10)
    with a:
        with pytest.raises(lockrank.LockRankError):
            b.acquire()


def test_failed_nonblocking_acquire_unwinds_stack():
    mu = _ranked("t.mu", 10)
    mu.acquire()
    try:
        t_result = {}

        def worker():
            t_result["got"] = mu.acquire(blocking=False)
            t_result["held"] = lockrank.held()

        t = threading.Thread(target=worker)
        t.start()
        t.join()
        assert t_result["got"] is False
        assert t_result["held"] == []      # per-thread stack unwound
    finally:
        mu.release()


def test_held_stack_is_thread_local():
    mu = _ranked("t.mu", 10)
    seen = {}

    def worker():
        seen["held"] = lockrank.held()

    with mu:
        t = threading.Thread(target=worker)
        t.start()
        t.join()
    assert seen["held"] == []


# ---- re-entrancy ------------------------------------------------------

def test_rlock_reentry_allowed():
    r = lockrank.ranked_rlock("t.r", 10)
    with r:
        with r:
            pass
    assert lockrank.held() == []


def test_rlock_reentry_below_other_locks_allowed():
    """Re-acquiring an ALREADY-HELD RLock is never a new deadlock edge,
    even with higher-ranked locks stacked on top of it."""
    r = lockrank.ranked_rlock("t.r", 10)
    hi = _ranked("t.hi", 20)
    with r:
        with hi:
            with r:                       # rank 10 under rank 20: OK,
                pass                      # this thread already holds r
    assert lockrank.held() == []


# ---- conditions -------------------------------------------------------

def test_ranked_condition_wait_notify():
    cv = lockrank.ranked_condition("t.cv", 10)
    fired = threading.Event()

    def waiter():
        with cv:
            cv.wait(timeout=5)
        fired.set()

    t = threading.Thread(target=waiter)
    t.start()
    with cv:
        cv.notify_all()
    t.join(timeout=5)
    assert fired.is_set()
    assert lockrank.held() == []


def test_condition_notify_while_higher_rank_held():
    """notify()'s ownership probe must not be treated as an
    acquisition: holding cv(10) then a leaf lock (20), notify still
    works."""
    cv = lockrank.ranked_condition("t.cv", 10)
    leaf = _ranked("t.leaf", 20)
    with cv:
        with leaf:
            cv.notify_all()               # must not raise
    assert lockrank.held() == []


# ---- registry ---------------------------------------------------------

def test_registry_rank_contradiction_raises():
    name = sorted(RANKS)[0]
    with pytest.raises(lockrank.LockRankError):
        lockrank.ranked_lock(name, RANKS[name] + 1)


def test_unregistered_name_without_rank_raises():
    with pytest.raises(lockrank.LockRankError):
        lockrank.ranked_lock("no.such.lock.name")


def test_registry_ranks_are_unique_and_hot_is_subset():
    from tidb_tpu_torch.utils.lockrank_ranks import HOT
    assert len(set(RANKS.values())) == len(RANKS), \
        "duplicate rank values collapse two locks into one order slot"
    assert HOT <= set(RANKS)


# ---- disabled mode: zero overhead ------------------------------------

def test_disabled_returns_bare_threading_primitives():
    """Without TIDB_TPU_LOCKRANK=1 the constructors return bare
    threading objects — no wrapper in the acquire path at all. Run in
    a subprocess because conftest arms the sanitizer here."""
    code = (
        "import sys, threading\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['tidb_tpu'] = None\n"
        "from tidb_tpu_torch.utils import lockrank\n"
        "assert not lockrank.enabled()\n"
        "mu = lockrank.ranked_lock('mvcc.store')\n"
        "assert type(mu) is type(threading.Lock()), type(mu)\n"
        "r = lockrank.ranked_rlock('ddl.runner')\n"
        "assert type(r) is type(threading.RLock()), type(r)\n"
        "cv = lockrank.ranked_condition('wal.gc')\n"
        "assert type(cv) is threading.Condition\n"
        "assert type(cv._lock) is type(threading.Lock())\n"
        "lo = lockrank.ranked_lock('t.unregistered')\n"  # no rank
        "assert type(lo) is type(threading.Lock())\n"    # lookup at all
        "print('ok')\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("TIDB_TPU_LOCKRANK", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "ok" in r.stdout


def test_enabled_wal_condition_is_ranked():
    cv = lockrank.ranked_condition("wal.gc")
    assert isinstance(cv._lock, lockrank._RankedLock)
    assert cv._lock.rank == RANKS["wal.gc"]

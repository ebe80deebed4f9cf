"""Per-query phase accounting: where does a device query's wall time go?

The reference surfaces per-operator runtime stats through
pkg/util/execdetails (EXPLAIN ANALYZE's execution info column); this is
the device-engine analog at the *backend* altitude: counters accumulated by
the copr layer while a statement runs — kernel dispatch count and time,
first fragment calls, host<->device upload time/bytes, device
buffer-pool hits, host-path execution time.

Collection points are central (one wrapper around every cached kernel,
one inside the device buffer pool), so new operators are covered for
free. Reset/snapshot is explicit: bench.py and EXPLAIN ANALYZE bracket
each statement with reset()/snap().

State is THREAD-LOCAL: each connection/background thread accumulates
into its own dict, so concurrent statements attribute their device time
to their own digest (Top SQL) instead of blurring into whichever
statement folds first. Nested internal SQL runs on its outer
statement's thread and accumulates into it by design (see
stmt_enter/depth). A worker thread doing a statement's dispatch on its
behalf (device_guard's watchdog) calls adopt(current()) to record into
the owning statement's dict.

Timing a dispatch measures the *call* (async on CUDA: the host returns
before the kernels finish); device time per kernel comes from
torch.profiler (bench/profile_tpch.py).

Device->host traffic is counted at the port's own fetch seam
(utils/fetch.py: `syncs`, `fetch_bytes`, `fetches`), and fragment calls
at timed_kernel below (`dispatches`).
"""
import threading
import time


_TLS = threading.local()


def _cur() -> dict:
    d = getattr(_TLS, "stats", None)
    if d is None:
        d = _TLS.stats = {}
    return d


def current() -> dict:
    """The calling thread's live stats dict — hand it to a worker
    thread via adopt() so dispatch done on this statement's behalf
    still lands on this statement."""
    return _cur()


def adopt(stats: dict):
    """Record this thread's phase counters into another thread's dict
    (device_guard watchdog workers)."""
    _TLS.stats = stats


def reset():
    _cur().clear()


def stmt_enter():
    """Called at statement start: reset ONLY for the outermost
    statement; nested (internal-SQL) statements accumulate into it.
    Nesting is per-thread — a statement on another connection's thread
    neither clears nor inherits this one's counters."""
    dep = getattr(_TLS, "depth", 0)
    if dep == 0:
        _cur().clear()
    _TLS.depth = dep + 1


def stmt_leave():
    _TLS.depth = max(getattr(_TLS, "depth", 0) - 1, 0)


def depth() -> int:
    """Statement nesting depth on this thread (1 = inside the outermost
    statement). Top SQL folds phase snapshots only at depth 1 so
    internal SQL never double-attributes the outer statement's
    accumulated counters."""
    return getattr(_TLS, "depth", 0)


def add(key, val):
    d = _cur()
    d[key] = d.get(key, 0) + val


def inc(key):
    d = _cur()
    d[key] = d.get(key, 0) + 1


def snap():
    """-> {phase: value} with times in ms (rounded), counters as-is."""
    out = {}
    for k, v in sorted(_cur().items()):
        out[k] = round(v * 1000, 2) if k.endswith("_s") else v
    return out


def timed_kernel(kind, fn, first=True):
    """Wrap a fragment callable with dispatch accounting. Its first call
    is recorded separately (on the card it may pay the lazy nvcc build
    of the scan kernels), unless `first` is False: a callable built anew
    for each call, which no cache holds, counts every call a dispatch."""
    state = {"first": first}

    def wrapped(*args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        dt = time.perf_counter() - t0
        inc("dispatches")
        if state["first"]:
            state["first"] = False
            inc("kernel_builds")
            add("compile_s", dt)
            add(f"compile_{kind}_s", dt)
        else:
            add("dispatch_s", dt)
            add(f"k_{kind}_s", dt)
        return out

    wrapped.__wrapped__ = fn
    return wrapped

"""What the gate tools (`tools/*_smoke.py`) share: the device a command
line asks for, rows in TestKit's string form, the reference's rows at
the gates' scale (bench/gates_sf005_expected.json, recorded from the
reference package on the CPU; its `_source` is the command), and the
card's outcome of an injected device fault."""
from __future__ import annotations

import json
import os

EXPECTED = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "bench", "gates_sf005_expected.json")


def device_of(argv) -> str:
    """--cpu runs on the host; the default is the card."""
    return "cpu" if "--cpu" in argv else "cuda"


def norm(rows) -> list:
    """rows as TestKit prints them: lists of strings, NULL as <nil>."""
    from ..testkit import _fmt
    return [["<nil>" if v is None else _fmt(v) for v in r] for r in rows]


def load_expected() -> dict:
    with open(EXPECTED) as f:
        return json.load(f)


def txn_open(tk) -> bool:
    """The session's transaction is still open."""
    t = tk.sess._txn
    return t is not None and not t.committed and not t.aborted


def card_fault(tk, sql, site, err="grant_lost"):
    """The card's outcome of an injected device fault at
    device_guard/<site>, where the reference degrades to its host twin:
    the statement fails with a clean 9013 naming the site's family, its
    implicit transaction rolled back and no lock left. -> (reached,
    failure): reached is True when the statement met the fault (False:
    it never reached the site and returned rows); failure is None or
    what went wrong."""
    from ..errors import DeviceUnavailableError
    from ..utils import failpoint
    failpoint.enable("device_guard/" + site, f"error:{err}")
    try:
        tk.must_query(sql)
        reached, failure = False, None
    except DeviceUnavailableError as e:
        reached = True
        failure = None if e.code == 9013 and \
            f"at {site.split('/')[0]}" in e.msg else \
            f"{site}: {e.code} {e.msg[:120]}"
    except Exception as e:                      # noqa: BLE001
        reached = True
        failure = f"{site}: unclean {type(e).__name__}: {str(e)[:120]}"
    finally:
        failpoint.disable("device_guard/" + site)
    if txn_open(tk):
        failure = failure or f"{site}: the statement's transaction " \
            "is still open"
    if tk.domain.storage.mvcc._locks:
        failure = failure or f"{site}: " \
            f"{len(tk.domain.storage.mvcc._locks)} locks left"
    return reached, failure

"""Correlated NOT IN over SCALAR aggregate subqueries: MySQL's
3-valued semantics (ROADMAP tail item). The subquery yields exactly one
row per correlation value — agg over an empty group is NULL (count: 0),
so `x NOT IN (select max(...) where corr)` is x <> that value under
3VL, NEVER an empty-set TRUE.

The twin of tests/test_notin_agg.py on tidb_tpu_torch, with device="cpu" at
every store."""
import pytest
from tidb_tpu_torch.testkit import TestKit


@pytest.fixture(autouse=True)
def _torch_registries():
    """The shared conftest resets tidb_tpu's registries only."""
    from tidb_tpu_torch.utils import device_guard, metrics, phase
    metrics.reset_all()
    device_guard.reset()
    phase.reset()
    yield


@pytest.fixture()
def tk():
    tk = TestKit(device="cpu")
    tk.must_exec("create table o (id int primary key, k int, x int)")
    tk.must_exec("create table i (id int primary key, k int, b int)")
    # k=1: max(b)=5; k=2: max(b)=NULL (all-null b); k=3: no rows
    tk.must_exec("insert into o values (1, 1, 5), (2, 1, 7), "
                 "(3, 2, 9), (4, 3, 9), (5, 1, null)")
    tk.must_exec("insert into i values (10, 1, 5), (11, 1, 3), "
                 "(12, 2, null)")
    return tk


def q(tk, sql):
    return [r[0] for r in tk.must_query(sql).rs.rows]


def test_not_in_scalar_max(tk):
    # MySQL semantics per outer row:
    # id=1 (k=1, x=5):  5 NOT IN {5}    -> FALSE -> drop
    # id=2 (k=1, x=7):  7 NOT IN {5}    -> TRUE  -> keep
    # id=3 (k=2, x=9):  9 NOT IN {NULL} -> NULL  -> drop
    # id=4 (k=3, x=9):  9 NOT IN {NULL} -> NULL  -> drop (max over
    #                   EMPTY group is NULL, not an empty set!)
    # id=5 (k=1, x=NULL): NULL NOT IN {5} -> NULL -> drop
    got = q(tk, "select id from o where x not in "
               "(select max(b) from i where i.k = o.k) order by id")
    assert got == [2], got


def test_not_in_scalar_count(tk):
    # count over an empty group is 0, not NULL:
    # id=1 (k=1, x=5):  5 NOT IN {2} -> TRUE keep
    # id=2 (k=1, x=7):  7 NOT IN {2} -> TRUE keep
    # id=3 (k=2, x=9):  9 NOT IN {1} -> TRUE keep
    # id=4 (k=3, x=9):  9 NOT IN {0} -> TRUE keep
    # id=5 (k=1, x=NULL): NULL NOT IN {2} -> NULL drop
    got = q(tk, "select id from o where x not in "
               "(select count(*) from i where i.k = o.k) order by id")
    assert got == [1, 2, 3, 4], got
    # and a count value that DOES match drops the row: k=3 count=0
    tk.must_exec("update o set x = 0 where id = 4")
    got = q(tk, "select id from o where x not in "
               "(select count(*) from i where i.k = o.k) order by id")
    assert got == [1, 2, 3], got


def test_in_scalar_max_unchanged(tk):
    # positive IN keeps its existing semantics
    got = q(tk, "select id from o where x in "
               "(select max(b) from i where i.k = o.k) order by id")
    assert got == [1], got


def test_not_in_grouped_agg(tk):
    """GROUPED aggregate subqueries CAN be empty per correlation value
    (no row for an absent group), so the per-group 3VL naaj path
    applies — unlike the scalar-agg case."""
    # per k: sets of max(b) grouped by id%2:
    #   k=1: groups {10:5} {11:3} -> {5, 3}
    #   k=2: {12: NULL}           -> {NULL}
    #   k=3: no rows              -> {} (empty set!)
    # outer rows:
    # id=1 (k=1, x=5):  5 NOT IN {5,3}  -> FALSE -> drop
    # id=2 (k=1, x=7):  7 NOT IN {5,3}  -> TRUE  -> keep
    # id=3 (k=2, x=9):  9 NOT IN {NULL} -> NULL  -> drop
    # id=4 (k=3, x=9):  9 NOT IN {}     -> TRUE  -> keep (empty set)
    # id=5 (k=1, x=NULL): NULL NOT IN {5,3} -> NULL -> drop
    got = q(tk, "select id from o where x not in "
               "(select max(b) from i where i.k = o.k "
               "group by i.id % 2) order by id")
    assert got == [2, 4], got


def test_not_in_group_by_only(tk):
    # per k: distinct b values; k=3 empty -> keep; k=2 {NULL} -> drop
    got = q(tk, "select id from o where x not in "
               "(select b from i where i.k = o.k group by b) "
               "order by id")
    assert got == [2, 4], got


def test_in_grouped_agg_and_exists(tk):
    """Positive IN / EXISTS over grouped correlated subqueries use the
    same decorrelation: sanity parity with hand-computed sets."""
    # IN: x in per-k {max(b) by id%2}: k=1 {5,3}: id=1 x=5 in -> keep
    got = q(tk, "select id from o where x in "
               "(select max(b) from i where i.k = o.k "
               "group by i.id % 2) order by id")
    assert got == [1], got
    # scalar comparison against grouped subquery stays unsupported-safe
    # (plan-time run or error, never wrong rows): spot the grouped
    # DISTINCT shape
    got = q(tk, "select id from o where exists "
               "(select b from i where i.k = o.k group by b) "
               "order by id")
    assert got == [1, 2, 3, 5], got


def test_not_in_residual_conds_exact(tk):
    """Residual correlated conditions (here `i.b < o.x`) make S_k(t)
    probe-dependent; the pair-expansion path in _naaj_correlated must
    keep full 3VL semantics instead of the old isnotnull guard.
    Per outer row for `x NOT IN (select b from i where i.k = o.k and
    i.id > o.id)` — i rows: (10,1,5),(11,1,3),(12,2,NULL):
      id=1 (k=1, x=5):  S = {5,3}       -> 5 in S    -> FALSE -> drop
      id=2 (k=1, x=7):  S = {5,3}       -> TRUE      -> keep
      id=3 (k=2, x=9):  S = {NULL}      -> NULL      -> drop
      id=4 (k=3, x=9):  S = {}          -> TRUE      -> keep
      id=5 (k=1, x=NULL): S = {5,3}     -> NULL      -> drop
    """
    got = q(tk, "select id from o where x not in "
               "(select b from i where i.k = o.k and i.id > o.id) "
               "order by id")
    assert got == [2, 4], got


def test_not_in_residual_null_probe_empty_group(tk):
    # the case the old guard got wrong: NULL probe value whose
    # residual-filtered group is EMPTY must be KEPT (NOT IN over the
    # empty set is TRUE even for NULL x)
    tk.must_exec("update o set k = 4 where id = 5")   # k=4: no i rows
    got = q(tk, "select id from o where x not in "
               "(select b from i where i.k = o.k and i.id > o.id) "
               "order by id")
    assert got == [2, 4, 5], got


def test_not_in_residual_excludes_null_values(tk):
    # residual cond filters the NULL b row out of k=2's set: S becomes
    # empty -> id=3 must now be kept
    got = q(tk, "select id from o where x not in "
               "(select b from i where i.k = o.k and i.b is not null "
               "and i.id > o.id) order by id")
    assert got == [2, 3, 4], got

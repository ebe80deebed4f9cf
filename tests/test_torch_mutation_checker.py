"""Write-time row/index consistency self-check (VERDICT r3 missing #7;
reference pkg/table/tables/mutation_checker.go + design doc
2021-09-22-data-consistency.md): an injected index corruption must be
caught AT WRITE TIME by the statement that performs it — not later by
ADMIN CHECK TABLE.

The twin of tests/test_mutation_checker.py on tidb_tpu_torch, with device="cpu" at
every store."""
import pytest

from tidb_tpu_torch.testkit import TestKit
from tidb_tpu_torch.executor.table_rt import InconsistentMutationError
from tidb_tpu_torch.utils import failpoint
from tidb_tpu_torch.types.datum import Datum


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
    tk.must_exec("create table mc (id int primary key, k int, "
                 "s varchar(10), key ik (k), unique key us (s))")
    tk.must_exec("insert into mc values (1, 10, 'a'), (2, 20, 'b')")
    yield tk
    failpoint.disable_all()


def test_clean_writes_pass(tk):
    tk.must_exec("insert into mc values (3, 30, 'c')")
    tk.must_exec("update mc set k = 11 where id = 1")
    tk.must_exec("delete from mc where id = 2")
    assert tk.must_query("select count(*) from mc").rows == [(2,)]


def test_corrupt_index_caught_at_write_time(tk):
    def corrupt(datums):
        d = datums[0]
        if not d.is_null and isinstance(d.val, int):
            datums[0] = Datum(d.kind, d.val + 1000, d.scale)
    failpoint.enable("mutation-corrupt-index", corrupt)
    with pytest.raises(Exception) as ei:
        tk.must_exec("insert into mc values (4, 40, 'd')")
    assert "mutation check" in str(ei.value), ei.value
    failpoint.disable("mutation-corrupt-index")
    # the statement failed atomically: no partial row visible
    assert tk.must_query("select count(*) from mc where id = 4").rows \
        == [(0,)]


def test_corrupt_string_index_caught(tk):
    def corrupt(datums):
        d = datums[0]
        if not d.is_null and isinstance(d.val, str):
            datums[0] = Datum(d.kind, d.val + "X", d.scale)
    failpoint.enable("mutation-corrupt-index", corrupt)
    with pytest.raises(Exception) as ei:
        tk.must_exec("insert into mc values (5, 50, 'e')")
    assert "mutation check" in str(ei.value), ei.value


def test_admin_check_not_needed_for_detection(tk):
    """The error type is the dedicated inconsistency error (8141
    analog), distinguishable from a duplicate-key failure."""
    def corrupt(datums):
        d = datums[0]
        if not d.is_null and isinstance(d.val, int):
            datums[0] = Datum(d.kind, d.val + 7, d.scale)
    failpoint.enable("mutation-corrupt-index", corrupt)
    with pytest.raises(InconsistentMutationError):
        tk.must_exec("insert into mc values (6, 60, 'f')")

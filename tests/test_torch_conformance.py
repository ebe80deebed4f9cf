"""The port's builtin conformance table (tidb_tpu_torch/tools/
conformance.py) against the reference's (tidb_tpu/tools/conformance.py):
the twin of tests/test_builtins_ext.py::test_conformance_complete, and
the two tables equal row for row. ~2 s on the CPU."""
import io
import subprocess
import sys
from contextlib import redirect_stdout

from tidb_tpu_torch.tools import conformance


def test_conformance_complete():
    rows = conformance.build_table()
    missing = [n for n, h in rows if h == "MISSING"]
    assert not missing, missing
    assert len(rows) >= 290


def test_table_equals_reference_row_for_row():
    from tidb_tpu.tools import conformance as ref
    assert conformance.build_table() == ref.build_table()
    # the port keeps its own copy of the name snapshot and its rules
    assert conformance.REF_NAMES == ref.REF_NAMES
    assert conformance.ALIASES == ref.ALIASES
    assert conformance.REWRITE_TIME == ref.REWRITE_TIME
    assert conformance.REF_NAMES is not ref.REF_NAMES


def test_main_prints_the_table():
    buf = io.StringIO()
    with redirect_stdout(buf):
        conformance.main()
    out = buf.getvalue()
    n = len(conformance.build_table())
    assert f"**{n} / {n} TiDB function names implemented** (0 missing)" \
        in out
    assert out.count("\n| ") == n + 1          # header + one per name
    assert "Missing:" not in out


def test_module_entry_point_imports_no_jax():
    """`python -m tidb_tpu_torch.tools.conformance` prints the table
    in a process where importing jax fails."""
    code = ("import sys, runpy; sys.modules['jax'] = None; "
            "sys.modules['tidb_tpu'] = None; "
            "sys.argv = ['conformance']; "
            "runpy.run_module('tidb_tpu_torch.tools.conformance', "
            "run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("# Builtin conformance")

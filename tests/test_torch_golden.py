"""Golden-file integration tests through the port (a twin of
tests/test_golden.py): the statements of tests/integration/t/*.test run
through tidb_tpu_torch on the CPU with tidb_tpu_fragment_min_rows = 0,
so every filter and top-n reader DAG takes the device route (the torch
fragments of copr/dag_exec.py) as every aggregation DAG does, and each
file's output must equal the reference's recorded .result. This twin
never writes a .result file."""
import os

import pytest

from tidb_tpu_torch.testkit import TestKit

_DIR = os.path.join(os.path.dirname(__file__), "integration")
NAMES = sorted(f[:-5] for f in os.listdir(os.path.join(_DIR, "t"))
               if f.endswith(".test"))


@pytest.fixture(autouse=True)
def _torch_registries():
    """The shared conftest resets tidb_tpu's registries only."""
    from tidb_tpu_torch.utils import metrics, device_guard, phase
    metrics.reset_all()
    device_guard.reset()
    phase.reset()
    yield


def _run_file(path):
    tk = TestKit(device="cpu")
    tk.must_exec("set tidb_tpu_fragment_min_rows = 0")
    out = []
    sql_acc = ""
    for line in open(path):
        line = line.rstrip("\n")
        if not line.strip() or line.strip().startswith("--"):
            continue
        sql_acc += (" " if sql_acc else "") + line
        if not line.rstrip().endswith(";"):
            continue
        sql = sql_acc
        sql_acc = ""
        out.append(f"> {sql}")
        try:
            rs = tk.sess.execute(sql)
            if rs.names:
                out.append("\t".join(rs.names))
                for row in rs.rows:
                    out.append("\t".join(
                        "NULL" if v is None else str(v) for v in row))
            else:
                out.append(f"ok ({rs.affected} rows affected)")
        except Exception as e:                        # noqa: BLE001
            out.append(f"ERROR: {type(e).__name__}")
    return "\n".join(out) + "\n", tk.domain.metrics


@pytest.fixture(scope="module")
def outputs():
    """{file: (output, its device-route reader DAGs, gated ones)}."""
    out = {}
    for name in NAMES:
        got, m = _run_file(os.path.join(_DIR, "t", name + ".test"))
        out[name] = (got, m.get("copr_device_exec", 0),
                     m.get("copr_fragment_gated", 0))
    return out


@pytest.mark.parametrize("name", NAMES)
def test_golden_through_port(outputs, name):
    got, _routed, gated = outputs[name]
    with open(os.path.join(_DIR, "r", name + ".result")) as f:
        want = f.read()
    assert got == want, f"golden mismatch for {name} through the port"
    assert gated == 0


def test_golden_files_reach_the_device_route(outputs):
    """The files' reader DAGs ran on the device route: over a hundred
    of them, in all but a few files (those without a table scan)."""
    routed = {name: o[1] for name, o in outputs.items()}
    assert sum(routed.values()) >= 100, routed
    assert sum(1 for n in routed.values() if n) >= len(NAMES) - 4, routed

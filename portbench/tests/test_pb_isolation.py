"""Nothing the benchmark runs has the top-level name jax, jaxlib, flax
or tidb_tpu (compared whole: tidb_tpu_torch is not tidb_tpu); the
reference imports nothing of the port either, and a client process
neither torch nor the port."""
import ast
import json
import os
import subprocess
import sys

from portbench.tests.conftest import ROOT, SF

PB = os.path.join(ROOT, "portbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "tidb_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _py(dirpath):
    for dp, _dn, fns in os.walk(dirpath):
        for fn in fns:
            if fn.endswith(".py"):
                yield os.path.join(dp, fn)


def test_reference_imports_neither_jax_nor_the_port():
    for path in _py(os.path.join(PB, "reference")):
        bad = set(_imports(path)) & (FORBIDDEN | {"tidb_tpu_torch",
                                                  "torch"})
        assert not bad, (path, bad)


def test_no_harness_file_imports_jax_or_the_reference_package():
    for path in _py(PB):
        assert not set(_imports(path)) & FORBIDDEN, path


def test_the_names_are_compared_whole():
    from portbench import run
    saved = dict(sys.modules)
    try:
        sys.modules["tidb_tpu_torch_x"] = sys.modules["json"]
        assert "tidb_tpu" not in run.forbidden_modules()
        sys.modules["tidb_tpu.x"] = sys.modules["json"]
        assert "tidb_tpu" in run.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_run_loads_no_forbidden_module():
    """A whole CPU run in a fresh interpreter: the modules it holds at
    the end, by top-level name."""
    code = (
        "import sys, json\n"
        "from portbench import run\n"
        f"res, code = run.run_cell('tpch_sf1.scan', 5, 3.0, False, "
        f"device='cpu', config_patch={{'scale_factor': {SF}}})\n"
        "print(json.dumps([code, res['correct'], "
        "sorted({m.split('.')[0] for m in sys.modules})]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    code, correct, mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert code == 0 and correct
    assert not set(mods) & FORBIDDEN
    assert "tidb_tpu_torch" in mods


def test_client_imports_neither_torch_nor_the_port():
    code = ("import sys, json\nimport portbench.client\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    mods = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not mods & (FORBIDDEN | {"torch", "tidb_tpu_torch", "numpy"})

"""Every module of the reference package (tidb_tpu/) has its
counterpart in the port (tidb_tpu_torch/): the same path, or one of the
two named replacements. ~1 s on the CPU."""
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# reference module -> the port's replacement (paths under each package)
REPLACED = {
    "ops/pallas_scan.py": ("ops/scan_kernels.py", "ops/csrc/scan_kernels.cu"),
    "utils/jaxcfg.py": ("utils/torchcfg.py",),
}


def _modules(pkg):
    base = os.path.join(ROOT, pkg)
    out = set()
    for d, dirs, files in os.walk(base):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        out |= {os.path.relpath(os.path.join(d, f), base).replace(
            os.sep, "/") for f in files if f.endswith(".py")}
    return out


def test_every_reference_module_has_a_counterpart():
    ref, port = _modules("tidb_tpu"), _modules("tidb_tpu_torch")
    missing = sorted(m for m in ref - port if m not in REPLACED)
    assert not missing, missing


def test_named_replacements_exist_and_are_replacements():
    ref, port = _modules("tidb_tpu"), _modules("tidb_tpu_torch")
    for old, new in REPLACED.items():
        assert old in ref and old not in port, old
        for path in new:
            assert os.path.exists(os.path.join(ROOT, "tidb_tpu_torch", path))


def test_last_modules_present():
    """The modules this slice closes the list with."""
    port = _modules("tidb_tpu_torch")
    for m in ("tools/conformance.py", "tools/tpulint/__init__.py",
              "tools/tpulint/cli.py", "tools/tpulint/rules/hostsync.py",
              "tools/tpulint/rules/dispatch.py",
              "tools/tpulint/rules/purity.py"):
        assert m in port, m

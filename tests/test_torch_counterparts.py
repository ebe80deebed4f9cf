"""Every module of the reference package (tidb_tpu/) has its
counterpart in the port (tidb_tpu_torch/): the same path, or one of the
two named replacements. Every gate script of the reference
(scripts/*_smoke.py) has a tool of the port
(tidb_tpu_torch/tools/*_smoke.py), and every reference test file a
tests/test_torch_* twin, or a named reason. ~1 s on the CPU."""
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


# reference gate script -> why the port has no tool of its own
SCRIPT_REASONS = {
    "soak_replication.py": "writes the JAX package's REPLICATION_SOAK.json; "
                           "queued for after the port's benchmark",
    "fence_proof.py": "a one-off proof that a TPU program is not "
                      "recompiled",
}
# reference test file -> why no test_torch_* file twins it
TEST_REASONS = {
    "test_bench_replay.py": "tests the JAX package's TPU bench driver "
                            "(bench.py), which the port's own benchmark "
                            "replaces",
}
# reference test files whose twins carry another name
TWIN_NAMES = {
    "test_delta_maintenance.py": "test_torch_htap.py",
    "test_replica_fabric.py": "test_torch_replica.py",
    "test_device_residency.py": "test_torch_residency.py",
    "test_backup_restore.py": "test_torch_backup.py",
    "test_tools.py": "test_torch_backup.py",
    "test_builtins_ext.py": "test_torch_conformance.py",
    "test_runs_policy.py": "test_torch_sort_agg.py",
}


def test_every_gate_script_has_a_tool():
    scripts = {f for f in os.listdir(os.path.join(ROOT, "scripts"))
               if f.endswith("_smoke.py")} | set(SCRIPT_REASONS)
    tools = _modules("tidb_tpu_torch")
    missing = sorted(s for s in scripts if s not in SCRIPT_REASONS and
                     f"tools/{s}" not in tools)
    assert not missing, missing
    for s in SCRIPT_REASONS:
        assert os.path.exists(os.path.join(ROOT, "scripts", s)), s


def test_every_reference_test_file_has_a_twin():
    tests = os.path.join(ROOT, "tests")
    names = set(os.listdir(tests))
    ref = sorted(f for f in names if f.startswith("test_") and
                 f.endswith(".py") and not f.startswith("test_torch_"))
    missing = []
    for f in ref:
        if f in TEST_REASONS:
            continue
        twin = TWIN_NAMES.get(f, "test_torch_" + f[len("test_"):])
        if twin not in names:
            missing.append(f)
    assert not missing, missing
    for f in list(TEST_REASONS) + list(TWIN_NAMES):
        assert f in names, f

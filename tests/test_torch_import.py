"""The PyTorch port imports without jax, in every module.

tests/conftest.py imports jax into this process, so the check runs in a
subprocess with sys.modules["jax"] = None: any `import jax` anywhere in the
port then raises ImportError."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "goldpolish_tpu_torch")

_SCRIPT = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.path.insert(0, {root!r})
import goldpolish_tpu_torch as p
names = [
    m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + ".")
    if m.ispkg or m.module_finder.find_spec(m.name).origin.endswith(".py")
]  # the built native .so sits in the tree but is no Python module
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m.startswith("goldpolish_tpu.") or m == "goldpolish_tpu")
assert not leaked, leaked
print(" ".join(names))
"""

# the modules each slice added; every one must be among those imported
_SLICE_MODULES = [
    "ops.scan_conv", "ops.bloom_probe", "polish.ntedit_gpu", "pipeline.bulk",
    "ops.kmers", "ops.dbg_bfs", "fill", "fill.nw", "fill.konnector",
    "fill.extend", "fill.sealer", "polish.reports", "ops.scan_eval",
    "ops.bloom_sort", "ops.nthash_device", "ops.bloom_device", "ops.siteeval_device",
    "ops.dbg_extend", "mapper", "pipeline.targeted", "tools", "tools.bf",
    "tools.ntedit", "tools.sealer", "tools.mask", "tools.to_upper",
    "parallel.distributed", "parallel.mesh",
]


def test_every_module_imports_without_jax():
    res = subprocess.run(
        [sys.executable, "-c", _SCRIPT.format(root=ROOT)],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
    )
    assert res.returncode == 0, res.stderr
    names = res.stdout.strip().splitlines()[-1].split()
    assert len(names) >= 38
    missing = [m for m in _SLICE_MODULES if f"goldpolish_tpu_torch.{m}" not in names]
    assert not missing, missing


# the scripts at the repository's root that run the port on the card
_ROOT_SCRIPTS = ["chip_smoke.py", "chip_trace.py"]


def _source_files():
    for dirpath, dirs, files in os.walk(PKG):
        dirs[:] = [d for d in dirs if d != "build"]  # build outputs, not source
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    for name in _ROOT_SCRIPTS:
        yield os.path.join(ROOT, name)


def test_no_jax_import_in_source():
    hits = []
    paths = list(_source_files())
    assert all(os.path.exists(p) for p in paths[-len(_ROOT_SCRIPTS):])
    for path in paths:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                s = line.strip()
                if s.startswith(("import jax", "from jax")) or (
                    s.startswith(("import goldpolish_tpu", "from goldpolish_tpu"))
                    and not s.startswith(("import goldpolish_tpu_torch",
                                          "from goldpolish_tpu_torch"))
                ):
                    hits.append(f"{path}:{i}: {s}")
    assert not hits, hits

"""No module under gpbench/ has the top-level name jax, jaxlib, flax or
goldpolish_tpu: every module of the harness and its reference imported in
a fresh process, whose sys.modules is then read by whole top-level names
(goldpolish_tpu_torch begins with goldpolish_tpu, so a prefix test would
be wrong)."""

import os
import subprocess
import sys
import types

import pytest

from ._tiny import run_cell

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))

SCRIPT = r"""
import importlib, os, pkgutil, sys
sys.path.insert(0, sys.argv[1])
import gpbench
names = ["gpbench.run", "gpbench.harness", "gpbench.generate"]
for sub in ("reference", "metrics", "kernels"):
    pkg = importlib.import_module("gpbench." + sub)
    names += ["gpbench.%s.%s" % (sub, m.name) for m in pkgutil.iter_modules(pkg.__path__)]
for n in names:
    importlib.import_module(n)
from gpbench import harness
# the harness's check is the same test
print(len(names), harness.forbidden_modules())
tops = {m.split(".")[0] for m in sys.modules}
print(sorted(tops & {"jax", "jaxlib", "flax", "goldpolish_tpu"}))
"""


def test_no_jax_in_the_benchmark():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", SCRIPT, ROOT], capture_output=True,
                         text=True, env=env, timeout=300, check=True).stdout.split("\n")
    assert int(out[0].split()[0]) > 20
    assert out[0].endswith("[]") and out[1] == "[]"


def test_the_check_sees_a_jax_package():
    """harness.forbidden_modules names goldpolish_tpu when it is loaded, and
    not goldpolish_tpu_torch."""
    from gpbench import harness

    saved = sys.modules.get("goldpolish_tpu")
    sys.modules["goldpolish_tpu_torch_dummy"] = object()
    try:
        sys.modules.pop("goldpolish_tpu", None)
        assert "goldpolish_tpu" not in harness.forbidden_modules()
        sys.modules["goldpolish_tpu"] = object()
        assert "goldpolish_tpu" in harness.forbidden_modules()
    finally:
        sys.modules.pop("goldpolish_tpu_torch_dummy")
        sys.modules.pop("goldpolish_tpu")
        if saved is not None:
            sys.modules["goldpolish_tpu"] = saved


@pytest.mark.parametrize("where,trace", [("reference", 0), ("read_metrics", 1)])
def test_a_jax_module_loaded_after_the_window_gives_no_result(monkeypatch, where, trace):
    """A forbidden module that the reference or a metric reader loads, once
    the window has closed, still stops the run: exit 3, no result line, and
    the module named on standard error."""
    from gpbench import harness

    owner = harness.Runner if where == "reference" else harness
    inner = getattr(owner, where)

    def planted(*a, **kw):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return inner(*a, **kw)

    monkeypatch.setattr(owner, where, planted)
    rc, res, err = run_cell("ecoli_bulk.ont_draft", 2**31 + 41, 0.5, trace)
    assert rc == 3 and res is None
    assert "forbidden modules loaded: ['jax']" in err

"""No run loads JAX or the JAX package, compared by whole top-level name;
the guard in ``run.py`` refuses a run that did."""

import ast
import subprocess
import sys
import types

import pytest

from helpers import ROOT, run_module, tiny_run

FORBIDDEN = {"jax", "jaxlib", "flax", "dpdfnet_tpu"}


def test_a_run_loads_no_jax_module():
    code = ("import sys; sys.path.insert(0, 'benchmark/tests'); import helpers; "
            "out = helpers.tiny_run('dn2.live'); assert out['correct']; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    tops = set(eval(p.stdout.strip().splitlines()[-1]))
    assert "dpdfnet_tpu_torch" in tops
    assert not tops & FORBIDDEN


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    run = run_module()
    monkeypatch.setitem(sys.modules, "dpdfnet_tpu_torch_extra", types.ModuleType("x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert run.forbidden_modules() == ["jax"]


def test_a_run_with_jax_loaded_is_refused(monkeypatch):
    monkeypatch.setitem(sys.modules, "dpdfnet_tpu.config", types.ModuleType("c"))
    with pytest.raises(RuntimeError, match="dpdfnet_tpu"):
        tiny_run("dn2.live")


def test_no_benchmark_source_imports_jax():
    for f in sorted((ROOT / "benchmark").rglob("*.py")):
        tree = ast.parse(f.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom) and node.level == 0
                     else [])
            assert not {n.split(".")[0] for n in names} & FORBIDDEN, (f, names)

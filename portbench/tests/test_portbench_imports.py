"""Nothing the benchmark runs loads ``jax`` or the JAX package ``repro``
(compared by whole top-level name: ``repro_torch`` is not ``repro``), and
nothing under ``portbench/`` reads the JAX package's old benchmark."""
from __future__ import annotations

import ast
import subprocess
import sys

from conftest import ROOT

from portbench import run, spec

SOURCES = sorted(p for p in spec.HERE.rglob("*.py") if "tests" not in p.parts)


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    assert run.FORBIDDEN == ("jax", "jaxlib", "flax", "repro")
    for name in ("repro", "jax"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert run.forbidden_modules() == ["repro"]


def test_no_source_imports_a_forbidden_module():
    for path in SOURCES:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                tops = [node.module.split(".")[0]]
            else:
                continue
            assert not set(tops) & set(run.FORBIDDEN), (path, tops)


def test_no_source_reads_the_old_benchmark():
    old = ("bench" + "marks/", "BENCH" + "_")
    for path in SOURCES:
        text = path.read_text()
        assert not any(o in text for o in old), path


def test_a_whole_run_loads_no_forbidden_module(tmp_path):
    """A run in a fresh process, every reader and the sweep and control
    scripts imported, then ``sys.modules`` compared."""
    code = f"""
import sys
sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}, {str(ROOT / 'portbench' / 'tests')!r}]
from conftest import tiny_base
from portbench import run, spec, sweep, control
bench, base = tiny_base({str(tmp_path)!r})
res = run.run(bench, "tiny", 5, 1.0, True, device="cpu", base=base, say=lambda l: None)
for p in (spec.HERE / "metrics").glob("*.py"):
    spec.metric(p.name[:-3])
print("FORBIDDEN", run.forbidden_modules(), res["correct"])
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN [] True" in out.stdout

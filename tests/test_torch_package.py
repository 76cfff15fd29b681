"""The port stands alone: no file of ``src/repro_torch/`` or
``chip_smoke.py`` imports ``jax`` or ``repro``, and every submodule
imports with ``jax``, ``repro`` and ``triton`` blocked and no ``nvcc``.
"""
import ast
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "repro")


def _banned(name: str) -> bool:
    return any(name == b or name.startswith(b + ".") for b in BANNED)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              == "import_module" and node.args):
            arg = node.args[0]          # import_module("x") / f"x.{y}"
            if isinstance(arg, ast.JoinedStr):
                arg = arg.values[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                yield arg.value


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_or_repro_imports(path):
    bad = [name for name in _imports(path) if _banned(name)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


MODULES = sorted(
    ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
        [str(PKG)], prefix="repro_torch.")])
#: the subpackages each slice added; walk_packages must reach all of them
SUBPACKAGES = ("configs", "core", "kernels", "launch", "models", "obs",
               "profiling", "serve")


def test_module_list_covers_every_subpackage():
    for sub in SUBPACKAGES:
        assert f"repro_torch.{sub}" in MODULES
    for path in SOURCES[:-1]:
        rel = path.relative_to(PKG.parent).with_suffix("")
        name = ".".join(rel.parts).removesuffix(".__init__")
        assert name in MODULES, name

_PROBE = """
import importlib, json, sys
for name in ("jax", "jaxlib", "repro", "triton"):
    sys.modules[name] = None            # any import of these now fails
results = {}
for mod in json.loads(sys.argv[1]):
    try:
        importlib.import_module(mod)
        results[mod] = "ok"
    except Exception as exc:            # report every module's failure
        results[mod] = f"{type(exc).__name__}: {exc}"
print(json.dumps(results))
"""


@pytest.fixture(scope="module")
def blocked_imports():
    """Import every submodule in one fresh interpreter with jax, repro and
    triton blocked and a PATH without nvcc."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), PATH="/usr/bin:/bin",
               CUDA_HOME=str(ROOT / "no-cuda-here"))
    out = subprocess.run([sys.executable, "-c", _PROBE, json.dumps(MODULES)],
                         env=env, capture_output=True, text=True, timeout=120,
                         check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", MODULES)
def test_imports_without_jax_repro_triton_nvcc(blocked_imports, module):
    assert blocked_imports[module] == "ok", blocked_imports[module]


def test_kernel_sources_present():
    csrc = PKG / "kernels" / "csrc"
    names = ("flash_attention", "decode_attention", "slowdown", "search",
             "stream")
    assert {p.name for p in csrc.glob("*.cu")} == {f"{n}.cu" for n in names}
    from repro_torch.kernels import _build
    for name in names:
        lib = _build.library_path(name)
        assert lib.parent == _build.BUILD_DIR and name in lib.name


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Alone in a directory, or without a card, the script fails and
    prints no result."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, str(alone)], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout

"""Finds what ``BENCHMARK.json`` names, each in a file of its own:

* a configuration ``<name>``: ``configs/<name>.json`` (its tenants, the
  sizes each is run at, the reference that checks it, the limit of each
  compared number, and for a gateway deployment the gateway's settings);
* a traffic mix ``<name>``: ``traffic/<name>.json`` (read by
  :mod:`portbench.traffic`);
* a per-layer metric ``<name>``: ``metrics/<name>.py``, whose
  ``read(record)`` returns the metric's value, or ``None`` where the run
  has nothing for it to read (the metric is then left out of the line);
* a reference ``<name>``: ``references/<name>.py``, with a ``Reference``
  class and a ``names(arch)`` function.

``base`` is this folder; the tests point it at a copy with files added.
A new cell, mix or metric is new files and a new ``BENCHMARK.json`` entry,
never an edit of a file that is here.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path) -> dict:
    return load_json(Path(root) / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{', '.join(w['name'] for w in bench['workloads'])}")


def config(name: str, base: Path = HERE) -> dict:
    return load_json(Path(base) / "configs" / f"{name}.json")


def traffic(name: str, base: Path = HERE) -> dict:
    return load_json(Path(base) / "traffic" / f"{name}.json")


def _module(path: Path, label: str):
    if not path.is_file():
        raise FileNotFoundError(f"{label}: no file {path}")
    sp = importlib.util.spec_from_file_location(
        f"portbench_{label}_{path.stem}".replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod


def metric(name: str, base: Path = HERE):
    """The reader module of per-layer metric ``name``."""
    mod = _module(Path(base) / "metrics" / f"{name}.py", "metric")
    if not callable(getattr(mod, "read", None)):
        raise TypeError(f"metrics/{name}.py has no read(record)")
    return mod


def reference(name: str, base: Path = HERE):
    return _module(Path(base) / "references" / f"{name}.py", "reference")


def _reported(entry: dict, cell_name: str) -> bool:
    return "workloads" not in entry or cell_name in entry["workloads"]


def end_to_end(bench: dict, cell_name: str) -> list[dict]:
    """The end-to-end metrics cell ``cell_name`` reports."""
    return [m for m in bench["end_to_end"] if _reported(m, cell_name)]


def per_layer(bench: dict, cell_name: str) -> list[dict]:
    """The per-layer metrics cell ``cell_name`` reports: those that list
    it, and those without a list whose end-to-end metric it reports."""
    mine = {m["name"] for m in end_to_end(bench, cell_name)}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in mine)]

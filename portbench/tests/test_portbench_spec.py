"""``BENCHMARK.json`` against its contract, and every name it gives found
in a file of its own; a new cell, mix and metric taken up from new files
alone."""
from __future__ import annotations

import hashlib
import json
import re

import pytest
from conftest import ROOT, tiny_base

from portbench import harness, run, spec

BENCH = spec.benchmark(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_entries_keep_their_keys_and_names():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                           "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                           "layer", "moves"}
        assert m["source"] in SOURCES
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_what_it_must():
    assert [w["name"] for w in BENCH["workloads"]] == [
        "cohost.chat", "nemotron-4-15b.decode", "nemotron-4-15b.longprompt"]
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in spec.end_to_end(BENCH, w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = spec.per_layer(BENCH, w["name"])
        assert layer
        for m in layer:
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_every_entry_resolves_by_name():
    for c in BENCH["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        cfg = spec.config(c["name"])
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert hasattr(spec.reference(cfg["reference"]), "Reference")
    for w in BENCH["workloads"]:
        cfg, mix = spec.config(w["config"]), spec.traffic(w["traffic"])
        assert {t["model"] for t in cfg["tenants"]} == set(mix["tenants"])
    for m in BENCH["per_layer"]:
        assert callable(spec.metric(m["name"]).read)
    used = {c["name"] for c in BENCH["configs"]}
    assert used == {w["config"] for w in BENCH["workloads"]}


def test_every_file_loads():
    for p in (spec.HERE / "configs").glob("*.json"):
        assert spec.config(p.stem)["tenants"]
    for p in (spec.HERE / "traffic").glob("*.json"):
        assert spec.traffic(p.stem)["process"] in ("poisson", "bursty",
                                                    "closed")
    for p in (spec.HERE / "metrics").glob("*.py"):
        assert callable(spec.metric(p.name[:-3]).read)
    with pytest.raises(FileNotFoundError):
        spec.metric("no_such_metric")
    with pytest.raises(KeyError):
        spec.cell(BENCH, "no_such_cell")


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_configs_hold_the_ports_sizes(config):
    """Nothing is cut (``reduced`` is empty), so every size the file
    states is the port's own configuration's."""
    from repro_torch import configs
    cfg = spec.config(config)
    assert cfg["reduced"] == []
    for t in cfg["tenants"]:
        port = configs.get(t["model"])
        for k in harness.ARCH_KEYS:
            assert getattr(port, k) == t["arch"][k], (t["model"], k)
        assert t["max_logit_gap"] > 0


def _digest(folder):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_cell_mix_and_metric_from_new_files_alone(tmp_path):
    before = _digest(spec.HERE)
    bench, base = tiny_base(tmp_path)
    # a new configuration, mix and metric: new files, and entries naming them
    cfg = json.loads((base / "configs" / "tiny.json").read_text())
    (base / "configs" / "tiny2.json").write_text(json.dumps(
        dict(cfg, name="tiny2")))
    mix = json.loads((base / "traffic" / "tiny.json").read_text())
    (base / "traffic" / "burst2.json").write_text(json.dumps(
        dict(mix, process="bursty", calm_rps=5.0, burst_rps=40.0,
             calm_s=0.5, burst_s=0.25)))
    (base / "metrics" / "requests_started.ttft.py").write_text(
        "def read(rec):\n"
        "    return sum(1 for v in rec['tracks'].values() for t in v\n"
        "               if t.stamps and t.stamps[0] <= rec['measured_end'])\n")
    bench["workloads"].append({"name": "tiny2.burst", "config": "tiny2",
                               "traffic": "burst2", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "requests_started.ttft", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "engine", "moves": "ttft_p95_ms",
                               "workloads": ["tiny2.burst"]})
    res = run.run(bench, "tiny2.burst", 11, 2.0, True, device="cpu",
                  base=base, say=lambda line: None)
    assert res["correct"]
    assert res["metrics"]["requests_started.ttft"]["value"] > 0
    assert _digest(spec.HERE) == before

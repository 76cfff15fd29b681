"""Port parity: the roofline terms, report and one-H100 dry run
(``repro_torch.analysis``, ``repro_torch.launch.dryrun``) against
``repro``.

``analyze`` and ``analytic_hbm_bytes`` are copies: with ``repro``'s
constants set to the card's they give the reference's numbers.  The dry
run's bytes are checked against models and caches built on the CPU, its
FLOPs against 6·N·tokens, and its report and CLI end to end.
"""
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from repro.analysis import roofline as jroof
from repro.configs.base import SHAPES as JSHAPES
from repro import configs as jconfigs
from repro_torch import configs as tconfigs
from repro_torch.analysis import report, roofline
from repro_torch.configs.base import SHAPES, ShapeCell
from repro_torch.launch import dryrun
from repro_torch.models import build
from repro_torch.train import optimizer as topt
from repro_torch.train.checkpoint import flatten

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def card_constants(monkeypatch):
    for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW"):
        monkeypatch.setattr(jroof, name, getattr(roofline, name))


def test_card_constants():
    assert roofline.PEAK_FLOPS == 989e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.HBM_BYTES == 80e9


@pytest.mark.parametrize("kind,useful", [("train", None), ("prefill", None),
                                         ("decode", 3e9), ("decode", None)])
@pytest.mark.parametrize("coll", [0.0, 5e8])
def test_analyze_matches_reference(card_constants, kind, useful, coll):
    cost = {"flops": 3.2e14, "bytes accessed": 9.1e11}
    jr = jroof.analyze(cost, jroof.CollectiveStats({"all-reduce": 2}, coll,
                                                   coll), 4, 5.5e14, useful,
                       kind)
    tr = roofline.analyze(cost, roofline.CollectiveStats(
        {"all-reduce": 2}, coll, coll), 4, 5.5e14, useful, kind)
    want, got = jroof.to_dict(jr), roofline.to_dict(tr)
    assert set(got) == set(want)
    for k in want:
        if k != "what_would_help":          # the card's words, not a TPU's
            assert got[k] == want[k], k


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_analytic_hbm_bytes_matches_reference(arch, shape):
    assert roofline.analytic_hbm_bytes(tconfigs.get(arch), SHAPES[shape]) \
        == jroof.analytic_hbm_bytes(jconfigs.get(arch), JSHAPES[shape])


def test_mixer_flops_is_the_reference_formula_on_one_card():
    from repro.launch import dryrun as jdry
    for arch in tconfigs.ARCHS:
        for shape in SHAPES:
            assert dryrun.mixer_flops(tconfigs.get(arch), SHAPES[shape]) \
                == pytest.approx(256.0 * jdry.mixer_flops(
                    jconfigs.get(arch), JSHAPES[shape]), rel=1e-12)


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
@pytest.mark.parametrize("layout", ["serve", "train"])
def test_weight_bytes_equal_a_model_on_the_cpu(arch, layout):
    cfg = tconfigs.get(arch).reduced()
    model = build(cfg, device="cpu", layout=layout)
    held = (model.parameters() if layout == "serve"
            else model.leaves.values())
    assert dryrun.weight_bytes(cfg, layout) == sum(
        p.numel() * p.element_size() for p in held)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "recurrentgemma-9b",
                                  "rwkv6-7b", "llama3.2-3b"])
def test_cache_bytes_equal_caches_on_the_cpu(arch):
    cfg = dataclasses.replace(tconfigs.get(arch).reduced(),
                              kv_cache_dtype="int8"
                              if arch == "llama3.2-3b" else "float32")
    caches = build(cfg, device="cpu").init_cache(3, 40)
    assert dryrun.cache_bytes(cfg, 3, 40) == sum(
        t.numel() * t.element_size() for t in flatten(caches).values())


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "dbrx-132b"])
def test_optimizer_bytes_equal_the_state_on_the_cpu(arch):
    cfg = tconfigs.get(arch).reduced()
    model = build(cfg, device="cpu", layout="train")
    state = topt.make(cfg.optimizer, 1e-3).init(model.leaves)
    assert dryrun.optimizer_bytes(cfg, model.leaves) == sum(
        t.numel() * t.element_size() for t in flatten(state).values())
    mem = dryrun.train_memory(cfg, ShapeCell("t", 16, 4, "train"))
    W = dryrun.weight_bytes(cfg, "train")
    assert mem["weights_bytes"] == mem["grads_bytes"] == W
    assert mem["peak_bytes"] > 2 * W + mem["optimizer_bytes"]


@pytest.mark.parametrize("arch,untied", [("llama3.2-3b", False),
                                         ("stablelm-1.6b", True)])
@pytest.mark.parametrize("seq", [16, 64])
def test_train_flops_near_6nd(arch, untied, seq):
    """Counted forward + backward matrix products plus the mixers lie
    within 10% of 6·N·tokens plus the mixers.  The token table's lookup
    is no matrix product: a tied model's table is counted through the
    head, an untied one's not at all, so N leaves it out there."""
    cfg = tconfigs.get(arch).reduced()
    cell = ShapeCell("t", seq, 4, "train")
    n = cfg.n_params() - (cfg.vocab * cfg.d_model if untied else 0)
    want = 6 * n * cell.global_batch * seq + dryrun.mixer_flops(cfg, cell)
    got = dryrun.matmul_flops(cfg, cell) + dryrun.mixer_flops(cfg, cell)
    assert got == pytest.approx(want, rel=0.10)
    fwd = dryrun.matmul_flops(cfg, cell, backward=False)
    assert got - dryrun.mixer_flops(cfg, cell) == pytest.approx(3 * fwd)


def test_flop_probe_reconstructs_full_depth():
    cfg = dataclasses.replace(tconfigs.get("recurrentgemma-9b").reduced(),
                              n_layers=7)
    cell = ShapeCell("p", 32, 2, "prefill")
    assert dryrun.matmul_flops(cfg, cell) == pytest.approx(
        dryrun._probe(cfg, cell, False))


def test_deepest_depth_and_largest_batch_are_the_verdict():
    cfg = tconfigs.get("stablelm-1.6b")
    cell = ShapeCell("t", 1024, 8, "train")
    depth = dryrun.deepest_depth(
        cfg, lambda c: dryrun.train_memory(c, cell)["peak_bytes"])
    assert depth == cfg.n_layers
    tiny = 30e9
    d = dryrun.deepest_depth(
        cfg, lambda c: dryrun.train_memory(c, cell)["peak_bytes"], tiny)
    assert 0 <= d < cfg.n_layers
    fits = lambda n: dryrun.train_memory(             # noqa: E731
        dataclasses.replace(cfg, n_layers=n), cell)["peak_bytes"] <= tiny
    assert fits(d) and not fits(d + 1)
    b = dryrun.largest_batch(cfg, cell)
    mem = lambda n: dryrun.memory(cfg, dataclasses.replace(  # noqa: E731
        cell, global_batch=n))["peak_bytes"]
    assert b >= 8 and mem(b) <= roofline.HBM_BYTES < mem(b + 1)


def test_report_renders_the_ports_artifacts(tmp_path):
    dryrun.run(["stablelm-1.6b", "rwkv6-7b"], list(SHAPES), tmp_path,
               log=lambda _: None)
    recs = report.load(tmp_path)
    assert len(recs) == 8
    rec = recs[("rwkv6-7b", "decode_32k")]
    assert rec["status"] == "ok" and rec["memory"]["fits"]
    skip = recs[("stablelm-1.6b", "long_500k")]
    assert skip["status"] == "skip"
    text = report.summary_stats(recs) + report.roofline_table(recs) \
        + report.dryrun_table(recs)
    assert "| rwkv6-7b | decode_32k | ok |" in text
    assert "| stablelm-1.6b | long_500k | SKIP |" in text
    table = report.dryrun_table(recs).splitlines()
    assert len(table) == 2 + len(report.ARCH_ORDER)
    row = next(r for r in table if r.startswith("| rwkv6-7b |"))
    m = rec["memory"]
    assert (f"{m['peak_estimate_gb']:.1f} yes; {m['deepest_depth']}/"
            f"{m['n_layers']}; {m['largest_batch']}") in row
    assert not row.endswith("| SKIP |")
    assert next(r for r in table if r.startswith("| stablelm-1.6b |")
                ).endswith("| SKIP |")
    assert "MISSING" in report.dryrun_table(recs)      # the other archs


def test_cli_one_arch_all_shapes_in_seconds(tmp_path):
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "dbrx-132b", "--shape", "all", "--out", str(tmp_path)],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin"},
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert time.perf_counter() - t0 < 60
    assert "dry-run complete." in proc.stdout
    rec = json.loads((tmp_path / "dbrx-132b_train_4k_h100.json").read_text())
    assert rec["memory"]["fits"] is False
    assert rec["roofline"]["t_collective_ms"] == 0.0
    assert len(list(tmp_path.glob("*.json"))) == 4

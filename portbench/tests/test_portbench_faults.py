"""``correct`` comes out false when the timed path is broken underneath,
once for each fault a serving cell can have, and when the control (the
reference through float8) stands in the program's place.  The runs skip
the harness's look for a card and drive the rest of a run on the CPU, at
the tiny cell's size.  (A cell on one chip has no exchange between chips
to leave out.)"""
from __future__ import annotations

import json

import pytest

from portbench import run


def _run(bench, base, seed=21, trace=False, **kw):
    return run.run(bench, "tiny", seed, 2.0, trace, device="cpu", base=base,
                   say=lambda line: None, **kw)


def _compare_everything(base):
    """Every finished request in the sample, so that a fault in any slot
    is seen."""
    path = base / "traffic" / "tiny.json"
    mix = json.loads(path.read_text())
    path.write_text(json.dumps(dict(mix, check_tokens=1_000_000)))


def test_sound_runs_are_correct(tiny):
    bench, base = tiny
    res = _run(bench, base)
    assert res["correct"] and res["failed"] == 0
    c = res["checks"]["gap.nemotron-4-15b"]
    assert c["value"] <= c["limit"] and c["tokens"] >= 64
    assert list(res)[-1] == "checks"


def _token_altered(monkeypatch):
    from repro_torch.serve import engine
    orig = engine.DecodeGraph.__call__

    def call(self, last_tok, lengths):
        out = orig(self, last_tok, lengths).clone()
        out[:, 0, 3] = out.max() + 1.0          # every row now picks token 3
        return out
    monkeypatch.setattr(engine.DecodeGraph, "__call__", call)


def _state_unchanged(monkeypatch):
    from repro_torch.models import kvcache
    monkeypatch.setattr(kvcache, "insert", lambda layer, *a, **k: layer)


def _half_batch(monkeypatch):
    from repro_torch.serve import engine
    orig = engine.DecodeGraph.__call__

    def call(self, last_tok, lengths):
        out = orig(self, last_tok, lengths).clone()
        half = out.shape[0] // 2
        out[half:] = out[:out.shape[0] - half]  # the upper half never computed
        return out
    monkeypatch.setattr(engine.DecodeGraph, "__call__", call)


@pytest.mark.parametrize("fault", [_token_altered, _state_unchanged,
                                   _half_batch])
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, fault):
    bench, base = tiny
    _compare_everything(base)
    fault(monkeypatch)
    res = _run(bench, base)
    assert not res["correct"] and res["failed"] > 0
    c = res["checks"]["gap.nemotron-4-15b"]
    assert c["value"] > c["limit"]


@pytest.mark.parametrize("seed", [31, 32, 33])
def test_the_control_is_not_correct(tiny, seed):
    """The reference computed through float8 (the nearest precision below
    the configuration's bfloat16), put in the program's place, comes out
    not correct on every seed, where the program's own tokens of the same
    run are correct."""
    bench, base = tiny
    res = _run(bench, base, seed=seed, control="fp8")
    assert not res["correct"] and res["failed"] > 0
    c = res["checks"]["gap.nemotron-4-15b"]
    assert c["program"] <= c["limit"] < c["value"]


def test_a_traced_run_is_correct_and_reads_its_metrics(tiny):
    bench, base = tiny
    res = _run(bench, base, trace=True)
    assert res["correct"]
    assert {"decode_step_ms.tps", "prefill_ms_per_ktok.ttft",
            "mfu.tps"} <= set(res["metrics"])
    # no device here: the trace's readers find nothing and stay out
    assert "idle_share.tps" not in res["metrics"]
    assert res["device"]["window_s"] > 0 and "breakdown" in res

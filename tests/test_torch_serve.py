"""Port parity: repro_torch's ServingEngine vs repro's, and the port's
serve launcher.

Both engines serve reduced stablelm-1.6b with the same weights (repro's
``Model.init``, carried across by ``params_from_jax``) on the CPU in
float32; greedy decoding must give identical tokens.
"""
import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build as jbuild
from repro.serve import engine as jengine
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.models import build as tbuild
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import engine as tengine

ARCH = "stablelm-1.6b"
PROMPT_LENS = (8, 13, 8)
MAX_NEW = 6


@pytest.fixture(scope="module")
def served():
    jcfg = jconfigs.get(ARCH).reduced()
    tcfg = tconfigs.get(ARCH).reduced()
    jm = jbuild(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tm = tbuild(tcfg, device="cpu")
    tm.load_state_dict(params_from_jax(tcfg, jax.tree.map(np.asarray,
                                                          params)))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab, size=n) for n in PROMPT_LENS]
    jeng = jengine.ServingEngine(jm, params, max_slots=4, capacity=64)
    teng = tengine.ServingEngine(tm, max_slots=4, capacity=64)
    for eng in (jeng, teng):
        for p in prompts:
            eng.submit(p, max_new=MAX_NEW)
        eng.run_until_drained()
    return jeng, teng, tm


def test_greedy_tokens_identical(served):
    jeng, teng, _ = served
    want = {r.rid: r.tokens for r in jeng.completed}
    got = {r.rid: r.tokens for r in teng.completed}
    assert len(got) == len(PROMPT_LENS)
    assert all(len(t) == MAX_NEW for t in got.values())
    assert got == want


def test_metrics_shape_and_counters(served):
    jeng, teng, _ = served
    assert tengine.METRIC_KEYS == jengine.METRIC_KEYS
    m, jm = teng.metrics(), jeng.metrics()
    assert tuple(m) == jengine.METRIC_KEYS
    for key in ("steps", "active", "queue_depth", "admitted", "completed",
                "deferred", "tokens_out"):
        assert m[key] == jm[key], key
    assert m["last_step_ms"] > 0 and m["mean_step_ms"] > 0
    assert not teng.has_work


def test_admission_gate_defers_fifo(served):
    _, _, tm = served
    eng = tengine.ServingEngine(tm, max_slots=2, capacity=32,
                                admission_gate=lambda req: req.rid == 0)
    for n in (5, 6, 7):
        eng.submit(np.arange(n), max_new=2)
    eng.step()
    assert eng.counters.admitted == 1 and eng.counters.deferred == 1
    assert eng.metrics()["queue_depth"] == 2


def test_launcher_serves_on_cpu(capsys):
    assert tserve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                        "--requests", "2", "--max-new", "3"]) == 0
    assert "served 2 requests, 6 tokens" in capsys.readouterr().out


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--arch", ARCH, "--reduced", "--requests", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tbuild(tconfigs.get(ARCH).reduced())


@pytest.mark.parametrize("flags", [["--gateway"], ["--fleet"],
                                   ["--co-arch", "llama3.2-3b"]])
def test_unported_modes_exit_nonzero(flags, capsys):
    with pytest.raises(SystemExit) as exc:
        tserve.main(["--arch", ARCH, "--device", "cpu", *flags])
    assert exc.value.code != 0
    assert "ROADMAP.md" in capsys.readouterr().err


def test_encoder_only_has_no_decode_service():
    assert tserve.main(["--arch", "hubert-xlarge", "--reduced",
                        "--device", "cpu"]) == 1

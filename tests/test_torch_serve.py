"""Port parity: repro_torch's ServingEngine vs repro's, and the port's
serve launcher (its single-model, ``--gateway``, ``--co-arch`` and
``--fleet`` modes on the CPU, and the reference's argument errors).

Both engines serve reduced stablelm-1.6b with the same weights (repro's
``Model.init``, carried across by ``params_from_jax``) on the CPU in
float32; greedy decoding must give identical tokens.
"""
import gc
import json

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build as jbuild
from repro.launch import serve as jserve
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


@pytest.mark.parametrize("eager", [False, True])
def test_decode_graph_bookkeeping_on_cpu(served, eager):
    """The engine's graph path (static id and length buffers, the logits
    in a static buffer, one step function over the engine's caches), run
    eagerly on the CPU, gives the reference engine's greedy tokens, with
    or without asking for eager steps."""
    from repro_torch.kernels import graph as tgraph

    jeng, _, tm = served
    eng = tengine.ServingEngine(tm, max_slots=4, capacity=64, eager=eager)
    assert isinstance(eng.graph, tengine.DecodeGraph)
    assert isinstance(eng.graph.graph, tgraph.Eager)   # nothing captured
    rng = np.random.default_rng(0)
    for n in PROMPT_LENS:
        eng.submit(rng.integers(0, tm.cfg.vocab, size=n), max_new=MAX_NEW)
    eng.run_until_drained()
    want = {r.rid: r.tokens for r in jeng.completed}
    assert {r.rid: r.tokens for r in eng.completed} == want


def test_launcher_serves_on_cpu(capsys):
    assert tserve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                        "--requests", "2", "--max-new", "3"]) == 0
    assert "served 2 requests, 6 tokens" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["dbrx-132b", "qwen3-moe-235b-a22b"])
def test_launcher_serves_moe_on_cpu(arch, capsys):
    assert tserve.main(["--arch", arch, "--reduced", "--device", "cpu",
                        "--requests", "3", "--max-new", "4"]) == 0
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--arch", ARCH, "--reduced", "--requests", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tbuild(tconfigs.get(ARCH).reduced())


CO = ["--arch", ARCH, "--co-arch", "llama3.2-3b", "--device", "cpu"]
TRACE = "bursty:base=150,burst=1200,n=1000,tenants=50,seed=7"


def test_gateway_mode_serves_on_cpu(capsys):
    """--gateway --reduced serves both reduced models (planning the full
    ones) under a two-slot KV budget."""
    assert tserve.main([*CO, "--gateway", "--reduced", "--requests", "3",
                        "--max-new", "3", "--budget-slots", "2"]) == 0
    out = capsys.readouterr().out
    assert "objective=throughput" in out and "haxconn" in out
    assert "stablelm-1.6b: served 3 requests, 9 tokens" in out
    assert "llama3.2-3b: served 3 requests, 9 tokens" in out
    deferred = int(out.split("deferred=")[1].split()[0])
    assert deferred > 0 and out.rstrip().endswith("on cpu")


def test_gateway_plan_round_trip(tmp_path, capsys):
    """--plan-only --save-plan, then --plan: the second boot makes zero
    solves, and the plan is the same with or without --reduced."""
    path = tmp_path / "gw.json"
    assert tserve.main([*CO, "--gateway", "--plan-only", "--save-plan",
                        str(path)]) == 0
    saved = capsys.readouterr().out
    assert tserve.main([*CO, "--gateway", "--reduced", "--plan", str(path),
                        "--requests", "1"]) == 0
    out = capsys.readouterr().out
    assert "with zero solver invocations" in out
    assert saved.split("saved to")[1].split("\n", 1)[1] in out


def test_co_arch_mode_plans_on_cpu(capsys):
    assert tserve.main([*CO, "--shape", "decode_32k"]) == 0
    out = capsys.readouterr().out
    assert "haxconn" in out and "stablelm-1.6b:decode_32k" in out


def test_fleet_mode_replays_on_cpu(tmp_path, capsys):
    """--fleet replays the trace over three solved pool plans; a second
    run with --expect-cached boots from the sharded cache."""
    argv = [*CO, "--fleet", "--trace", TRACE, "--slo", "p99=400",
            "--cache-root", str(tmp_path / "plans")]
    assert tserve.main(argv) == 0
    first = capsys.readouterr().out
    assert "pool: 3 plans, 3 solver invocation(s)" in first
    assert "requests=1000 completed=1000 shed=0" in first
    assert tserve.main([*argv, "--expect-cached"]) == 0
    again = capsys.readouterr().out
    assert "pool: 3 plans, 0 solver invocation(s)" in again
    assert first.split("\n")[0] == again.split("\n")[0]   # trace hash


@pytest.mark.parametrize("argv, message", [
    (["--fleet", "--co-arch", "llama3.2-3b"], "--fleet requires --trace"),
    (["--fleet", "--trace", TRACE], "--fleet requires --co-arch"),
    (["--fleet", "--co-arch", "llama3.2-3b", "--trace", TRACE,
      "--expect-cached"], "--expect-cached requires --cache-root"),
    (["--gateway", "--co-arch", ARCH], "two distinct models"),
    (["--co-arch", "llama3.2-3b", "--solver", "nope"], "unknown solver"),
    (["--co-arch", "llama3.2-3b", "--evaluator", "nope"],
     "unknown evaluator"),
    (["--co-arch", "llama3.2-3b", "--devices", "2"],
     "require --solver anneal"),
    (["--search-budget-ms", "5"], "require --solver anneal"),
    (["--trace", TRACE], "--trace requires --fleet"),
    (["--plan-only"], "require --gateway"),
    (["--gateway"], "--gateway requires --co-arch"),
])
def test_argument_errors(argv, message, capsys):
    with pytest.raises(SystemExit) as exc:
        tserve.main(["--arch", ARCH, "--device", "cpu", *argv])
    assert exc.value.code != 0
    assert message in capsys.readouterr().err


def test_encoder_only_has_no_decode_service():
    assert tserve.main(["--arch", "hubert-xlarge", "--reduced",
                        "--device", "cpu"]) == 1


def obs_run(main, argv, tmp_path, name, capsys):
    """``main(argv)`` with --trace-out, --metrics-out and --log-json into
    ``tmp_path``; returns (exit code, trace, metrics snapshot, the JSON
    log lines)."""
    trace = tmp_path / f"{name}.trace.json"
    metrics = tmp_path / f"{name}.metrics.json"
    rc = main([*argv, "--trace-out", str(trace), "--metrics-out",
               str(metrics), "--log-json", "--log-level", "debug"])
    err = capsys.readouterr().err
    logs = [json.loads(line) for line in err.splitlines()
            if line.startswith("{")]
    return rc, json.loads(trace.read_text()), json.loads(
        metrics.read_text()), logs


def event_names(trace) -> list:
    return sorted({e["name"] for e in trace["traceEvents"]})


@pytest.mark.parametrize("mode", ["single", "gateway"])
def test_obs_outputs_match_reference(mode, tmp_path, capsys):
    """The port's CLI on reduced stablelm-1.6b (beside reduced dbrx-132b
    in the gateway) writes a Perfetto trace and a registry snapshot that
    parse, its trace holding the events the reference's CLI writes on the
    same run."""
    argv = ["--arch", ARCH, "--requests", "2", "--max-new", "3"]
    if mode == "gateway":
        argv += ["--gateway", "--co-arch", "dbrx-132b"]
    rc, trace, metrics, logs = obs_run(
        tserve.main, [*argv, "--reduced", "--device", "cpu"], tmp_path,
        "port", capsys)
    assert rc == 0 and isinstance(metrics, dict)
    assert all({"ts", "level", "logger", "msg"} <= set(doc) for doc in logs)
    jrc, jtrace, _, _ = obs_run(jserve.main, argv, tmp_path, "ref", capsys)
    assert jrc == 0
    assert event_names(trace) == event_names(jtrace)
    assert set(trace) == set(jtrace)
    if mode == "gateway":
        assert "scheduler.resolve" in event_names(trace)
        assert metrics["repro_scheduler_solves"]["value"] >= 1


def test_obs_outputs_written_when_the_run_fails(tmp_path, capsys):
    rc, trace, metrics, _ = obs_run(
        tserve.main, ["--arch", "hubert-xlarge", "--reduced", "--device",
                      "cpu"], tmp_path, "fail", capsys)
    assert rc == 1
    assert trace["traceEvents"] == [] and isinstance(metrics, dict)


class _Capture:
    """Stands in for ``torch.cuda.graph`` where there is no card."""

    def __init__(self, graph):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_graph_captures_without_the_cycle_collector(monkeypatch):
    """The cycle collector is off while a graph captures (a dead graph
    collected there invalidates the capture) and on again after, also
    when the captured function raises."""
    from repro_torch.kernels import graph as tgraph

    monkeypatch.setattr(torch.cuda, "CUDAGraph", object)
    monkeypatch.setattr(torch.cuda, "graph", _Capture)
    seen = []
    assert tgraph.Graph(lambda: seen.append(gc.isenabled())).launches == {}
    assert seen == [False] and gc.isenabled()

    def fails():
        raise RuntimeError("captured function failed")

    with pytest.raises(RuntimeError, match="captured function failed"):
        tgraph.Graph(fails)
    assert gc.isenabled()


# ---------------------------------------------------------------------------
# card only: the decode step as a CUDA graph
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are built with nvcc "
                    "for sm_90a)")
    return torch.device("cuda")


def _card_engines(dev, arch):
    """Graph and eager engines over one reduced float32 model on the card,
    each fed the same requests, admitted between steps."""
    tcfg = tconfigs.get(arch).reduced()
    tm = tbuild(tcfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    engines = {"graph": tengine.ServingEngine(tm, max_slots=4, capacity=64),
               "eager": tengine.ServingEngine(tm, max_slots=4, capacity=64,
                                              eager=True)}
    return tm, engines


class Recording:
    """Calls ``fn`` and keeps a copy of each call's logits."""

    def __init__(self, fn, pick=lambda out: out):
        self.fn, self.pick, self.logits = fn, pick, []

    def __call__(self, *args):
        out = self.fn(*args)
        self.logits.append(self.pick(out).clone())
        return out


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "recurrentgemma-9b"])
def test_graph_and_eager_decode_agree(cuda_device, arch, monkeypatch):
    """20 steps with admissions in between: identical greedy tokens, and
    every step's float32 logits within 1e-5 relative."""
    from repro_torch.kernels import graph as tgraph

    tm, engines = _card_engines(cuda_device, arch)
    graph, eager = engines["graph"], engines["eager"]
    assert isinstance(graph.graph.graph, tgraph.Graph)
    assert isinstance(eager.graph.graph, tgraph.Eager)
    graph.graph = Recording(graph.graph)
    # the graph replays without Python, so only the eager engine calls this
    eager_step = Recording(tm.decode_step, pick=lambda out: out[0])
    monkeypatch.setattr(tm, "decode_step", eager_step)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, tm.cfg.vocab, size=n)
               for n in (5, 9, 17, 33, 3)]
    for eng in (graph, eager):
        for step in range(20):
            if step % 4 == 0:
                eng.submit(prompts[step // 4], max_new=7)
            eng.step()
    assert len(graph.graph.logits) == len(eager_step.logits) == 20
    for g, e in zip(graph.graph.logits, eager_step.logits):
        rel = float((g - e).norm() / e.norm())
        assert rel <= 1e-5, rel
    got = {r.rid: r.tokens for r in graph.completed}
    want = {r.rid: r.tokens for r in eager.completed}
    assert got == want and len(got) >= 3


@pytest.mark.cuda
def test_graph_replays_count_exact_launches(cuda_device):
    """A replay adds each wrapper's launches of one step: the decode
    kernel once per attention layer, nothing for the prefill kernel."""
    from repro_torch.kernels import decode_attention as tdec
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import rglru as trg

    tm, engines = _card_engines(cuda_device, "recurrentgemma-9b")
    eng = engines["graph"]
    kinds = tm.cfg.layer_kinds
    attn = sum(k in ("attn", "local") for k in kinds)
    assert eng.graph.graph.launches == {
        "decode_attention": attn, "rglru": kinds.count("rglru")}
    eng.submit(np.arange(6), max_new=50)
    eng.step()                                   # admit + first step
    before = (tfa.launches, tdec.launches, trg.launches)
    for _ in range(5):
        eng.step()
    torch.cuda.synchronize()
    assert (tfa.launches, tdec.launches, trg.launches) == (
        before[0], before[1] + 5 * attn,
        before[2] + 5 * kinds.count("rglru"))


@pytest.mark.cuda
def test_capture_survives_a_dead_graph(cuda_device):
    """A graph whose last reference sits in a reference cycle that dies
    while another graph captures must outlive the capture: with the cycle
    collector set to run at every allocation, the capture completes and
    replays."""
    from repro_torch.kernels import graph as tgraph

    x = torch.zeros(4, device=cuda_device)
    dead = [tgraph.Graph(lambda: x + 1.0)]

    def step():
        cycle = {"graph": dead.pop()}     # the graph's last reference
        cycle["self"] = cycle
        del cycle                         # young garbage, mid-capture
        return [x + float(i) for i in range(50)][-1]

    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        g = tgraph.Graph(step)
    finally:
        gc.set_threshold(*thresholds)
    assert torch.equal(g.replay(), torch.full((4,), 49.0,
                                              device=cuda_device))

"""Port parity: ``repro_torch.serve.fleet`` vs ``repro.serve.fleet``.

``traffic.py`` and ``slo.py`` (and the package's ``__init__``) are word
for word copies; ``loop.py`` is a copy whose ``build_pool`` takes a
keyword-only ``device``.  The fleet prices service from the solved plans
and never builds a model, so both packages must give the same numbers
exactly:

* traces and trace hashes per generator and seed, and from specs;
* on ``tests/test_fleet.py``'s pool (full-size stablelm-1.6b and
  llama3.2-3b over two pod splits), the same steady-state step table and
  request hash per plan;
* the same ``FleetReport`` (latency, wait, status, plan and end arrays,
  reschedule events) for a replay, a replay under injected contention
  (§4.4 re-solves) and the same under the duty-cycle throttle;
* a ``ShardedPlanCache`` root either package wrote boots the other's
  ``build_pool`` with zero solves.
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest

from repro import configs as jconfigs
from repro.core.accelerators import tpu_pod_split as jsplit
from repro.core.plan import ShardedPlanCache as JSharded
from repro.serve import fleet as jfleet
from repro.serve import gateway as jgateway
from repro_torch import configs as tconfigs
from repro_torch.core.accelerators import tpu_pod_split as tsplit
from repro_torch.core.plan import ShardedPlanCache as TSharded
from repro_torch.serve import fleet as tfleet
from repro_torch.serve import gateway as tgateway

ROOT = Path(__file__).resolve().parents[1]
SPLITS = ((1, 3, "p13"), (2, 2, "p22"))


def source(pkg, name):
    return (ROOT / "src" / pkg / "serve" / "fleet" / f"{name}.py").read_text()


@pytest.mark.parametrize("name", ["traffic", "slo", "__init__"])
def test_copied_verbatim(name):
    """Word for word apart from the import prefix."""
    want = source("repro", name).replace("repro.", "repro_torch.")
    assert source("repro_torch", name) == want


# ---------------------------------------------------------------------------
# traffic
# ---------------------------------------------------------------------------
TRACES = {
    "poisson": lambda f, seed: f.poisson_trace(120.0, 400, 25, seed=seed,
                                               skew=1.0),
    "bursty": lambda f, seed: f.bursty_trace(80.0, 900.0, 500, 30,
                                             seed=seed),
    "diurnal": lambda f, seed: f.diurnal_trace(200.0, 300, 40, seed=seed,
                                               day_s=60.0),
}
COLUMNS = ("t_ms", "tenant", "prompt_len", "max_new")


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("kind", sorted(TRACES))
def test_traces_identical(kind, seed):
    a, b = TRACES[kind](jfleet, seed), TRACES[kind](tfleet, seed)
    for col in COLUMNS:
        assert np.array_equal(getattr(a, col), getattr(b, col)), col
    assert a.trace_hash() == b.trace_hash()
    assert a.to_json() == b.to_json()


@pytest.mark.parametrize("spec", [
    "poisson:rate=200,n=300,tenants=20,seed=1",
    "bursty:base=150,burst=1200,n=10000,tenants=100,seed=7",
    "diurnal:peak=300,n=500,tenants=50,seed=3",
])
def test_trace_specs_identical(spec, tmp_path):
    a, b = jfleet.parse_trace_spec(spec), tfleet.parse_trace_spec(spec)
    assert a.trace_hash() == b.trace_hash()
    # a trace file one package saved loads in the other
    path = a.save(tmp_path / "trace.json")
    again = tfleet.parse_trace_spec(str(path))
    assert again.trace_hash() == a.trace_hash()
    assert np.array_equal(again.t_ms, b.t_ms)


# ---------------------------------------------------------------------------
# the pool: tests/test_fleet.py's fixture in both packages
# ---------------------------------------------------------------------------
def specs(configs, gateway):
    return [gateway.TenantSpec("stable", configs.get("stablelm-1.6b"),
                               max_slots=2, capacity=256, prompt_len=64,
                               max_new=16),
            gateway.TenantSpec("llama", configs.get("llama3.2-3b"),
                               max_slots=2, capacity=256, prompt_len=64,
                               max_new=16)]


def build_jax(cache=None):
    plats = [jsplit(a, b, name=n) for a, b, n in SPLITS]
    return jfleet.build_pool(
        specs(jconfigs, jgateway), plats,
        jgateway.GatewayConfig(max_transitions=1, body_groups=1), cache,
        slots=4, deadline_s=5.0)


def build_torch(cache=None):
    plats = [tsplit(a, b, name=n) for a, b, n in SPLITS]
    return tfleet.build_pool(
        specs(tconfigs, tgateway), plats,
        tgateway.GatewayConfig(max_transitions=1, body_groups=1), cache,
        slots=4, deadline_s=5.0, device="cpu")


def test_pools_identical():
    for jp, tp in zip(build_jax(), build_torch()):
        assert jp.name == tp.name and jp.classes == tp.classes
        assert jp.plan.plan.request_hash == tp.plan.plan.request_hash
        assert jp.plan.solution.assignments == tp.plan.solution.assignments
        assert np.array_equal(jp.base_step_ms, tp.base_step_ms)
        assert np.array_equal(jp.kv_bytes, tp.kv_bytes)
        assert np.array_equal(jp.class_demand, tp.class_demand)
        assert jp.plan.summary() == tp.plan.summary()
        assert tp.scheduler.device.type == "cpu"


# ---------------------------------------------------------------------------
# replays
# ---------------------------------------------------------------------------
REPORT_ARRAYS = ("latency_ms", "wait_ms", "slowdown", "status", "plan",
                 "t_end", "tenant")


def replay(fleet, pool, scenario):
    """One replay; returns the report.  ``contention``: tests/test_fleet.py's
    §4.4 burst on plan 0; ``throttle``: a 2.5x burst on every plan under a
    tight SLO with the duty-cycle throttle on."""
    if scenario == "plain":
        tr = fleet.bursty_trace(150.0, 1200.0, 2000, 100, seed=7)
        cfg, events = fleet.FleetConfig(), []
    elif scenario == "contention":
        tr = fleet.bursty_trace(150.0, 1200.0, 3000, 100, seed=5)
        cfg = fleet.FleetConfig(default_slo=fleet.SLO(p99_ms=10_000.0),
                                slowdown_threshold=1.3, patience=4,
                                cooldown=64, warmup=0)
        events = [(float(tr.t_ms[len(tr) // 4]), 0, 4.0)]
    else:
        tr = fleet.poisson_trace(150.0, 1500, 12, seed=3)
        # the default re-solve budget: ~15x what these solves take, so
        # both packages' solves finish (a solve cut by its deadline would
        # depend on the host's speed)
        cfg = fleet.FleetConfig(default_slo=fleet.SLO(p99_ms=120.0),
                                slowdown_threshold=1.2, patience=4,
                                cooldown=64, throttle=True,
                                throttle_duty=0.5, throttle_margin=0.5)
        events = [(0.3 * float(tr.t_ms[-1]), p, 2.5)
                  for p in range(len(pool))]
    gw = fleet.FleetGateway(pool, n_tenants=tr.n_tenants, cfg=cfg,
                            capacity_hint=len(tr))
    return gw.replay(tr, contention_events=events)


@pytest.mark.parametrize("scenario", ["plain", "contention", "throttle"])
def test_replay_reports_identical(scenario):
    a = replay(jfleet, build_jax(), scenario)
    b = replay(tfleet, build_torch(), scenario)
    for name in REPORT_ARRAYS:          # exact; NaN where a request never ran
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name, strict=True)
    assert [dataclasses.astuple(e) for e in a.reschedules] == [
        dataclasses.astuple(e) for e in b.reschedules]
    assert a.throttle_events == b.throttle_events
    assert a.summary() == b.summary()
    assert a.slo_report() == b.slo_report()
    assert b.completed + b.shed + b.throttled == b.n_requests
    if scenario == "contention":
        assert b.reschedules
    if scenario == "throttle":
        assert b.throttled > 0


# ---------------------------------------------------------------------------
# sharded plan caches cross between the packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_sharded_cache_boots_other_package(writer, tmp_path):
    root = tmp_path / "plans"
    build_w, build_r, Sharded_w, Sharded_r = (
        (build_jax, build_torch, JSharded, TSharded) if writer == "repro"
        else (build_torch, build_jax, TSharded, JSharded))
    first = build_w(Sharded_w(root))
    assert sum(pp.scheduler.solves for pp in first) == len(SPLITS)
    again = build_r(Sharded_r(root))
    assert sum(pp.scheduler.solves for pp in again) == 0
    for a, b in zip(first, again):
        assert np.array_equal(a.step_ms, b.step_ms)
        assert a.plan.plan.request_hash == b.plan.plan.request_hash


def test_build_pool_needs_cuda_by_default(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfleet.build_pool(specs(tconfigs, tgateway), [tsplit(2, 2)])

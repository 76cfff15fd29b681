"""Port parity: ``repro_torch.serve.{gateway,concurrent}`` vs ``repro``'s.

Reduced stablelm-1.6b and llama3.2-3b on ``tpu_pod_split(2, 2)``, as
``tests/test_serve_gateway.py`` sets them up, through both packages'
``MultiTenantGateway`` on the CPU.  The port's tenants get the
reference's weights (``params_from_jax``), and every step gets the same
injected ``observed_ms``, so both gateways must agree exactly:

* the plan: request hash, assignments, objective, the round-robin
  baseline, predicted step times and ``summary()``;
* the greedy tokens of every request of every tenant;
* under a one-slot KV budget, the KV bytes in use after every step and
  the deferred admissions;
* with a slowdown injected into one tenant's steps, the §4.4
  ``RescheduleEvent``s and the re-solved plan;
* ``metrics()`` in ``GATEWAY_SCHEMA``'s shape;
* a plan either package's ``plan_gateway`` saved boots the other's
  gateway with zero solves;
* ``CoServer.run_round``: the logits within float32 tolerance, and the
  same simulated clock.

The card cases (marker ``cuda``) check the gateway's tokens against a
standalone engine's on the same model and the exact kernel launches.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import Plan as JPlan
from repro.core import Scheduler as JScheduler
from repro.core.accelerators import tpu_pod_split as jsplit
from repro.obs import GATEWAY_SCHEMA as J_GATEWAY_SCHEMA
from repro.serve import concurrent as jconc
from repro.serve import gateway as jgw
from repro_torch import configs as tconfigs
from repro_torch.core import Plan as TPlan
from repro_torch.core import Scheduler as TScheduler
from repro_torch.core.accelerators import tpu_pod_split as tsplit
from repro_torch.models.convert import params_from_jax
from repro_torch.obs import GATEWAY_SCHEMA as T_GATEWAY_SCHEMA
from repro_torch.serve import concurrent as tconc
from repro_torch.serve import gateway as tgw

ARCHS = {"stable": "stablelm-1.6b", "llama": "llama3.2-3b"}
PROMPT_LEN = 5
#: float32 tolerance of the attention kernels (tests/test_kernels.py)
F32_TOL = dict(atol=2e-5, rtol=2e-5)


class Side:
    """One package's pieces under the same names."""

    def __init__(self, configs, split, gw, Scheduler, Plan, **device):
        self.configs, self.gw, self.Scheduler, self.Plan = (
            configs, gw, Scheduler, Plan)
        self.plat = split(2, 2, name="v5e-2x2-test")
        self.device = device             # {} for repro, device="cpu" here

    def specs(self, max_slots=2, capacity=32):
        return [self.gw.TenantSpec(name, self.configs.get(arch).reduced(),
                                   max_slots=max_slots, capacity=capacity,
                                   prompt_len=PROMPT_LEN, max_new=4)
                for name, arch in ARCHS.items()]

    def gcfg(self, **kw):
        kw.setdefault("platform", self.plat)
        kw.setdefault("max_transitions", 1)
        kw.setdefault("body_groups", 1)
        return self.gw.GatewayConfig(**kw)

    def scheduler(self):
        return self.Scheduler(self.plat, **self.device)

    def gateway(self, **kw):
        return self.gw.MultiTenantGateway(self.specs(), self.gcfg(**kw),
                                          **self.device)


JAX = Side(jconfigs, jsplit, jgw, JScheduler, JPlan)
TORCH = Side(tconfigs, tsplit, tgw, TScheduler, TPlan, device="cpu")


def carry_weights(jgateway, tgateway):
    """The reference's seeded weights into the port's tenant models (an
    in-place copy: nothing the engines hold goes stale)."""
    for name, eng in jgateway.engines.items():
        model = tgateway.engines[name].model
        model.load_state_dict(params_from_jax(
            model.cfg, jax.tree.map(np.asarray, eng.params)))


def submit_all(gw, seed, per_tenant=3, max_new=None):
    rng = np.random.default_rng(seed)
    for name in gw.specs:
        for _ in range(per_tenant):
            gw.submit(name, rng.integers(0, 256, size=PROMPT_LEN),
                      max_new=max_new)


def drive(gw, observed, max_steps=200):
    """Step until drained, ``observed(step)`` giving each step's injected
    per-tenant ms; records what every step reports."""
    steps = []
    while gw.has_work and gw.total_steps < max_steps:
        rep = gw.step(observed_ms=observed(gw.total_steps))
        steps.append((rep.step, rep.active, rep.kv_bytes_in_use, rep.fired,
                      rep.rescheduled))
    return steps


def tokens(gw):
    return {n: {r.rid: list(r.tokens) for r in e.completed}
            for n, e in gw.engines.items()}


@pytest.fixture(scope="module")
def runs():
    """Both packages' gateways through the same three runs, in order:
    unbudgeted serving, a one-slot KV budget, an injected slowdown."""
    out = {}
    for side in (JAX, TORCH):
        gw = side.gateway(patience=2, cooldown=2, warmup=1)
        if side is TORCH:
            carry_weights(out["repro"]["gw"], gw)
        rec = {"gw": gw, "plan": gw.plan, "solves": gw.scheduler.solves}
        steady = lambda step: {"stable": 1.0, "llama": 1.0}
        submit_all(gw, seed=0)
        rec["serve"] = drive(gw, steady)
        rec["tokens"] = tokens(gw)
        rec["metrics"] = gw.metrics()

        one_slot = max(s.kv_bytes_per_slot for s in gw.specs.values())
        gw.gcfg = dataclasses.replace(gw.gcfg, memory_budget_bytes=one_slot)
        submit_all(gw, seed=1, per_tenant=2)
        rec["budget"] = drive(gw, steady)
        rec["one_slot"] = one_slot
        rec["deferred"] = gw.deferred_admissions
        gw.gcfg = dataclasses.replace(gw.gcfg, memory_budget_bytes=None)

        start = gw.total_steps
        submit_all(gw, seed=2, per_tenant=2, max_new=12)
        rec["slowdown"] = drive(gw, lambda step: {
            "stable": 1.0, "llama": 10.0 if step >= start + 4 else 1.0})
        rec["reschedules"] = [dataclasses.astuple(ev)
                              for ev in gw.reschedules]
        rec["after"] = gw.plan
        rec["tokens_all"] = tokens(gw)
        out["repro" if side is JAX else "repro_torch"] = rec
    return out["repro"], out["repro_torch"]


def test_plan_identical(runs):
    a, b = (r["plan"] for r in runs)
    assert runs[0]["solves"] == runs[1]["solves"] == 1
    assert a.plan.request_hash == b.plan.request_hash
    assert a.solution.assignments == b.solution.assignments
    assert a.solution.objective == b.solution.objective
    assert a.solution.optimal == b.solution.optimal
    assert a.n_prefill_groups == b.n_prefill_groups
    for key in ("latency_ms", "throughput_fps", "makespan"):
        assert getattr(a.round_robin, key) == getattr(b.round_robin, key)
    assert [w.assignment for w in
            jgw.round_robin_workloads(a.platform, a.graphs, a.iterations)
            ] == [w.assignment for w in tgw.round_robin_workloads(
                b.platform, b.graphs, b.iterations)]
    for name in ARCHS:
        assert (a.predicted_decode_step_ms(name)
                == b.predicted_decode_step_ms(name))
    assert a.speedup_vs_round_robin == b.speedup_vs_round_robin
    assert a.summary() == b.summary()


def test_greedy_tokens_identical(runs):
    want, got = (r["tokens"] for r in runs)
    assert got == want
    for reqs in got.values():
        assert len(reqs) == 3 and all(len(t) == 4 for t in reqs.values())
    # and over all three runs
    assert runs[1]["tokens_all"] == runs[0]["tokens_all"]


def test_steps_identical(runs):
    """Every step's active slots, KV bytes, fired tenants and reschedule
    flag, unbudgeted and with the injected slowdown."""
    for run in ("serve", "slowdown"):
        assert runs[1][run] == runs[0][run], run


def test_budget_admissions_identical(runs):
    a, b = runs
    assert b["budget"] == a["budget"]
    assert b["deferred"] == a["deferred"] > 0
    assert b["one_slot"] == a["one_slot"]
    assert all(kv <= b["one_slot"] for _, _, kv, _, _ in b["budget"])


def test_reschedule_events_identical(runs):
    a, b = runs
    assert b["reschedules"] == a["reschedules"]
    assert b["reschedules"], "the injected slowdown never re-scheduled"
    for ev in b["reschedules"]:
        assert "llama" in ev[1] and "stable" not in ev[1]
        assert ev[4] <= ev[3] + 1e-9          # adopt only if better
    assert a["after"].solution.assignments == b["after"].solution.assignments
    assert a["after"].plan.request_hash == b["after"].plan.request_hash


def test_metrics_shape(runs):
    a, b = (r["metrics"] for r in runs)
    assert tuple(T_GATEWAY_SCHEMA) == tuple(J_GATEWAY_SCHEMA)
    assert tuple(b) == tuple(a) == (*T_GATEWAY_SCHEMA, "tenants")
    for key in T_GATEWAY_SCHEMA:
        assert b[key] == a[key], key
    for name in ARCHS:
        assert tuple(b["tenants"][name]) == tuple(a["tenants"][name])
        for key, val in a["tenants"][name].items():
            if not key.endswith("step_ms"):       # wall clock
                assert b["tenants"][name][key] == val, key


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_saved_plan_boots_other_package(writer, tmp_path):
    w, r = (JAX, TORCH) if writer == "repro" else (TORCH, JAX)
    s1 = w.scheduler()
    plan = w.gw.plan_gateway(w.specs(), w.gcfg(), scheduler=s1)
    assert s1.solves == 1
    path = plan.plan.save(tmp_path / "gw.json")
    s2 = r.scheduler()
    s2.cache.add(r.Plan.load(path))
    gw = r.gw.MultiTenantGateway(r.specs(), r.gcfg(), scheduler=s2)
    assert s2.solves == 0 and s2.cache.hits == 1
    assert gw.plan.plan.request_hash == plan.plan.request_hash
    assert gw.plan.solution.assignments == plan.solution.assignments


def test_coserver_round(runs):
    """Both packages' co-serving plans and one ``CoServer`` round over the
    gateways' (same-weight) reduced models."""
    cfgs = [(jconfigs.get(a), tconfigs.get(a)) for a in ARCHS.values()]
    jplan = jconc.plan_concurrent_serving(
        [c for c, _ in cfgs], ["decode_32k"] * 2, platform=JAX.plat)
    tplan = tconc.plan_concurrent_serving(
        [c for _, c in cfgs], ["decode_32k"] * 2, platform=TORCH.plat,
        device="cpu")
    assert tplan.summary() == jplan.summary()
    assert tplan.plan.request_hash == jplan.plan.request_hash
    jgate, tgate = (r["gw"] for r in runs)
    rng = np.random.default_rng(5)
    ids = [rng.integers(0, 256, size=(2, 7)).astype(np.int32)
           for _ in ARCHS]
    jco = jconc.CoServer(
        models=[jgate.engines[n].model for n in ARCHS],
        params=[jgate.engines[n].params for n in ARCHS], plan=jplan)
    tco = tconc.CoServer(models=[tgate.engines[n].model for n in ARCHS],
                         plan=tplan)
    for _ in range(2):
        want = jco.run_round([{"token_ids": x} for x in ids])
        got = tco.run_round([{"token_ids": torch.from_numpy(x)}
                             for x in ids])
        for g, w in zip(got, want):
            assert g.shape == w.shape
            torch.testing.assert_close(g, torch.from_numpy(np.array(w)),
                                       **F32_TOL)
    assert tco.rounds == jco.rounds == 2
    assert tco.sim_time_ms == jco.sim_time_ms
    assert tco.simulated_fps == jco.simulated_fps


@pytest.mark.parametrize("call", ["plan_gateway", "MultiTenantGateway",
                                  "plan_concurrent_serving"])
def test_default_device_needs_cuda(call, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    specs, gcfg = TORCH.specs(), TORCH.gcfg()
    fn = {"plan_gateway": lambda: tgw.plan_gateway(specs, gcfg),
          "MultiTenantGateway": lambda: tgw.MultiTenantGateway(specs, gcfg),
          "plan_concurrent_serving": lambda: tconc.plan_concurrent_serving(
              [s.cfg for s in specs], ["decode_32k"] * 2)}[call]
    with pytest.raises(RuntimeError, match="CUDA"):
        fn()


# ---------------------------------------------------------------------------
# card only
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are built with nvcc "
                    "for sm_90a)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_gateway_tokens_and_launches_on_card(cuda_device):
    """Reduced stablelm-1.6b and llama3.2-3b through the gateway on the
    card, each tenant's decode step its own CUDA graph: every tenant's
    greedy tokens equal a standalone graph engine's over the same model,
    and the kernels launch exactly layers x prefills (flash) and layers x
    steps (decode, counted through the graph replays)."""
    from repro_torch.kernels import decode_attention as tdec
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels.graph import Graph
    from repro_torch.serve.engine import ServingEngine

    specs = TORCH.specs(max_slots=4, capacity=64)
    gw = tgw.MultiTenantGateway(specs, TORCH.gcfg(), device=cuda_device)
    assert gw.scheduler.device.type == "cuda"
    for eng in gw.engines.values():
        assert isinstance(eng.graph.graph, Graph)
    rng = np.random.default_rng(0)
    prompts = {n: [rng.integers(0, 256, size=k) for k in (5, 9, 17, 33)]
               for n in gw.specs}
    for name, ps in prompts.items():
        for p in ps:
            gw.submit(name, p, max_new=8)
    tfa.launches = tdec.launches = 0
    gw.run_until_drained()
    torch.cuda.synchronize()
    layers = {n: sum(k in ("attn", "local") for k in s.cfg.layer_kinds)
              for n, s in gw.specs.items()}
    assert tfa.launches == sum(layers[n] * len(prompts[n]) for n in layers)
    assert tdec.launches == sum(layers[n] * gw.engines[n].steps
                                for n in layers)
    for name, eng in gw.engines.items():
        alone = ServingEngine(eng.model, max_slots=4, capacity=64)
        for p in prompts[name]:
            alone.submit(p, max_new=8)
        alone.run_until_drained()
        want = {r.rid: r.tokens for r in alone.completed}
        got = {r.rid: r.tokens for r in eng.completed}
        assert got == want and len(got) == len(prompts[name])

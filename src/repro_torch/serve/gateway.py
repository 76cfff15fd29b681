"""Contention-aware multi-tenant serving gateway (counterpart of
``repro/serve/gateway.py``).

Unifies the single-model continuous-batching engine
(:mod:`repro_torch.serve.engine`), the HaX-CoNN planner
(:class:`repro_torch.core.Scheduler`) and the D-HaX-CoNN dynamic loop
(:mod:`repro_torch.core.dynamic`) into one subsystem that serves *several* models
concurrently on a shared-memory platform:

* **Phase-aware planning** — every tenant is exported as one schedulable
  chain ``prefill groups -> decode macro-groups`` (a decode macro-group is
  ``max_new`` decode steps fused, so its duration is commensurate with
  prefill while its *per-unit-time* shared-memory demand stays the decode
  demand).  The solver may therefore place a tenant's compute-bound prefill
  and memory-bound decode on *different* accelerators — phase
  disaggregation expressed as an ordinary HaX-CoNN transition.
* **Admission control** — a shared KV-memory budget across all tenants;
  each engine's slot admission is gated on the projected global usage, so a
  burst on one model cannot evict another model's working set.
* **Dynamic re-scheduling (§4.4)** — per-tenant
  :class:`~repro_torch.core.dynamic.SlowdownMonitor` watches observed decode
  step latency for deviation from its calibrated steady-state baseline
  (the stand-in for the plan's prediction where wall-clock and simulated
  ms are incommensurate; the predicted step latency itself is reported by
  :meth:`GatewayPlan.predicted_decode_step_ms`).  A sustained deviation
  re-solves via :func:`~repro_torch.core.dynamic.reschedule_plan` —
  ``Scheduler.resolve`` under a contention model rescaled to the observed
  severity, so re-schedules are plan-cached and logged like offline solves.

The plan's timing is simulated (its exact event-driven timeline); token
generation is real compute, exactly like :mod:`repro_torch.serve.concurrent`.

Two differences from the reference, both about where things run:

* every function that makes a :class:`~repro_torch.core.Scheduler`, and
  the gateway itself, take a keyword-only ``device``: ``cuda`` unless the
  caller asks for the CPU; given a ``scheduler``, its device is used;
* the port's engine owns its model's parameters, so each tenant's model
  is built on that device and seeded from a ``torch.Generator``
  (``seed + i``) where the reference seeds a ``jax.random.PRNGKey``.
  On the card each engine's decode step is a CUDA graph of its own.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Mapping, Sequence

import torch

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.core.accelerators import Platform
from repro_torch.core.contention import ContentionModel
from repro_torch.core.dynamic import (ScaledContentionModel, SlowdownMonitor,
                                quantize_severity, reschedule_plan)
from repro_torch.core.graph import DNNGraph
from repro_torch.core.plan import Plan, PlanCache
from repro_torch.core.scheduler import Scheduler
from repro_torch.core.simulate import SimResult, Workload, simulate
from repro_torch.core.solver_bb import Solution
from repro_torch.models import build
from repro_torch.models.graph_export import export_graph
from repro_torch.obs import GATEWAY_SCHEMA, conform, get_registry, get_tracer
from repro_torch.serve.engine import Request, ServingEngine

_DTYPE_BYTES = {"int8": 1, "float16": 2, "bfloat16": 2, "float32": 4}


def kv_bytes_per_token(cfg: ModelConfig) -> int:
    """KV-cache bytes one decoded token pins in shared memory."""
    n_attn = sum(1 for k in cfg.layer_kinds if k in ("attn", "local"))
    return (2 * cfg.n_kv_heads * cfg.d_head
            * _DTYPE_BYTES.get(cfg.kv_cache_dtype, 2) * n_attn)


@dataclass(frozen=True)
class TenantSpec:
    """One served model plus its traffic/engine shape."""

    name: str
    #: config actually executed (reduced for CPU runs).
    cfg: ModelConfig
    #: config characterized for planning; defaults to ``cfg``.  Passing the
    #: full-size sibling plans the production schedule while executing the
    #: reduced one (same split as :mod:`repro_torch.serve.concurrent`).
    plan_cfg: ModelConfig | None = None
    max_slots: int = 4
    #: KV capacity per slot, tokens.
    capacity: int = 64
    #: typical prompt length (drives the prefill phase graph).
    prompt_len: int = 8
    #: typical decode length (drives the decode macro-group scale).
    max_new: int = 16

    @property
    def planning_cfg(self) -> ModelConfig:
        return self.plan_cfg if self.plan_cfg is not None else self.cfg

    @property
    def kv_bytes_per_slot(self) -> int:
        return self.capacity * kv_bytes_per_token(self.cfg)


@dataclass(frozen=True)
class GatewayConfig:
    platform: str | Platform = "v5e-pod-split"
    objective: str = "throughput"
    model: ContentionModel | None = None
    #: shared KV budget across every tenant, bytes; None disables throttling.
    memory_budget_bytes: float | None = None
    #: registry solver entry planning the schedule ("auto" = z3 -> bb ->
    #: greedy; "anneal" opts into the device-resident search).
    solver: str = "auto"
    #: extra knobs for the named solver entry as sorted (name, value)
    #: pairs — e.g. anneal's ``devices``/``budget_ms``; validated against
    #: the entry's declared vocabulary at request construction.
    solver_knobs: tuple = ()
    max_transitions: int = 2
    #: layer-group granularity of the phase graphs (body groups per phase).
    body_groups: int = 2
    # ---- dynamic loop knobs ----
    #: 2x over the steady-state floor before firing: CPU wall-clock steps
    #: jitter far more than the simulated timeline they stand in for.
    slowdown_threshold: float = 2.0
    patience: int = 3
    cooldown: int = 16
    warmup: int = 4
    reschedule_budget_s: float = 0.5


# ---------------------------------------------------------------------------
# Planning
# ---------------------------------------------------------------------------

def tenant_phase_graph(spec: TenantSpec, platform: Platform,
                       body_groups: int = 2) -> DNNGraph:
    """Export a tenant as one prefill->decode chain (see module docstring)."""
    cfg = spec.planning_cfg
    per_group = max(1, math.ceil(cfg.n_layers / body_groups))
    pf_cell = ShapeCell(f"{spec.name}-prefill", spec.prompt_len,
                        spec.max_slots, "prefill")
    dc_cell = ShapeCell(f"{spec.name}-decode", spec.capacity,
                        spec.max_slots, "decode")
    pf = export_graph(cfg, pf_cell, platform, layers_per_group=per_group)
    dc = export_graph(cfg, dc_cell, platform, layers_per_group=per_group)
    groups = [dataclasses.replace(g, name=f"prefill:{g.name}")
              for g in pf.groups]
    for g in dc.groups:
        # one macro-group = max_new decode steps: duration/bytes scale, the
        # per-unit-time shared demand (a rate) is unchanged.
        groups.append(dataclasses.replace(
            g,
            name=f"decode:{g.name}",
            times={a: t * spec.max_new for a, t in g.times.items()},
            flops=g.flops * spec.max_new,
            hbm_bytes=g.hbm_bytes * spec.max_new,
            out_bytes=g.out_bytes * spec.max_new,
        ))
    return DNNGraph(spec.name, tuple(groups))


@dataclass
class GatewayPlan:
    """A contention-aware multi-tenant schedule plus its baselines."""

    platform: Platform
    specs: list[TenantSpec]
    graphs: list[DNNGraph]               # one per tenant, tenant order
    iterations: list[int]
    solution: Solution
    round_robin: SimResult
    #: #groups in the prefill phase per tenant (decode groups follow).
    n_prefill_groups: dict[str, int]
    #: the serializable artifact this plan came from (provenance: request
    #: hash, solver entry, solve wall-time); None only for hand-built plans.
    plan: Plan | None = None

    @property
    def speedup_vs_round_robin(self) -> float:
        return (self.solution.result.throughput_fps
                / self.round_robin.throughput_fps)

    def assignment_of(self, tenant: str) -> tuple[str, ...]:
        i = self._idx(tenant)
        return self.solution.workloads[i].assignment

    def phase_assignment(self, tenant: str) -> dict[str, tuple[str, ...]]:
        npf = self.n_prefill_groups[tenant]
        asg = self.assignment_of(tenant)
        return {"prefill": asg[:npf], "decode": asg[npf:]}

    def predicted_decode_step_ms(self, tenant: str) -> float:
        """Schedule-predicted latency of one batched decode step (ms)."""
        i = self._idx(tenant)
        npf = self.n_prefill_groups[tenant]
        dur = sum(iv.end - iv.start
                  for iv in self.solution.result.timeline
                  if iv.workload == i and iv.group >= npf)
        n_steps = self.specs[i].max_new * self.iterations[i]
        return dur / n_steps if n_steps else 0.0

    def _idx(self, tenant: str) -> int:
        for i, s in enumerate(self.specs):
            if s.name == tenant:
                return i
        raise KeyError(tenant)

    def summary(self) -> str:
        sol, rr = self.solution.result, self.round_robin
        rows = [f"objective={self.solution.kind} "
                f"optimal={self.solution.optimal}",
                f"  {'round-robin':18s} lat={rr.latency_ms:9.3f}ms "
                f"fps={rr.throughput_fps:8.1f}",
                f"  {'haxconn':18s} lat={sol.latency_ms:9.3f}ms "
                f"fps={sol.throughput_fps:8.1f} "
                f"({100 * (self.speedup_vs_round_robin - 1):+.1f}% fps)"]
        for s in self.specs:
            ph = self.phase_assignment(s.name)
            rows.append(f"    {s.name}: prefill->{set(ph['prefill'])} "
                        f"decode->{set(ph['decode'])} "
                        f"step={self.predicted_decode_step_ms(s.name):.3f}ms")
        return "\n".join(rows)


def round_robin_workloads(platform: Platform, graphs: Sequence[DNNGraph],
                          iterations: Sequence[int]) -> list[Workload]:
    """Naive multi-tenant baseline: whole model *i* on accelerator *i % n*,
    both phases pinned together, no contention awareness."""
    names = platform.names
    return [Workload(g, (names[i % len(names)],) * len(g),
                     iterations=iterations[i])
            for i, g in enumerate(graphs)]


def plan_gateway(specs: Sequence[TenantSpec],
                 gcfg: GatewayConfig = GatewayConfig(),
                 iterations: Sequence[int] | None = None,
                 deadline_s: float | None = 20.0,
                 scheduler: Scheduler | None = None, *,
                 device=None) -> GatewayPlan:
    """Contention-aware (model, phase) -> accelerator plan for all tenants.

    ``scheduler`` lets a control plane share one plan cache across tenant
    churn (and pre-load serialized :class:`Plan` artifacts so booting the
    gateway performs zero solver invocations); when given, its platform and
    model override ``gcfg.platform``/``gcfg.model``, and its device
    overrides ``device``.
    """
    sched = scheduler or Scheduler(gcfg.platform, gcfg.model, device=device)
    plat = sched.platform
    graphs = [tenant_phase_graph(s, plat, gcfg.body_groups) for s in specs]
    npf = {}
    for s, g in zip(specs, graphs):
        npf[s.name] = sum(1 for gr in g.groups
                          if gr.name.startswith("prefill:"))
    its = list(iterations or [1] * len(specs))
    plan = sched.resolve(sched.request(
        graphs, gcfg.objective, solver=gcfg.solver,
        max_transitions=gcfg.max_transitions,
        iterations=its, deadline_s=deadline_s,
        solver_knobs=dict(gcfg.solver_knobs)))
    sol = plan.solution
    # re-simulate with the timeline recorded — predicted per-step latencies
    # are read off the decode-group intervals.
    res = simulate(plat, sol.workloads, sched.model, record_timeline=True)
    sol = Solution(sol.workloads, res, sol.objective, sol.kind,
                   sol.evaluated, sol.optimal, params=dict(sol.params))
    rr = simulate(plat, round_robin_workloads(plat, graphs, its),
                  sched.model, record_timeline=False)
    return GatewayPlan(plat, list(specs), graphs, its, sol, rr, npf,
                       plan=plan)


# ---------------------------------------------------------------------------
# Runtime
# ---------------------------------------------------------------------------

@dataclass
class RescheduleEvent:
    step: int
    tenants: tuple[str, ...]
    observed_factor: float
    old_objective: float
    new_objective: float
    changed: bool


@dataclass
class GatewayStepReport:
    step: int
    active: dict[str, int]
    kv_bytes_in_use: int
    fired: tuple[str, ...]
    rescheduled: bool


class MultiTenantGateway:
    """Admits and serves requests for several models concurrently under one
    contention-aware schedule and one shared memory budget."""

    def __init__(self, specs: Sequence[TenantSpec],
                 gcfg: GatewayConfig = GatewayConfig(),
                 iterations: Sequence[int] | None = None,
                 deadline_s: float | None = 20.0, seed: int = 0,
                 scheduler: Scheduler | None = None, *, device=None):
        if len({s.name for s in specs}) != len(specs):
            raise ValueError("duplicate tenant names")
        for s in specs:
            if not s.cfg.has_decode:
                raise ValueError(
                    f"tenant {s.name!r}: {s.cfg.name} is encoder-only — "
                    f"the gateway serves decode workloads")
        self.specs = {s.name: s for s in specs}
        self.gcfg = gcfg
        # bounded cache: the gateway re-solves at runtime-observed
        # severities indefinitely, so its private cache must not grow
        # without limit (a shared scheduler manages its own policy).
        self.scheduler = scheduler or Scheduler(
            gcfg.platform, gcfg.model, cache=PlanCache(max_entries=256),
            device=device)
        dev = self.scheduler.device
        self.plan = plan_gateway(specs, gcfg, iterations, deadline_s,
                                 scheduler=self.scheduler)
        self._base_model = self.scheduler.model
        self.engines: dict[str, ServingEngine] = {}
        for i, s in enumerate(specs):
            m = build(s.cfg, device=dev)
            m.init(torch.Generator(device=dev).manual_seed(seed + i))
            self.engines[s.name] = ServingEngine(
                m, max_slots=s.max_slots, capacity=s.capacity,
                admission_gate=lambda req, name=s.name: self._gate(name, req))
        self.monitors = {
            s.name: SlowdownMonitor(threshold=gcfg.slowdown_threshold,
                                    patience=gcfg.patience,
                                    cooldown=gcfg.cooldown,
                                    warmup=gcfg.warmup)
            for s in specs}
        #: fastest observed step per tenant — the wall-clock calibration
        #: anchor (simulated predicted ms and CPU wall ms are incommensurate;
        #: deviation from the own steady-state floor is the §4.4 signal).
        self._floor_ms: dict[str, float] = {}
        self.total_steps = 0
        self.deferred_admissions = 0
        self.reschedules: list[RescheduleEvent] = []

    # ---- admission ----------------------------------------------------
    @property
    def kv_bytes_in_use(self) -> int:
        return sum(self.engines[n].active * s.kv_bytes_per_slot
                   for n, s in self.specs.items())

    def _gate(self, tenant: str, req: Request) -> bool:
        budget = self.gcfg.memory_budget_bytes
        if budget is None:
            return True
        ok = (self.kv_bytes_in_use
              + self.specs[tenant].kv_bytes_per_slot) <= budget
        if not ok:
            self.deferred_admissions += 1
        return ok

    # ---- request path -------------------------------------------------
    def submit(self, tenant: str, prompt, max_new: int | None = None,
               eos: int | None = None) -> Request:
        spec = self.specs[tenant]
        return self.engines[tenant].submit(
            prompt, max_new=max_new or spec.max_new, eos=eos)

    @property
    def has_work(self) -> bool:
        return any(e.has_work for e in self.engines.values())

    def step(self, observed_ms: Mapping[str, float] | None = None
             ) -> GatewayStepReport:
        """Multiplex one non-blocking decode step across every tenant.

        ``observed_ms`` overrides the wall-clock measurement per tenant —
        tests and replay harnesses inject deviations through it.
        """
        self.total_steps += 1
        fired: list[str] = []
        active: dict[str, int] = {}
        for name, eng in self.engines.items():
            if not eng.has_work:
                active[name] = 0
                continue
            active[name] = eng.step()
            obs = (observed_ms or {}).get(name, eng.counters.last_step_ms)
            if active[name] == 0 or obs <= 0.0:
                continue
            floor = self._floor_ms.get(name)
            # slowly-decaying minimum: one outlier-fast step cannot anchor
            # the baseline forever and poison the ratio stream.
            floor = obs if floor is None else min(floor * 1.02, obs)
            self._floor_ms[name] = floor
            if self.monitors[name].observe(obs, floor):
                fired.append(name)
        rescheduled = False
        if fired:
            rescheduled = self._reschedule(tuple(fired))
        return GatewayStepReport(self.total_steps, active,
                                 self.kv_bytes_in_use, tuple(fired),
                                 rescheduled)

    def run_until_drained(self, max_steps: int = 10000
                          ) -> dict[str, list[Request]]:
        while self.has_work and self.total_steps < max_steps:
            self.step()
        return {n: e.completed for n, e in self.engines.items()}

    def metrics(self) -> dict:
        """Telemetry snapshot: one ``tenants`` row per engine in the
        canonical :data:`~repro_torch.serve.engine.METRIC_KEYS` shape plus
        gateway-level aggregates — the same format the fleet loop
        (:mod:`repro_torch.serve.fleet`) consumes and re-emits."""
        tenants = {n: e.metrics() for n, e in self.engines.items()}
        return conform(GATEWAY_SCHEMA, {
            "steps": self.total_steps,
            "kv_bytes_in_use": self.kv_bytes_in_use,
            "deferred_admissions": self.deferred_admissions,
            "reschedules": len(self.reschedules),
        }, tenants=tenants)

    # ---- dynamic loop -------------------------------------------------
    def _reschedule(self, tenants: tuple[str, ...]) -> bool:
        """Re-solve under the observed contention severity (§4.4).

        The incumbent schedule is re-evaluated under the same scaled model
        and kept unless the bounded re-solve genuinely improves on it — a
        budget-starved solver slice must never replace a good plan with a
        naive one.  Both objectives in the recorded event are therefore
        commensurate (same contention model).
        """
        # quantized once, up front: the incumbent re-evaluation and the
        # re-solve must price contention under the *same* model or their
        # objectives are incommensurate.
        factor = quantize_severity(
            max(self.monitors[n].ratio for n in tenants))
        model = ScaledContentionModel(self._base_model, factor)
        old = self.plan.solution
        cur_res = simulate(self.plan.platform, old.workloads, model,
                           record_timeline=True)
        cur_obj = cur_res.objective(self.gcfg.objective)
        rplan = reschedule_plan(
            self.scheduler, self.plan.graphs, factor,
            objective=self.gcfg.objective,
            max_transitions=self.gcfg.max_transitions,
            iterations=self.plan.iterations,
            budget_s=self.gcfg.reschedule_budget_s)
        best = rplan.solution
        if best.objective < cur_obj - 1e-9:
            res = simulate(self.plan.platform, best.workloads, model,
                           record_timeline=True)
            new = Solution(best.workloads, res, best.objective,
                           best.kind, best.evaluated, best.optimal)
            art = rplan          # provenance follows the adopted schedule
        else:
            new = Solution(old.workloads, cur_res, cur_obj, old.kind,
                           best.evaluated, False)
            art = self.plan.plan
        changed = new.assignments != old.assignments
        self.reschedules.append(RescheduleEvent(
            self.total_steps, tenants, factor, cur_obj, new.objective,
            changed))
        get_tracer().instant("gateway.reschedule", "dynamic",
                             step=self.total_steps,
                             tenants=",".join(tenants), factor=factor,
                             changed=changed)
        get_registry().counter(
            "gateway_reschedules",
            "§4.4 slowdown-triggered re-schedules").labels(
                changed=str(changed).lower()).inc()
        self.plan = dataclasses.replace(self.plan, solution=new, plan=art)
        for n in tenants:
            self.monitors[n].reset()
            # the post-adaptation steady state becomes the new baseline
            self._floor_ms.pop(n, None)
        return changed

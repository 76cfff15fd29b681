"""Fleet gateway front-end: multiplex thousands of tenants over a small
pool of contention-aware SoC plans.

The existing :class:`~repro_torch.serve.gateway.MultiTenantGateway` steps a
handful of tenants synchronously — one engine per tenant, real compute.
A fleet control plane faces the opposite shape: *hundreds to thousands*
of open-loop tenants, a *small* pool of solved SoC plans (one per device
split / placement the solver produced), and the questions that matter are
queueing, admission and tail latency, not token values.  This module is
that front-end:

* :class:`PoolPlan` — one solved multi-tenant schedule
  (:func:`~repro_torch.serve.gateway.plan_gateway` product) promoted to a fleet
  serving unit: per-tenant-class predicted decode-step latencies, a slot
  count, KV bytes per request, and the :class:`~repro_torch.core.Scheduler`
  that owns its plan cache (re-solves route through it, so §4.4
  re-schedules are cached/persisted like offline solves).
* :class:`FleetGateway` — a deterministic virtual-time event machine:
  arrivals drain into per-tenant queues, the
  :class:`~repro_torch.serve.fleet.slo.AdmissionController` decides
  shed/admit/defer and routes each request to a pool plan (SLO-aware
  earliest-finish or static round-robin), plan slots serve requests with
  the schedule-predicted service times, and per-request
  queueing/service/slowdown telemetry is recorded in flat arrays.
  Replaying a million-request :class:`~repro_torch.serve.fleet.traffic.
  ArrivalTrace` is a tight Python/heapq loop — no real compute, bit-
  deterministic, fast enough for CI.
* **§4.4 in the fleet loop** — per-plan
  :class:`~repro_torch.core.dynamic.SlowdownMonitor` watches observed step
  latency against the plan's steady-state floor; external contention
  (injected via ``contention_events``) fires the monitor, and the gateway
  re-solves that pool plan under the observed severity
  (:func:`~repro_torch.core.dynamic.reschedule_plan`), adopting the new
  assignment only when it genuinely improves the scaled-model objective.
* **Closed-loop recalibration** — pass a
  :class:`~repro_torch.profiling.online.StreamingRecalibrator` and every
  completion under external demand feeds an ``(own, ext, slowdown)``
  telemetry sample into it; each monitor firing first steps the
  recalibrator, and a published re-fit is adopted into *every* pool
  plan's scheduler before the re-solve, so the §4.4 response prices
  contention against the live surface instead of the stale offline one.
  When re-solving under the re-fitted model still cannot meet a tenant's
  SLO, the tenant is duty-cycled
  (:class:`~repro_torch.serve.fleet.slo.TenantThrottle` +
  ``AdmissionController.duty_admit``) until its miss rate recovers —
  re-solve first, shed load second.
* :func:`serve_async` — an ``asyncio`` front-end over the same machine:
  submissions become awaitable completions, arrivals are paced in wall
  time (``time_scale``), so an interactive service and the virtual-time
  replay share one implementation.

Wall-clock time never enters the model: the clock is the trace's, service
times are the solved schedule's predictions, and a replay is reproducible
bit-for-bit from ``(trace, pool, config)``.
"""
from __future__ import annotations

import asyncio
import dataclasses
import heapq
from collections import deque
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Callable, Mapping, Sequence

import numpy as np

from repro_torch.core.dynamic import (ScaledContentionModel, SlowdownMonitor,
                                quantize_severity, reschedule_plan)
from repro_torch.core.scheduler import Scheduler
from repro_torch.core.simulate import simulate
from repro_torch.core.solver_bb import Solution
from repro_torch.obs import (GATEWAY_SCHEMA, TENANT_SCHEMA, conform, get_logger,
                       get_tracer)
from repro_torch.serve.gateway import (GatewayConfig, GatewayPlan, TenantSpec,
                                 plan_gateway)
from repro_torch.serve.fleet.slo import SLO, AdmissionController, TenantThrottle
from repro_torch.serve.fleet.traffic import ArrivalTrace

log = get_logger(__name__)

if TYPE_CHECKING:  # pragma: no cover - annotation only
    from repro_torch.profiling.online import StreamingRecalibrator

# request status codes (FleetReport.status)
PENDING, RUNNING, DONE, SHED, THROTTLED = 0, 1, 2, 3, 4

#: a contention oracle maps ``(pool_plan, ext_demand)`` to the true
#: per-class severity factors — benchmark harnesses wrap the generating
#: model here so injected *demand* is priced through ground truth while
#: the gateway's own model may have drifted away from it.
ContentionOracle = Callable[["PoolPlan", float], "float | np.ndarray"]


# ---------------------------------------------------------------------------
# PoolPlan
# ---------------------------------------------------------------------------

@dataclass
class PoolPlan:
    """One solved SoC schedule serving a share of the fleet."""

    name: str
    plan: GatewayPlan
    scheduler: Scheduler
    #: concurrent requests this plan serves (the schedule's batch width).
    slots: int
    #: tenant-class names, index-aligned with the step/kv arrays.
    classes: tuple[str, ...] = field(init=False)
    #: current predicted decode-step ms per class (includes any applied
    #: contention severity; the number the loop bills service time from).
    step_ms: np.ndarray = field(init=False)
    #: steady-state floor per class (factor 1.0) — the §4.4 baseline.
    base_step_ms: np.ndarray = field(init=False)
    #: KV bytes one in-flight request pins, per class.
    kv_bytes: np.ndarray = field(init=False)
    #: mean shared-memory demand of each class's decode groups on their
    #: assigned accelerators — the ``own`` coordinate of the telemetry
    #: samples the online recalibrator consumes.
    class_demand: np.ndarray = field(init=False)
    #: external contention severity currently applied per class (1 = none).
    factor_per_class: np.ndarray = field(init=False)
    #: scalar view of the applied severity (mean over classes) — the §4.4
    #: deviation signal and the back-compat knob for scalar callers.
    factor: float = 1.0

    def __post_init__(self):
        if self.slots < 1:
            raise ValueError("slots must be >= 1")
        self.classes = tuple(s.name for s in self.plan.specs)
        self.base_step_ms = np.array(
            [self.plan.predicted_decode_step_ms(c) for c in self.classes])
        if np.any(self.base_step_ms <= 0.0):
            raise ValueError(
                f"pool plan {self.name!r}: non-positive predicted decode "
                f"step — the schedule cannot price service time")
        self.step_ms = self.base_step_ms.copy()
        self.kv_bytes = np.array(
            [float(s.kv_bytes_per_slot) for s in self.plan.specs])
        self.factor_per_class = np.ones(len(self.classes))
        self.class_demand = self._class_demand()

    def service_ms(self, cls: int, max_new: int) -> float:
        """Predicted service time of one request (decode macro steps)."""
        return float(self.step_ms[cls]) * max_new

    # -- §4.4 surface ------------------------------------------------------
    def _steps_under(self, solution: Solution) -> np.ndarray:
        view = dataclasses.replace(self.plan, solution=solution)
        return np.array(
            [view.predicted_decode_step_ms(c) for c in self.classes])

    def _class_demand(self) -> np.ndarray:
        """Mean decode-group memory demand per class under the current
        assignment (fraction of shared-domain capacity)."""
        out = np.zeros(len(self.classes))
        for j, (cls, graph) in enumerate(zip(self.classes,
                                             self.plan.graphs)):
            npf = self.plan.n_prefill_groups[cls]
            asg = self.plan.assignment_of(cls)
            dem = [graph.groups[g].demand_on(asg[g])
                   for g in range(npf, len(graph))]
            out[j] = float(np.mean(dem)) if dem else 0.0
        return out

    def apply_factor(self, factor: "float | np.ndarray") -> None:
        """Apply external contention severity ``factor`` (1.0 = none).

        Models a co-runner the schedule did not plan for — another
        workload on the SoC saturating the shared-memory domains — which
        slows every group on this plan multiplicatively.  A scalar slows
        all classes uniformly; a per-class array (a contention oracle's
        output) prices each class at its own severity.  Observed step
        latency becomes ``base * factor``, which is exactly the deviation
        signal the §4.4 :class:`SlowdownMonitor` consumes; the response
        (:meth:`reschedule`) re-solves under a contention model rescaled
        to the observed severity.
        """
        vec = np.broadcast_to(np.asarray(factor, dtype=float),
                              (len(self.classes),)).copy()
        if np.any(vec <= 0.0):
            raise ValueError("contention factor must be > 0")
        self.factor_per_class = vec
        self.factor = float(vec.mean())
        self.step_ms = self.base_step_ms * vec

    def adopt_model(self, model, *, objective: str = "throughput") -> None:
        """Swap the scheduler's contention model for a re-fitted one.

        The closed loop calls this when the online recalibrator publishes:
        future re-solves price contention against the live surface, and
        the steady-state floor (``base_step_ms``) is re-simulated under it
        so the §4.4 monitor's deviation baseline tracks the new model.
        The applied external severity carries over unchanged.
        """
        self.scheduler.model = model
        sol = self.plan.solution
        res = simulate(self.plan.platform, sol.workloads, model,
                       record_timeline=True)
        new = Solution(sol.workloads, res, res.objective(objective),
                       sol.kind, sol.evaluated, False)
        self.plan = dataclasses.replace(self.plan, solution=new)
        self.base_step_ms = self._steps_under(new)
        self.apply_factor(self.factor_per_class)

    def reschedule(self, observed_factor: float, *, objective: str,
                   max_transitions: int, budget_s: float) -> tuple[bool, float, float]:
        """§4.4 re-solve under the observed severity; adopt only if better.

        Returns ``(changed, old_objective, new_objective)`` — both priced
        under the same scaled model, exactly like
        ``MultiTenantGateway._reschedule``.
        """
        factor = quantize_severity(observed_factor)
        model = ScaledContentionModel(self.scheduler.model, factor)
        old = self.plan.solution
        cur_res = simulate(self.plan.platform, old.workloads, model,
                           record_timeline=True)
        cur_obj = cur_res.objective(objective)
        rplan = reschedule_plan(
            self.scheduler, self.plan.graphs, factor, objective=objective,
            max_transitions=max_transitions,
            iterations=self.plan.iterations, budget_s=budget_s)
        best = rplan.solution
        if best.objective < cur_obj - 1e-9:
            res = simulate(self.plan.platform, best.workloads, model,
                           record_timeline=True)
            new = Solution(best.workloads, res, best.objective, best.kind,
                           best.evaluated, best.optimal)
            art = rplan
        else:
            new = Solution(old.workloads, cur_res, cur_obj, old.kind,
                           best.evaluated, False)
            art = self.plan.plan
        changed = new.assignments != old.assignments
        self.plan = dataclasses.replace(self.plan, solution=new, plan=art)
        # steady-state floor follows the adopted assignment; current step
        # table prices it at the live severity.
        base_model = self.scheduler.model
        base_res = simulate(self.plan.platform, new.workloads, base_model,
                            record_timeline=True)
        self.base_step_ms = self._steps_under(
            Solution(new.workloads, base_res,
                     base_res.objective(objective), new.kind,
                     new.evaluated, False))
        self.class_demand = self._class_demand()
        self.apply_factor(self.factor_per_class)
        return changed, cur_obj, new.objective


def build_pool(specs: Sequence[TenantSpec],
               platforms: Sequence,
               gcfg: GatewayConfig | None = None,
               cache=None, *, slots: int | None = None,
               deadline_s: float | None = 20.0,
               device=None) -> list[PoolPlan]:
    """Solve one :class:`PoolPlan` per platform (pod split / SoC).

    All schedulers share ``cache`` — point it at a
    :class:`~repro_torch.core.plan.ShardedPlanCache` root and a later
    ``build_pool`` over the same platforms boots every plan from disk
    with zero solver invocations (each plan is one O(load-a-JSON) read;
    shards keep concurrent control planes from contending on one index).
    ``device`` is where each scheduler's torch evaluator and anneal
    search run (``cuda`` unless asked otherwise).
    """
    pool = []
    for plat in platforms:
        cfg = dataclasses.replace(gcfg or GatewayConfig(), platform=plat)
        sched = Scheduler(cfg.platform, cfg.model, cache=cache,
                          device=device)
        gwplan = plan_gateway(specs, cfg, deadline_s=deadline_s,
                              scheduler=sched)
        pool.append(PoolPlan(
            name=getattr(plat, "name", str(plat)), plan=gwplan,
            scheduler=sched,
            slots=slots or sum(s.max_slots for s in specs)))
    return pool


# ---------------------------------------------------------------------------
# FleetGateway
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FleetConfig:
    """Knobs of the fleet loop (routing + admission + §4.4)."""

    #: "slo" = earliest-predicted-finish routing; "round_robin" = static
    #: tenant-hash placement (the baseline the benchmark compares against).
    policy: str = "slo"
    default_slo: SLO = SLO(p99_ms=1000.0)
    #: fleet-wide KV budget (bytes); None disables memory admission.
    memory_budget_bytes: float | None = None
    max_queue_per_tenant: int = 64
    shed_factor: float = 4.0
    objective: str = "throughput"
    max_transitions: int = 2
    # ---- §4.4 knobs (per pool plan) ----
    slowdown_threshold: float = 1.5
    patience: int = 8
    cooldown: int = 256
    warmup: int = 0
    reschedule_budget_s: float = 0.25
    # ---- throttle knobs (second control axis; see slo.TenantThrottle) ----
    #: enable per-tenant duty-cycling of SLO-violating tenants.  Only
    #: engages after at least one §4.4 re-solve — re-solve first, shed
    #: load second.
    throttle: bool = False
    #: fraction of a throttled tenant's arrivals that are still admitted.
    throttle_duty: float = 0.5
    throttle_enter: float = 0.5
    throttle_exit: float = 0.1
    throttle_patience: int = 8
    #: prediction headroom: at reschedule time a tenant is throttled when
    #: its predicted finish (best-plan queueing + service) exceeds
    #: ``throttle_margin * p99_ms`` — engaging at a fraction of the budget
    #: drains the backlog *before* deadlines start blowing.
    throttle_margin: float = 0.5

    def __post_init__(self):
        if self.policy not in ("slo", "round_robin"):
            raise ValueError(
                f"unknown policy {self.policy!r} (slo | round_robin)")
        if not 0.0 < self.throttle_duty < 1.0:
            raise ValueError("throttle_duty must be in (0, 1)")


@dataclass
class FleetRescheduleEvent:
    t_ms: float
    plan: str
    observed_factor: float
    old_objective: float
    new_objective: float
    changed: bool


class _Records:
    """Flat per-request telemetry, growable (asyncio path) but usually
    preallocated to the trace length (replay path)."""

    __slots__ = ("n", "tenant", "cls", "plan", "t_arrive", "t_start",
                 "t_end", "service_ms", "est_ms", "max_new", "status",
                 "ext", "floor_ms")

    def __init__(self, capacity: int):
        capacity = max(16, capacity)
        self.n = 0
        self.tenant = np.zeros(capacity, np.int32)
        self.cls = np.zeros(capacity, np.int16)
        self.plan = np.full(capacity, -1, np.int16)
        self.t_arrive = np.zeros(capacity, np.float64)
        self.t_start = np.full(capacity, np.nan)
        self.t_end = np.full(capacity, np.nan)
        self.service_ms = np.zeros(capacity, np.float64)
        self.est_ms = np.zeros(capacity, np.float64)
        self.max_new = np.zeros(capacity, np.int32)
        self.status = np.zeros(capacity, np.int8)
        # telemetry basis captured at service *start* (demand and floor can
        # both move while a request is in flight; attributing the observed
        # slowdown to completion-time state would poison the re-fit window).
        self.ext = np.zeros(capacity, np.float64)
        self.floor_ms = np.zeros(capacity, np.float64)

    def append(self, tenant: int, cls: int, t: float, max_new: int) -> int:
        if self.n == len(self.tenant):
            for name in self.__slots__[1:]:
                arr = getattr(self, name)
                grown = np.empty(2 * len(arr), arr.dtype)
                grown[:len(arr)] = arr
                setattr(self, name, grown)
        i = self.n
        self.tenant[i] = tenant
        self.cls[i] = cls
        self.t_arrive[i] = t
        self.max_new[i] = max_new
        self.plan[i] = -1
        self.t_start[i] = np.nan
        self.t_end[i] = np.nan
        self.service_ms[i] = 0.0
        self.est_ms[i] = 0.0
        self.status[i] = PENDING
        self.ext[i] = 0.0
        self.floor_ms[i] = 0.0
        self.n += 1
        return i


@dataclass
class FleetReport:
    """Per-request telemetry + aggregates of one replay."""

    n_tenants: int
    classes: tuple[str, ...]
    policy: str
    tenant: np.ndarray
    cls: np.ndarray
    plan: np.ndarray
    t_arrive: np.ndarray
    t_start: np.ndarray
    t_end: np.ndarray
    service_ms: np.ndarray
    max_new: np.ndarray
    status: np.ndarray
    reschedules: list[FleetRescheduleEvent]
    shed: int
    deferred: int
    slos: Mapping[int, SLO]
    default_slo: SLO
    #: (t_ms, bundle_hash, max_rel_err) per published online re-fit.
    recalibrations: list = field(default_factory=list)
    #: (t_ms, tenant, "throttle" | "release") duty-cycle switches.
    throttle_events: list = field(default_factory=list)
    #: arrivals refused by the duty gate (status THROTTLED).
    throttled: int = 0
    #: pool-plan names, index-aligned with the ``plan`` column (trace
    #: export track labels); empty for pre-obs reports.
    plan_names: tuple = ()

    # -- derived -----------------------------------------------------------
    @property
    def n_requests(self) -> int:
        return len(self.tenant)

    @property
    def completed(self) -> int:
        return int(np.sum(self.status == DONE))

    @property
    def done_mask(self) -> np.ndarray:
        return self.status == DONE

    @property
    def latency_ms(self) -> np.ndarray:
        """End-to-end latency of completed requests (queueing + service)."""
        m = self.done_mask
        return self.t_end[m] - self.t_arrive[m]

    @property
    def wait_ms(self) -> np.ndarray:
        m = self.done_mask
        return self.t_start[m] - self.t_arrive[m]

    @property
    def slowdown(self) -> np.ndarray:
        """Latency / pure-service ratio per completed request (>= 1)."""
        m = self.done_mask
        return (self.t_end[m] - self.t_arrive[m]) / self.service_ms[m]

    def percentile(self, q: float) -> float:
        lat = self.latency_ms
        return float(np.percentile(lat, q)) if len(lat) else float("nan")

    @property
    def p50_ms(self) -> float:
        return self.percentile(50.0)

    @property
    def p99_ms(self) -> float:
        return self.percentile(99.0)

    @property
    def makespan_ms(self) -> float:
        ends = self.t_end[self.done_mask]
        if not len(ends):
            return 0.0
        return float(ends.max() - self.t_arrive.min())

    @property
    def sustained_rps(self) -> float:
        mk = self.makespan_ms
        return 1e3 * self.completed / mk if mk > 0.0 else 0.0

    # -- SLO accounting ----------------------------------------------------
    def _slo_for(self, tenant: int) -> SLO:
        return self.slos.get(tenant, self.default_slo)

    def slo_report(self) -> dict:
        """Per-tenant p99 / completion rate vs target, aggregated.

        A tenant violates when its observed p99 exceeds its budget or its
        completion throughput (over the trace span) undershoots its floor.
        """
        m = self.done_mask
        lat = self.t_end[m] - self.t_arrive[m]
        ten = self.tenant[m]
        span_s = self.makespan_ms / 1e3
        order = np.argsort(ten, kind="stable")
        ten_sorted, lat_sorted = ten[order], lat[order]
        bounds = np.searchsorted(ten_sorted,
                                 np.arange(self.n_tenants + 1))
        p99_violations = throughput_violations = served_tenants = 0
        for t in range(self.n_tenants):
            lo, hi = bounds[t], bounds[t + 1]
            if hi == lo:
                continue
            served_tenants += 1
            slo = self._slo_for(t)
            if float(np.percentile(lat_sorted[lo:hi], 99.0)) > slo.p99_ms:
                p99_violations += 1
            if (slo.throughput_rps > 0.0 and span_s > 0.0
                    and (hi - lo) / span_s < slo.throughput_rps):
                throughput_violations += 1
        return {"served_tenants": served_tenants,
                "p99_violations": p99_violations,
                "throughput_violations": throughput_violations,
                "shed": self.shed, "throttled": self.throttled}

    def tenant_metrics(self, tenant: int) -> dict:
        """One tenant's telemetry in the canonical
        :data:`~repro_torch.serve.engine.METRIC_KEYS` shape."""
        mine = self.tenant == tenant
        done = mine & self.done_mask
        running = mine & (self.status == RUNNING)
        queued = mine & (self.status == PENDING)
        steps = int(self.max_new[done].sum())
        svc = self.service_ms[done]
        per_step = (svc / self.max_new[done]) if len(svc) else np.array([])
        return conform(TENANT_SCHEMA, {
            "steps": steps,
            "active": int(running.sum()),
            "queue_depth": int(queued.sum()),
            "admitted": int(mine.sum())
            - int((self.status[mine] == SHED).sum())
            - int((self.status[mine] == THROTTLED).sum()),
            "completed": int(done.sum()),
            "deferred": 0,      # deferral is fleet-global (KV budget)
            "tokens_out": steps,
            "last_step_ms": float(per_step[-1]) if len(per_step) else 0.0,
            "mean_step_ms": float(per_step.mean()) if len(per_step) else 0.0,
        })

    # -- trace export ------------------------------------------------------
    def trace_events(self, max_requests: int | None = 50_000,
                     track_id: Callable[[str], int] | None = None
                     ) -> list[dict]:
        """Chrome trace events derived post hoc from the record arrays.

        One queue span (arrival -> service start) and one service span
        (start -> end) per completed request, on the owning pool plan's
        track — derived in bulk from the flat NumPy columns, never
        recorded live, so the replay hot loop stays untouched.

        ``track_id`` maps a track name to a tid (pass
        ``Tracer.track_id`` when ingesting via ``Tracer.add_events`` so
        tids share the tracer's registry and its ``thread_name``
        metadata covers them); without it the events are standalone and
        carry their own metadata records.  At most ``max_requests``
        requests are exported (``None`` = all); truncation is logged
        and visible in the event count, never silent.
        """
        idx = np.flatnonzero(self.status == DONE)
        total = len(idx)
        if max_requests is not None and total > max_requests:
            log.info("trace export truncated to the first %d of %d "
                     "completed requests", max_requests, total)
            idx = idx[:max_requests]
        names = self.plan_names or tuple(
            f"plan{p}" for p in range(int(self.plan.max(initial=-1)) + 1))
        events: list[dict] = []
        if track_id is None:
            tids = {nm: 2 * p + 1 for p, nm in enumerate(names)}
            tids.update({f"{nm}/queue": 2 * p + 2
                         for p, nm in enumerate(names)})
            events += [{"ph": "M", "name": "thread_name", "pid": 1,
                        "tid": t, "args": {"name": nm}}
                       for nm, t in tids.items()]
            track_id = tids.__getitem__
        svc_tid = [track_id(nm) for nm in names]
        q_tid = [track_id(f"{nm}/queue") for nm in names]
        plan = self.plan[idx]
        tenant = self.tenant[idx]
        cls = self.cls[idx]
        ts_q = np.round(self.t_arrive[idx] * 1e3, 3)
        start = self.t_start[idx]
        dur_q = np.round((start - self.t_arrive[idx]) * 1e3, 3)
        ts_s = np.round(start * 1e3, 3)
        dur_s = np.round((self.t_end[idx] - start) * 1e3, 3)
        cls_names = self.classes
        for j in range(len(idx)):
            p = int(plan[j])
            name = cls_names[int(cls[j])] if cls_names else str(int(cls[j]))
            t = int(tenant[j])
            if dur_q[j] > 0.0:
                events.append({
                    "ph": "X", "name": f"queue:{name}", "cat": "queue",
                    "ts": float(ts_q[j]), "dur": float(dur_q[j]),
                    "pid": 1, "tid": q_tid[p], "args": {"tenant": t}})
            events.append({
                "ph": "X", "name": name, "cat": "service",
                "ts": float(ts_s[j]), "dur": float(dur_s[j]),
                "pid": 1, "tid": svc_tid[p],
                "args": {"tenant": t, "wait_ms": float(dur_q[j])}})
        return events

    def summary(self) -> str:
        slo = self.slo_report()
        rows = [
            f"fleet[{self.policy}] requests={self.n_requests} "
            f"completed={self.completed} shed={self.shed} "
            f"deferred={self.deferred}",
            f"  latency p50={self.p50_ms:.1f}ms p99={self.p99_ms:.1f}ms "
            f"sustained={self.sustained_rps:.1f} req/s",
            f"  slo: {slo['p99_violations']}/{slo['served_tenants']} "
            f"tenants over p99 budget, "
            f"{slo['throughput_violations']} under throughput floor",
            f"  reschedules={len(self.reschedules)} "
            f"recalibrations={len(self.recalibrations)} "
            f"throttled={self.throttled}",
        ]
        return "\n".join(rows)


class FleetGateway:
    """Virtual-time multiplexer of an open-loop fleet over a plan pool.

    Deterministic by construction: no RNG, no wall clock — identical
    ``(pool, config, trace, contention_events)`` replay identically.
    """

    def __init__(self, pool: Sequence[PoolPlan], n_tenants: int,
                 cfg: FleetConfig = FleetConfig(),
                 slos: Mapping[int, SLO] | None = None,
                 capacity_hint: int = 0, *,
                 recalibrator: "StreamingRecalibrator | None" = None,
                 contention_oracle: ContentionOracle | None = None):
        if not pool:
            raise ValueError("pool must hold at least one PoolPlan")
        classes = pool[0].classes
        for pp in pool:
            if pp.classes != classes:
                raise ValueError(
                    f"pool plans serve different tenant-class sets: "
                    f"{pp.classes} != {classes}")
        if n_tenants < 1:
            raise ValueError("n_tenants must be >= 1")
        self.pool = list(pool)
        self.classes = classes
        self.n_tenants = n_tenants
        self.cfg = cfg
        self.controller = AdmissionController(
            budget_bytes=cfg.memory_budget_bytes,
            default_slo=cfg.default_slo, slos=slos,
            max_queue_per_tenant=cfg.max_queue_per_tenant,
            shed_factor=cfg.shed_factor)
        self.monitors = [
            SlowdownMonitor(threshold=cfg.slowdown_threshold,
                            patience=cfg.patience, cooldown=cfg.cooldown,
                            warmup=cfg.warmup)
            for _ in pool]
        self.reschedules: list[FleetRescheduleEvent] = []
        # closed-loop recalibration + throttling state
        self.recalibrator = recalibrator
        self.contention_oracle = contention_oracle
        self.recalibrations: list[tuple[float, str, float]] = []
        self.throttle_events: list[tuple[float, int, str]] = []
        self._throttles: dict[int, TenantThrottle] = {}
        #: external antagonist demand currently applied per plan (the
        #: ``ext`` coordinate of recalibration telemetry; 0 = none known).
        self._ext_demand = [0.0] * len(pool)
        # runtime state
        self._rec = _Records(capacity_hint)
        self._now = 0.0
        self._seq = 0
        self._heap: list[tuple[float, int, int]] = []      # (end, seq, req)
        self._free_slots = [pp.slots for pp in self.pool]
        #: per-plan FIFO of queued request indices (drained into slots).
        self._plan_q: list[deque[int]] = [deque() for _ in self.pool]
        #: per-plan outstanding predicted work (ms) — the routing signal.
        self._load_ms = np.zeros(len(self.pool))
        #: per-tenant queued-request depth (admission signal).
        self._tenant_depth = np.zeros(n_tenants, np.int32)
        #: asyncio futures resolved at completion (serve_async only).
        self._futures: dict[int, asyncio.Future] = {}

    # -- class mapping -----------------------------------------------------
    def class_of(self, tenant: int) -> int:
        return tenant % len(self.classes)

    @property
    def now_ms(self) -> float:
        return self._now

    # -- arrivals ----------------------------------------------------------
    def submit(self, t_ms: float, tenant: int, max_new: int) -> int:
        """One open-loop arrival at virtual time ``t_ms``.

        Returns the request index, or -1 when the request was shed.
        Arrival times must be non-decreasing (the trace invariant).
        """
        self.advance(t_ms)
        if not 0 <= tenant < self.n_tenants:
            raise ValueError(f"tenant {tenant} out of range")
        cls = self.class_of(tenant)
        if not self.controller.duty_admit(tenant):
            i = self._rec.append(tenant, cls, t_ms, max_new)
            self._rec.status[i] = THROTTLED
            self._resolve_future(i)
            return -1
        waits = [self._load_ms[p] / self.pool[p].slots
                 for p in range(len(self.pool))]
        if self.controller.should_shed(
                tenant, int(self._tenant_depth[tenant]), min(waits)):
            i = self._rec.append(tenant, cls, t_ms, max_new)
            self._rec.status[i] = SHED
            self._resolve_future(i)
            return -1
        if self.cfg.policy == "round_robin":
            p = tenant % len(self.pool)
        else:
            services = [pp.service_ms(cls, max_new) for pp in self.pool]
            p = self.controller.select_plan(waits, services)
        i = self._rec.append(tenant, cls, t_ms, max_new)
        self._rec.plan[i] = p
        est = self.pool[p].service_ms(cls, max_new)
        self._rec.est_ms[i] = est
        self._load_ms[p] += est
        self._tenant_depth[tenant] += 1
        self._plan_q[p].append(i)
        self._try_start(p)
        return i

    # -- event machine -----------------------------------------------------
    def advance(self, t_ms: float) -> None:
        """Process completions up to virtual time ``t_ms``."""
        if t_ms < self._now - 1e-9:
            raise ValueError(
                f"time went backwards: {t_ms} < {self._now}")
        heap = self._heap
        while heap and heap[0][0] <= t_ms:
            end, _, i = heapq.heappop(heap)
            self._now = max(self._now, end)
            self._complete(i, end)
        self._now = max(self._now, t_ms)

    def drain(self) -> None:
        """Run the clock forward until every admitted request completed."""
        while self._heap:
            end, _, i = heapq.heappop(self._heap)
            self._now = max(self._now, end)
            self._complete(i, end)

    def _try_start(self, p: int) -> None:
        pp = self.pool[p]
        q = self._plan_q[p]
        while q and self._free_slots[p] > 0:
            i = q[0]
            cls = int(self._rec.cls[i])
            if not self.controller.try_acquire(float(pp.kv_bytes[cls])):
                break                         # deferred: retried on frees
            q.popleft()
            self._free_slots[p] -= 1
            self._tenant_depth[self._rec.tenant[i]] -= 1
            service = pp.service_ms(cls, int(self._rec.max_new[i]))
            start = max(self._now, float(self._rec.t_arrive[i]))
            self._rec.t_start[i] = start
            self._rec.service_ms[i] = service
            self._rec.ext[i] = self._ext_demand[p]
            self._rec.floor_ms[i] = float(pp.base_step_ms[cls])
            self._rec.t_end[i] = start + service
            self._rec.status[i] = RUNNING
            self._seq += 1
            heapq.heappush(self._heap, (start + service, self._seq, i))

    def _complete(self, i: int, end: float) -> None:
        p = int(self._rec.plan[i])
        cls = int(self._rec.cls[i])
        pp = self.pool[p]
        self._rec.status[i] = DONE
        self._free_slots[p] += 1
        self._load_ms[p] = max(0.0, self._load_ms[p] - self._rec.est_ms[i])
        self.controller.release(float(pp.kv_bytes[cls]))
        self._resolve_future(i)
        # §4.4: observed per-step latency vs the steady-state floor.
        observed = self._rec.service_ms[i] / max(1, self._rec.max_new[i])
        floor = float(pp.base_step_ms[cls])
        # closed loop, axis 1: stream (own, ext, slowdown) telemetry into
        # the recalibrator whenever external demand is known — priced
        # against the demand/floor in effect when service *started*.
        ext = float(self._rec.ext[i])
        floor_at_start = float(self._rec.floor_ms[i])
        if (self.recalibrator is not None and ext > 0.0
                and floor_at_start > 0.0):
            self.recalibrator.observe(float(pp.class_demand[cls]), ext,
                                      observed / floor_at_start)
        # closed loop, axis 2: duty-cycle tenants whose SLOs keep missing
        # *after* re-solving had its chance (gate on a past reschedule).
        if self.cfg.throttle and self.reschedules:
            tenant = int(self._rec.tenant[i])
            slo = self.controller.slo_for(tenant)
            missed = (end - float(self._rec.t_arrive[i])) > slo.p99_ms
            th = self._throttles.get(tenant)
            if th is None:
                th = self._throttles[tenant] = TenantThrottle(
                    enter_miss_rate=self.cfg.throttle_enter,
                    exit_miss_rate=self.cfg.throttle_exit,
                    patience=self.cfg.throttle_patience)
            hold = th.throttled and self._pressure() >= \
                self.cfg.slowdown_threshold
            action = th.observe(missed, hold=hold)
            if action == "throttle":
                self.controller.set_duty(tenant, self.cfg.throttle_duty)
                self.throttle_events.append((end, tenant, action))
                get_tracer().instant("fleet.throttle", "dynamic",
                                     ts_ms=end, track="fleet",
                                     tenant=tenant,
                                     duty=self.cfg.throttle_duty)
            elif action == "release":
                self.controller.set_duty(tenant, 1.0)
                self.throttle_events.append((end, tenant, action))
                get_tracer().instant("fleet.release", "dynamic",
                                     ts_ms=end, track="fleet",
                                     tenant=tenant)
        if self.monitors[p].observe(observed, floor):
            self._reschedule(p, end)
        # a freed slot (or KV budget) may unblock any plan's queue.
        for other in range(len(self.pool)):
            if self._plan_q[other] and self._free_slots[other] > 0:
                self._try_start(other)

    def _reschedule(self, p: int, t_ms: float) -> None:
        pp = self.pool[p]
        # the re-fit runs *before* the re-solve: a published bundle is
        # adopted into every pool plan's scheduler, so the §4.4 response
        # below prices contention against the live surface.
        if self.recalibrator is not None:
            published = self.recalibrator.step()
            if published is not None:
                err = (self.recalibrator.events[-1].max_rel_err
                       if self.recalibrator.events else float("nan"))
                self.recalibrations.append(
                    (t_ms, published.bundle_hash(), err))
                get_tracer().instant(
                    "fleet.recalibration", "recalibrate", ts_ms=t_ms,
                    track="fleet", bundle=published.bundle_hash()[:12],
                    max_rel_err=round(err, 6))
                for other in self.pool:
                    other.adopt_model(published.model,
                                      objective=self.cfg.objective)
        factor = quantize_severity(self.monitors[p].ratio)
        changed, old_obj, new_obj = pp.reschedule(
            factor, objective=self.cfg.objective,
            max_transitions=self.cfg.max_transitions,
            budget_s=self.cfg.reschedule_budget_s)
        self.reschedules.append(FleetRescheduleEvent(
            t_ms, pp.name, factor, old_obj, new_obj, changed))
        get_tracer().instant("fleet.reschedule", "dynamic", ts_ms=t_ms,
                             track="fleet", plan=pp.name, factor=factor,
                             changed=changed)
        self.monitors[p].reset()
        # a changed assignment moves class demand; re-price the injected
        # antagonist through the oracle against the new placement.
        ext = self._ext_demand[p]
        if changed and self.contention_oracle is not None and ext > 0.0:
            pp.apply_factor(self.contention_oracle(pp, ext))
        if self.cfg.throttle:
            self._throttle_check(t_ms)

    def _pressure(self) -> float:
        """Worst currently-applied contention factor across the pool —
        the signal that decides whether a throttled tenant's low miss
        rate is genuine recovery or just the duty cycle working."""
        return max(float(np.max(pp.factor_per_class)) for pp in self.pool)

    def _throttle_check(self, t_ms: float) -> None:
        """Prediction-driven engagement, run after each §4.4 re-solve:
        a tenant whose best-plan predicted finish (queueing estimate +
        re-fit-priced service) still exceeds ``throttle_margin`` of its
        latency budget gets duty-cycled *now*, before observed deadline
        misses pile up.  Release stays observation-driven
        (:meth:`TenantThrottle.observe` hysteresis in ``_complete``),
        but is *held* while ``_pressure`` stays above the monitor
        threshold — admitted traffic under a duty cycle looks healthy
        because of the throttle, not despite it."""
        waits = [self._load_ms[p] / self.pool[p].slots
                 for p in range(len(self.pool))]
        finish_by_cls = [
            min(w + pp.service_ms(c, pp.plan.specs[c].max_new)
                for w, pp in zip(waits, self.pool))
            for c in range(len(self.classes))]
        for tenant in range(self.n_tenants):
            budget = self.controller.slo_for(tenant).p99_ms
            if (finish_by_cls[self.class_of(tenant)]
                    <= self.cfg.throttle_margin * budget):
                continue
            th = self._throttles.get(tenant)
            if th is None:
                th = self._throttles[tenant] = TenantThrottle(
                    enter_miss_rate=self.cfg.throttle_enter,
                    exit_miss_rate=self.cfg.throttle_exit,
                    patience=self.cfg.throttle_patience)
            if th.engage():
                self.controller.set_duty(tenant, self.cfg.throttle_duty)
                self.throttle_events.append((t_ms, tenant, "throttle"))
                get_tracer().instant("fleet.throttle", "dynamic",
                                     ts_ms=t_ms, track="fleet",
                                     tenant=tenant,
                                     duty=self.cfg.throttle_duty)

    # -- external contention (tests / benchmarks / replay harnesses) ------
    def set_contention(self, plan: int, factor: float) -> None:
        """Inject external memory contention on one pool plan: all service
        from now on is priced under ``ScaledContentionModel(base, factor)``
        — the knob replay harnesses use to trigger the §4.4 loop."""
        self.pool[plan].apply_factor(factor)

    def set_demand(self, plan: int, ext_demand: float) -> None:
        """Inject external antagonist *demand* (fraction of shared-domain
        capacity) on one pool plan.

        Unlike :meth:`set_contention` (a raw severity factor), demand is
        priced through the ``contention_oracle`` — ground truth in a drift
        benchmark — into per-class factors, and it gives recalibration
        telemetry its ``ext`` coordinate: completions under non-zero
        demand stream ``(own, ext, observed slowdown)`` samples into the
        recalibrator.
        """
        if ext_demand < 0.0:
            raise ValueError("ext_demand must be >= 0")
        if self.contention_oracle is None:
            raise ValueError(
                "set_demand requires a contention_oracle to price demand "
                "into severity (use set_contention for raw factors)")
        self._ext_demand[plan] = float(ext_demand)
        pp = self.pool[plan]
        if ext_demand > 0.0:
            pp.apply_factor(self.contention_oracle(pp, float(ext_demand)))
        else:
            pp.apply_factor(1.0)

    # -- replay ------------------------------------------------------------
    def replay(self, trace: ArrivalTrace,
               contention_events: Sequence[tuple[float, int, float]] = (),
               drain: bool = True,
               demand_events: Sequence[tuple[float, int, float]] = (),
               ) -> FleetReport:
        """Replay an arrival trace through the loop (virtual time).

        ``contention_events`` is a sorted sequence of ``(t_ms, plan_idx,
        factor)`` external-severity switches merged into the arrival
        stream; ``demand_events`` are ``(t_ms, plan_idx, ext_demand)``
        antagonist-demand switches routed through :meth:`set_demand`
        (they drive the closed recalibration loop and require a
        ``contention_oracle``).  With ``drain`` the clock runs until the
        last admitted request completes.
        """
        if trace.n_tenants > self.n_tenants:
            raise ValueError(
                f"trace has {trace.n_tenants} tenants, gateway admits "
                f"{self.n_tenants}")
        events = sorted(
            [(t, p, v, False) for t, p, v in contention_events]
            + [(t, p, v, True) for t, p, v in demand_events])

        def fire(t_ev: float, plan: int, val: float, is_demand: bool):
            self.advance(t_ev)
            if is_demand:
                self.set_demand(plan, val)
            else:
                self.set_contention(plan, val)

        e = 0
        t_arr, tenants, mnew = trace.t_ms, trace.tenant, trace.max_new
        with get_tracer().span("fleet.replay", "fleet",
                               requests=len(trace),
                               policy=self.cfg.policy) as sp:
            for k in range(len(trace)):
                t = float(t_arr[k])
                while e < len(events) and events[e][0] <= t:
                    fire(*events[e])
                    e += 1
                self.submit(t, int(tenants[k]), int(mnew[k]))
            for ev in events[e:]:
                fire(*ev)
            if drain:
                self.drain()
            sp.set(reschedules=len(self.reschedules),
                   recalibrations=len(self.recalibrations),
                   shed=self.controller.shed)
        return self.report()

    def report(self) -> FleetReport:
        r = self._rec
        n = r.n
        return FleetReport(
            n_tenants=self.n_tenants, classes=self.classes,
            policy=self.cfg.policy,
            tenant=r.tenant[:n].copy(), cls=r.cls[:n].copy(),
            plan=r.plan[:n].copy(), t_arrive=r.t_arrive[:n].copy(),
            t_start=r.t_start[:n].copy(), t_end=r.t_end[:n].copy(),
            service_ms=r.service_ms[:n].copy(),
            max_new=r.max_new[:n].copy(), status=r.status[:n].copy(),
            reschedules=list(self.reschedules),
            shed=self.controller.shed, deferred=self.controller.deferred,
            slos=dict(self.controller.slos),
            default_slo=self.controller.default_slo,
            recalibrations=list(self.recalibrations),
            throttle_events=list(self.throttle_events),
            throttled=self.controller.throttled,
            plan_names=tuple(pp.name for pp in self.pool))

    def metrics(self) -> dict:
        """Live telemetry in the gateway's ``metrics()`` shape: per-tenant
        rows under ``"tenants"`` (canonical :data:`~repro_torch.serve.engine.
        METRIC_KEYS`), fleet aggregates on top."""
        rep = self.report()
        return conform(GATEWAY_SCHEMA, {
            "steps": int(rep.max_new[rep.done_mask].sum()),
            "kv_bytes_in_use": self.controller.kv_bytes_in_use,
            "deferred_admissions": self.controller.deferred,
            "reschedules": len(self.reschedules),
        }, tenants={int(t): rep.tenant_metrics(int(t))
                    for t in np.unique(rep.tenant)})

    def export_trace(self, tracer=None,
                     max_requests: int | None = 50_000) -> int:
        """Ingest the replay's derived per-request spans into ``tracer``
        (default: the global tracer).  Returns the event count added.
        The live replay recorded only rare instants (reschedule /
        throttle / recalibration publish); this bulk pass adds the
        per-plan queue/service spans from the record arrays."""
        tracer = tracer or get_tracer()
        if not tracer.enabled:
            return 0
        events = self.report().trace_events(max_requests=max_requests,
                                            track_id=tracer.track_id)
        tracer.add_events(events)
        return len(events)

    # -- asyncio front-end -------------------------------------------------
    def _resolve_future(self, i: int) -> None:
        fut = self._futures.pop(i, None)
        if fut is not None and not fut.done():
            fut.set_result(self._rec.status[i] == DONE)

    async def submit_async(self, tenant: int, max_new: int,
                           t_ms: float | None = None) -> bool:
        """Submit one request and await its completion (False = shed)."""
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        t = self._now if t_ms is None else t_ms
        # register before submitting: shed resolves the future inline.
        self._futures[self._rec.n] = fut
        i = self.submit(t, tenant, max_new)
        if i < 0:
            return await fut
        return await fut


async def serve_async(gateway: FleetGateway, trace: ArrivalTrace,
                      time_scale: float = 0.0) -> FleetReport:
    """Drive the fleet loop as an asyncio service.

    Arrivals are paced in wall time (``sleep(gap_ms * time_scale / 1e3)``;
    0 replays as fast as the event loop can schedule) and each submission
    is a task awaiting its own completion — the front-end shape a network
    server would use, over the same deterministic virtual-time core.
    """
    async def one(t: float, tenant: int, max_new: int):
        return await gateway.submit_async(tenant, max_new, t_ms=t)

    tasks = []
    prev = float(trace.t_ms[0]) if len(trace) else 0.0
    for k in range(len(trace)):
        t = float(trace.t_ms[k])
        if time_scale > 0.0 and t > prev:
            await asyncio.sleep((t - prev) * time_scale / 1e3)
        prev = t
        tasks.append(asyncio.ensure_future(
            one(t, int(trace.tenant[k]), int(trace.max_new[k]))))
        # yield to let completions resolve between submissions.
        await asyncio.sleep(0)
    gateway.drain()
    if tasks:
        await asyncio.gather(*tasks)
    return gateway.report()

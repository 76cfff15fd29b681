"""The Scheduler object API: resolved platform + model -> cached Plans.

One :class:`Scheduler` owns a resolved :class:`~repro_torch.core.accelerators.
Platform`, a default contention model and a :class:`~repro_torch.core.plan.
PlanCache`; every schedule it produces is a :class:`~repro_torch.core.plan.Plan`
with provenance, produced by a named registry solver entry and cached by
request content hash — repeated ``solve()`` calls for the same problem are
O(1) and re-schedules triggered at runtime (§4.4) are cached and logged
through the same path.

    from repro_torch.core import Scheduler

    sched = Scheduler("xavier-agx")
    plan = sched.solve(["vgg19", "resnet152"], objective="latency")
    plan.save("artifacts/plans/vgg-resnet.json")   # pre-solve offline
    rows = sched.compare(["vgg19", "resnet152"])   # Table-6 shaped

The legacy free functions in :mod:`repro_torch.core.api` are thin deprecated
shims over one shared Scheduler per (platform, model).
"""
from __future__ import annotations

import inspect
import time
from typing import Mapping, Sequence

from . import registry
from .accelerators import PLATFORMS, Platform
from .contention import ContentionModel, ProportionalShareModel
from .graph import DNNGraph
from .plan import (Plan, PlanCache, ScheduleRequest, platform_fingerprint)
from .profiles import get_graph
from .simulate import SimResult, Workload, simulate, validate_assignment
from ..obs import get_logger, get_registry, get_tracer
from ..runtime import resolve_device

log = get_logger(__name__)

#: calibrated default for the SoC EMC domains — reproduces the paper's
#: observed co-run slowdown magnitudes (up to ~70% performance loss, §5.2)
#: at the Table-2 demand levels.
DEFAULT_SOC_MODEL = ProportionalShareModel(capacity=1.0, sensitivity=3.0)
#: ICI over-subscription is served fairly by the fabric; no extra sensitivity.
DEFAULT_POD_MODEL = ProportionalShareModel(capacity=1.0, sensitivity=1.0)


def resolve_platform(platform: str | Platform) -> Platform:
    if isinstance(platform, Platform):
        return platform
    return PLATFORMS[platform]()


def default_model(platform: Platform) -> ContentionModel:
    return DEFAULT_POD_MODEL if "ICI" in platform.domains else DEFAULT_SOC_MODEL


def resolve_graphs(dnns: Sequence[str | DNNGraph],
                   platform: Platform) -> list[DNNGraph]:
    return [d if isinstance(d, DNNGraph) else get_graph(d, platform)
            for d in dnns]


def failed(row: object) -> bool:
    """True for a structured error row in :meth:`Scheduler.compare` output."""
    return isinstance(row, dict) and "error" in row


def _error_row(exc: BaseException) -> dict:
    return {"error": {"type": type(exc).__name__, "message": str(exc)}}


def _accepts_kwarg(fn, name: str) -> bool:
    """True if ``fn`` can be called with keyword argument ``name``."""
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):          # builtins / C callables
        return False
    if name in params:
        return True
    return any(p.kind is inspect.Parameter.VAR_KEYWORD
               for p in params.values())


class Scheduler:
    """Holds a resolved platform + contention model; produces cached Plans."""

    def __init__(self, platform: str | Platform = "agx-orin",
                 model: ContentionModel | None = None,
                 cache: PlanCache | None = None,
                 evaluator: str = registry.EVAL_AUTO,
                 device=None):
        self.platform = resolve_platform(platform)
        self.model = model or default_model(self.platform)
        self.cache = cache if cache is not None else PlanCache()
        #: how solvers/compare score candidate schedules: "batch" | "torch" |
        #: "scalar" | "auto" (best available).  Not part of the problem
        #: identity — evaluators cache under the same request hash; the
        #: Plan records which one actually searched.
        if evaluator != registry.EVAL_AUTO:
            # fail construction, not first solve, on a typo — the raised
            # UnknownEntryError lists the registered evaluator names.
            registry.get_evaluator(evaluator)
        self.evaluator = evaluator
        #: where the torch evaluator and the anneal search run (``cuda``
        #: unless asked otherwise); like ``evaluator``, never in a request.
        self.device = resolve_device(device)
        #: actual solver invocations (== cache misses that reached a solver).
        self.solves = 0

    def __repr__(self) -> str:
        return (f"Scheduler(platform={self.platform.name!r}, "
                f"model={type(self.model).__name__}, "
                f"evaluator={self.evaluator!r}, device={str(self.device)!r}, "
                f"cached={len(self.cache)}, solves={self.solves})")

    @classmethod
    def from_bundle(cls, bundle, **kwargs) -> "Scheduler":
        """Scheduler solving from a measured :class:`~repro_torch.profiling.
        ProfileBundle` (or a path to one): the bundle's platform plus its
        calibrated contention model.  Schedule the bundle's measured
        graphs by passing them to :meth:`solve`.  ``evaluator`` and
        ``device`` pass through ``kwargs``."""
        from ..profiling.bundle import scheduler_from_bundle
        return scheduler_from_bundle(bundle, **kwargs)

    # ------------------------------------------------------------------
    def graphs(self, dnns: Sequence[str | DNNGraph]) -> list[DNNGraph]:
        """Resolve paper-profile names / pass through pre-built graphs."""
        return resolve_graphs(dnns, self.platform)

    def request(self, dnns: Sequence[str | DNNGraph],
                objective: str = "latency", *,
                model: ContentionModel | None = None,
                solver: str = registry.AUTO,
                max_transitions: int | None = 3,
                iterations: Sequence[int] | None = None,
                depends_on: Sequence[int | None] | None = None,
                deadline_s: float | None = None,
                solver_knobs: Mapping | None = None,
                **knobs) -> ScheduleRequest:
        """Build a validated request against this scheduler's platform.

        Extra keyword arguments are solver-entry knobs (e.g. anneal's
        ``population``/``devices``/``budget_ms``); they require an
        explicit ``solver=`` and are validated against that entry's
        declared vocabulary — an unknown name raises
        :class:`~repro_torch.core.registry.UnknownEntryError` listing the valid
        knobs.
        """
        merged = dict(solver_knobs or {})
        merged.update(knobs)
        return ScheduleRequest(
            graphs=tuple(self.graphs(dnns)),
            platform=self.platform,
            model=model or self.model,
            objective=objective,
            solver=solver,
            max_transitions=max_transitions,
            iterations=tuple(iterations or ()),
            depends_on=tuple(depends_on or ()),
            deadline_s=deadline_s,
            solver_knobs=tuple(sorted(merged.items())),
        )

    # ------------------------------------------------------------------
    def resolve(self, request: ScheduleRequest, *,
                evaluator: str | None = None) -> Plan:
        """Cache-or-solve entry point — every schedule goes through here.

        ``evaluator`` overrides the scheduler-wide knob for this call; it
        steers *how* solvers score candidates ("batch" population scoring
        vs the looped "scalar" authoritative path), never *what* problem is
        solved, so it does not participate in the request hash.
        """
        h = request.request_hash()
        with get_tracer().span("scheduler.resolve", "solve",
                               request=h[:12]) as sp:
            plan = self.cache.get(h)
            if plan is not None:
                sp.set(cache="hit", solver=plan.solver)
                get_registry().counter(
                    "scheduler_cache_hits",
                    "resolve() calls served from the plan cache").inc()
                log.info(
                    "plan cache hit %s (solver=%s, %.3fs solve amortized)",
                    h[:12], plan.solver, plan.solve_time_s)
                return plan
            ev = registry.resolve_evaluator(evaluator or self.evaluator).name
            kind, sol, dt = self._dispatch(request, ev)
            self.solves += 1
            sp.set(cache="miss", solver=kind, evaluator=ev,
                   objective=request.objective,
                   objective_value=sol.objective, solve_s=round(dt, 6))
            get_registry().counter(
                "scheduler_solves",
                "resolve() calls that reached a solver").inc()
            plan = Plan(request=request, solution=sol, solver=kind,
                        solve_time_s=dt, request_hash=h,
                        platform_fingerprint=platform_fingerprint(
                            request.platform),
                        evaluator=ev,
                        # getattr: third-party Solutions may predate params.
                        solver_params=dict(getattr(sol, "params", {}) or {}))
            self.cache.put(plan)
            log.info("solved %s with %s/%s in %.3fs (%s=%.6g, optimal=%s)",
                     h[:12], kind, ev, dt, sol.kind, sol.objective,
                     sol.optimal)
            return plan

    def _dispatch(self, request: ScheduleRequest, evaluator: str):
        errors = []
        for entry in registry.dispatch_order(request.solver):
            t0 = time.perf_counter()
            kwargs = dict(
                objective=request.objective,
                max_transitions=request.max_transitions,
                iterations=list(request.iterations),
                depends_on=list(request.depends_on),
                deadline_s=request.deadline_s)
            if _accepts_kwarg(entry.fn, "evaluator"):
                kwargs["evaluator"] = evaluator
            if _accepts_kwarg(entry.fn, "device"):   # the port's device knob
                kwargs["device"] = self.device
            else:
                # third-party solvers registered against the pre-evaluator
                # signature keep working; they just search their own way.
                log.debug("solver %s does not accept evaluator=; skipping",
                          entry.name)
            # per-entry knobs were validated at request construction
            # against this entry's declared vocabulary.
            kwargs.update(dict(request.solver_knobs))
            try:
                with get_tracer().span(f"solver.{entry.name}", "solve",
                                       objective=request.objective):
                    sol = entry.fn(request.platform, list(request.graphs),
                                   request.model, **kwargs)
            except ValueError as exc:
                # e.g. exhaustive search space too large: degrade down the
                # registry's priority order (z3 -> bb -> greedy).
                errors.append(f"{entry.name}: {exc}")
                log.info("solver %s declined (%s), trying next entry",
                         entry.name, exc)
                continue
            return entry.name, sol, time.perf_counter() - t0
        raise RuntimeError(
            f"no solver produced a schedule for {request.request_hash()[:12]}"
            f": {'; '.join(errors)}")

    def solve(self, dnns: Sequence[str | DNNGraph],
              objective: str = "latency", *,
              evaluator: str | None = None, **kwargs) -> Plan:
        """Request + resolve in one call (kwargs as in :meth:`request`)."""
        return self.resolve(self.request(dnns, objective, **kwargs),
                            evaluator=evaluator)

    # ------------------------------------------------------------------
    def evaluate_baseline(self, name: str, dnns: Sequence[str | DNNGraph],
                          *, model: ContentionModel | None = None,
                          iterations: Sequence[int] | None = None,
                          depends_on: Sequence[int | None] | None = None,
                          ) -> tuple[list[Workload], SimResult]:
        """Evaluate one registered baseline under the exact simulator."""
        graphs = self.graphs(dnns)
        wls = registry.get_baseline(name)(
            self.platform, graphs, iterations=iterations,
            depends_on=depends_on)
        return wls, simulate(self.platform, wls, model or self.model)

    def evaluate_baselines(self, dnns: Sequence[str | DNNGraph], *,
                           model: ContentionModel | None = None,
                           iterations: Sequence[int] | None = None,
                           depends_on: Sequence[int | None] | None = None,
                           evaluator: str | None = None,
                           ) -> dict[str, SimResult | dict]:
        """Evaluate *every* registered baseline in one batch pass.

        Rows that fail to build or validate become structured
        ``{"error": ...}`` dicts (see :func:`failed`); the rest are scored
        together through the selected evaluator's batch path — one
        vectorized sweep instead of one event-driven run per baseline.
        """
        graphs = self.graphs(dnns)
        entry = registry.resolve_evaluator(registry.bind_device(
            evaluator or self.evaluator, self.device))   # the port's device
        rows: dict[str, SimResult | dict] = {}
        built: list[tuple[str, list[Workload]]] = []
        for name in registry.baseline_names():
            try:
                wls = registry.get_baseline(name)(
                    self.platform, graphs, iterations=iterations,
                    depends_on=depends_on)
                for wl in wls:
                    validate_assignment(self.platform, wl)
            except (ValueError, KeyError, RuntimeError) as exc:
                rows[name] = _error_row(exc)
            else:
                built.append((name, wls))
        if built:
            try:
                bt = entry.simulate_batch(
                    self.platform, [wls for _, wls in built],
                    model or self.model, validate=False)
            except (ValueError, KeyError, RuntimeError) as exc:
                # one pathological candidate fails the whole batch call —
                # degrade to per-row scalar evaluation so the failure stays
                # a structured row instead of taking down the sweep.
                log.warning("batch baseline sweep failed (%s); retrying "
                            "row-by-row through the scalar simulator", exc)
                for name, wls in built:
                    try:
                        rows[name] = simulate(self.platform, wls,
                                              model or self.model)
                    except (ValueError, KeyError, RuntimeError) as row_exc:
                        rows[name] = _error_row(row_exc)
            else:
                for i, (name, _) in enumerate(built):
                    rows[name] = bt.result(i)
        return rows

    def compare(self, dnns: Sequence[str | DNNGraph],
                objective: str = "latency", *,
                model: ContentionModel | None = None,
                solver: str = registry.AUTO,
                max_transitions: int | None = 3,
                iterations: Sequence[int] | None = None,
                depends_on: Sequence[int | None] | None = None,
                deadline_s: float | None = 20.0,
                evaluator: str | None = None,
                ) -> dict[str, SimResult | Plan | dict]:
        """HaX-CoNN vs. every registered baseline (Table-6 row shape).

        Baseline rows are :class:`SimResult` (scored through the batch
        evaluator in one sweep); the ``"haxconn"`` row is a :class:`Plan`.
        A failing row is recorded as a structured ``{"error": {"type",
        "message"}}`` dict (see :func:`failed`) so "infeasible on this
        platform" is distinguishable from "crashed".
        """
        graphs = self.graphs(dnns)
        rows: dict[str, SimResult | Plan | dict] = dict(
            self.evaluate_baselines(
                graphs, model=model, iterations=iterations,
                depends_on=depends_on, evaluator=evaluator))
        try:
            rows["haxconn"] = self.solve(
                graphs, objective, model=model, solver=solver,
                max_transitions=max_transitions, iterations=iterations,
                depends_on=depends_on, deadline_s=deadline_s,
                evaluator=evaluator)
        except (ValueError, KeyError, RuntimeError,
                registry.SolverUnavailable) as exc:
            rows["haxconn"] = _error_row(exc)
        return rows

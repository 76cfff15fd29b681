"""Exact event-driven timeline simulation of a concurrent schedule.

This is the authoritative evaluator of Eqs. 2, 4, 5, 7, 8 of the paper.  The
formulation's circularity (end times depend on contention, contention depends
on overlap intervals, intervals depend on end times) is resolved exactly by
event-driven integration: between consecutive events the set of active layers
is constant, so each active layer progresses at the constant rate
``1 / slowdown(own demand, external demand)`` — the paper's *contention
intervals* (Fig. 4) are precisely the spans between our events.

Semantics:
  * each accelerator executes at most one layer group at a time (Eq. 9 with
    ε = 0; the solver may assume ε slack, the simulator is authoritative),
    FIFO among ready workloads;
  * an inter-accelerator transition after group i delays the *workload* by
    τ(out) + τ(in) + bytes/bw (Eq. 2/3) without occupying either accelerator
    (the data moves over the shared path);
  * a workload may run several back-to-back iterations (Table 8 balancing,
    Scenario 1), and may depend on another workload per-iteration
    (Scenario 3 streaming pipelines).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping, Sequence

from .accelerators import Platform
from .contention import ContentionModel
from .graph import DNNGraph

_TOL = 1e-9


@dataclass(frozen=True)
class Workload:
    graph: DNNGraph
    #: accelerator name per layer group.
    assignment: tuple[str, ...]
    iterations: int = 1
    #: if set, iteration k of this workload only becomes ready once iteration
    #: k of workload ``depends_on`` has completed (streaming pipeline).
    depends_on: int | None = None
    #: release time offset (ms).
    arrival_ms: float = 0.0

    def __post_init__(self):
        if len(self.assignment) != len(self.graph):
            raise ValueError(
                f"{self.graph.name}: assignment length {len(self.assignment)}"
                f" != {len(self.graph)} groups"
            )


@dataclass(frozen=True)
class Interval:
    """One executed span of a layer group at a constant slowdown."""
    start: float
    end: float
    workload: int
    iteration: int
    group: int
    acc: str
    slowdown: float


@dataclass
class SimResult:
    makespan: float
    finish_times: list[float]
    iteration_latencies: list[list[float]]
    timeline: list[Interval]
    #: wall-clock ms added purely by contention (Σ interval (1 - 1/s) · len).
    contention_ms: float
    #: contention-free total busy ms (for utilization reporting).
    busy_ms: dict[str, float] = field(default_factory=dict)

    @property
    def latency_ms(self) -> float:
        return self.makespan

    @property
    def throughput_fps(self) -> float:
        """Completed DNN inferences per second."""
        n = sum(len(lats) for lats in self.iteration_latencies)
        return 1e3 * n / self.makespan if self.makespan > 0 else float("inf")

    def objective(self, kind: str) -> float:
        """Solver objective: lower is better for every kind."""
        if kind == "latency":       # Eq. 11: min max T_n
            return self.makespan
        if kind == "throughput":    # max completed inferences / second
            return -self.throughput_fps
        if kind == "sum_inverse":   # Eq. 10 literal: max Σ 1/T_n
            return -sum(1.0 / t for t in self.finish_times if t > 0)
        raise ValueError(kind)


def validate_assignment(platform: Platform, wl: Workload) -> None:
    for i, acc in enumerate(wl.assignment):
        if acc not in platform.names:
            raise ValueError(f"{wl.graph.name}[{i}] -> unknown accelerator {acc!r}")
    for i in range(len(wl.assignment) - 1):
        if wl.assignment[i] != wl.assignment[i + 1]:
            if not wl.graph[i].can_transition_after:
                raise ValueError(
                    f"{wl.graph.name}: illegal transition after group {i} "
                    f"({wl.graph[i].name})"
                )


class _WorkloadState:
    __slots__ = ("wl", "idx", "it", "group", "remaining", "ready_at",
                 "it_start", "started", "done", "lat")

    def __init__(self, wl: Workload, idx: int):
        self.wl = wl
        self.idx = idx
        self.it = 0
        self.group = 0
        self.remaining = wl.graph[0].time_on(wl.assignment[0])
        self.ready_at = wl.arrival_ms   # may be raised by dependencies
        self.it_start = wl.arrival_ms
        self.started = False
        self.done = False
        self.lat: list[float] = []

    @property
    def acc(self) -> str:
        return self.wl.assignment[self.group]

    @property
    def demand(self) -> float:
        return self.wl.graph[self.group].demand_on(self.acc)


def simulate(
    platform: Platform,
    workloads: Sequence[Workload],
    model: ContentionModel | Mapping[str, ContentionModel],
    record_timeline: bool = True,
) -> SimResult:
    for wl in workloads:
        validate_assignment(platform, wl)
    models: dict[str, ContentionModel]
    if hasattr(model, "slowdown"):
        models = {dom: model for dom in platform.domains} or {"_": model}  # type: ignore[dict-item]
    else:
        models = dict(model)  # type: ignore[arg-type]

    # accelerator -> contention domains it belongs to
    acc_domains: dict[str, list[str]] = {a: [] for a in platform.names}
    for dom, members in platform.domains.items():
        for m in members:
            acc_domains[m].append(dom)

    states = [_WorkloadState(wl, i) for i, wl in enumerate(workloads)]
    running: dict[str, _WorkloadState] = {}          # acc -> state
    finish: list[float] = [0.0] * len(workloads)
    timeline: list[Interval] = []
    contention_ms = 0.0
    busy: dict[str, float] = {a: 0.0 for a in platform.names}
    t = 0.0

    def slowdown_of(st: _WorkloadState) -> float:
        own = st.demand
        external = 0.0
        for dom in acc_domains[st.acc]:
            for other in running.values():
                if other is st:
                    continue
                if st.acc != other.acc and other.acc in platform.domains[dom]:
                    external += other.demand
        if external <= 0.0 or own <= 0.0:
            return 1.0
        dom = acc_domains[st.acc][0] if acc_domains[st.acc] else "_"
        return max(1.0, models[dom].slowdown(own, external))

    def dependency_ready(st: _WorkloadState) -> bool:
        dep = st.wl.depends_on
        if dep is None:
            return True
        return states[dep].done or states[dep].it > st.it

    guard = 0
    max_events = 200000 + 200 * sum(
        len(w.graph) * w.iterations for w in workloads
    )
    while not all(st.done for st in states):
        guard += 1
        if guard > max_events:
            raise RuntimeError("simulator did not converge (event storm)")

        # 1) start any ready workload whose accelerator is free (FIFO by
        #    ready time then index).
        waiting = [
            st for st in states
            if not st.done and st not in running.values()
            and st.ready_at <= t + _TOL and dependency_ready(st)
        ]
        waiting.sort(key=lambda s: (s.ready_at, s.idx))
        for st in waiting:
            if st.acc not in running:
                running[st.acc] = st
                if st.group == 0 and not st.started:
                    st.it_start = t        # iteration service actually begins
                    st.started = True

        if not running:
            # idle gap: jump to the next arrival / transition end / dependency
            pend = [st.ready_at for st in states
                    if not st.done and st.ready_at > t + _TOL]
            if not pend:
                # blocked purely on a dependency whose producer is running —
                # cannot happen with running empty; guard against deadlock.
                raise RuntimeError("deadlock: nothing running, nothing pending")
            t = min(pend)
            continue

        # 2) compute per-running-layer slowdowns for this contention interval.
        rates = {st.idx: slowdown_of(st) for st in running.values()}

        # 3) next event: earliest completion among running layers, or the
        #    next ready/arrival boundary that could change the active set.
        dt = min(st.remaining * rates[st.idx] for st in running.values())
        horizon = t + dt
        for st in states:
            if (not st.done and st not in running.values()
                    and t + _TOL < st.ready_at < horizon - _TOL):
                horizon = st.ready_at
        span = horizon - t

        # 4) integrate.
        for st in list(running.values()):
            s = rates[st.idx]
            st.remaining -= span / s
            if record_timeline:
                timeline.append(Interval(t, horizon, st.idx, st.it, st.group,
                                         st.acc, s))
            contention_ms += span * (1.0 - 1.0 / s)
            busy[st.acc] += span / s
        t = horizon

        # 5) process completions.
        for acc, st in list(running.items()):
            if st.remaining > _TOL:
                continue
            del running[acc]
            wl = st.wl
            if st.group + 1 < len(wl.graph):
                nxt = st.group + 1
                tau = platform.transition_cost_ms(
                    wl.graph[st.group].out_bytes, wl.assignment[st.group],
                    wl.assignment[nxt])
                st.group = nxt
                st.remaining = wl.graph[nxt].time_on(wl.assignment[nxt])
                st.ready_at = t + tau
            else:
                st.lat.append(t - st.it_start)
                st.it += 1
                st.started = False
                if st.it >= wl.iterations:
                    st.done = True
                    finish[st.idx] = t
                else:
                    st.group = 0
                    st.remaining = wl.graph[0].time_on(wl.assignment[0])
                    st.ready_at = t

    return SimResult(
        makespan=t,
        finish_times=finish,
        iteration_latencies=[st.lat for st in states],
        timeline=timeline,
        contention_ms=contention_ms,
        busy_ms=busy,
    )

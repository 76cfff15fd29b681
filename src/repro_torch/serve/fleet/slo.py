"""Per-tenant SLO targets driving admission, shedding and plan selection.

MoCA (PAPERS.md) frames multi-tenant accelerator runtimes around per-tenant
QoS targets that *drive* resource decisions rather than merely being
reported afterwards.  This module is that control surface for the fleet
loop:

* :class:`SLO` — a tenant's targets: tail-latency budget (``p99_ms``) and
  optional throughput floor (``throughput_rps``), plus a ``priority``
  weight used when load must be shed.
* :class:`AdmissionController` — the shared budget + SLO gate.  It owns
  the fleet-wide KV-memory budget (the same accounting as
  ``MultiTenantGateway``'s ``memory_budget_bytes``), decides
  admit/defer/shed per arriving request, and performs SLO-aware plan
  selection (route each request to the pool plan minimizing its predicted
  finish time against the tenant's deadline).  :meth:`engine_gate` adapts
  the controller to the existing :class:`~repro_torch.serve.engine.ServingEngine`
  ``admission_gate`` hook, so a real engine and the fleet's virtual-time
  loop enforce one budget through one object.

Decision semantics (one request):

1. **shed** — refused outright, never queued: the tenant's queue is at its
   bound, or the predicted queueing delay already blows the latency budget
   by ``shed_factor``.  Open-loop arrivals cannot be back-pressured, so
   shedding early protects admitted requests instead of letting everyone
   time out (a rejected request is an SLO outcome too — it is counted).
2. **admit** — enqueued; a KV slot is *acquired* only when service starts
   (``try_acquire``/``release``), so queued requests never pin memory.
3. **defer** — an admitted request whose service start is blocked on the
   KV budget; it stays queued and is retried as budget frees.
4. **throttle** — contention *mitigation*, the closed loop's second
   control axis (MoCA's per-tenant throttling; the duty-cycle mechanism of
   :class:`~repro_torch.profiling.probes.MemoryProbe` applied as a control
   action instead of an antagonist): when re-solving under the re-fitted
   contention model still cannot meet a tenant's SLO, the tenant is
   duty-cycled — only ``duty`` of its arrivals are admitted, via a
   deterministic token bucket — until its deadline-miss rate recovers.
   :class:`TenantThrottle` is the hysteresis state machine deciding
   engage/release, with separate enter/exit thresholds plus patience on
   both edges so throttle/unthrottle does not flap.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Sequence

from repro_torch.obs import ADMISSION_SCHEMA, conform


@dataclass(frozen=True)
class SLO:
    """One tenant's service-level objectives."""

    #: end-to-end (queueing + service) tail-latency budget.
    p99_ms: float
    #: minimum sustained completion rate the tenant is promised; 0 = best
    #: effort.  Checked post-hoc per replay (see FleetReport.slo_report).
    throughput_rps: float = 0.0
    #: relative weight when shedding: lower priority sheds first.
    priority: float = 1.0

    def __post_init__(self):
        if self.p99_ms <= 0.0:
            raise ValueError("p99_ms must be > 0")
        if self.throughput_rps < 0.0 or self.priority <= 0.0:
            raise ValueError("throughput_rps must be >= 0 and priority > 0")

    def to_dict(self) -> dict:
        return {"p99_ms": self.p99_ms,
                "throughput_rps": self.throughput_rps,
                "priority": self.priority}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "SLO":
        return cls(p99_ms=d["p99_ms"],
                   throughput_rps=d.get("throughput_rps", 0.0),
                   priority=d.get("priority", 1.0))


def parse_slo(spec: str) -> SLO:
    """CLI helper: ``p99=400[,rps=5][,priority=2]`` -> :class:`SLO`."""
    keys = {"p99": "p99_ms", "p99_ms": "p99_ms",
            "rps": "throughput_rps", "throughput_rps": "throughput_rps",
            "priority": "priority"}
    kwargs: dict[str, float] = {}
    for item in filter(None, spec.split(",")):
        key, _, val = item.partition("=")
        if key not in keys:
            raise ValueError(f"unknown SLO field {key!r} in {spec!r} "
                             f"(one of {', '.join(sorted(set(keys)))})")
        kwargs[keys[key]] = float(val)
    if "p99_ms" not in kwargs:
        raise ValueError(f"SLO spec {spec!r} must set p99=<ms>")
    return SLO(**kwargs)


@dataclass
class TenantThrottle:
    """Hysteresis engage/release controller for one tenant's duty cycle.

    ``observe`` folds each completion's deadline outcome into an EWMA
    miss rate and returns ``"throttle"`` once the rate stays above
    ``enter_miss_rate`` for ``patience`` consecutive completions,
    ``"release"`` once a throttled tenant stays below ``exit_miss_rate``
    for ``patience`` completions, and ``None`` otherwise.  The gap between
    the two thresholds plus the patience on both edges is the hysteresis:
    a tenant hovering at the boundary never flaps.
    """

    #: EWMA deadline-miss rate that engages the throttle.
    enter_miss_rate: float = 0.5
    #: EWMA miss rate a throttled tenant must fall below to release.
    exit_miss_rate: float = 0.1
    #: consecutive observations beyond a threshold before switching.
    patience: int = 8
    #: EWMA weight of the newest completion.
    alpha: float = 0.2

    miss_ewma: float = field(init=False, default=0.0)
    throttled: bool = field(init=False, default=False)
    switches: int = field(init=False, default=0)
    _strikes: int = field(init=False, default=0)

    def __post_init__(self):
        if not 0.0 <= self.exit_miss_rate < self.enter_miss_rate <= 1.0:
            raise ValueError(
                "need 0 <= exit_miss_rate < enter_miss_rate <= 1 "
                "(the gap is the hysteresis)")
        if self.patience < 1:
            raise ValueError("patience must be >= 1")

    def engage(self) -> bool:
        """Force-engage (prediction-driven, at reschedule time): the
        re-solved plan's predicted finish still blows the tenant's budget,
        so don't wait for observed misses to accumulate.  Seeds the miss
        EWMA at 1 so release still requires a sustained run of on-time
        completions.  Returns False when already throttled."""
        if self.throttled:
            return False
        self.throttled = True
        self._strikes = 0
        self.miss_ewma = 1.0
        self.switches += 1
        return True

    def observe(self, missed: bool, hold: bool = False) -> str | None:
        """Fold one completion's deadline outcome; maybe switch state.

        ``hold=True`` pins an engaged throttle regardless of the miss
        rate: under a duty cycle the *admitted* traffic looks healthy
        precisely because of the throttle, so while the condition that
        caused the engagement persists (e.g. priced contention still
        above the monitor threshold) a low miss EWMA must not trigger
        release — that would re-flood the queues the duty cycle just
        drained and flap."""
        self.miss_ewma = (self.alpha * (1.0 if missed else 0.0)
                          + (1.0 - self.alpha) * self.miss_ewma)
        if not self.throttled and self.miss_ewma > self.enter_miss_rate:
            self._strikes += 1
            if self._strikes >= self.patience:
                self.throttled, self._strikes = True, 0
                self.switches += 1
                return "throttle"
        elif self.throttled and self.miss_ewma < self.exit_miss_rate:
            if hold:
                self._strikes = 0
                return None
            self._strikes += 1
            if self._strikes >= self.patience:
                self.throttled, self._strikes = False, 0
                self.switches += 1
                return "release"
        else:
            self._strikes = 0
        return None


class AdmissionController:
    """Shared KV budget + SLO policy for a fleet of tenants.

    ``slos`` maps tenant id (or the special key ``"default"``) to its
    :class:`SLO`; tenants without an entry use ``default_slo``.
    """

    def __init__(self, budget_bytes: float | None = None,
                 default_slo: SLO = SLO(p99_ms=1000.0),
                 slos: Mapping[int, SLO] | None = None,
                 max_queue_per_tenant: int = 64,
                 shed_factor: float = 4.0):
        if max_queue_per_tenant < 1:
            raise ValueError("max_queue_per_tenant must be >= 1")
        if shed_factor <= 0.0:
            raise ValueError("shed_factor must be > 0")
        self.budget_bytes = budget_bytes
        self.default_slo = default_slo
        self.slos = dict(slos or {})
        self.max_queue_per_tenant = max_queue_per_tenant
        self.shed_factor = shed_factor
        self.kv_bytes_in_use = 0.0
        #: per-tenant duty cycle (absent/1.0 = unthrottled).
        self.duty: dict[int, float] = {}
        self._duty_acc: dict[int, float] = {}
        # counters (telemetry)
        self.shed = 0
        self.deferred = 0
        self.throttled = 0

    # -- SLO lookup --------------------------------------------------------
    def slo_for(self, tenant: int) -> SLO:
        return self.slos.get(tenant, self.default_slo)

    def deadline_ms(self, tenant: int, arrival_ms: float) -> float:
        return arrival_ms + self.slo_for(tenant).p99_ms

    # -- KV budget (same accounting as the gateway's memory_budget_bytes) --
    def kv_admit(self, nbytes: float) -> bool:
        if self.budget_bytes is None:
            return True
        return self.kv_bytes_in_use + nbytes <= self.budget_bytes

    def try_acquire(self, nbytes: float) -> bool:
        if not self.kv_admit(nbytes):
            self.deferred += 1
            return False
        self.kv_bytes_in_use += nbytes
        return True

    def release(self, nbytes: float) -> None:
        self.kv_bytes_in_use = max(0.0, self.kv_bytes_in_use - nbytes)

    def engine_gate(self, bytes_per_slot: float) -> Callable[[object], bool]:
        """Adapter for the existing ``ServingEngine(admission_gate=...)``
        hook: the returned callable prices one slot admission against this
        controller's shared budget (deferral keeps the engine's FIFO)."""
        def gate(_req: object) -> bool:
            ok = self.kv_admit(bytes_per_slot)
            if not ok:
                self.deferred += 1
            return ok
        return gate

    # -- duty-cycle throttling (MoCA-style mitigation) ---------------------
    def set_duty(self, tenant: int, duty: float) -> None:
        """Set (or clear, with ``duty >= 1``) a tenant's admission duty
        cycle.  The accumulator resets so a fresh throttle takes effect on
        the very next arrival."""
        if not 0.0 < duty:
            raise ValueError("duty must be > 0")
        if duty >= 1.0:
            self.duty.pop(tenant, None)
            self._duty_acc.pop(tenant, None)
        else:
            self.duty[tenant] = duty
            self._duty_acc[tenant] = 0.0

    def duty_of(self, tenant: int) -> float:
        return self.duty.get(tenant, 1.0)

    def duty_admit(self, tenant: int) -> bool:
        """Deterministic token bucket: admit exactly ``duty`` of a
        throttled tenant's arrivals (the duty-cycle mechanism of
        ``profiling.probes.MemoryProbe``, applied as mitigation).  Each
        arrival deposits ``duty``; an arrival is admitted when the bucket
        holds a full token.  No randomness: the admit pattern for
        ``duty=0.5`` is strictly alternating."""
        duty = self.duty.get(tenant)
        if duty is None:
            return True
        acc = self._duty_acc.get(tenant, 0.0) + duty
        if acc >= 1.0 - 1e-12:
            self._duty_acc[tenant] = acc - 1.0
            return True
        self._duty_acc[tenant] = acc
        self.throttled += 1
        return False

    # -- admission / shedding ---------------------------------------------
    def should_shed(self, tenant: int, queue_depth: int,
                    est_wait_ms: float) -> bool:
        """Refuse an arriving request outright (never queued)?

        Sheds when the tenant's queue is at its bound or predicted
        queueing alone exceeds ``shed_factor / priority`` times the
        latency budget — higher-priority tenants tolerate deeper backlog
        before shedding.
        """
        if queue_depth >= self.max_queue_per_tenant:
            self.shed += 1
            return True
        slo = self.slo_for(tenant)
        if est_wait_ms > self.shed_factor * slo.priority * slo.p99_ms:
            self.shed += 1
            return True
        return False

    # -- plan selection ----------------------------------------------------
    def select_plan(self, est_wait_ms: Sequence[float],
                    service_ms: Sequence[float]) -> int:
        """SLO-aware routing: earliest predicted finish over the pool.

        ``est_wait_ms[p]`` is plan p's current queueing estimate and
        ``service_ms[p]`` this request's predicted service time there
        (plans are heterogeneous: the same tenant class runs at different
        speeds on different SoC plans).  Minimizing predicted finish is
        what makes the SLO policy beat static round-robin on tail latency:
        it respects both instantaneous load *and* plan affinity.
        """
        best, best_cost = 0, float("inf")
        for p, (w, s) in enumerate(zip(est_wait_ms, service_ms)):
            cost = w + s
            if cost < best_cost:
                best, best_cost = p, cost
        return best

    # -- telemetry ---------------------------------------------------------
    def metrics(self) -> dict:
        """Admission telemetry in the canonical
        :data:`~repro_torch.obs.ADMISSION_SCHEMA` shape."""
        return conform(ADMISSION_SCHEMA, {
            "kv_bytes_in_use": self.kv_bytes_in_use,
            "budget_bytes": self.budget_bytes,
            "shed": self.shed, "deferred": self.deferred,
            "throttled": self.throttled,
            "duty": dict(self.duty)})

"""Fleet-scale serving: trace-driven traffic, SLO-aware multiplexing.

The fleet subsystem scales the serving stack from "a handful of tenants,
one schedule" (:mod:`repro_torch.serve.gateway`) to "thousands of open-loop
tenants over a small pool of solved SoC plans":

* :mod:`~repro_torch.serve.fleet.traffic` — seeded, bit-deterministic arrival
  traces (Poisson / bursty MMPP / diurnal replay) with a JSON wire format.
* :mod:`~repro_torch.serve.fleet.slo` — per-tenant SLO targets driving
  admission, shedding and plan selection through one shared
  :class:`AdmissionController`.
* :mod:`~repro_torch.serve.fleet.loop` — the virtual-time fleet gateway:
  per-tenant queues, KV-budget admission, earliest-finish SLO routing vs
  round-robin, per-plan §4.4 slowdown monitoring, closed-loop online
  recalibration (streamed telemetry → PCCS re-fit → model adoption) with
  per-tenant duty-cycle throttling as the fallback mitigation, an asyncio
  front-end, and flat-array per-request telemetry (:class:`FleetReport`).
"""
from repro_torch.serve.fleet.loop import (FleetConfig, FleetGateway, FleetReport,
                                    FleetRescheduleEvent, PoolPlan,
                                    build_pool, serve_async)
from repro_torch.serve.fleet.slo import (SLO, AdmissionController, TenantThrottle,
                                   parse_slo)
from repro_torch.serve.fleet.traffic import (ArrivalTrace, GENERATORS,
                                       bursty_trace, diurnal_trace,
                                       parse_trace_spec, poisson_trace)

__all__ = [
    "ArrivalTrace", "GENERATORS", "bursty_trace", "diurnal_trace",
    "parse_trace_spec", "poisson_trace",
    "SLO", "AdmissionController", "TenantThrottle", "parse_slo",
    "FleetConfig", "FleetGateway", "FleetReport", "FleetRescheduleEvent",
    "PoolPlan", "build_pool", "serve_async",
]

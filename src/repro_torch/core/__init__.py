"""HaX-CoNN core: contention-aware concurrent DNN scheduling.

Reproduces "Shared Memory-contention-aware Concurrent DNN Execution for
Diversely Heterogeneous System-on-Chips" (Dagli & Belviranli, 2023) and
generalizes it to TPU-pod virtual accelerators.

Primary entry points: :class:`Scheduler` (solve/compare against a resolved
platform), :class:`ScheduleRequest` (one validated problem description),
:class:`Plan` (serializable schedule artifact) and :class:`PlanCache`
(content-addressed store).  Solvers, contention models and baselines are
pluggable through :mod:`repro_torch.core.registry`.
"""
from . import registry
from .accelerators import PLATFORMS, Accelerator, Platform
from .contention import (PiecewiseModel, ProportionalShareModel,
                         estimate_blackbox_demand, pccs_from_pairs)
from .graph import DNNGraph, LayerGroup
from .lowering import (ProblemSpec, SlowdownSurface, concat_specs,
                       lower_assignments, lower_product, lower_surface,
                       lower_sweep, lower_workloads,
                       register_surface_lowering,
                       register_vectorized_slowdown, slowdown_array)
from .plan import Plan, PlanCache, ScheduleRequest, ShardedPlanCache
from .scheduler import (DEFAULT_POD_MODEL, DEFAULT_SOC_MODEL, Scheduler,
                        default_model, resolve_graphs, resolve_platform)
from .simulate import Interval, SimResult, Workload, simulate
from .simulate_batch import (BatchTimeline, simulate_assignments,
                             simulate_batch, simulate_spec, simulate_sweep)
from .solver_bb import Solution

__all__ = [
    "PLATFORMS", "Accelerator", "Platform",
    "PiecewiseModel", "ProportionalShareModel",
    "estimate_blackbox_demand", "pccs_from_pairs",
    "DNNGraph", "LayerGroup",
    "Interval", "SimResult", "Workload", "simulate",
    "BatchTimeline", "simulate_assignments", "simulate_batch",
    "simulate_spec", "simulate_sweep",
    "ProblemSpec", "SlowdownSurface", "concat_specs", "lower_assignments",
    "lower_product", "lower_surface", "lower_sweep", "lower_workloads",
    "register_surface_lowering", "register_vectorized_slowdown",
    "slowdown_array",
    "Solution",
    "Plan", "PlanCache", "ScheduleRequest", "Scheduler",
    "ShardedPlanCache",
    "DEFAULT_POD_MODEL", "DEFAULT_SOC_MODEL",
    "default_model", "resolve_graphs", "resolve_platform",
    "registry",
]

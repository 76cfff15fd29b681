"""DEPRECATED facade — thin shims over the Scheduler/Plan object API.

New code should use :class:`repro_torch.core.Scheduler` directly:

    from repro_torch.core import Scheduler
    sched = Scheduler("xavier-agx")
    plan = sched.solve(["vgg19", "resnet152"], objective="latency")
    print(plan.assignments, plan.result.latency_ms, plan.solver)

The free functions below keep the historical call shape (``schedule`` /
``evaluate_baseline`` / ``compare`` returning bare ``Solution`` /
``SimResult`` objects) and delegate to one *shared* Scheduler per
(platform, model, device), so repeated calls hit its plan cache.  Like
:class:`~repro_torch.core.Scheduler`, they run on ``cuda`` unless given
``device="cpu"`` (a keyword the reference's shims do not have).  They emit
:class:`DeprecationWarning` and will be removed once every caller has
migrated (see docs/api.md for the migration table).
"""
from __future__ import annotations

import warnings
from typing import Sequence

from ..runtime import resolve_device
from .contention import ContentionModel
from .graph import DNNGraph
from .plan import PlanCache, platform_fingerprint
from .scheduler import (DEFAULT_POD_MODEL, DEFAULT_SOC_MODEL, Scheduler,
                        default_model, failed, resolve_graphs,
                        resolve_platform)
from .simulate import SimResult, Workload
from .solver_bb import Solution

__all__ = [
    "DEFAULT_POD_MODEL", "DEFAULT_SOC_MODEL",
    "resolve_platform", "default_model", "resolve_graphs", "failed",
    "schedule", "evaluate_baseline", "compare", "shared_scheduler",
]

_SCHEDULERS: dict[object, Scheduler] = {}


def shared_scheduler(platform: str | "Platform" = "agx-orin",
                     model: ContentionModel | None = None, *,
                     device=None) -> Scheduler:
    """The process-wide Scheduler the deprecated shims delegate to."""
    plat = resolve_platform(platform)
    dev = resolve_device(device)
    try:
        key = (platform_fingerprint(plat), model, str(dev))
        hash(key)
    except TypeError:            # unhashable custom model: no sharing
        return Scheduler(plat, model, device=dev)
    sched = _SCHEDULERS.get(key)
    if sched is None:
        # bounded: a long-lived process funnels every legacy call through
        # these shared schedulers, so their caches must not grow forever.
        sched = _SCHEDULERS[key] = Scheduler(
            plat, model, cache=PlanCache(max_entries=256), device=dev)
    return sched


def _deprecated(old: str, new: str) -> None:
    warnings.warn(
        f"repro_torch.core.api.{old} is deprecated; use {new} "
        f"(see docs/api.md)", DeprecationWarning, stacklevel=3)


def schedule(
    dnns: Sequence[str | DNNGraph],
    platform="agx-orin",
    objective: str = "latency",
    model: ContentionModel | None = None,
    max_transitions: int | None = 3,
    iterations: Sequence[int] | None = None,
    depends_on: Sequence[int | None] | None = None,
    deadline_s: float | None = None,
    *,
    device=None,
) -> Solution:
    """Deprecated: ``Scheduler(platform).solve(dnns, objective, ...)``."""
    _deprecated("schedule", "Scheduler.solve")
    plan = shared_scheduler(platform, model, device=device).solve(
        dnns, objective, max_transitions=max_transitions,
        iterations=iterations, depends_on=depends_on, deadline_s=deadline_s)
    return plan.solution


def evaluate_baseline(
    name: str,
    dnns: Sequence[str | DNNGraph],
    platform="agx-orin",
    model: ContentionModel | None = None,
    iterations: Sequence[int] | None = None,
    depends_on: Sequence[int | None] | None = None,
    *,
    device=None,
) -> tuple[list[Workload], SimResult]:
    """Deprecated: ``Scheduler(platform).evaluate_baseline(name, dnns)``."""
    _deprecated("evaluate_baseline", "Scheduler.evaluate_baseline")
    sched = shared_scheduler(platform, model, device=device)
    return sched.evaluate_baseline(
        name, dnns, iterations=iterations, depends_on=depends_on)


def compare(
    dnns: Sequence[str | DNNGraph],
    platform="agx-orin",
    objective: str = "latency",
    model: ContentionModel | None = None,
    iterations: Sequence[int] | None = None,
    depends_on: Sequence[int | None] | None = None,
    deadline_s: float | None = 20.0,
    *,
    device=None,
) -> dict[str, object]:
    """Deprecated: ``Scheduler(platform).compare(dnns, objective, ...)``.

    Row shape is preserved except that a failing baseline is now a
    structured ``{"error": {"type", "message"}}`` dict instead of a silent
    ``None`` (check with :func:`repro_torch.core.scheduler.failed`).  The
    ``"haxconn"`` row stays a bare :class:`Solution`, and — as before the
    redesign — a solver failure raises instead of appearing as a row.
    """
    _deprecated("compare", "Scheduler.compare")
    rows = shared_scheduler(platform, model, device=device).compare(
        dnns, objective, iterations=iterations, depends_on=depends_on,
        deadline_s=deadline_s)
    hax = rows["haxconn"]
    if failed(hax):
        err = hax["error"]
        raise RuntimeError(
            f"schedule solve failed ({err['type']}): {err['message']}")
    rows["haxconn"] = hax.solution
    return rows

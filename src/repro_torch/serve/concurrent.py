"""Concurrent multi-model serving with HaX-CoNN schedules — the paper's
technique as a first-class framework feature (counterpart of
``repro/serve/concurrent.py``).

A pod is split into virtual accelerators (submeshes); each model to be
served concurrently is exported as a layer-group graph with analytic
roofline costs per submesh (:mod:`repro_torch.models.graph_export`); the HaX-CoNN
solver maps groups to submeshes, contention-aware on the shared ICI domain,
with resharding transition costs; and the plan is evaluated against every
baseline under the exact contention simulator.

The *timing* is simulated (the cost model is the dry-run-calibrated
roofline) while the *compute* runs for real — `CoServer.run_round`
executes both models and reports outputs plus the schedule's predicted
timeline.  ``plan_concurrent_serving`` takes a keyword-only ``device``
(``cuda`` unless the caller asks for the CPU; given a ``scheduler``, its
device is used).  ``CoServer`` runs each model's ``forward`` under
``torch.inference_mode()`` where the reference jits it; the port's models
own their weights, so it takes no ``params``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeCell
from repro_torch.core.accelerators import Platform, tpu_pod_split
from repro_torch.core.graph import DNNGraph
from repro_torch.core.plan import Plan
from repro_torch.core.scheduler import Scheduler, failed
from repro_torch.models import Model
from repro_torch.models.graph_export import export_graph


@dataclass
class ServingPlan:
    graphs: list[DNNGraph]
    solution: object                  # core.solver_bb.Solution
    #: per-baseline SimResult, or a structured {"error": ...} row when that
    #: baseline is infeasible on this platform (see core.scheduler.failed).
    baselines: dict[str, object]
    platform: Platform
    #: serializable provenance artifact of the haxconn solution.
    plan: Plan | None = None

    @property
    def speedup_vs_best_baseline(self) -> float:
        best = min(r.latency_ms for r in self.baselines.values()
                   if not failed(r))
        return best / self.solution.result.latency_ms

    def summary(self) -> str:
        rows = [f"objective={self.solution.kind} "
                f"optimal={self.solution.optimal}"]
        for name, res in self.baselines.items():
            if failed(res):
                rows.append(f"  {name:18s} infeasible: "
                            f"{res['error']['message']}")
            else:
                rows.append(f"  {name:18s} lat={res.latency_ms:9.3f}ms "
                            f"fps={res.throughput_fps:8.1f}")
        sol = self.solution
        rows.append(f"  {'haxconn':18s} lat={sol.result.latency_ms:9.3f}ms "
                    f"fps={sol.result.throughput_fps:8.1f} "
                    f"({100 * (self.speedup_vs_best_baseline - 1):+.1f}%)")
        for wl in sol.workloads:
            trans = [f"{wl.assignment[i]}->{wl.assignment[i + 1]}@{i}"
                     for i in range(len(wl.assignment) - 1)
                     if wl.assignment[i] != wl.assignment[i + 1]]
            rows.append(f"    {wl.graph.name}: {trans or ['no transition']}")
        return "\n".join(rows)


def plan_concurrent_serving(
    cfgs: Sequence[ModelConfig],
    cells: Sequence[str | ShapeCell],
    platform: Platform | None = None,
    objective: str = "latency",
    iterations: Sequence[int] | None = None,
    deadline_s: float = 20.0,
    scheduler: Scheduler | None = None,
    *,
    device=None,
) -> ServingPlan:
    """Schedule concurrent inference of several models on a split pod."""
    sched = scheduler or Scheduler(platform or tpu_pod_split(),
                                   device=device)
    plat = sched.platform
    graphs = []
    for cfg, cell in zip(cfgs, cells):
        cell = SHAPES[cell] if isinstance(cell, str) else cell
        graphs.append(export_graph(cfg, cell, plat))
    rows = sched.compare(graphs, objective, max_transitions=2,
                         iterations=iterations, deadline_s=deadline_s)
    plan = rows.pop("haxconn")
    if failed(plan):
        raise RuntimeError(f"no schedule found: {plan['error']['message']}")
    return ServingPlan(graphs, plan.solution, rows, plat, plan=plan)


# ---------------------------------------------------------------------------
# co-serving demo (real compute + simulated time)
# ---------------------------------------------------------------------------

@dataclass
class CoServer:
    """Executes scheduled rounds of two models for real while advancing a
    simulated clock from the plan's exact timeline."""

    models: list[Model]
    plan: ServingPlan
    sim_time_ms: float = 0.0
    rounds: int = 0

    def run_round(self, batches) -> list[torch.Tensor]:
        outs = []
        with torch.inference_mode():
            for model, batch in zip(self.models, batches):
                outs.append(model.forward(batch))
        self.sim_time_ms += self.plan.solution.result.makespan
        self.rounds += 1
        return outs

    @property
    def simulated_fps(self) -> float:
        per_round = sum(len(w.graph.groups) and 1
                        for w in self.plan.solution.workloads)
        return 1e3 * self.rounds * per_round / max(self.sim_time_ms, 1e-9)

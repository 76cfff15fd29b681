"""Greedy contention-aware solver (pure Python, no z3, never exhaustive).

The registry's last-resort entry for ``solver="auto"``: when z3 is missing
and the branch-and-bound search space is too large, this solver still
returns a valid, contention-scored schedule in polynomial time:

  1. evaluate every baseline scheduler under the *exact* contention
     simulator and take the best one as the incumbent (the same §5.3
     starting point the CEGAR loop uses);
  2. improve it with single-group reassignment moves scored by the
     simulator until no move helps (or the sweep budget is hit).

Search backends (the registry ``evaluator`` knob):

* ``"batch"`` (default via ``"auto"``) / ``"jax"`` — population hill
  climb: every legal single-group move of every beam member is scored in
  one ``simulate_assignments`` call of the selected evaluator entry per
  step (steepest ascent; ``beam_width > 1`` keeps the best k incumbents
  alive).  The NumPy entry packs each frontier directly; the jax entry
  lowers it to a :class:`~repro_torch.core.lowering.ProblemSpec` and pads to a
  power of two, so the varying frontier sizes share compiled XLA
  executables.  The final incumbent is re-simulated through the
  authoritative scalar simulator before being returned.
* ``"scalar"`` — the original first-improvement sweep, one scalar
  simulation per move.

The result is never worse than the best baseline — the never-worse
guarantee HaX-CoNN claims for its fallback path — but carries no
optimality certificate (``Solution.optimal`` is always False).
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np

from .accelerators import Platform
from .contention import ContentionModel
from .graph import DNNGraph
from .simulate import Workload, simulate

_EPS = 1e-9


def _legal(graph: DNNGraph, assignment: Sequence[str],
           max_transitions: int | None) -> bool:
    trans = 0
    for i in range(len(assignment) - 1):
        if assignment[i] != assignment[i + 1]:
            if not graph[i].can_transition_after:
                return False
            trans += 1
    return max_transitions is None or trans <= max_transitions


def _baseline_pool(platform, graphs, its, deps, max_transitions):
    """(name, workloads) for every registered baseline that yields a legal
    schedule on this platform."""
    from . import registry

    pool = []
    for name in registry.baseline_names():
        try:
            wls = registry.get_baseline(name)(
                platform, graphs, iterations=its, depends_on=deps)
        except (ValueError, KeyError):
            continue
        if any(not _legal(w.graph, w.assignment, max_transitions)
               for w in wls):
            continue
        pool.append((name, wls))
    if not pool:
        raise RuntimeError("no baseline produced a valid schedule")
    return pool


def _neighbors(platform: Platform, graphs: Sequence[DNNGraph],
               asg: tuple[tuple[str, ...], ...],
               max_transitions: int | None):
    """All legal single-group reassignments of ``asg``."""
    for n, g in enumerate(graphs):
        for i in range(len(g)):
            for acc in platform.names:
                if acc == asg[n][i] or acc not in g[i].times:
                    continue
                cand = list(asg[n])
                cand[i] = acc
                if not _legal(g, cand, max_transitions):
                    continue
                yield asg[:n] + (tuple(cand),) + asg[n + 1:]


def solve(
    platform: Platform,
    graphs: Sequence[DNNGraph],
    model: ContentionModel | Mapping[str, ContentionModel],
    objective: str = "latency",
    max_transitions: int | None = 3,
    iterations: Sequence[int] | None = None,
    depends_on: Sequence[int | None] | None = None,
    max_sweeps: int = 3,
    evaluator: str = "auto",
    beam_width: int = 1,
):
    from . import registry
    from .solver_bb import Solution

    its = list(iterations or [1] * len(graphs))
    deps = list(depends_on or [None] * len(graphs))
    entry = registry.resolve_evaluator(evaluator)
    if entry.name != "scalar":
        return _solve_population(entry, platform, graphs, model, objective,
                                 max_transitions, its, deps, max_sweeps,
                                 beam_width)

    def build(assignments):
        return [Workload(g, tuple(a), iterations=it, depends_on=dep)
                for g, a, it, dep in zip(graphs, assignments, its, deps)]

    # 1) incumbent: best *registered* baseline under the exact simulator.
    best = None
    evaluated = 0
    for _name, wls in _baseline_pool(platform, graphs, its, deps,
                                     max_transitions):
        res = simulate(platform, wls, model, record_timeline=False)
        evaluated += 1
        obj = res.objective(objective)
        if best is None or obj < best[0]:
            best = (obj, wls, res)
    obj, wls, res = best

    # 2) hill climb: single-group reassignments scored by the simulator.
    assignments = [list(w.assignment) for w in wls]
    for _ in range(max_sweeps):
        improved = False
        for n, g in enumerate(graphs):
            for i in range(len(g)):
                for acc in platform.names:
                    if acc == assignments[n][i] or acc not in g[i].times:
                        continue
                    old = assignments[n][i]
                    assignments[n][i] = acc
                    if not _legal(g, assignments[n], max_transitions):
                        assignments[n][i] = old
                        continue
                    cand = build(assignments)
                    cand_res = simulate(platform, cand, model,
                                        record_timeline=False)
                    evaluated += 1
                    cand_obj = cand_res.objective(objective)
                    if cand_obj < obj - _EPS:
                        obj, wls, res = cand_obj, cand, cand_res
                        improved = True
                    else:
                        assignments[n][i] = old
        if not improved:
            break

    return Solution(wls, res, obj, objective, evaluated, optimal=False)


def _solve_population(entry, platform: Platform, graphs: Sequence[DNNGraph],
                      model, objective: str, max_transitions: int | None,
                      its: Sequence[int], deps: Sequence[int | None],
                      max_sweeps: int, beam_width: int):
    from .solver_bb import Solution

    # 1) incumbent: all baselines scored in one batch call.
    pool = _baseline_pool(platform, graphs, its, deps, max_transitions)
    base_asgs = [tuple(w.assignment for w in wls) for _, wls in pool]
    bt = entry.simulate_assignments(platform, graphs, base_asgs, model,
                                    iterations=its, depends_on=deps,
                                    validate=False)
    objs = bt.objective(objective)
    evaluated = len(pool)
    start = int(np.argmin(objs))

    beam: list[tuple[float, tuple[tuple[str, ...], ...]]] = [
        (float(objs[start]), base_asgs[start])]
    seen = {base_asgs[start]}

    # 2) population hill climb: score every legal single-group move of every
    # beam member in one batch per step; steepest ascent with optional beam.
    max_steps = max(1, max_sweeps) * sum(len(g) for g in graphs)
    for _ in range(max_steps):
        frontier: list[tuple[tuple[str, ...], ...]] = []
        for _obj, asg in beam:
            for nb in _neighbors(platform, graphs, asg, max_transitions):
                if nb not in seen:
                    seen.add(nb)
                    frontier.append(nb)
        if not frontier:
            break
        bt = entry.simulate_assignments(platform, graphs, frontier, model,
                                        iterations=its, depends_on=deps,
                                        validate=False)
        objs = bt.objective(objective)
        evaluated += len(frontier)
        merged = beam + [(float(o), a) for o, a in zip(objs, frontier)]
        merged.sort(key=lambda t: t[0])
        improved = merged[0][0] < beam[0][0] - _EPS
        beam = merged[:max(1, beam_width)]
        if not improved:
            break

    best_asg = beam[0][1]
    wls = [Workload(g, tuple(a), iterations=it, depends_on=dep)
           for g, a, it, dep in zip(graphs, best_asg, its, deps)]
    # scalar re-simulation: the recorded result is authoritative.
    res = entry.simulate(platform, wls, model, record_timeline=False)
    return Solution(wls, res, res.objective(objective), objective,
                    evaluated, optimal=False)

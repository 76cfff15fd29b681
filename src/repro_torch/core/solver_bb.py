"""Exact branch-and-bound / exhaustive solver (pure Python, no z3).

Used as the optimality *oracle* in tests and as the fallback when z3 is not
installed.  Enumerates per-DNN assignments with a bounded number of
inter-accelerator transitions (``max_transitions``; the paper's optimal
schedules in Table 6 all use exactly one transition per DNN, and
``max_transitions=len(graph)`` recovers the full space), prunes joint
combinations with an admissible contention-free lower bound, and evaluates
survivors with the exact simulator.

Evaluation backends (the registry ``evaluator`` knob):

* ``"batch"`` (default via ``"auto"``) — lower bounds for the whole joint
  space are computed vectorized, candidates are visited in ascending-bound
  order in chunks, and each chunk is scored in one
  ``simulate_assignments`` call of the selected evaluator entry (NumPy
  lockstep for ``"batch"``, the XLA jit+vmap loop for ``"jax"`` — chunk
  populations pad to powers of two there, so the tail chunks reuse
  compiled executables).  The final incumbent is re-simulated through the
  authoritative scalar simulator, so the returned :class:`Solution` never
  depends on a fast path.
* ``"scalar"`` — the original one-candidate-at-a-time loop.

All backends visit candidates in the same order and accept the same strict
improvements, so they return the same schedule (a population path may score
a few extra candidates past the scalar path's break point; it can only
confirm the incumbent).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Mapping, Sequence

import numpy as np

from .accelerators import Platform
from .contention import ContentionModel
from .graph import DNNGraph
from .simulate import SimResult, Workload, simulate


@dataclass
class Solution:
    workloads: list[Workload]
    result: SimResult
    objective: float
    kind: str
    evaluated: int
    optimal: bool
    #: solver-specific provenance (seed, steps, population, ...); travels
    #: into Plan artifacts as ``solver_params``.  Exact solvers leave it
    #: empty; stochastic ones record what reproduces their run.
    params: dict = field(default_factory=dict)

    @property
    def assignments(self) -> list[tuple[str, ...]]:
        return [w.assignment for w in self.workloads]


def enumerate_assignments(
    graph: DNNGraph, accs: Sequence[str], max_transitions: int
) -> list[tuple[str, ...]]:
    """All legal assignments of ``graph`` with <= ``max_transitions``."""
    accs = [a for a in accs if a in graph.accelerators]
    n = len(graph)
    legal_after = [graph[i].can_transition_after for i in range(n)]
    out: list[tuple[str, ...]] = []

    def rec(i: int, cur: list[str], trans: int):
        if i == n:
            out.append(tuple(cur))
            return
        for a in accs:
            if i > 0 and a != cur[-1]:
                if trans >= max_transitions or not legal_after[i - 1]:
                    continue
                cur.append(a)
                rec(i + 1, cur, trans + 1)
            else:
                cur.append(a)
                rec(i + 1, cur, trans)
            cur.pop()

    rec(0, [], 0)
    return out


def lower_bound_time(platform: Platform, graph: DNNGraph,
                     assignment: Sequence[str]) -> float:
    """Contention- and queueing-free completion time (admissible)."""
    t = sum(graph[i].time_on(a) for i, a in enumerate(assignment))
    for i in range(len(assignment) - 1):
        if assignment[i] != assignment[i + 1]:
            t += platform.transition_cost_ms(graph[i].out_bytes,
                                             assignment[i], assignment[i + 1])
    return t


def joint_lower_bound(platform: Platform, graphs: Sequence[DNNGraph],
                      assignments: Sequence[Sequence[str]],
                      iterations: Sequence[int]) -> float:
    """Admissible makespan LB: max of per-DNN path bounds and per-acc load."""
    per_dnn = [
        lower_bound_time(platform, g, a) * it
        for g, a, it in zip(graphs, assignments, iterations)
    ]
    load: dict[str, float] = {a: 0.0 for a in platform.names}
    for g, asg, it in zip(graphs, assignments, iterations):
        for i, a in enumerate(asg):
            load[a] += g[i].time_on(a) * it
    return max(max(per_dnn), max(load.values()))


def solve(
    platform: Platform,
    graphs: Sequence[DNNGraph],
    model: ContentionModel | Mapping[str, ContentionModel],
    objective: str = "latency",
    max_transitions: int = 2,
    iterations: Sequence[int] | None = None,
    depends_on: Sequence[int | None] | None = None,
    max_candidates: int = 2_000_000,
    evaluator: str = "auto",
    chunk: int = 512,
) -> Solution:
    from . import registry

    its = list(iterations or [1] * len(graphs))
    deps = list(depends_on or [None] * len(graphs))
    cand = [enumerate_assignments(g, platform.names, max_transitions)
            for g in graphs]
    total = 1
    for c in cand:
        total *= len(c)
    if total > max_candidates:
        raise ValueError(
            f"search space {total} too large for exhaustive solve; "
            f"reduce max_transitions or merge layer groups"
        )

    entry = registry.resolve_evaluator(evaluator)
    if entry.name != "scalar":
        return _solve_batched(entry, platform, graphs, model, objective,
                              cand, its, deps, total, chunk)

    # Order joint candidates by lower bound so the incumbent tightens fast.
    best: Solution | None = None
    evaluated = 0
    combos = sorted(
        itertools.product(*cand),
        key=lambda asgs: joint_lower_bound(platform, graphs, asgs, its),
    )
    for asgs in combos:
        lb = joint_lower_bound(platform, graphs, asgs, its)
        if best is not None and objective in ("latency", "throughput"):
            # both objectives are monotone in makespan; lb bounds makespan.
            if lb >= best.result.makespan - 1e-12:
                break  # sorted by LB: nothing later can win
        wls = [Workload(g, tuple(a), iterations=it, depends_on=dep)
               for g, a, it, dep in zip(graphs, asgs, its, deps)]
        res = simulate(platform, wls, model, record_timeline=False)
        evaluated += 1
        obj = res.objective(objective)
        if best is None or obj < best.objective:
            best = Solution(wls, res, obj, objective, evaluated, optimal=True)
    assert best is not None
    best.evaluated = evaluated
    return best


def _joint_lower_bounds(platform: Platform, graphs: Sequence[DNNGraph],
                        cand: Sequence[Sequence[tuple[str, ...]]],
                        its: Sequence[int]) -> np.ndarray:
    """Vectorized :func:`joint_lower_bound` over the full joint space.

    Returns a flat (prod K_i,) array in C order — i.e. the same order
    ``itertools.product(*cand)`` enumerates, so a stable argsort reproduces
    the scalar path's visit order exactly.
    """
    names = list(platform.names)
    a_idx = {a: j for j, a in enumerate(names)}
    shape = tuple(len(c) for c in cand)
    w = len(graphs)
    paths = []            # per graph: (K_i,) critical-path bound
    loads = []            # per graph: (K_i, A) per-accelerator load
    for g, clist, it in zip(graphs, cand, its):
        pl = np.empty(len(clist))
        ld = np.zeros((len(clist), len(names)))
        for k, asg in enumerate(clist):
            pl[k] = lower_bound_time(platform, g, asg) * it
            for i, a in enumerate(asg):
                ld[k, a_idx[a]] += g[i].time_on(a) * it
        paths.append(pl)
        loads.append(ld)

    def bshape(i: int, trailing: tuple[int, ...] = ()) -> tuple[int, ...]:
        return tuple(shape[j] if j == i else 1 for j in range(w)) + trailing

    per_dnn = np.zeros(shape)
    for i in range(w):
        per_dnn = np.maximum(per_dnn, paths[i].reshape(bshape(i)))
    load = np.zeros(shape + (len(names),))
    for i in range(w):
        load = load + loads[i].reshape(bshape(i, (len(names),)))
    return np.maximum(per_dnn, load.max(axis=-1)).ravel()


def _solve_batched(entry, platform: Platform, graphs: Sequence[DNNGraph],
                   model, objective: str,
                   cand: Sequence[Sequence[tuple[str, ...]]],
                   its: Sequence[int], deps: Sequence[int | None],
                   total: int, chunk: int) -> Solution:
    shape = tuple(len(c) for c in cand)
    lb = _joint_lower_bounds(platform, graphs, cand, its)
    order = np.argsort(lb, kind="stable")
    prune = objective in ("latency", "throughput")

    best_flat = -1
    best_obj = np.inf
    best_makespan = np.inf
    evaluated = 0
    pos = 0
    while pos < total:
        take = order[pos:pos + chunk]
        if best_flat >= 0 and prune:
            # lb ascending along `order`: candidates at/after the first one
            # with lb >= incumbent makespan cannot win (both objectives are
            # monotone in makespan; lb bounds makespan from below).
            keep = lb[take] < best_makespan - 1e-12
            if not keep.all():
                take = take[:int(np.argmin(keep))]
            if len(take) == 0:
                break
        idxs = np.unravel_index(take, shape)
        asgs_chunk = [[cand[i][idxs[i][j]] for i in range(len(graphs))]
                      for j in range(len(take))]
        bt = entry.simulate_assignments(
            platform, graphs, asgs_chunk, model,
            iterations=its, depends_on=deps, validate=False)
        objs = bt.objective(objective)
        evaluated += len(take)
        j = int(np.argmin(objs))    # first among ties = scalar visit order
        if objs[j] < best_obj:
            best_obj = float(objs[j])
            best_makespan = float(bt.makespan[j])
            best_flat = int(take[j])
        pos += len(take)

    assert best_flat >= 0
    best_idx = np.unravel_index(best_flat, shape)
    wls = [Workload(g, tuple(cand[i][best_idx[i]]), iterations=it,
                    depends_on=dep)
           for i, (g, it, dep) in enumerate(zip(graphs, its, deps))]
    # the scalar simulator is authoritative: the recorded result (and the
    # objective stored with it) never comes from the fast path.
    res = entry.simulate(platform, wls, model, record_timeline=False)
    return Solution(wls, res, res.objective(objective), objective,
                    evaluated, optimal=True)

"""Baseline schedulers the paper compares against (§5, Table 1).

All baselines return per-group assignments which are then evaluated by the
*exact* contention-aware simulator — reproducing the paper's observation that
contention-unaware schedulers mispredict timings (by up to 75%, §5.2) and
therefore produce inefficient schedules.

  * ``fastest_only``      — Case 1: everything serialized on the fastest
                            accelerator (GPU-only).
  * ``naive_concurrent``  — Case 2: whole-DNN mapping, one DNN per
                            accelerator (no layer-level transitions).
  * ``mensa_like``        — greedy per-layer, per-DNN affinity mapping with
                            myopic transition costs, contention-unaware
                            (Mensa [6] supports single-DNN only: each DNN is
                            mapped independently of the others).
  * ``herald_like``       — multi-DNN load-balancing list scheduler, no
                            transition costs, contention-unaware (Herald [35]).
  * ``h2h_like``          — Herald + transition-cost awareness (H2H [69]),
                            still contention-unaware.
"""
from __future__ import annotations

import itertools
from typing import Sequence

from .accelerators import Platform
from .graph import DNNGraph
from .simulate import Workload


def _fastest(platform: Platform, graphs: Sequence[DNNGraph]) -> str:
    """Accelerator with the lowest total standalone time over all graphs."""
    accs = set(platform.names)
    for g in graphs:
        accs &= set(g.accelerators)
    if not accs:
        raise ValueError("no accelerator supports every graph")
    return min(accs, key=lambda a: sum(g.standalone_time(a) for g in graphs))


def _mk(graphs, assignments, iterations, depends_on):
    its = iterations or [1] * len(graphs)
    deps = depends_on or [None] * len(graphs)
    return [
        Workload(g, tuple(a), iterations=its[i], depends_on=deps[i])
        for i, (g, a) in enumerate(zip(graphs, assignments))
    ]


def fastest_only(platform: Platform, graphs: Sequence[DNNGraph],
                 iterations=None, depends_on=None) -> list[Workload]:
    best = _fastest(platform, graphs)
    return _mk(graphs, [[best] * len(g) for g in graphs], iterations, depends_on)


def naive_concurrent(platform: Platform, graphs: Sequence[DNNGraph],
                     iterations=None, depends_on=None) -> list[Workload]:
    """Whole-DNN mapping (no layer-level transitions): pick the whole-network
    to accelerator assignment minimizing the *contention-free* makespan bound
    (max of per-accelerator load and per-DNN runtime) — the strongest
    schedule expressible without layer splitting, still contention-blind."""
    its = iterations or [1] * len(graphs)
    best: tuple[float, list[str]] | None = None
    for combo in itertools.product(platform.names, repeat=len(graphs)):
        if any(a not in g.accelerators for a, g in zip(combo, graphs)):
            continue
        load: dict[str, float] = {a: 0.0 for a in platform.names}
        paths = []
        for a, g, it in zip(combo, graphs, its):
            t = g.standalone_time(a) * it
            load[a] += t
            paths.append(t)
        bound = max(max(load.values()), max(paths))
        if best is None or bound < best[0]:
            best = (bound, list(combo))
    if best is None:
        raise ValueError("no feasible whole-DNN mapping")
    assignments = [[a] * len(g) for a, g in zip(best[1], graphs)]
    return _mk(graphs, assignments, iterations, depends_on)


def mensa_like(platform: Platform, graphs: Sequence[DNNGraph],
               iterations=None, depends_on=None) -> list[Workload]:
    """Greedy per-layer affinity with myopic transition accounting.

    For each DNN independently: walk groups in order and pick the accelerator
    minimizing (group time + transition cost from the previous choice).
    Ignores other DNNs and contention entirely.
    """
    assignments = []
    for g in graphs:
        choice: list[str] = []
        for i, grp in enumerate(g):
            def cost(a: str) -> float:
                c = grp.time_on(a)
                if choice and a != choice[-1]:
                    if not g[i - 1].can_transition_after:
                        return float("inf")
                    c += platform.transition_cost_ms(
                        g[i - 1].out_bytes, choice[-1], a)
                return c
            choice.append(min(grp.times, key=cost))
        assignments.append(choice)
    return _mk(graphs, assignments, iterations, depends_on)


def _list_schedule(platform: Platform, graphs: Sequence[DNNGraph],
                   transition_aware: bool) -> list[list[str]]:
    """Contention-unaware multi-DNN list scheduler (Herald/H2H stand-ins).

    Event-driven greedy: repeatedly dispatch the next group of the DNN whose
    frontier is earliest, to the accelerator minimizing its *predicted*
    completion (no contention in the prediction).
    """
    avail = {a: 0.0 for a in platform.names}
    frontier = [0.0] * len(graphs)       # time the DNN's next group is ready
    idx = [0] * len(graphs)
    last_acc: list[str | None] = [None] * len(graphs)
    assignments: list[list[str]] = [[] for _ in graphs]
    remaining = sum(len(g) for g in graphs)
    while remaining:
        n = min((i for i in range(len(graphs)) if idx[i] < len(graphs[i])),
                key=lambda i: frontier[i])
        g, i = graphs[n], idx[n]
        grp = g[i]

        def completion(a: str) -> float:
            start = max(avail[a], frontier[n])
            tau = 0.0
            if transition_aware and last_acc[n] is not None and a != last_acc[n]:
                if not g[i - 1].can_transition_after:
                    return float("inf")
                tau = platform.transition_cost_ms(g[i - 1].out_bytes,
                                                  last_acc[n], a)
            elif (last_acc[n] is not None and a != last_acc[n]
                  and not g[i - 1].can_transition_after):
                return float("inf")
            return start + tau + grp.time_on(a)

        acc = min(grp.times, key=completion)
        done = completion(acc)
        avail[acc] = done
        frontier[n] = done
        last_acc[n] = acc
        assignments[n].append(acc)
        idx[n] += 1
        remaining -= 1
    return assignments


def herald_like(platform: Platform, graphs: Sequence[DNNGraph],
                iterations=None, depends_on=None) -> list[Workload]:
    return _mk(graphs, _list_schedule(platform, graphs, transition_aware=False),
               iterations, depends_on)


def h2h_like(platform: Platform, graphs: Sequence[DNNGraph],
             iterations=None, depends_on=None) -> list[Workload]:
    return _mk(graphs, _list_schedule(platform, graphs, transition_aware=True),
               iterations, depends_on)


BASELINES = {
    "fastest_only": fastest_only,
    "naive_concurrent": naive_concurrent,
    "mensa": mensa_like,
    "herald": herald_like,
    "h2h": h2h_like,
}

"""Device-resident annealing solver (the ``"anneal"`` registry entry).

The port's counterpart of ``repro/core/solver_anneal.py``.  A thin host
shell around :mod:`repro_torch.core.search_torch`: seed the search from
the best registered baseline schedule (the same pool the greedy solver
starts from), run the island annealer over the lowered tables on the card,
then re-simulate the device incumbent through the authoritative scalar
simulator — the returned :class:`~repro_torch.core.solver_bb.Solution` never
depends on device numerics, exactly like the batch/jax evaluator paths of
the bb and greedy solvers.

The entry is *opt-in*: it registers at priority 30, behind z3 -> bb ->
greedy, so ``solver="auto"`` never reaches it; callers ask for it by name
(``solver="anneal"``) when the joint space is too large to enumerate and
greedy's single-site hill climb stalls.  Search provenance (seed, steps,
population, the device-side objective) is recorded in ``Solution.params``
and flows into :class:`~repro_torch.core.plan.Plan` artifacts.

Knobs left unset fall to fixed defaults — unless ``budget_ms`` is given,
in which case :func:`auto_tune` derives them from the problem's log2
joint-space size, the requested device count, and the *measured*
evaluator throughput (a two-call probe at the final population, or a
``cands_per_s`` hint recorded in a ProfileBundle's provenance) so the
search fills its wall-clock budget instead of guessing.

Every entry point takes a ``device`` (``cuda`` unless asked otherwise); it
never enters the Solution's parameters or a request's hash.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Mapping, Sequence

import numpy as np

from .accelerators import Platform
from .contention import ContentionModel
from .graph import DNNGraph
from .simulate import Workload
from .solver_bb import Solution
from .solver_greedy import _baseline_pool

#: fixed defaults when no wall-clock budget drives the auto-tuner.
DEFAULT_POPULATION = 2048
DEFAULT_STEPS = 192

#: auto-tune clamps: the population stays large enough for island
#: migration to matter and small enough that compile time stays amortized.
MIN_POPULATION, MAX_POPULATION = 256, 8192
MIN_STEPS, MAX_STEPS = 16, 4096
#: steps used by the throughput probe (compile-warm + one timed call).
PROBE_STEPS = 8


def _round_up(value: float, quantum: int) -> int:
    return max(quantum, int(math.ceil(value / quantum)) * quantum)


def space_bits(tables) -> float:
    """log2 of the joint assignment-space size (ignoring transition
    legality): the sum over live (workload, group) sites of the per-site
    accelerator branching."""
    bits = 0.0
    for m in range(tables.w):
        ng = int(tables.ngroups[m])
        bits += float(np.sum(np.log2(
            np.maximum(tables.n_allowed[m, :ng], 1))))
    return bits


def probe_cands_per_s(tables, *, objective: str = "latency",
                      population: int, island: int,
                      devices: int | None = None, migrate: str = "auto",
                      fanout: str = "auto", backend: str = "auto",
                      precision: str = "float32", seed: int = 0,
                      device=None) -> float:
    """Measured steady-state candidates/s of the torch search on
    ``device``.

    Two short runs at the *final* population: the first builds the
    kernels and warms the allocator, the second is timed.
    """
    from . import search_torch
    kw = dict(objective=objective, seed=seed, population=population,
              island=island, steps=PROBE_STEPS, devices=devices,
              migrate=migrate, fanout=fanout, backend=backend,
              precision=precision, device=device)
    search_torch.anneal_search(tables, **kw)        # build / warm-up
    t0 = time.perf_counter()
    out = search_torch.anneal_search(tables, **kw)
    dt = max(time.perf_counter() - t0, 1e-9)
    return out.evaluated / dt


@dataclass(frozen=True)
class TunedKnobs:
    """What :func:`auto_tune` decided, plus how it got there."""

    population: int
    steps: int
    island: int
    cands_per_s: float | None
    probed: bool


def auto_tune(tables, *, budget_ms: float,
              population: int | None = None, steps: int | None = None,
              island: int | None = None, devices: int | None = None,
              cands_per_s: float | None = None, objective: str = "latency",
              migrate: str = "auto", fanout: str = "auto",
              backend: str = "auto", precision: str = "float32",
              seed: int = 0, device=None) -> TunedKnobs:
    """Derive (population, steps) filling ``budget_ms`` of search time.

    Population scales with the problem's log2 joint-space size — wider
    spaces get more parallel chains — rounded up to the island x devices
    quantum the mesh requires.  Steps then spend the remaining budget at
    the measured throughput: ``cands_per_s`` when the caller has one (a
    ProfileBundle provenance hint), else a live two-call probe whose
    compiled executable the real search reuses.  Explicitly-set knobs are
    honored and only the unset ones are derived.
    """
    from . import search_torch
    if budget_ms <= 0:
        raise ValueError(f"budget_ms ({budget_ms}) must be > 0")
    isl = search_torch.DEFAULT_ISLAND if island is None else island
    quantum = isl * (devices or 1)
    if population is None:
        # ~64 chains per joint-space bit: small two-DNN pairs get a few
        # hundred chains, Table-6 triples a few thousand.
        population = int(np.clip(_round_up(64.0 * space_bits(tables),
                                           quantum),
                                 _round_up(MIN_POPULATION, quantum),
                                 _round_up(MAX_POPULATION, quantum)))
    probed = False
    if steps is None:
        if cands_per_s is None:
            cands_per_s = probe_cands_per_s(
                tables, objective=objective, population=population,
                island=isl, devices=devices, migrate=migrate,
                fanout=fanout, backend=backend, precision=precision,
                seed=seed, device=device)
            probed = True
        # evaluated = population * (steps + 1)  =>  solve for steps.
        steps = int(np.clip(
            budget_ms / 1e3 * cands_per_s / population - 1,
            MIN_STEPS, MAX_STEPS))
    return TunedKnobs(population=population, steps=steps, island=isl,
                      cands_per_s=cands_per_s, probed=probed)


def measure_search_throughput(
    platform: Platform,
    graphs: Sequence[DNNGraph],
    model: ContentionModel | Mapping[str, ContentionModel],
    *,
    objective: str = "latency",
    max_transitions: int | None = 3,
    population: int = 1024,
    island: int | None = None,
    devices: int | None = None,
    device=None,
) -> float:
    """Candidates/s of the device search on this host for one problem —
    the number a ProfileBundle records (provenance ``search_cands_per_s``)
    so later budgeted solves can skip the live probe."""
    from . import search_torch
    tables = search_torch.build_tables(
        platform, graphs, model,
        max(len(g) for g in graphs) if max_transitions is None
        else max_transitions)
    isl = search_torch.DEFAULT_ISLAND if island is None else island
    return probe_cands_per_s(tables, objective=objective,
                             population=_round_up(population,
                                                  isl * (devices or 1)),
                             island=isl, devices=devices, device=device)


def solve(
    platform: Platform,
    graphs: Sequence[DNNGraph],
    model: ContentionModel | Mapping[str, ContentionModel],
    objective: str = "latency",
    max_transitions: int | None = 3,
    iterations: Sequence[int] | None = None,
    depends_on: Sequence[int | None] | None = None,
    *,
    seed: int = 0,
    population: int | None = None,
    steps: int | None = None,
    island: int | None = None,
    exchange_every: int = 16,
    precision: str = "float32",
    backend: str = "auto",
    chunk: int | None = None,
    devices: int | None = None,
    migrate: str = "auto",
    fanout: str = "auto",
    budget_ms: float | None = None,
    cands_per_s: float | None = None,
    evaluator: str = "auto",
    device=None,
) -> Solution:
    from . import registry, search_torch

    its = list(iterations or [1] * len(graphs))
    deps = list(depends_on or [None] * len(graphs))
    mt = (max(len(g) for g in graphs) if max_transitions is None
          else max_transitions)
    tables = search_torch.build_tables(platform, graphs, model, mt,
                                     iterations=its, depends_on=deps)
    entry = registry.resolve_evaluator(evaluator)

    tuned = None
    if budget_ms is not None:
        tuned = auto_tune(
            tables, budget_ms=budget_ms, population=population, steps=steps,
            island=island, devices=devices, cands_per_s=cands_per_s,
            objective=objective, migrate=migrate, fanout=fanout,
            backend=backend, precision=precision, seed=seed, device=device)
        population, steps, island = (tuned.population, tuned.steps,
                                     tuned.island)
    else:
        island = search_torch.DEFAULT_ISLAND if island is None else island
        if population is None:
            population = _round_up(DEFAULT_POPULATION,
                                   island * (devices or 1))
        if steps is None:
            steps = DEFAULT_STEPS

    # Baseline-seeded start: best registered baseline under the scalar
    # simulator (greedy's incumbent pool).  Failing that, the search falls
    # back to its own duration-greedy single-accelerator init.
    init = init_obj = None
    scalar_evals = 0
    try:
        pool = _baseline_pool(platform, graphs, its, deps, mt)
    except RuntimeError:
        pool = []
    for _name, wls in pool:
        res = entry.simulate(platform, wls, model, record_timeline=False)
        scalar_evals += 1
        obj = res.objective(objective)
        if init_obj is None or obj < init_obj:
            init, init_obj = [w.assignment for w in wls], obj

    out = search_torch.anneal_search(
        tables, objective=objective, seed=seed, population=population,
        steps=steps, island=island, exchange_every=exchange_every,
        precision=precision, backend=backend, chunk=chunk, devices=devices,
        migrate=migrate, fanout=fanout, init_assignment=init,
        init_objective=init_obj, device=device)

    # The scalar simulator is authoritative: the recorded result (and the
    # objective the Solution carries) never comes from the device.
    wls = [Workload(g, tuple(a), iterations=it, depends_on=dep)
           for g, a, it, dep in zip(graphs, out.assignment, its, deps)]
    res = entry.simulate(platform, wls, model, record_timeline=False)
    scalar_evals += 1
    obj = res.objective(objective)
    if init_obj is not None and init_obj < obj:
        # float32 ranking can (rarely) prefer a mutant the exact simulator
        # scores a hair worse than the baseline seed; never regress.
        wls = [Workload(g, tuple(a), iterations=it, depends_on=dep)
               for g, a, it, dep in zip(graphs, init, its, deps)]
        res = entry.simulate(platform, wls, model, record_timeline=False)
        scalar_evals += 1
        obj = res.objective(objective)

    params = {
        "seed": int(out.seed),
        "steps": int(out.steps),
        "population": int(out.population),
        "island": int(island),
        "exchange_every": int(exchange_every),
        "precision": out.precision,
        "backend": out.backend,
        "chain": int(out.chain),
        "device_objective": float(out.objective),
    }
    if devices is not None:
        params.update(devices=int(devices), migrate=out.migrate,
                      fanout=out.fanout)
    if budget_ms is not None:
        params["budget_ms"] = float(budget_ms)
        if tuned is not None and tuned.cands_per_s is not None:
            params["cands_per_s"] = float(tuned.cands_per_s)
            params["throughput_probed"] = bool(tuned.probed)
    return Solution(
        wls, res, obj, objective, out.evaluated + scalar_evals,
        optimal=False, params=params)

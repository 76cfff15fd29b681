"""Vectorized batch timeline evaluation: N candidate schedules in one pass.

The exact event-driven simulator in :mod:`repro_torch.core.simulate` is the
authoritative evaluator of the paper's Eq. 2-8 timeline, but it walks one
candidate schedule at a time — and schedule *search* (greedy hill climb,
branch-and-bound sibling scoring, the Table-8 exhaustive sweep) is bounded
by how many candidates it can score per second.  This module evaluates a
whole population of candidates simultaneously by running the same
event-driven state machine in *lockstep across candidates*: every piece of
per-workload simulator state becomes an array over ``candidates ×
workloads``, and each loop iteration advances every still-running candidate
to its own next event with a fixed number of NumPy kernels.  Interpreter
overhead is paid once per event *wave* instead of once per event per
candidate, which is where the >=10x candidate-evaluation throughput comes
from (see ``benchmarks/bench_simulate.py`` / ``BENCH_simulate.json``).

Problems reach the event loop as a lowered :class:`~repro_torch.core.lowering.
ProblemSpec` — the frozen array-IR produced by :mod:`repro_torch.core.lowering`
(``lower_workloads`` / ``lower_assignments`` / ``lower_product`` /
``lower_sweep``) and shared with the XLA evaluator in
:mod:`repro_torch.core.simulate_torch`; :func:`simulate_spec` here is the NumPy
interpretation of that IR, and the convenience wrappers below lower and run
in one call.

Semantics are bit-for-bit the scalar simulator's modulo floating-point
summation order (guarded to 1e-6 by ``tests/test_simulate_differential.py``):

  * one layer group per accelerator at a time, FIFO by (ready time, index);
  * inter-accelerator transitions delay the workload without occupying
    either accelerator;
  * contention intervals integrate ``1 / slowdown(own, external)`` progress
    between events, with external demand summed over shared domains;
  * multi-iteration workloads, ``depends_on`` pipelines and ``arrival_ms``
    offsets behave identically.

The scalar simulator remains *authoritative*: solvers that search with the
batch evaluator re-simulate their final incumbent through
:func:`repro_torch.core.simulate.simulate` before returning it, so a plan's
recorded result never depends on this fast path.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Sequence

import numpy as np

from .accelerators import Platform
from .contention import ContentionModel
from .graph import DNNGraph
# re-exported for backward compatibility: the surface/vectorized-slowdown
# registries live in core.lowering now (one home, every backend consumes).
from .lowering import (ProblemSpec, TOL as _TOL, lower_assignments,
                       lower_product, lower_sweep, lower_workloads,
                       model_slowdown, register_vectorized_slowdown,
                       slowdown_array)
from .simulate import SimResult, Workload

__all__ = [
    "BatchTimeline", "batch_from_results", "simulate_spec", "simulate_batch",
    "simulate_assignments", "simulate_product", "simulate_sweep",
    "register_vectorized_slowdown", "slowdown_array",
]


# ---------------------------------------------------------------------------
# BatchTimeline
# ---------------------------------------------------------------------------

@dataclass
class BatchTimeline:
    """Per-candidate timeline results of one :func:`simulate_batch` call.

    Arrays are indexed ``[candidate]`` / ``[candidate, workload]``; iteration
    latencies are padded with NaN beyond each workload's iteration count.
    """

    #: (N,) total schedule span per candidate (max workload finish time).
    makespan: np.ndarray
    #: (N, W) completion time of every workload.
    finish_times: np.ndarray
    #: (N, W, max_iters) per-iteration service latency, NaN-padded.
    iteration_latencies: np.ndarray
    #: (N, W) number of iterations each workload ran.
    iterations: np.ndarray
    #: (N,) wall-clock ms added purely by contention per candidate.
    contention_ms: np.ndarray
    #: (N, A) contention-free busy ms per accelerator.
    busy_ms: np.ndarray
    #: accelerator names indexing the last axis of ``busy_ms``.
    acc_names: tuple[str, ...]

    def __len__(self) -> int:
        return int(self.makespan.shape[0])

    @property
    def n_candidates(self) -> int:
        return len(self)

    @property
    def throughput_fps(self) -> np.ndarray:
        """(N,) completed DNN inferences per second per candidate."""
        n = self.iterations.sum(axis=1)
        with np.errstate(divide="ignore"):
            fps = np.where(self.makespan > 0, 1e3 * n / self.makespan,
                           np.inf)
        return fps

    def objective(self, kind: str) -> np.ndarray:
        """(N,) solver objective per candidate; lower is better for every
        kind — mirrors :meth:`repro_torch.core.simulate.SimResult.objective`."""
        if kind == "latency":
            return self.makespan.copy()
        if kind == "throughput":
            return -self.throughput_fps
        if kind == "sum_inverse":
            with np.errstate(divide="ignore"):
                inv = np.where(self.finish_times > 0,
                               1.0 / self.finish_times, 0.0)
            return -inv.sum(axis=1)
        raise ValueError(kind)

    def argbest(self, kind: str) -> int:
        """Index of the best candidate (first among exact ties)."""
        return int(np.argmin(self.objective(kind)))

    def result(self, i: int) -> SimResult:
        """Extract candidate ``i`` as a scalar-shaped :class:`SimResult`.

        The interval-level ``timeline`` is not materialized by the batch
        path (it exists to explain one schedule, not to rank thousands);
        re-simulate the winner through the authoritative scalar simulator
        when a Gantt-grade timeline is needed.
        """
        lats = [
            [float(x) for x in row[:int(self.iterations[i, n])]]
            for n, row in enumerate(self.iteration_latencies[i])
        ]
        return SimResult(
            makespan=float(self.makespan[i]),
            finish_times=[float(x) for x in self.finish_times[i]],
            iteration_latencies=lats,
            timeline=[],
            contention_ms=float(self.contention_ms[i]),
            busy_ms={a: float(self.busy_ms[i, j])
                     for j, a in enumerate(self.acc_names)},
        )

    def results(self) -> list[SimResult]:
        return [self.result(i) for i in range(len(self))]


def batch_from_results(results: Sequence[SimResult],
                       acc_names: Sequence[str]) -> BatchTimeline:
    """Assemble a :class:`BatchTimeline` from scalar :class:`SimResult`s.

    This is the "scalar" evaluator's batch implementation: every call site
    written against the batch interface can fall back to the authoritative
    simulator without changing shape.
    """
    n = len(results)
    w = max((len(r.finish_times) for r in results), default=0)
    maxit = max((max((len(l) for l in r.iteration_latencies), default=0)
                 for r in results), default=0)
    lat = np.full((n, w, max(maxit, 1)), np.nan)
    its = np.zeros((n, w), dtype=np.int64)
    fin = np.zeros((n, w))
    for i, r in enumerate(results):
        fin[i, :len(r.finish_times)] = r.finish_times
        for j, l in enumerate(r.iteration_latencies):
            its[i, j] = len(l)
            lat[i, j, :len(l)] = l
    return BatchTimeline(
        makespan=np.array([r.makespan for r in results]),
        finish_times=fin,
        iteration_latencies=lat,
        iterations=its,
        contention_ms=np.array([r.contention_ms for r in results]),
        busy_ms=np.array([[r.busy_ms.get(a, 0.0) for a in acc_names]
                          for r in results]),
        acc_names=tuple(acc_names),
    )


# ---------------------------------------------------------------------------
# the lockstep event loop (NumPy interpretation of the lowered IR)
# ---------------------------------------------------------------------------

def _empty_batch(platform: Platform) -> BatchTimeline:
    return BatchTimeline(
        makespan=np.zeros(0), finish_times=np.zeros((0, 0)),
        iteration_latencies=np.zeros((0, 0, 1)),
        iterations=np.zeros((0, 0), dtype=np.int64),
        contention_ms=np.zeros(0),
        busy_ms=np.zeros((0, len(platform.names))),
        acc_names=tuple(platform.names))


def simulate_batch(
    platform: Platform,
    workloads_batch: Sequence[Sequence[Workload]],
    model: ContentionModel | Mapping[str, ContentionModel],
    validate: bool = True,
) -> BatchTimeline:
    """Simulate N candidate schedules in one vectorized pass.

    ``workloads_batch[c]`` is candidate ``c``'s workload list; candidates
    must agree on the number of workloads but may differ in assignments,
    graphs, iterations, dependencies and arrival offsets.  Returns a
    :class:`BatchTimeline` whose per-candidate values match the scalar
    simulator within floating-point summation order (see
    ``tests/test_simulate_differential.py``).
    """
    if len(workloads_batch) == 0:
        return _empty_batch(platform)
    return simulate_spec(lower_workloads(platform, workloads_batch, model,
                                         validate))


def _col_reduce(ufunc, arr: np.ndarray) -> np.ndarray:
    """Reduce (N, W) along axis 1 via W-1 vectorized column ops.

    NumPy's ``arr.min(axis=1)``/``.any(axis=1)`` degenerate to a Python-side
    outer loop when the reduced axis is tiny (W is 2-4 here) — column-wise
    reduction keeps every op SIMD-width over N instead.
    """
    if arr.shape[1] == 1:
        return arr[:, 0].copy()    # never alias mutable state
    out = ufunc(arr[:, 0], arr[:, 1])
    for j in range(2, arr.shape[1]):
        out = ufunc(out, arr[:, j])
    return out


def simulate_spec(spec: ProblemSpec) -> BatchTimeline:
    """Run the lockstep NumPy event loop over a lowered problem spec.

    The spec is immutable and reusable; candidate compaction during the run
    operates on local gathers, never on the spec's arrays.
    """
    p = spec
    n, w, a_cnt = p.n, p.w, p.amax
    n0 = n
    rows = np.arange(n)
    #: live position -> original candidate id (identity until compaction).
    orig = np.arange(n)

    # spec columns as locals: compaction re-gathers these (the spec's own
    # arrays are read-only and shared).
    g_acc, g_dur, g_dem, g_tau = p.acc, p.dur, p.dem, p.tau
    g_ngroups, g_iters = p.ngroups, p.iters
    g_dep, g_arrival = p.dep, p.arrival

    # mutable per-(candidate, workload) state — the scalar _WorkloadState
    # fields as arrays.  cur_acc/own are maintained incrementally (they only
    # change at group/iteration boundaries) to keep the per-wave kernel
    # count down.
    group = np.zeros((n, w), dtype=np.int64)
    cur_acc = g_acc[:, :, 0].copy()
    own = g_dem[:, :, 0].copy()
    remaining = g_dur[:, :, 0].copy()
    ready = g_arrival.copy()
    it = np.zeros((n, w), dtype=np.int64)
    it_start = g_arrival.copy()
    started = np.zeros((n, w), dtype=bool)
    done = np.zeros((n, w), dtype=bool)
    is_run = np.zeros((n, w), dtype=bool)
    run_wl = np.full((n, a_cnt), -1, dtype=np.int64)
    t = np.zeros(n)

    # outputs stay full-size, indexed by original candidate id.
    max_it = int(g_iters.max())
    iters_full = g_iters.copy()
    finish = np.zeros((n0, w))
    lat = np.full((n0, w, max_it), np.nan)
    contention = np.zeros(n0)
    busy = np.zeros((n0, a_cnt))

    # same guard shape as the scalar simulator, summed across the batch
    # (each lockstep wave advances at least one event or idle jump in every
    # still-alive candidate).
    per_cand = 200000 + 200 * (g_ngroups * g_iters).sum(axis=1)
    max_waves = int(per_cand.sum())
    guard = 0

    inf = np.inf
    alive = ~done.all(axis=1)
    n_alive = n
    while n_alive:
        guard += 1
        if guard > max_waves:
            raise RuntimeError("batch simulator did not converge "
                               "(event storm)")

        if n >= 1024 and n_alive <= n // 2:
            # compact: candidates finish at wildly different wave counts in
            # heterogeneous sweeps; dropping finished rows keeps every wave
            # proportional to live work instead of the original batch size.
            keep = np.nonzero(alive)[0]
            orig = orig[keep]
            t = t[keep]
            group, cur_acc, own = group[keep], cur_acc[keep], own[keep]
            remaining, ready = remaining[keep], ready[keep]
            it, it_start = it[keep], it_start[keep]
            started, done, is_run = started[keep], done[keep], is_run[keep]
            run_wl = run_wl[keep]
            alive = alive[keep]
            g_acc, g_dur = g_acc[keep], g_dur[keep]
            g_dem, g_tau = g_dem[keep], g_tau[keep]
            g_ngroups, g_iters = g_ngroups[keep], g_iters[keep]
            g_dep, g_arrival = g_dep[keep], g_arrival[keep]
            n = len(keep)
            rows = np.arange(n)

        # 1) FIFO claim: eligible waiting workloads sorted by (ready, idx)
        # take their accelerator if free.
        dep_row = np.clip(g_dep, 0, w - 1)
        dep_ok = ((g_dep < 0)
                  | done[rows[:, None], dep_row]
                  | (it[rows[:, None], dep_row] > it))
        eligible = (alive[:, None] & ~done & ~is_run & dep_ok
                    & (ready <= t[:, None] + _TOL))
        if eligible.any():
            key = np.where(eligible, ready, inf)
            if w == 2:
                # stable (ready, idx) order without an axis-1 argsort
                second_first = key[:, 1] < key[:, 0]
                order = np.empty((n, 2), dtype=np.int64)
                order[:, 0] = second_first
                order[:, 1] = ~second_first
            else:
                order = np.argsort(key, axis=1, kind="stable")
            for r in range(w):
                w_r = order[:, r]
                el = eligible[rows, w_r]
                if not el.any():
                    continue
                a_r = cur_acc[rows, w_r]
                claim = el & (run_wl[rows, a_r] < 0)
                if claim.any():
                    cc = rows[claim]
                    run_wl[cc, a_r[claim]] = w_r[claim]
                    is_run[cc, w_r[claim]] = True
                    fresh = (claim & (group[rows, w_r] == 0)
                             & ~started[rows, w_r])
                    if fresh.any():
                        fc = rows[fresh]
                        it_start[fc, w_r[fresh]] = t[fresh]
                        started[fc, w_r[fresh]] = True

        any_run = _col_reduce(np.logical_or, is_run)
        idle = alive & ~any_run
        if idle.any():
            # idle gap: jump those candidates to their next arrival /
            # transition / dependency boundary (they re-claim next wave,
            # exactly like the scalar simulator's `continue`) while every
            # running candidate still integrates this wave.
            pend = np.where(~done & (ready > t[:, None] + _TOL), ready, inf)
            tmin = _col_reduce(np.minimum, pend)
            if not np.isfinite(tmin[idle]).all():
                raise RuntimeError(
                    "deadlock: nothing running, nothing pending")
            t = np.where(idle, tmin, t)
            if not any_run.any():
                continue

        # 2) per-interval slowdowns — computed on the 1-D running-entry
        # vectors (rc, rw), not full (N, W) planes.  One accelerator runs
        # at most one layer, so per-(candidate, acc) demand needs no
        # accumulation: plain fancy assignment is collision-free.
        rc, rw = np.nonzero(is_run)
        run_acc = cur_acc[rc, rw]
        own_run = own[rc, rw]
        acc_dem = np.zeros((n, a_cnt))
        acc_dem[rc, run_acc] = own_run
        # external demand visible from acc a = sum_b domshare[a, b]·demand_b
        ext_run = (acc_dem @ p.domshare.T)[rc, run_acc]
        s_run = np.ones(len(rc))
        contended = (own_run > 0.0) & (ext_run > 0.0)
        if contended.any():
            macc = np.where(contended, p.model_of_acc[run_acc], -1)
            for mid, mod in enumerate(p.models):
                m2 = macc == mid
                if m2.any():
                    # surfaces come pre-lowered on the spec: no per-wave
                    # re-lowering on the hot path.
                    s_run[m2] = np.maximum(
                        1.0, model_slowdown(mod, p.surfaces[mid],
                                            own_run[m2], ext_run[m2]))
            if (contended & (macc < 0)).any():
                bad = int(run_acc[np.nonzero(contended & (macc < 0))[0][0]])
                raise KeyError(
                    f"no contention model covers accelerator "
                    f"{p.acc_names[bad]!r}")

        # 3) next event horizon: earliest running completion, capped by any
        # ready/arrival boundary strictly inside the interval.
        rem_run = remaining[rc, rw]
        run_rem = np.full((n, w), inf)
        run_rem[rc, rw] = rem_run * s_run
        dt = _col_reduce(np.minimum, run_rem)
        horizon = t + dt
        cap = _col_reduce(np.minimum, np.where(
            ~done & ~is_run & (ready > t[:, None] + _TOL)
            & (ready < horizon[:, None] - _TOL),
            ready, inf))
        horizon = np.minimum(horizon, cap)

        # 4) integrate the contention interval.
        span_run = (horizon - t)[rc]
        prog = span_run / s_run
        rem_run = rem_run - prog
        remaining[rc, rw] = rem_run
        np.add.at(contention, orig[rc], span_run * (1.0 - 1.0 / s_run))
        busy[orig[rc], run_acc] += prog   # collision-free: one layer per acc
        t = np.where(alive & any_run, horizon, t)

        # 5) process completions.
        fin_run = rem_run <= _TOL
        if fin_run.any():
            cc, cw = rc[fin_run], rw[fin_run]
            run_wl[cc, run_acc[fin_run]] = -1
            is_run[cc, cw] = False

            g_cur = group[cc, cw]
            has_next = g_cur + 1 < g_ngroups[cc, cw]
            if has_next.any():
                hc, hw = cc[has_next], cw[has_next]
                tau = g_tau[hc, hw, g_cur[has_next]]
                g_new = g_cur[has_next] + 1
                group[hc, hw] = g_new
                cur_acc[hc, hw] = g_acc[hc, hw, g_new]
                own[hc, hw] = g_dem[hc, hw, g_new]
                remaining[hc, hw] = g_dur[hc, hw, g_new]
                ready[hc, hw] = t[hc] + tau

            if not has_next.all():
                lc, lw = cc[~has_next], cw[~has_next]
                it_new = it[lc, lw] + 1
                lat[orig[lc], lw, it_new - 1] = t[lc] - it_start[lc, lw]
                it[lc, lw] = it_new
                started[lc, lw] = False
                fin = it_new >= g_iters[lc, lw]
                if fin.any():
                    fc, fw = lc[fin], lw[fin]
                    done[fc, fw] = True
                    finish[orig[fc], fw] = t[fc]
                if not fin.all():
                    ac, aw = lc[~fin], lw[~fin]
                    group[ac, aw] = 0
                    cur_acc[ac, aw] = g_acc[ac, aw, 0]
                    own[ac, aw] = g_dem[ac, aw, 0]
                    remaining[ac, aw] = g_dur[ac, aw, 0]
                    ready[ac, aw] = t[ac]
            alive = ~_col_reduce(np.logical_and, done)
            n_alive = int(alive.sum())

    return BatchTimeline(
        makespan=finish.max(axis=1),
        finish_times=finish,
        iteration_latencies=lat,
        iterations=iters_full,
        contention_ms=contention,
        busy_ms=busy,
        acc_names=p.acc_names,
    )


def simulate_assignments(
    platform: Platform,
    graphs: Sequence[DNNGraph],
    assignments_batch: Sequence[Sequence[Sequence[str]]],
    model: ContentionModel | Mapping[str, ContentionModel],
    iterations: Sequence[int] | None = None,
    depends_on: Sequence[int | None] | None = None,
    validate: bool = True,
) -> BatchTimeline:
    """Batch-evaluate assignment vectors for fixed graphs, iterations and
    dependencies — the solver hot-path shape.  Skips Workload object
    construction entirely: packing is a handful of vectorized gathers."""
    if len(assignments_batch) == 0:
        return _empty_batch(platform)
    return simulate_spec(lower_assignments(
        platform, graphs, assignments_batch, model, iterations=iterations,
        depends_on=depends_on, validate=validate))


def simulate_product(
    platform: Platform,
    graphs: Sequence[DNNGraph],
    cand_lists: Sequence[Sequence[Sequence[str]]],
    model: ContentionModel | Mapping[str, ContentionModel],
    iterations: Sequence[int] | None = None,
    depends_on: Sequence[int | None] | None = None,
    validate: bool = True,
) -> BatchTimeline:
    """Evaluate the full cross product of per-graph assignment lists.

    ``cand_lists[m]`` holds graph ``m``'s candidate assignments (e.g. from
    :func:`repro_torch.core.solver_bb.enumerate_assignments`); candidate ``i`` of
    the result corresponds to ``list(itertools.product(*cand_lists))[i]``
    without that list ever being built.
    """
    if any(len(c) == 0 for c in cand_lists):
        return _empty_batch(platform)
    return simulate_spec(lower_product(
        platform, graphs, cand_lists, model, iterations=iterations,
        depends_on=depends_on, validate=validate))


def simulate_sweep(
    platform: Platform,
    problems: Sequence[tuple],
    model: ContentionModel | Mapping[str, ContentionModel],
    validate: bool = True,
) -> tuple[BatchTimeline, list[slice]]:
    """Evaluate many scheduling problems' candidate populations in ONE pass.

    ``problems[k] = (graphs, cand_lists, iterations, depends_on)`` — e.g.
    one entry per Table-8 DNN pair with its per-graph exhaustive assignment
    lists (the cross product is expanded by index arithmetic, in
    ``itertools.product`` order).  All problems must share the platform,
    model and workload count; their candidates are concatenated into a
    single lockstep wave loop, which is where sweep-scale batches amortize
    the per-wave kernel overhead far beyond what per-problem calls reach.

    Returns the combined :class:`BatchTimeline` plus one ``slice`` per
    problem addressing its candidates inside the combined arrays.
    """
    spec, slices = lower_sweep(platform, problems, model, validate)
    if spec is None:
        return _empty_batch(platform), []
    return simulate_spec(spec), slices

"""D-HaX-CoNN: dynamic runtime adaptation of optimal schedule generation (§5.3).

Autonomous workload CFGs change at runtime (mode switches, new DNN sets).
Stalling for seconds while Z3 re-solves is not acceptable, so D-HaX-CoNN:

  1. starts from the best *naive* schedule (not Herald/H2H — they themselves
     take seconds, see the paper's footnote),
  2. runs the CEGAR solver in bounded wall-clock slices, replacing the live
     schedule whenever a better one is found,
  3. converges to (and certifies) the optimal schedule as the loop keeps
     running.

The solver state is kept warm across :meth:`step` calls — blocking clauses
and bound cuts persist, matching Z3's incremental model-based quantifier
instantiation behaviour described in the paper.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Mapping, Sequence

try:
    import z3
    HAVE_Z3 = True
except ImportError:  # pragma: no cover
    HAVE_Z3 = False

from .accelerators import Platform
from .contention import ContentionModel
from .graph import DNNGraph
import dataclasses

from .lowering import (lower_surface, register_surface_lowering,
                       register_vectorized_slowdown, slowdown_array)
from .plan import Plan, ScheduleRequest
from .registry import (decode_model, encode_model,
                       register_contention_model)
from .simulate import Workload, simulate
from .solver_bb import Solution
from .solver_z3 import _EPS, _Encoding, _incumbent


@dataclass
class ImprovementEvent:
    solver_time_s: float
    objective: float
    assignments: list[tuple[str, ...]]


@dataclass
class DHaXCoNN:
    """Anytime scheduler for one workload CFG."""

    platform: Platform
    graphs: Sequence[DNNGraph]
    model: ContentionModel | Mapping[str, ContentionModel]
    objective: str = "latency"
    max_transitions: int | None = 3
    iterations: Sequence[int] | None = None
    depends_on: Sequence[int | None] | None = None

    best: Solution = field(init=False)
    converged: bool = field(init=False, default=False)
    solver_time_s: float = field(init=False, default=0.0)
    history: list[ImprovementEvent] = field(init=False)
    evaluated: int = field(init=False, default=0)

    def __post_init__(self):
        self._its = list(self.iterations or [1] * len(self.graphs))
        self._deps = list(self.depends_on or [None] * len(self.graphs))
        self.best = _incumbent(self.platform, self.graphs, self.model,
                               self.objective, self._its, self._deps)
        self.history = [ImprovementEvent(0.0, self.best.objective,
                                         self.best.assignments)]
        if HAVE_Z3:
            self._enc = _Encoding(self.platform, self.graphs, self._its,
                                  self.max_transitions, self._deps)
        else:  # degrade to a one-shot exhaustive fallback on first step
            self._enc = None

    # ------------------------------------------------------------------
    def step(self, budget_s: float) -> Solution:
        """Run the solver for at most ``budget_s`` seconds; return best."""
        if self.converged:
            return self.best
        t_end = time.perf_counter() + budget_s
        if self._enc is None:
            from . import solver_bb
            self.best = solver_bb.solve(
                self.platform, self.graphs, self.model, self.objective,
                self.max_transitions or 3, self._its, self._deps)
            self.converged = True
            return self.best
        enc = self._enc
        while True:
            now = time.perf_counter()
            if now >= t_end:
                break
            enc.s.push()
            enc.s.add(enc.bound_constraint(self.objective,
                                           self.best.objective))
            enc.s.set("timeout", max(1, int((t_end - now) * 1000)))
            r = enc.s.check()
            m = enc.s.model() if r == z3.sat else None
            enc.s.pop()
            self.solver_time_s += time.perf_counter() - now
            if r == z3.unsat:
                self.converged = True
                self.best.optimal = True
                break
            if r != z3.sat:
                break  # slice exhausted mid-search
            asgs = enc.extract(m)
            enc.block(asgs)
            wls = [Workload(g, a, iterations=it, depends_on=dep)
                   for g, a, it, dep in
                   zip(self.graphs, asgs, self._its, self._deps)]
            res = simulate(self.platform, wls, self.model,
                           record_timeline=False)
            self.evaluated += 1
            obj = res.objective(self.objective)
            if obj < self.best.objective - _EPS:
                self.best = Solution(wls, res, obj, self.objective,
                                     self.evaluated, False)
                self.history.append(ImprovementEvent(
                    self.solver_time_s, obj, self.best.assignments))
        return self.best

    # ------------------------------------------------------------------
    def current_workloads(self) -> list[Workload]:
        return self.best.workloads


# ---------------------------------------------------------------------------
# §4.4 runtime trigger: when *measured* step latency deviates from the
# schedule's *predicted* latency, the live schedule is stale (workload mix
# changed, thermal throttling, a co-runner the model did not know about) and
# the anytime solver should be given another slice.
# ---------------------------------------------------------------------------

@dataclass
class SlowdownMonitor:
    """Deviation detector over an observed/predicted latency stream.

    ``observe`` folds each measurement into an EWMA of the slowdown ratio
    ``observed / predicted``; once the smoothed ratio stays above
    ``threshold`` for ``patience`` consecutive observations the monitor
    fires (returns True) and then holds off for ``cooldown`` observations so
    one sustained deviation triggers one re-schedule, not a storm.  Ratios
    *below* 1 (running faster than predicted) never fire.
    """

    threshold: float = 1.5
    patience: int = 3
    cooldown: int = 16
    #: observations folded into the EWMA before firing is allowed — absorbs
    #: warmup noise (JIT compilation, cache population) after (re)start.
    warmup: int = 4
    alpha: float = 0.5            # EWMA weight of the newest observation

    ratio: float = field(init=False, default=1.0)
    strikes: int = field(init=False, default=0)
    fired: int = field(init=False, default=0)
    _holdoff: int = field(init=False, default=0)

    def __post_init__(self):
        self._holdoff = self.warmup

    def observe(self, observed_ms: float, predicted_ms: float) -> bool:
        # a single NaN/inf sample (torn timer read, dead counter) must not
        # poison the EWMA: NaN folded into ``ratio`` makes every later
        # ``ratio > threshold`` comparison False and the monitor goes
        # silently dead for the rest of the run.
        if (not math.isfinite(observed_ms)
                or not math.isfinite(predicted_ms)
                or predicted_ms <= 0.0 or observed_ms < 0.0):
            return False
        r = observed_ms / predicted_ms
        self.ratio = self.alpha * r + (1.0 - self.alpha) * self.ratio
        if self._holdoff > 0:
            self._holdoff -= 1
            return False
        if self.ratio > self.threshold:
            self.strikes += 1
        else:
            self.strikes = 0
        if self.strikes >= self.patience:
            self.strikes = 0
            self.fired += 1
            self._holdoff = self.cooldown
            return True
        return False

    def reset(self) -> None:
        """Forget history (call after the schedule actually changed)."""
        self.ratio = 1.0
        self.strikes = 0
        self._holdoff = self.cooldown


@dataclass(frozen=True)
class ScaledContentionModel:
    """Online recalibration: scale a base model's *excess* slowdown.

    When the monitor observes the system running ``factor``× slower than the
    schedule predicted, re-solving under ``ScaledContentionModel(base,
    factor)`` makes the solver price contention at the observed severity —
    the paper's feedback from measurement into schedule generation — without
    refitting the underlying PCCS surface.
    """

    base: ContentionModel
    factor: float = 1.0

    def slowdown(self, own: float, external: float) -> float:
        return 1.0 + self.factor * (self.base.slowdown(own, external) - 1.0)


register_contention_model(
    "scaled", ScaledContentionModel,
    encode=lambda m: {"factor": m.factor, "base": encode_model(m.base)},
    decode=lambda cfg: ScaledContentionModel(
        decode_model(cfg["base"]), cfg["factor"]))


def _scaled_surface(m: ScaledContentionModel):
    """Lower by folding the excess factor into the base surface — one
    registration point serves the NumPy batch path and the jax evaluator
    alike; scaled-of-scaled towers fold multiplicatively."""
    base = lower_surface(m.base)
    if base is None:
        return None   # no array-IR form (jax evaluator refuses; NumPy
        #               falls through to _scaled_vectorized below)
    return dataclasses.replace(base, factor=base.factor * m.factor)


def _scaled_vectorized(m: ScaledContentionModel, own, ext):
    # reached only when the base has no surface form (model_slowdown
    # dispatches surface-first): delegate to the base's vectorized path so
    # §4.4 rescaling never drops a third-party fast path to the
    # elementwise fallback.
    return 1.0 + m.factor * (slowdown_array(m.base, own, ext) - 1.0)


register_surface_lowering(ScaledContentionModel, _scaled_surface)
register_vectorized_slowdown(ScaledContentionModel, _scaled_vectorized)


#: largest severity ``quantize_severity`` emits.  An observed factor this
#: large means the prediction underflowed toward 0 (or the platform is
#: unusably degraded); pricing contention any steeper no longer changes
#: which schedule wins, and an unbounded factor would overflow
#: ``round(inf * 16.0)`` and crash the reschedule path.
MAX_SEVERITY = 64.0


def quantize_severity(factor: float) -> float:
    """Snap an observed slowdown factor to 1/16 steps in [1, MAX_SEVERITY].

    Severity resolution no schedule is sensitive to, but coarse enough
    that re-solves at recurring severities are plan-cache hits.  NaN maps
    to the neutral 1.0 (no measured deviation); +inf and anything beyond
    :data:`MAX_SEVERITY` clamp to the documented ceiling instead of
    raising ``OverflowError``.
    """
    if math.isnan(factor):
        return 1.0
    if factor >= MAX_SEVERITY:
        return MAX_SEVERITY
    return max(1.0, round(factor * 16.0) / 16.0)


def reschedule_plan(scheduler, graphs: Sequence[DNNGraph],
                    observed_factor: float, *,
                    objective: str = "latency",
                    max_transitions: int | None = 3,
                    iterations: Sequence[int] | None = None,
                    depends_on: Sequence[int | None] | None = None,
                    budget_s: float = 0.5) -> Plan:
    """§4.4 runtime re-solve, routed through ``Scheduler.resolve``.

    The monitor's observed severity rescales the scheduler's base contention
    model (:class:`ScaledContentionModel`) and the bounded re-solve goes
    through the normal resolve path, so repeated re-schedules at similar
    severity are plan-cache hits and every re-solve is logged/persisted
    uniformly with offline solves.  The continuously-valued EWMA factor is
    quantized (:func:`quantize_severity`) so recurring deviations actually
    share cache entries instead of minting a new plan per float; callers
    comparing an incumbent against the result must price the incumbent at
    the same quantized severity.
    """
    observed_factor = quantize_severity(observed_factor)
    model = ScaledContentionModel(scheduler.model, observed_factor)
    request = ScheduleRequest(
        graphs=tuple(graphs),
        platform=scheduler.platform,
        model=model,
        objective=objective,
        max_transitions=max_transitions,
        iterations=tuple(iterations or ()),
        depends_on=tuple(depends_on or ()),
        deadline_s=budget_s,
    )
    return scheduler.resolve(request)

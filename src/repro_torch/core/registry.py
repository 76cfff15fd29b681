"""Entry-point-style registries for solvers, contention models and baselines.

The Scheduler/Plan API (:mod:`repro_torch.core.scheduler`, :mod:`repro_torch.core.plan`)
never hard-codes a solver module: every schedule is produced by a *named*
solver entry looked up here, every serialized plan records which entry
produced it, and contention models round-trip through named codecs so a
:class:`~repro_torch.core.plan.Plan` artifact is self-describing.  Third-party
backends register themselves at import time exactly like the built-ins
below:

    from repro_torch.core import registry

    @registry.register_solver("ilp", priority=5,
                              available=lambda: HAVE_PULP)
    def solve_ilp(platform, graphs, model, *, objective, max_transitions,
                  iterations, depends_on, deadline_s):
        ...
        return Solution(...)

``solver="auto"`` resolves to the best *available* entry by ascending
priority and degrades down the list when an entry raises ``ValueError``
(e.g. the exhaustive search space is too large): z3 -> bb -> greedy with the
built-ins.
"""
from __future__ import annotations

import re
from collections import abc as _abc
from dataclasses import dataclass
from typing import Any, Callable, Mapping

import dataclasses
import functools

from . import baselines as _baselines
from . import simulate_batch as _sb
from . import solver_bb, solver_greedy, solver_z3
from .contention import PiecewiseModel, ProportionalShareModel
from .simulate import SimResult, Workload, simulate
from .solver_bb import Solution
from ..obs import get_logger

AUTO = "auto"
#: evaluator auto-selection sentinel (same spelling as the solver knob).
EVAL_AUTO = "auto"


class SolverUnavailable(RuntimeError):
    """A solver entry exists but its backend is not importable here."""


class UnknownEntryError(KeyError):
    """Lookup of an unregistered entry name (solver/evaluator/
    contention-model/baseline).

    A ``KeyError`` whose ``str()`` is the human-readable message (plain
    ``KeyError`` reprs its argument), so CLI surfaces can show it directly;
    the message always lists the registered names.
    """

    def __str__(self) -> str:  # pragma: no cover - trivial
        return self.args[0] if self.args else ""


# ---------------------------------------------------------------------------
# solvers
# ---------------------------------------------------------------------------

#: uniform solver signature: ``fn(platform, graphs, model, *, objective,
#: max_transitions, iterations, depends_on, deadline_s) -> Solution``.
SolverFn = Callable[..., Solution]


@dataclass(frozen=True)
class SolverEntry:
    name: str
    fn: SolverFn
    #: probed at dispatch time — an entry may be registered unconditionally
    #: while its backend (z3, ...) is an optional dependency.
    available: Callable[[], bool]
    #: ascending preference order for ``solver="auto"``.
    priority: int
    description: str = ""
    #: extra keyword knobs this entry accepts beyond the uniform solver
    #: signature — the vocabulary :func:`validate_solver_knobs` checks
    #: ``Scheduler.solve(**knobs)`` pass-throughs against.
    knobs: tuple[str, ...] = ()


_SOLVERS: dict[str, SolverEntry] = {}


def register_solver(name: str, *, priority: int = 100,
                    available: Callable[[], bool] = lambda: True,
                    description: str = "",
                    knobs: tuple[str, ...] = (),
                    replace: bool = False) -> Callable[[SolverFn], SolverFn]:
    """Decorator registering a solver entry under ``name``."""

    def deco(fn: SolverFn) -> SolverFn:
        if name in _SOLVERS and not replace:
            raise ValueError(f"solver {name!r} already registered")
        _SOLVERS[name] = SolverEntry(name, fn, available, priority,
                                     description or (fn.__doc__ or ""),
                                     tuple(knobs))
        return fn

    return deco


def solver_names() -> tuple[str, ...]:
    """Registered solver names in auto-dispatch (priority) order."""
    return tuple(e.name for e in
                 sorted(_SOLVERS.values(), key=lambda e: e.priority))


def get_solver(name: str) -> SolverEntry:
    """Look up one entry; raises with the known names on a typo."""
    try:
        return _SOLVERS[name]
    except KeyError:
        raise UnknownEntryError(
            f"unknown solver {name!r}; registered solvers: "
            f"{', '.join(solver_names())} (or {AUTO!r})") from None


def validate_solver_knobs(solver: str, knobs: Mapping[str, Any]) -> None:
    """Reject unknown solver knobs up front, listing the valid names.

    Knobs are per-entry vocabulary, so they require a *named* solver:
    with ``solver="auto"`` the dispatch target (hence the legal knob set)
    is unknowable before solve time and the combination is refused.
    """
    if not knobs:
        return
    if solver == AUTO:
        raise UnknownEntryError(
            f"solver knobs {sorted(knobs)} require an explicit solver "
            f"(knob vocabularies are per-entry); pick one of: "
            f"{', '.join(n for n in solver_names() if _SOLVERS[n].knobs)}")
    entry = get_solver(solver)
    unknown = sorted(set(knobs) - set(entry.knobs))
    if unknown:
        valid = ", ".join(entry.knobs) if entry.knobs else "none"
        raise UnknownEntryError(
            f"unknown knob(s) {unknown} for solver {solver!r}; "
            f"valid knobs: {valid}")


def auto_order() -> tuple[SolverEntry, ...]:
    """Available entries in the order ``solver="auto"`` tries them."""
    return tuple(e for e in sorted(_SOLVERS.values(),
                                   key=lambda e: e.priority)
                 if e.available())


def dispatch_order(name: str) -> tuple[SolverEntry, ...]:
    """Entries to try for a requested solver name (length 1 unless auto)."""
    if name == AUTO:
        order = auto_order()
        if not order:
            raise SolverUnavailable("no solver backend is available")
        return order
    entry = get_solver(name)
    if not entry.available():
        raise SolverUnavailable(
            f"solver {name!r} is registered but its backend is not "
            f"available (available: "
            f"{', '.join(e.name for e in auto_order()) or 'none'})")
    return (entry,)


@register_solver("z3", priority=0,
                 available=lambda: solver_z3.HAVE_Z3,
                 description="CEGAR-optimal via Z3 + exact simulator (§3.4)")
def _solve_z3(platform, graphs, model, *, objective, max_transitions,
              iterations, depends_on, deadline_s,
              evaluator=EVAL_AUTO, device=None) -> Solution:
    # CEGAR refines one counterexample at a time; its simulator use is
    # inherently scalar, so the evaluator knob is accepted but unused.
    return solver_z3.solve(platform, graphs, model, objective=objective,
                           max_transitions=max_transitions,
                           iterations=iterations, depends_on=depends_on,
                           deadline_s=deadline_s)


@register_solver("bb", priority=10,
                 description="exact branch-and-bound (pure Python)")
def _solve_bb(platform, graphs, model, *, objective, max_transitions,
              iterations, depends_on, deadline_s,
              evaluator=EVAL_AUTO, device=None) -> Solution:
    # bb has no deadline (it is exact or refuses); None transitions = full
    # space, bounded by the longest chain.
    mt = (max(len(g) for g in graphs) if max_transitions is None
          else max_transitions)
    # the torch evaluator bound to the Scheduler's device (not a request field)
    return solver_bb.solve(platform, graphs, model, objective, mt,
                           iterations, depends_on,
                           evaluator=bind_device(evaluator, device))


@register_solver("greedy", priority=20,
                 description="best baseline + simulator-scored hill climb")
def _solve_greedy(platform, graphs, model, *, objective, max_transitions,
                  iterations, depends_on, deadline_s,
                  evaluator=EVAL_AUTO, device=None) -> Solution:
    # the torch evaluator bound to the Scheduler's device (not a request field)
    return solver_greedy.solve(platform, graphs, model, objective=objective,
                               max_transitions=max_transitions,
                               iterations=iterations, depends_on=depends_on,
                               evaluator=bind_device(evaluator, device))


#: the anneal entry's pass-through knob vocabulary — kept next to the
#: registration so `Scheduler.solve(**knobs)` validation and the actual
#: `solver_anneal.solve` signature stay in one reviewable place.
ANNEAL_KNOBS = ("seed", "population", "steps", "island", "exchange_every",
                "precision", "backend", "chunk", "devices", "migrate",
                "fanout", "budget_ms", "cands_per_s")


# priority 30: greedy (20) always succeeds, so "auto" never degrades this
# far — the device search is strictly opt-in via solver="anneal".
# the port's search (core.search_torch) under the reference's name and knobs
@register_solver("anneal", priority=30,
                 knobs=ANNEAL_KNOBS,
                 description="device-resident island annealing over the "
                             "lowered IR (core.search_torch; opt-in)")
def _solve_anneal(platform, graphs, model, *, objective, max_transitions,
                  iterations, depends_on, deadline_s,
                  evaluator=EVAL_AUTO, device=None, **knobs) -> Solution:
    # deadline-free like bb: the step budget, not wall-clock, bounds the
    # search.  Extra knobs (seed, population, steps, ...) pass through for
    # direct registry callers; Scheduler sends only the uniform signature.
    from . import solver_anneal
    return solver_anneal.solve(platform, graphs, model, objective=objective,
                               max_transitions=max_transitions,
                               iterations=iterations, depends_on=depends_on,
                               evaluator=evaluator, device=device, **knobs)


# ---------------------------------------------------------------------------
# evaluators: how candidate schedules are scored (batch vs scalar)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class EvaluatorEntry:
    """One named way to score candidate schedules under the Eq. 2-8 timeline.

    ``simulate`` scores a single candidate and is always the authoritative
    scalar simulator; ``simulate_batch``/``simulate_assignments`` score a
    population in one call.  The "scalar" entry implements the batch
    interface as a plain loop over the scalar simulator, so every call site
    written against the batch shape can fall back with ``evaluator="scalar"``
    and nothing else changes.
    """

    name: str
    simulate: Callable[..., SimResult]
    simulate_batch: Callable[..., "_sb.BatchTimeline"]
    simulate_assignments: Callable[..., "_sb.BatchTimeline"]
    available: Callable[[], bool]
    #: ascending preference order for ``evaluator="auto"``.
    priority: int
    description: str = ""


_EVALUATORS: dict[str, EvaluatorEntry] = {}


def register_evaluator(name: str, *, simulate: Callable[..., SimResult],
                       simulate_batch: Callable[..., "_sb.BatchTimeline"],
                       simulate_assignments: Callable[..., "_sb.BatchTimeline"],
                       priority: int = 100,
                       available: Callable[[], bool] = lambda: True,
                       description: str = "",
                       replace: bool = False) -> None:
    if name in _EVALUATORS and not replace:
        raise ValueError(f"evaluator {name!r} already registered")
    _EVALUATORS[name] = EvaluatorEntry(
        name, simulate, simulate_batch, simulate_assignments, available,
        priority, description)


def evaluator_names() -> tuple[str, ...]:
    """Registered evaluator names in auto-dispatch (priority) order."""
    return tuple(e.name for e in
                 sorted(_EVALUATORS.values(), key=lambda e: e.priority))


def get_evaluator(name: str) -> EvaluatorEntry:
    try:
        return _EVALUATORS[name]
    except KeyError:
        raise UnknownEntryError(
            f"unknown evaluator {name!r}; registered evaluators: "
            f"{', '.join(evaluator_names())} (or {EVAL_AUTO!r})") from None


def resolve_evaluator(name: "str | EvaluatorEntry" = EVAL_AUTO
                      ) -> EvaluatorEntry:
    """Resolve an evaluator name (``"auto"`` -> best available entry)."""
    if isinstance(name, EvaluatorEntry):   # a torch entry bound to a device
        return name
    if name == EVAL_AUTO:
        for entry in sorted(_EVALUATORS.values(), key=lambda e: e.priority):
            if entry.available():
                return entry
        raise RuntimeError("no evaluator backend is available")
    entry = get_evaluator(name)
    if not entry.available():
        raise RuntimeError(
            f"evaluator {name!r} is registered but not available here")
    return entry


def _scalar_simulate_batch(platform, workloads_batch, model,
                           validate: bool = True) -> "_sb.BatchTimeline":
    # `validate` is accepted for interface parity; simulate() always
    # validates its workloads itself, so there is nothing extra to do.
    results = [simulate(platform, wls, model, record_timeline=False)
               for wls in workloads_batch]
    return _sb.batch_from_results(results, platform.names)


def _scalar_simulate_assignments(platform, graphs, assignments_batch, model,
                                 iterations=None, depends_on=None,
                                 validate: bool = True) -> "_sb.BatchTimeline":
    its = list(iterations or [1] * len(graphs))
    deps = list(depends_on or [None] * len(graphs))
    batch = [
        [Workload(g, tuple(a), iterations=i, depends_on=d)
         for g, a, i, d in zip(graphs, asgs, its, deps)]
        for asgs in assignments_batch
    ]
    return _scalar_simulate_batch(platform, batch, model, validate=validate)


def _torch_simulate_batch(*args, **kwargs):
    from . import simulate_torch
    return simulate_torch.simulate_batch(*args, **kwargs)


def _torch_simulate_assignments(*args, **kwargs):
    from . import simulate_torch
    return simulate_torch.simulate_assignments(*args, **kwargs)


def bind_device(evaluator: str, device) -> "str | EvaluatorEntry":
    """The evaluator name, or the torch entry bound to ``device``.

    The device is not part of a request; it reaches the torch evaluator's
    batch calls here, so the solvers keep their evaluator-name interface.
    """
    if device is None or evaluator != "torch":
        return evaluator
    entry = get_evaluator("torch")
    return dataclasses.replace(
        entry,
        simulate_batch=functools.partial(entry.simulate_batch, device=device),
        simulate_assignments=functools.partial(entry.simulate_assignments,
                                               device=device))


register_evaluator(
    "batch", priority=0,
    simulate=simulate,                       # single candidates stay scalar
    simulate_batch=_sb.simulate_batch,
    simulate_assignments=_sb.simulate_assignments,
    description="NumPy lockstep population evaluator (core.simulate_batch)")
register_evaluator(
    "scalar", priority=10,
    simulate=simulate,
    simulate_batch=_scalar_simulate_batch,
    simulate_assignments=_scalar_simulate_assignments,
    description="authoritative event-driven simulator, looped per candidate")
# priority > batch: "auto" keeps resolving to the NumPy path; searches opt
# into the card with evaluator="torch" (the port's name for "jax").
# Either way the scalar simulator stays authoritative for final incumbents.
register_evaluator(
    "torch", priority=50,
    simulate=simulate,                       # final incumbents stay scalar
    simulate_batch=_torch_simulate_batch,
    simulate_assignments=_torch_simulate_assignments,
    description="batched lockstep evaluator over the lowered ProblemSpec "
                "on a torch device (core.simulate_torch; float64 by "
                "default)")


# ---------------------------------------------------------------------------
# contention-model codecs (Plan serialization)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ModelCodec:
    name: str
    cls: type
    encode: Callable[[Any], dict]
    decode: Callable[[Mapping[str, Any]], Any]


_MODEL_CODECS: dict[str, ModelCodec] = {}


def register_contention_model(name: str, cls: type, *,
                              encode: Callable[[Any], dict] | None = None,
                              decode: Callable[..., Any] | None = None,
                              replace: bool = False) -> None:
    """Register a named (encode, decode) codec for a contention-model class.

    Defaults assume a flat dataclass: encode via ``vars()`` of the public
    fields, decode via ``cls(**cfg)``.
    """
    if name in _MODEL_CODECS and not replace:
        raise ValueError(f"contention model {name!r} already registered")
    enc = encode or (lambda m: {
        k: v for k, v in vars(m).items() if not k.startswith("_")})
    dec = decode or (lambda cfg: cls(**cfg))
    _MODEL_CODECS[name] = ModelCodec(name, cls, enc, dec)


def contention_model_names() -> tuple[str, ...]:
    return tuple(sorted(_MODEL_CODECS))


#: kind recorded for models without a codec: the plan still solves, hashes
#: and caches in-process, but the artifact refuses to deserialize.
OPAQUE_MODEL = "opaque"

_log = get_logger(__name__)
_OPAQUE_WARNED: set[str] = set()


def encode_model(model: Any) -> dict:
    """Serialize a contention model to ``{"kind": ..., **params}``.

    Per-domain model mappings (``{"EMC": model, ...}``, accepted everywhere
    a single model is) encode recursively.  A model class without a
    registered codec encodes as an *opaque* fingerprint — deterministic
    (dataclass ``repr``) so request hashing and in-process plan caching
    keep working, but :func:`decode_model` refuses it: register a codec to
    make such plans round-trip through JSON.
    """
    if isinstance(model, _abc.Mapping):
        return {"kind": "per-domain",
                "domains": {k: encode_model(v)
                            for k, v in sorted(model.items())}}
    for codec in _MODEL_CODECS.values():
        if type(model) is codec.cls:
            return {"kind": codec.name, **codec.encode(model)}
    fingerprint = repr(model)
    if re.search(r" at 0x[0-9a-f]+>", fingerprint):
        # default object repr embeds the instance address: equal-valued
        # models hash differently, so caching silently degrades to per-
        # instance.  Correct (no wrong hits) but worth flagging once.
        name = type(model).__name__
        if name not in _OPAQUE_WARNED:
            _OPAQUE_WARNED.add(name)
            _log.warning(
                "contention model %s has neither a registered codec nor a "
                "value-based __repr__; plan caching is per-instance only — "
                "register a codec with register_contention_model(...)", name)
    return {"kind": OPAQUE_MODEL, "type": type(model).__name__,
            "repr": fingerprint}


def decode_model(cfg: Mapping[str, Any]) -> Any:
    """Inverse of :func:`encode_model`."""
    cfg = dict(cfg)
    kind = cfg.pop("kind")
    if kind == "per-domain":
        return {k: decode_model(v) for k, v in cfg["domains"].items()}
    if kind == OPAQUE_MODEL:
        raise TypeError(
            f"this plan was solved with contention model {cfg['type']!r} "
            f"which has no registered codec; call "
            f"registry.register_contention_model(...) for it (before "
            f"solving) to make its plans deserializable")
    if kind not in _MODEL_CODECS:
        # core.dynamic (home of the "scaled" codec) is not ported yet
        raise UnknownEntryError(
            f"unknown contention model kind {kind!r} (not ported yet, or "
            f"not registered); registered "
            f"contention models: {', '.join(contention_model_names())} — "
            f"import the module that registers it before loading this "
            f"plan") from None
    return _MODEL_CODECS[kind].decode(cfg)


register_contention_model(
    "proportional", ProportionalShareModel,
    encode=lambda m: {"capacity": m.capacity, "sensitivity": m.sensitivity})
register_contention_model(
    "piecewise", PiecewiseModel,
    encode=lambda m: {"own_knots": list(m.own_knots),
                      "ext_knots": list(m.ext_knots),
                      "table": [list(r) for r in m.table]},
    decode=lambda cfg: PiecewiseModel(
        tuple(cfg["own_knots"]), tuple(cfg["ext_knots"]),
        tuple(tuple(r) for r in cfg["table"])))


# ---------------------------------------------------------------------------
# baselines
# ---------------------------------------------------------------------------

_BASELINES: dict[str, Callable] = dict(_baselines.BASELINES)


def register_baseline(name: str, fn: Callable, *,
                      replace: bool = False) -> None:
    if name in _BASELINES and not replace:
        raise ValueError(f"baseline {name!r} already registered")
    _BASELINES[name] = fn


def baseline_names() -> tuple[str, ...]:
    return tuple(_BASELINES)


def get_baseline(name: str) -> Callable:
    try:
        return _BASELINES[name]
    except KeyError:
        raise UnknownEntryError(
            f"unknown baseline {name!r}; registered baselines: "
            f"{', '.join(baseline_names())}") from None

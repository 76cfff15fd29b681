"""Lowered array-IR for scheduling problems: ``ProblemSpec`` + surfaces.

Every fast evaluator of the paper's Eq. 2-8 timeline — the NumPy lockstep
loop in :mod:`repro_torch.core.simulate_batch` and the XLA evaluator in
:mod:`repro_torch.core.simulate_torch` — consumes the same *lowered* form of a
scheduling problem instead of walking ``Platform``/``DNNGraph``/``Workload``
objects.  This module is that lowering pass:

* :class:`ProblemSpec` — a frozen, hashable bundle of pure arrays: per
  (candidate, workload, group) accelerator indices, contention-free
  durations, shared-memory demands and post-group transition delays, plus
  the per-workload iteration / dependency / arrival columns and the
  platform's contention topology (domain-share matrix, per-accelerator
  model ids).  Arrays are read-only; equal-valued specs hash and compare
  equal, so a spec can key caches (e.g. compiled XLA executables).
* :func:`lower_workloads` / :func:`lower_assignments` /
  :func:`lower_product` / :func:`lower_sweep` — the three packing shapes
  evaluators need (arbitrary per-candidate workload lists; fixed graphs x N
  assignment vectors; cross products expanded by index arithmetic) plus the
  multi-problem sweep concatenation, all producing ``ProblemSpec``.
* :class:`SlowdownSurface` — the PCCS slowdown model lowered to pure
  parameters (piecewise-linear surface knots/table or the proportional-
  share closed form, with a scale factor for §4.4's
  ``ScaledContentionModel``).  Surfaces are what lets the jax evaluator
  price contention without calling back into Python; the NumPy path
  evaluates the same parameters through :func:`surface_slowdown`.

Registries (one home, every backend consumes them):

* :func:`register_surface_lowering` — ``model class -> SlowdownSurface``.
  Built-ins (:class:`~repro_torch.core.contention.ProportionalShareModel`,
  :class:`~repro_torch.core.contention.PiecewiseModel`) register here below;
  :class:`~repro_torch.core.dynamic.ScaledContentionModel` registers its
  factor-folding lowering in its home module.
* :func:`register_vectorized_slowdown` — ``model class -> NumPy slowdown``
  for third-party models that have no surface form but still want the
  batch fast path.  :func:`slowdown_array` dispatches: explicit vectorized
  fn > lowered surface > elementwise ``model.slowdown`` fallback.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from typing import Any, Callable, Mapping, Sequence

import numpy as np

from .accelerators import Platform
from .contention import ContentionModel, PiecewiseModel, ProportionalShareModel
from .graph import DNNGraph
from .simulate import Workload, validate_assignment

#: event-resolution threshold shared by every evaluator backend (scalar,
#: NumPy batch, jax); the differential contract depends on all of them
#: resolving events at the same tolerance.
TOL = 1e-9


# ---------------------------------------------------------------------------
# slowdown surfaces: contention models lowered to pure parameters
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SlowdownSurface:
    """A contention model lowered to array-IR parameters.

    ``kind`` selects the closed form:

    * ``"proportional"`` — :class:`ProportionalShareModel`'s analytic
      formula, parameterized by ``capacity`` and ``sensitivity``.
    * ``"piecewise"`` — PCCS proper: bilinear interpolation over
      ``own_knots`` x ``ext_knots`` with values ``table`` (clamped
      extension outside the grid).

    ``factor`` scales the *excess* slowdown (``1 + factor * (s - 1)``) —
    the lowered form of §4.4's ``ScaledContentionModel``; nesting folds
    multiplicatively, so any scaled tower lowers to one surface.
    """

    kind: str
    capacity: float = 1.0
    sensitivity: float = 1.0
    own_knots: tuple[float, ...] = ()
    ext_knots: tuple[float, ...] = ()
    table: tuple[tuple[float, ...], ...] = ()
    factor: float = 1.0


#: cls -> fn(model) -> SlowdownSurface | None (None = not lowerable).
_SURFACES: dict[type, Callable[[Any], SlowdownSurface | None]] = {}


def register_surface_lowering(
        cls: type, fn: Callable[[Any], SlowdownSurface | None],
        replace: bool = False) -> None:
    """Register a lowering of ``cls`` instances to :class:`SlowdownSurface`."""
    if cls in _SURFACES and not replace:
        raise ValueError(f"surface lowering for {cls.__name__} already "
                         f"registered")
    _SURFACES[cls] = fn


def lower_surface(model: Any) -> SlowdownSurface | None:
    """Lower a contention model to its surface, or None if it has no
    registered array-IR form (such models stay usable through the NumPy
    elementwise fallback but are rejected by the jax evaluator)."""
    fn = _SURFACES.get(type(model))
    return fn(model) if fn is not None else None


register_surface_lowering(
    ProportionalShareModel,
    lambda m: SlowdownSurface("proportional", capacity=float(m.capacity),
                              sensitivity=float(m.sensitivity)))
register_surface_lowering(
    PiecewiseModel,
    lambda m: SlowdownSurface(
        "piecewise",
        own_knots=tuple(float(x) for x in m.own_knots),
        ext_knots=tuple(float(x) for x in m.ext_knots),
        table=tuple(tuple(float(v) for v in row) for row in m.table)))


def _locate_batch(knots: np.ndarray, x: np.ndarray):
    """Vectorized PiecewiseModel._locate: (lo, hi, w) per element."""
    n = len(knots)
    hi = np.searchsorted(knots, x, side="right")
    lo = np.clip(hi - 1, 0, n - 1)
    hi = np.clip(hi, 0, n - 1)
    below = x <= knots[0]
    above = x >= knots[-1]
    lo = np.where(below, 0, np.where(above, n - 1, lo))
    hi = np.where(below, 0, np.where(above, n - 1, hi))
    denom = knots[hi] - knots[lo]
    with np.errstate(invalid="ignore", divide="ignore"):
        w = np.where(denom > 0, (x - knots[lo]) / np.where(denom > 0, denom, 1.0),
                     0.0)
    w = np.where(below | above, 0.0, w)
    return lo, hi, w


def surface_slowdown(surface: SlowdownSurface, own: np.ndarray,
                     ext: np.ndarray) -> np.ndarray:
    """NumPy evaluation of a lowered surface over equal-shaped demand arrays.

    Matches the scalar models bit-for-bit (same operations in the same
    order); :mod:`repro_torch.core.simulate_torch` evaluates the same parameters
    through :mod:`repro_torch.kernels.slowdown`.
    """
    if surface.kind == "proportional":
        own_ = np.maximum(0.0, own)
        ext_ = np.maximum(0.0, ext)
        total = own_ + ext_
        boundedness = np.minimum(1.0, own_ / surface.capacity)
        dilation = total / surface.capacity
        s = 1.0 + surface.sensitivity * boundedness * (dilation - 1.0)
        s = np.where((own_ == 0.0) | (total <= surface.capacity), 1.0, s)
    elif surface.kind == "piecewise":
        ok = np.asarray(surface.own_knots, dtype=float)
        ek = np.asarray(surface.ext_knots, dtype=float)
        table = np.asarray(surface.table, dtype=float)
        i0, i1, wi = _locate_batch(ok, own)
        j0, j1, wj = _locate_batch(ek, ext)
        v0 = table[i0, j0] * (1 - wj) + table[i0, j1] * wj
        v1 = table[i1, j0] * (1 - wj) + table[i1, j1] * wj
        s = v0 * (1 - wi) + v1 * wi
        s = np.where((own <= 0.0) | (ext <= 0.0), 1.0, s)
    else:
        raise ValueError(f"unknown surface kind {surface.kind!r}")
    if surface.factor != 1.0:
        s = 1.0 + surface.factor * (s - 1.0)
    return s


# ---------------------------------------------------------------------------
# vectorized slowdown dispatch (NumPy batch path)
# ---------------------------------------------------------------------------

#: cls -> fn(model, own: ndarray, ext: ndarray) -> ndarray.  Third-party
#: contention models without a surface form register here to stay on the
#: fast path; anything unregistered falls back to an elementwise call of
#: ``model.slowdown``.
_VECTORIZED: dict[type, Callable[[Any, np.ndarray, np.ndarray], np.ndarray]] = {}


def register_vectorized_slowdown(
        cls: type,
        fn: Callable[[Any, np.ndarray, np.ndarray], np.ndarray],
        replace: bool = False) -> None:
    """Register a NumPy implementation of ``cls.slowdown`` for the batch path."""
    if cls in _VECTORIZED and not replace:
        raise ValueError(f"vectorized slowdown for {cls.__name__} already "
                         f"registered")
    _VECTORIZED[cls] = fn


def model_slowdown(model: Any, surface: SlowdownSurface | None,
                   own: np.ndarray, ext: np.ndarray) -> np.ndarray:
    """:func:`slowdown_array` with a pre-lowered surface.

    Dispatch order: the lowered surface when one exists (it *is* the
    model's array-IR semantics, and hot loops holding a
    :class:`ProblemSpec` pass ``spec.surfaces[mid]`` so no re-lowering
    happens per contention interval), then an explicitly registered
    vectorized implementation, then an elementwise fallback — slower, but
    any object with a scalar ``slowdown`` stays usable (and *correct*)
    from every batch call site.
    """
    if surface is not None:
        return surface_slowdown(surface, np.asarray(own, dtype=float),
                                np.asarray(ext, dtype=float))
    fn = _VECTORIZED.get(type(model))
    if fn is not None:
        return fn(model, own, ext)
    flat_own = np.asarray(own, dtype=float).ravel()
    flat_ext = np.asarray(ext, dtype=float).ravel()
    out = np.fromiter((model.slowdown(float(o), float(e))
                       for o, e in zip(flat_own, flat_ext)),
                      dtype=float, count=flat_own.size)
    return out.reshape(np.shape(own))


def slowdown_array(model: Any, own: np.ndarray, ext: np.ndarray) -> np.ndarray:
    """Vectorized ``model.slowdown`` over equal-shaped demand arrays
    (lowers the model's surface on the fly; see :func:`model_slowdown`)."""
    return model_slowdown(model, lower_surface(model), own, ext)


# ---------------------------------------------------------------------------
# ProblemSpec: the frozen array-IR of a candidate population
# ---------------------------------------------------------------------------

_ARRAY_FIELDS = ("acc", "dur", "dem", "tau", "ngroups", "iters", "dep",
                 "arrival", "domshare", "model_of_acc")


@dataclass(frozen=True, eq=False)
class ProblemSpec:
    """Dense array form of ``n`` candidate schedules over ``w`` workloads.

    Group-axis arrays are zero-padded to ``gmax`` (the longest graph);
    ``ngroups`` bounds the live prefix per (candidate, workload).  All
    arrays are read-only; :meth:`content_hash` (and ``__hash__``/``__eq__``)
    are value-based, so equal problems lowered independently compare equal
    and can share cache entries.
    """

    #: candidates, workloads per candidate, max groups, accelerators.
    n: int
    w: int
    gmax: int
    amax: int
    #: accelerator names indexing the accelerator axis everywhere below.
    acc_names: tuple[str, ...]
    #: (n, w, gmax) accelerator index of each layer group.
    acc: np.ndarray
    #: (n, w, gmax) contention-free duration / shared-memory demand /
    #: post-group transition delay.
    dur: np.ndarray
    dem: np.ndarray
    tau: np.ndarray
    #: (n, w) live group count / iteration count / producer index (-1 =
    #: independent) / release offset.
    ngroups: np.ndarray
    iters: np.ndarray
    dep: np.ndarray
    arrival: np.ndarray
    #: (amax, amax) number of contention domains shared by each accelerator
    #: pair (diagonal zero): external demand seen from ``a`` is
    #: ``sum_b demand_b * domshare[a, b]``.
    domshare: np.ndarray
    #: (amax,) index into ``models``/``surfaces`` (-1 = never modeled).
    model_of_acc: np.ndarray
    #: deduplicated contention-model objects (NumPy path) and their lowered
    #: surfaces (jax path; ``None`` where a model has no array-IR form).
    models: tuple[Any, ...]
    surfaces: tuple[SlowdownSurface | None, ...]

    def __post_init__(self):
        for name in _ARRAY_FIELDS:
            given = getattr(self, name)
            arr = np.ascontiguousarray(given)
            if arr.flags.writeable:
                if arr is given:
                    # never freeze (or alias) a caller-owned buffer in
                    # place; internal builders hand over pre-frozen arrays
                    # so the common path stays zero-copy.
                    arr = arr.copy()
                arr.setflags(write=False)
            object.__setattr__(self, name, arr)
        object.__setattr__(self, "_hash", None)

    def __len__(self) -> int:
        return self.n

    @property
    def n_candidates(self) -> int:
        return self.n

    def _model_fingerprints(self) -> tuple[str, ...]:
        # value-based identity: the lowered surface when one exists (the
        # parameters ARE the model as far as any evaluator is concerned),
        # else the registry codec, else the model repr.
        out = []
        for model, surface in zip(self.models, self.surfaces):
            if surface is not None:
                out.append(repr(surface))
                continue
            from . import registry  # deferred: registry imports this module
            out.append(json.dumps(registry.encode_model(model),
                                  sort_keys=True))
        return tuple(out)

    def content_hash(self) -> str:
        """Hex digest of the full problem content (arrays + topology +
        lowered model parameters) — stable across processes for specs built
        from surface-lowerable models."""
        h = hashlib.sha256()
        h.update(repr((self.n, self.w, self.gmax, self.amax, self.acc_names,
                       self._model_fingerprints())).encode())
        for name in _ARRAY_FIELDS:
            arr = getattr(self, name)
            h.update(name.encode())
            h.update(str(arr.dtype).encode())
            h.update(arr.tobytes())
        return h.hexdigest()

    def __hash__(self) -> int:
        cached = getattr(self, "_hash")
        if cached is None:
            cached = int.from_bytes(
                bytes.fromhex(self.content_hash()[:16]), "big")
            object.__setattr__(self, "_hash", cached)
        return cached

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, ProblemSpec):
            return NotImplemented
        if (self.n, self.w, self.gmax, self.amax, self.acc_names) != \
                (other.n, other.w, other.gmax, other.amax, other.acc_names):
            return False
        if any(not np.array_equal(getattr(self, f), getattr(other, f))
               for f in _ARRAY_FIELDS):
            return False
        return self._model_fingerprints() == other._model_fingerprints()

    def __repr__(self) -> str:
        return (f"ProblemSpec(n={self.n}, w={self.w}, gmax={self.gmax}, "
                f"accs={self.acc_names}, models={len(self.models)})")


# ---------------------------------------------------------------------------
# platform topology lowering (shared by every packing shape)
# ---------------------------------------------------------------------------

def _platform_tables(platform: Platform,
                     model: ContentionModel | Mapping[str, ContentionModel]):
    """(domshare, model_of_acc, models, surfaces) for one platform+model."""
    acc_names = tuple(platform.names)
    acc_idx = {a: j for j, a in enumerate(acc_names)}
    amax = len(acc_names)

    ds = np.zeros((amax, amax))
    for members in platform.domains.values():
        idxs = [acc_idx[m] for m in members]
        for i in idxs:
            for j in idxs:
                if i != j:
                    ds[i, j] += 1.0

    # per-accelerator contention model (the scalar simulator uses the model
    # of the accelerator's *first* domain).
    if hasattr(model, "slowdown"):
        models_map: dict[str, Any] = {d: model for d in platform.domains}
        if not models_map:
            models_map = {"_": model}
    else:
        models_map = dict(model)  # type: ignore[arg-type]
    first_domain: dict[str, str] = {}
    for dom, members in platform.domains.items():
        for m in members:
            first_domain.setdefault(m, dom)
    models: list[Any] = []
    model_of_acc = np.full(amax, -1, dtype=np.int64)
    seen: dict[int, int] = {}
    for j, a in enumerate(acc_names):
        dom = first_domain.get(a)
        if dom is None:
            continue  # never contends: slowdown is never evaluated
        mod = models_map.get(dom)
        if mod is None:
            # scalar simulate would KeyError on first contention; defer
            # identically by leaving the slot unmodeled.
            continue
        key = id(mod)
        if key not in seen:
            seen[key] = len(models)
            models.append(mod)
        model_of_acc[j] = seen[key]
    surfaces = tuple(lower_surface(m) for m in models)
    return acc_names, ds, model_of_acc, tuple(models), surfaces


class _SpecBuilder:
    """Mutable staging area for one :class:`ProblemSpec`."""

    def __init__(self, platform: Platform, n: int, w: int, gmax: int,
                 model: ContentionModel | Mapping[str, ContentionModel]):
        (self.acc_names, self.domshare, self.model_of_acc, self.models,
         self.surfaces) = _platform_tables(platform, model)
        self.n, self.w, self.gmax = n, w, gmax
        self.amax = len(self.acc_names)
        self.acc = np.zeros((n, w, gmax), dtype=np.int64)
        self.dur = np.zeros((n, w, gmax))
        self.dem = np.zeros((n, w, gmax))
        self.tau = np.zeros((n, w, gmax))
        self.ngroups = np.zeros((n, w), dtype=np.int64)
        self.iters = np.ones((n, w), dtype=np.int64)
        self.dep = np.full((n, w), -1, dtype=np.int64)
        self.arrival = np.zeros((n, w))

    def set_static_columns(self, iterations: Sequence[int],
                           depends_on: Sequence[int | None]) -> None:
        self.iters[:] = np.asarray(list(iterations), dtype=np.int64)[None, :]
        self.dep[:] = np.asarray([-1 if d is None else d for d in depends_on],
                                 dtype=np.int64)[None, :]

    def freeze(self) -> ProblemSpec:
        # the builder owns these arrays: pre-freeze for a zero-copy handoff
        # (ProblemSpec copies any still-writable array it is given).
        for name in ("acc", "dur", "dem", "tau", "ngroups", "iters",
                     "dep", "arrival", "domshare", "model_of_acc"):
            np.ascontiguousarray(getattr(self, name)).setflags(write=False)
        return ProblemSpec(
            n=self.n, w=self.w, gmax=self.gmax, amax=self.amax,
            acc_names=self.acc_names, acc=self.acc, dur=self.dur,
            dem=self.dem, tau=self.tau, ngroups=self.ngroups,
            iters=self.iters, dep=self.dep, arrival=self.arrival,
            domshare=self.domshare, model_of_acc=self.model_of_acc,
            models=self.models, surfaces=self.surfaces)


# ---------------------------------------------------------------------------
# the three packing shapes + sweep concatenation
# ---------------------------------------------------------------------------

def lower_workloads(platform: Platform,
                    workloads_batch: Sequence[Sequence[Workload]],
                    model: ContentionModel | Mapping[str, ContentionModel],
                    validate: bool = True) -> ProblemSpec:
    """Generic lowering: per-candidate Workload lists (graphs may differ)."""
    acc_idx = {a: j for j, a in enumerate(platform.names)}
    n = len(workloads_batch)
    if n == 0:
        raise ValueError("cannot lower an empty candidate population")
    w = len(workloads_batch[0])
    for c, wls in enumerate(workloads_batch):
        if len(wls) != w:
            raise ValueError(
                f"candidate {c} has {len(wls)} workloads, expected {w} "
                f"(all candidates of a batch share the workload count)")
    gmax = max(len(wl.graph) for wls in workloads_batch for wl in wls)
    b = _SpecBuilder(platform, n, w, gmax, model)
    for c, wls in enumerate(workloads_batch):
        for m, wl in enumerate(wls):
            if validate:
                validate_assignment(platform, wl)
            g = wl.graph
            ng = len(g)
            b.ngroups[c, m] = ng
            b.iters[c, m] = wl.iterations
            b.dep[c, m] = -1 if wl.depends_on is None else wl.depends_on
            b.arrival[c, m] = wl.arrival_ms
            asg = wl.assignment
            for i in range(ng):
                a = asg[i]
                b.acc[c, m, i] = acc_idx[a]
                b.dur[c, m, i] = g[i].time_on(a)
                b.dem[c, m, i] = g[i].demand_on(a)
                if i + 1 < ng:
                    b.tau[c, m, i] = platform.transition_cost_ms(
                        g[i].out_bytes, a, asg[i + 1])
    return b.freeze()


def graph_tables(platform: Platform, g: DNNGraph):
    """Per-graph (group, accelerator) lookup tables.

    Returns ``(time_t, dem_t, legal, move, tau_pair)``:

    * ``time_t`` (ng, A) — group duration per accelerator, NaN = illegal;
    * ``dem_t``  (ng, A) — memory demand per accelerator;
    * ``legal``  (ng,)   — ``can_transition_after`` per group;
    * ``move``   (ng,)   — output-tensor move time through the shared
      interconnect when the *next* group runs elsewhere;
    * ``tau_pair`` (A, A) — per-pair fixed transition in+out cost.

    Shared by the assignment lowering gathers below and by the
    device-resident search tables (:mod:`repro_torch.core.search_torch`), which
    mutate assignment indices directly against these tables.
    """
    names = list(platform.names)
    a_cnt = len(names)
    ng = len(g)
    time_t = np.full((ng, a_cnt), np.nan)
    dem_t = np.zeros((ng, a_cnt))
    legal = np.zeros(ng, dtype=bool)
    out_b = np.zeros(ng)
    for i, grp in enumerate(g):
        legal[i] = grp.can_transition_after
        out_b[i] = grp.out_bytes
        for a, tv in grp.times.items():
            if a in names:
                time_t[i, names.index(a)] = float(tv)
        for a, dv in grp.mem_demand.items():
            if a in names:
                dem_t[i, names.index(a)] = float(dv)
    tau_pair = np.zeros((a_cnt, a_cnt))
    for si, src in enumerate(names):
        for di, dst in enumerate(names):
            if si != di:
                tau_pair[si, di] = (platform.acc(src).transition_out_ms
                                    + platform.acc(dst).transition_in_ms)
    move = (out_b / platform.transition_bw / 1e-3
            if platform.transition_bw else np.zeros(ng))
    return time_t, dem_t, legal, move, tau_pair


def _graph_arrays(platform: Platform, g: DNNGraph,
                  arr: np.ndarray, validate: bool):
    """Vectorized per-graph fill: assignment string array (K, len(g)) ->
    (acc idx, duration, demand, post-group transition delay) arrays."""
    names = list(platform.names)
    a_cnt = len(names)
    ng = len(g)
    if arr.shape[1:] != (ng,):
        raise ValueError(
            f"graph {g.name!r}: assignment shape {arr.shape} != (*, {ng})")
    time_t, dem_t, legal, move, tau_pair = graph_tables(platform, g)

    sorted_names = sorted(names)
    to_idx = np.argsort(np.array(names))            # sorted pos -> acc index
    pos = np.clip(np.searchsorted(sorted_names, arr), 0, a_cnt - 1)
    idx = to_idx[pos]
    if validate and not (np.asarray(names)[idx] == arr).all():
        bad = arr[np.asarray(names)[idx] != arr].ravel()[0]
        raise ValueError(f"{g.name}: unknown accelerator {bad!r}")
    gi = np.arange(ng)
    dur = time_t[gi[None, :], idx]
    if validate and np.isnan(dur).any():
        ci, gix = np.nonzero(np.isnan(dur))
        raise ValueError(
            f"{g.name}[{gix[0]}] cannot run on {arr[ci[0], gix[0]]!r}")
    dem = dem_t[gi[None, :], idx]
    tau = np.zeros_like(dur)
    if ng > 1:
        moved = idx[:, :-1] != idx[:, 1:]
        if validate and (moved & ~legal[None, :-1]).any():
            ci, gix = np.nonzero(moved & ~legal[None, :-1])
            raise ValueError(
                f"{g.name}: illegal transition after group {gix[0]} "
                f"({g[gix[0]].name})")
        tau[:, :-1] = np.where(
            moved, move[None, :-1] + tau_pair[idx[:, :-1], idx[:, 1:]], 0.0)
    return idx, np.nan_to_num(dur), dem, tau


def lower_assignments(platform: Platform, graphs: Sequence[DNNGraph],
                      assignments_batch: Sequence[Sequence[Sequence[str]]],
                      model: ContentionModel | Mapping[str, ContentionModel],
                      iterations: Sequence[int] | None = None,
                      depends_on: Sequence[int | None] | None = None,
                      validate: bool = True) -> ProblemSpec:
    """Solver hot-path lowering: fixed graphs, N assignment vectors.

    Per-graph (group, accelerator) lookup tables are built once and every
    candidate is filled by vectorized gathers — no per-candidate Python
    loop, which is what keeps huge sweeps pack-bound on NumPy rather than
    the interpreter.
    """
    n = len(assignments_batch)
    if n == 0:
        raise ValueError("cannot lower an empty candidate population")
    w = len(graphs)
    gmax = max(len(g) for g in graphs)
    b = _SpecBuilder(platform, n, w, gmax, model)
    b.set_static_columns(list(iterations or [1] * w),
                         list(depends_on or [None] * w))
    for m, g in enumerate(graphs):
        ng = len(g)
        b.ngroups[:, m] = ng
        arr = np.asarray([asgs[m] for asgs in assignments_batch])
        idx, dur, dem, tau = _graph_arrays(platform, g, arr, validate)
        b.acc[:, m, :ng] = idx
        b.dur[:, m, :ng] = dur
        b.dem[:, m, :ng] = dem
        b.tau[:, m, :ng] = tau
    return b.freeze()


def lower_product(platform: Platform, graphs: Sequence[DNNGraph],
                  cand_lists: Sequence[Sequence[Sequence[str]]],
                  model: ContentionModel | Mapping[str, ContentionModel],
                  iterations: Sequence[int] | None = None,
                  depends_on: Sequence[int | None] | None = None,
                  validate: bool = True) -> ProblemSpec:
    """Lower the full cross product of per-graph candidate lists without
    materializing the combinations: each graph's unique assignments are
    packed once, then broadcast into the product in ``itertools.product``
    order by pure index arithmetic."""
    w = len(graphs)
    ks = [len(c) for c in cand_lists]
    n = 1
    for k in ks:
        n *= k
    if n == 0:
        raise ValueError("cannot lower an empty candidate population")
    gmax = max(len(g) for g in graphs)
    b = _SpecBuilder(platform, n, w, gmax, model)
    b.set_static_columns(list(iterations or [1] * w),
                         list(depends_on or [None] * w))
    after = n
    for m, g in enumerate(graphs):
        ng = len(g)
        b.ngroups[:, m] = ng
        arr = np.asarray(list(cand_lists[m]))
        idx, dur, dem, tau = _graph_arrays(platform, g, arr, validate)
        # itertools.product order: graph m's index repeats `after` times
        # within one period and the whole period tiles `before` times.
        after //= ks[m]
        sel = np.tile(np.repeat(np.arange(ks[m]), after), n // (ks[m] * after))
        b.acc[:, m, :ng] = idx[sel]
        b.dur[:, m, :ng] = dur[sel]
        b.dem[:, m, :ng] = dem[sel]
        b.tau[:, m, :ng] = tau[sel]
    return b.freeze()


def concat_specs(specs: Sequence[ProblemSpec]) -> ProblemSpec:
    """Concatenate specs along the candidate axis (shared platform/model;
    same workload count; group axis padded to the max)."""
    first = specs[0]
    w = first.w
    if len({s.w for s in specs}) != 1:
        raise ValueError("all specs in a sweep must share the workload count")
    if any(s.acc_names != first.acc_names for s in specs):
        raise ValueError("all specs in a sweep must share the platform")
    # the concatenated spec adopts the first spec's contention topology and
    # models — reject silently-different ones instead of mis-scoring.
    ref_fp = first._model_fingerprints()
    for s in specs[1:]:
        if (not np.array_equal(s.domshare, first.domshare)
                or not np.array_equal(s.model_of_acc, first.model_of_acc)):
            raise ValueError("all specs in a sweep must share the "
                             "contention-domain topology")
        if s._model_fingerprints() != ref_fp:
            raise ValueError("all specs in a sweep must share the "
                             "contention model(s)")
    gmax = max(s.gmax for s in specs)
    n = sum(s.n for s in specs)

    def cat(name: str, pad_axis2: bool) -> np.ndarray:
        parts = []
        for s in specs:
            a = getattr(s, name)
            if pad_axis2 and s.gmax < gmax:
                pad = np.zeros((s.n, w, gmax - s.gmax), dtype=a.dtype)
                a = np.concatenate([a, pad], axis=2)
            parts.append(a)
        out = np.concatenate(parts, axis=0)
        out.setflags(write=False)    # freshly owned: zero-copy handoff
        return out

    return ProblemSpec(
        n=n, w=w, gmax=gmax, amax=first.amax, acc_names=first.acc_names,
        acc=cat("acc", True), dur=cat("dur", True), dem=cat("dem", True),
        tau=cat("tau", True), ngroups=cat("ngroups", False),
        iters=cat("iters", False), dep=cat("dep", False),
        arrival=cat("arrival", False), domshare=first.domshare,
        model_of_acc=first.model_of_acc, models=first.models,
        surfaces=first.surfaces)


def lower_sweep(
    platform: Platform,
    problems: Sequence[tuple],
    model: ContentionModel | Mapping[str, ContentionModel],
    validate: bool = True,
) -> tuple[ProblemSpec | None, list[slice]]:
    """Lower many problems' cross-product populations into ONE spec.

    ``problems[k] = (graphs, cand_lists, iterations, depends_on)``; returns
    the concatenated spec (None for an empty problem list) plus one
    ``slice`` per problem addressing its candidates inside it.
    """
    specs, slices, lo = [], [], 0
    for graphs, cand_lists, iterations, depends_on in problems:
        s = lower_product(platform, graphs, cand_lists, model,
                          iterations=iterations, depends_on=depends_on,
                          validate=validate)
        specs.append(s)
        slices.append(slice(lo, lo + s.n))
        lo += s.n
    if not specs:
        return None, []
    return concat_specs(specs), slices

"""Serializable schedule artifacts: ScheduleRequest -> Plan -> PlanCache.

HaX-CoNN's product is the *schedule*; this module makes it a first-class,
persistable object instead of an ephemeral in-process
:class:`~repro_torch.core.solver_bb.Solution`:

* :class:`ScheduleRequest` — one validated description of a scheduling
  problem (graphs, platform, contention model, objective, transition
  budget, iterations, dependencies, solver choice, deadline).  Its
  canonical JSON form is content-hashed, so two requests describing the
  same problem share one hash regardless of where they were built.
* :class:`Plan` — a solved schedule plus provenance (request hash, solver
  entry that produced it, solve wall-time, platform fingerprint, creation
  time).  ``to_json``/``from_json`` round-trip the *entire* problem and
  solution, so a plan solved offline can be diffed, cached and loaded by
  the serving gateway with zero solver invocations.
* :class:`PlanCache` — content-addressed (by request hash) in-memory +
  optional on-disk store; ``artifacts/plans/`` is the conventional root.

Plans are versioned (``FORMAT``): loading verifies the stored request hash
against a recomputation from the deserialized request, so a hand-edited or
format-drifted artifact fails loudly instead of silently driving a stale
schedule.
"""
from __future__ import annotations

import hashlib
import json
import pathlib
import time
from dataclasses import dataclass, field
from typing import Any, Mapping

from . import registry
from .accelerators import Accelerator, Platform
from .contention import ContentionModel
from .graph import DNNGraph, LayerGroup
from .simulate import Interval, SimResult, Workload
from .solver_bb import Solution
from ..obs import get_logger, get_registry, get_tracer

log = get_logger(__name__)

FORMAT = 1
OBJECTIVES = ("latency", "throughput", "sum_inverse")


# ---------------------------------------------------------------------------
# canonical (de)serialization of the problem ingredients
# ---------------------------------------------------------------------------

def graph_to_dict(g: DNNGraph) -> dict:
    return {
        "name": g.name,
        "groups": [{
            "name": grp.name,
            "times": {a: float(t) for a, t in sorted(grp.times.items())},
            "mem_demand": {a: float(d)
                           for a, d in sorted(grp.mem_demand.items())},
            "out_bytes": float(grp.out_bytes),
            "can_transition_after": bool(grp.can_transition_after),
            "flops": float(grp.flops),
            "hbm_bytes": float(grp.hbm_bytes),
        } for grp in g.groups],
    }


def graph_from_dict(d: Mapping[str, Any]) -> DNNGraph:
    return DNNGraph(d["name"], tuple(
        LayerGroup(name=grp["name"], times=dict(grp["times"]),
                   mem_demand=dict(grp["mem_demand"]),
                   out_bytes=grp["out_bytes"],
                   can_transition_after=grp["can_transition_after"],
                   flops=grp["flops"], hbm_bytes=grp["hbm_bytes"])
        for grp in d["groups"]))


def platform_to_dict(p: Platform) -> dict:
    return {
        "name": p.name,
        "accelerators": [{
            "name": a.name, "peak_flops": a.peak_flops, "mem_bw": a.mem_bw,
            "transition_in_ms": a.transition_in_ms,
            "transition_out_ms": a.transition_out_ms, "n_chips": a.n_chips,
        } for a in p.accelerators],
        "transition_bw": p.transition_bw,
        "domains": {k: list(v) for k, v in sorted(p.domains.items())},
        "domain_bw": {k: float(v) for k, v in sorted(p.domain_bw.items())},
        "epsilon_ms": p.epsilon_ms,
    }


def platform_from_dict(d: Mapping[str, Any]) -> Platform:
    return Platform(
        name=d["name"],
        accelerators=tuple(Accelerator(**a) for a in d["accelerators"]),
        transition_bw=d["transition_bw"],
        domains={k: tuple(v) for k, v in d["domains"].items()},
        domain_bw=dict(d["domain_bw"]),
        epsilon_ms=d["epsilon_ms"],
    )


def canonical_hash(obj: Any) -> str:
    """Content hash of a JSON-serializable object (order-independent)."""
    blob = json.dumps(obj, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def platform_fingerprint(p: Platform) -> str:
    return canonical_hash(platform_to_dict(p))


# ---------------------------------------------------------------------------
# ScheduleRequest
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ScheduleRequest:
    """One validated scheduling problem (replaces 8 loose kwargs).

    ``iterations``/``depends_on`` are normalized to per-graph tuples at
    construction, so equal problems hash equally however they were spelled.
    """

    graphs: tuple[DNNGraph, ...]
    platform: Platform
    model: ContentionModel
    objective: str = "latency"
    solver: str = registry.AUTO
    max_transitions: int | None = 3
    iterations: tuple[int, ...] = ()
    depends_on: tuple[int | None, ...] = ()
    deadline_s: float | None = None
    #: extra solver-entry knobs (e.g. anneal's population/devices/
    #: budget_ms), normalized to a sorted tuple of (name, value) pairs so
    #: equal requests hash equally however the mapping was spelled.
    solver_knobs: tuple[tuple[str, Any], ...] = ()

    def __post_init__(self):
        if not self.graphs:
            raise ValueError("request has no DNN graphs")
        object.__setattr__(self, "graphs", tuple(self.graphs))
        n = len(self.graphs)
        if self.objective not in OBJECTIVES:
            raise ValueError(
                f"unknown objective {self.objective!r}; "
                f"one of {', '.join(OBJECTIVES)}")
        if self.solver != registry.AUTO:
            registry.get_solver(self.solver)   # raises with known names
        knobs = self.solver_knobs
        if isinstance(knobs, Mapping):
            knobs = tuple(knobs.items())
        knobs = tuple(sorted((str(k), v) for k, v in knobs))
        for k, v in knobs:
            if v is not None and not isinstance(v, (bool, int, float, str)):
                raise ValueError(
                    f"solver knob {k!r} has non-scalar value {v!r}; "
                    f"knobs must be JSON scalars")
        registry.validate_solver_knobs(self.solver, dict(knobs))
        object.__setattr__(self, "solver_knobs", knobs)
        its = tuple(self.iterations) or (1,) * n
        if len(its) != n:
            raise ValueError(
                f"iterations has {len(its)} entries for {n} graphs")
        if any(int(i) != i or i < 1 for i in its):
            raise ValueError("iterations must be positive integers")
        object.__setattr__(self, "iterations", tuple(int(i) for i in its))
        deps = tuple(self.depends_on) or (None,) * n
        if len(deps) != n:
            raise ValueError(
                f"depends_on has {len(deps)} entries for {n} graphs")
        for i, dep in enumerate(deps):
            if dep is not None and (dep < 0 or dep >= n or dep == i):
                raise ValueError(f"depends_on[{i}] = {dep} is invalid")
        for i in range(n):                   # fail fast on dependency cycles
            seen = {i}
            j = deps[i]
            while j is not None:
                if j in seen:
                    raise ValueError(
                        f"depends_on contains a cycle through graphs "
                        f"{sorted(seen)}")
                seen.add(j)
                j = deps[j]
        object.__setattr__(self, "depends_on", deps)
        if self.max_transitions is not None and self.max_transitions < 0:
            raise ValueError("max_transitions must be >= 0 or None")
        names = set(self.platform.names)
        for g in self.graphs:
            if not names & set(g.accelerators):
                raise ValueError(
                    f"graph {g.name!r} runs on no accelerator of platform "
                    f"{self.platform.name!r}")

    def to_dict(self) -> dict:
        d = {
            "graphs": [graph_to_dict(g) for g in self.graphs],
            "platform": platform_to_dict(self.platform),
            "model": registry.encode_model(self.model),
            "objective": self.objective,
            "solver": self.solver,
            "max_transitions": self.max_transitions,
            "iterations": list(self.iterations),
            "depends_on": list(self.depends_on),
            "deadline_s": self.deadline_s,
        }
        # only serialized when set: knob-free requests keep the hash (and
        # the on-disk cache keys) of every plan minted before this field.
        if self.solver_knobs:
            d["solver_knobs"] = dict(self.solver_knobs)
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ScheduleRequest":
        return cls(
            graphs=tuple(graph_from_dict(g) for g in d["graphs"]),
            platform=platform_from_dict(d["platform"]),
            model=registry.decode_model(d["model"]),
            objective=d["objective"],
            solver=d["solver"],
            max_transitions=d["max_transitions"],
            iterations=tuple(d["iterations"]),
            depends_on=tuple(d["depends_on"]),
            deadline_s=d["deadline_s"],
            solver_knobs=tuple(sorted(d.get("solver_knobs", {}).items())),
        )

    def request_hash(self) -> str:
        cached = self.__dict__.get("_hash")
        if cached is None:
            cached = canonical_hash(self.to_dict())
            object.__setattr__(self, "_hash", cached)
        return cached


# ---------------------------------------------------------------------------
# Solution (de)serialization — graphs referenced by request index
# ---------------------------------------------------------------------------

def _solution_to_dict(sol: Solution, request: ScheduleRequest) -> dict:
    graph_idx = {id(g): i for i, g in enumerate(request.graphs)}

    def wl_graph_index(wl: Workload) -> int:
        i = graph_idx.get(id(wl.graph))
        if i is not None:
            return i
        for j, g in enumerate(request.graphs):   # re-built equal graph
            if g == wl.graph:
                return j
        raise ValueError(
            f"workload graph {wl.graph.name!r} is not part of the request")

    return {
        "workloads": [{
            "graph": wl_graph_index(wl),
            "assignment": list(wl.assignment),
            "iterations": wl.iterations,
            "depends_on": wl.depends_on,
            "arrival_ms": wl.arrival_ms,
        } for wl in sol.workloads],
        "result": {
            "makespan": sol.result.makespan,
            "finish_times": list(sol.result.finish_times),
            "iteration_latencies": [list(l)
                                    for l in sol.result.iteration_latencies],
            "timeline": [[iv.start, iv.end, iv.workload, iv.iteration,
                          iv.group, iv.acc, iv.slowdown]
                         for iv in sol.result.timeline],
            "contention_ms": sol.result.contention_ms,
            "busy_ms": dict(sol.result.busy_ms),
        },
        "objective": sol.objective,
        "kind": sol.kind,
        "evaluated": sol.evaluated,
        "optimal": sol.optimal,
        "params": dict(getattr(sol, "params", {}) or {}),
    }


def _solution_from_dict(d: Mapping[str, Any],
                        request: ScheduleRequest) -> Solution:
    wls = [Workload(request.graphs[w["graph"]], tuple(w["assignment"]),
                    iterations=w["iterations"], depends_on=w["depends_on"],
                    arrival_ms=w["arrival_ms"])
           for w in d["workloads"]]
    r = d["result"]
    res = SimResult(
        makespan=r["makespan"],
        finish_times=list(r["finish_times"]),
        iteration_latencies=[list(l) for l in r["iteration_latencies"]],
        timeline=[Interval(*iv) for iv in r["timeline"]],
        contention_ms=r["contention_ms"],
        busy_ms=dict(r["busy_ms"]),
    )
    # absent in pre-anneal artifacts: exact solvers carry no params.
    return Solution(wls, res, d["objective"], d["kind"], d["evaluated"],
                    d["optimal"], params=dict(d.get("params", {})))


# ---------------------------------------------------------------------------
# Plan
# ---------------------------------------------------------------------------

@dataclass
class Plan:
    """A solved schedule plus provenance — the deployable artifact."""

    request: ScheduleRequest
    solution: Solution
    #: registry entry that actually produced the solution ("z3"|"bb"|...).
    solver: str
    solve_time_s: float
    request_hash: str
    platform_fingerprint: str
    #: evaluator the solver searched with ("batch"|"scalar"); provenance
    #: only — the recorded result always comes from the scalar simulator,
    #: and the request hash is evaluator-independent.
    evaluator: str = "scalar"
    #: solver-specific provenance copied from ``Solution.params`` (e.g. the
    #: anneal entry's seed / steps / population); empty for exact solvers.
    #: Like ``evaluator``, never part of the request hash.
    solver_params: dict = field(default_factory=dict)
    created_at: float = field(default_factory=time.time)

    # -- convenience views ------------------------------------------------
    @property
    def assignments(self) -> list[tuple[str, ...]]:
        return self.solution.assignments

    @property
    def objective(self) -> float:
        return self.solution.objective

    @property
    def result(self) -> SimResult:
        return self.solution.result

    @property
    def optimal(self) -> bool:
        return self.solution.optimal

    def summary(self) -> str:
        res = self.solution.result
        seed = self.solver_params.get("seed")
        rows = [f"plan {self.request_hash[:12]} solver={self.solver} "
                + (f"seed={seed} " if seed is not None else "")
                + f"evaluator={self.evaluator} "
                f"objective={self.solution.kind}={self.objective:.4f} "
                f"optimal={self.optimal} solve={self.solve_time_s:.3f}s",
                f"  platform={self.request.platform.name} "
                f"lat={res.latency_ms:.3f}ms fps={res.throughput_fps:.1f}"]
        for wl in self.solution.workloads:
            rows.append(f"    {wl.graph.name}: {' '.join(wl.assignment)}")
        return "\n".join(rows)

    # -- (de)serialization ------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "format": FORMAT,
            "request": self.request.to_dict(),
            "solution": _solution_to_dict(self.solution, self.request),
            "solver": self.solver,
            "solve_time_s": self.solve_time_s,
            "request_hash": self.request_hash,
            "platform_fingerprint": self.platform_fingerprint,
            "evaluator": self.evaluator,
            "solver_params": dict(self.solver_params),
            "created_at": self.created_at,
        }

    def to_json(self, indent: int | None = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Plan":
        if d.get("format") != FORMAT:
            raise ValueError(
                f"unsupported plan format {d.get('format')!r} "
                f"(this build reads format {FORMAT})")
        request = ScheduleRequest.from_dict(d["request"])
        recomputed = request.request_hash()
        if recomputed != d["request_hash"]:
            raise ValueError(
                "plan artifact is corrupt or was produced by an "
                f"incompatible build: stored request hash "
                f"{d['request_hash'][:12]} != recomputed {recomputed[:12]}")
        return cls(
            request=request,
            solution=_solution_from_dict(d["solution"], request),
            solver=d["solver"],
            solve_time_s=d["solve_time_s"],
            request_hash=d["request_hash"],
            platform_fingerprint=d["platform_fingerprint"],
            # absent in pre-batch-evaluator artifacts: those searched scalar.
            evaluator=d.get("evaluator", "scalar"),
            # absent in pre-anneal artifacts: exact solvers have no params.
            solver_params=dict(d.get("solver_params", {})),
            created_at=d["created_at"],
        )

    @classmethod
    def from_json(cls, s: str) -> "Plan":
        return cls.from_dict(json.loads(s))

    def save(self, path: str | pathlib.Path) -> pathlib.Path:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(self.to_json())
        return path

    @classmethod
    def load(cls, path: str | pathlib.Path) -> "Plan":
        return cls.from_json(pathlib.Path(path).read_text())


# ---------------------------------------------------------------------------
# PlanCache
# ---------------------------------------------------------------------------

class PlanCache:
    """Content-addressed plan store: in-memory, optionally disk-backed.

    ``root=None`` keeps plans in memory only (the default for library use);
    with a directory every solved plan is persisted as
    ``<root>/plan-<hash16>.json`` and later processes hit it cold.
    ``max_entries`` bounds the in-memory map with LRU eviction — set it
    for long-running control planes whose request stream is unbounded.
    Corrupt, truncated or format-drifted disk entries degrade to a miss
    (logged) instead of raising, so one bad artifact never wedges a boot.
    """

    def __init__(self, root: str | pathlib.Path | None = None,
                 max_entries: int | None = None):
        self.root = pathlib.Path(root) if root is not None else None
        self.max_entries = max_entries
        self._mem: dict[str, Plan] = {}
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._mem)

    def path_for(self, request_hash: str) -> pathlib.Path | None:
        if self.root is None:
            return None
        return self.root / f"plan-{request_hash[:16]}.json"

    def get(self, request_hash: str) -> Plan | None:
        tier = "mem"
        plan = self._mem.get(request_hash)
        if plan is not None:
            # LRU: a hit refreshes recency so hot plans survive eviction.
            self._mem.pop(request_hash)
            self._mem[request_hash] = plan
        else:
            path = self.path_for(request_hash)
            if path is not None and path.exists():
                tier = "disk"
                try:
                    plan = Plan.load(path)
                except (OSError, ValueError, TypeError, KeyError,
                        json.JSONDecodeError) as exc:
                    # a corrupt / truncated / undecodable artifact (e.g.
                    # solved with a codec-less model, or a writer that died
                    # mid-save) degrades to a miss — it must not poison the
                    # cache for every later process.
                    log.warning("ignoring unreadable plan cache file %s "
                                "(%s); re-solving", path, exc)
                    tier = "corrupt"
                    plan = None
                else:
                    if plan.request_hash != request_hash:
                        log.warning(
                            "cache file %s holds plan %s, not %s; ignoring",
                            path, plan.request_hash[:12], request_hash[:12])
                        tier = "wrong_hash"
                        plan = None
                if plan is not None:
                    self._insert(plan)
                if tier in ("corrupt", "wrong_hash"):
                    # rare by construction: worth a trace instant + counter
                    # so a degrading store is visible before it hurts p99.
                    get_tracer().instant("plan_cache.degrade", "cache",
                                         reason=tier, request=request_hash[:12])
                    get_registry().counter(
                        "plan_cache_degraded",
                        "disk plan-cache entries degraded to a miss").labels(
                            reason=tier).inc()
        if plan is None:
            self.misses += 1
            get_registry().counter(
                "plan_cache_misses", "plan cache lookups that missed").inc()
            return None
        self.hits += 1
        get_registry().counter(
            "plan_cache_hits", "plan cache lookups that hit").labels(
                tier=tier).inc()
        return plan

    def add(self, plan: Plan) -> None:
        """Insert without persisting (pre-loading a shipped artifact)."""
        self._insert(plan)

    def put(self, plan: Plan) -> pathlib.Path | None:
        self._insert(plan)
        path = self.path_for(plan.request_hash)
        if path is not None:
            plan.save(path)
        return path

    def _insert(self, plan: Plan) -> None:
        # re-insert at the recent end so _mem stays LRU-ordered (oldest
        # access first — Python dicts preserve insertion order).
        self._mem.pop(plan.request_hash, None)
        self._mem[plan.request_hash] = plan
        if self.max_entries is not None:
            while len(self._mem) > self.max_entries:     # LRU eviction
                self._mem.pop(next(iter(self._mem)))

    def clear(self) -> None:
        self._mem.clear()
        self.hits = self.misses = 0


class ShardedPlanCache(PlanCache):
    """Disk-backed :class:`PlanCache` sharded by request-hash prefix.

    A fleet control plane cold-starts hundreds of schedulers against one
    shared plan store; with a flat directory every process lists and locks
    the same inode.  Sharding by the first ``shard_chars`` hex digits of
    the request hash (``<root>/<prefix>/plan-<hash16>.json``) spreads
    concurrent readers/writers over ``16**shard_chars`` independent
    directories, and a lookup never scans an index — it is exactly one
    ``open()`` of a content-addressed path, so a cold boot stays
    O(load-a-JSON) per plan.

    ``max_disk_entries`` bounds the on-disk store: after every persist the
    owning shard is trimmed oldest-mtime-first to its share of the budget
    (``ceil(max_disk_entries / n_shards)``) — eviction never touches other
    shards, preserving the no-cross-shard-contention property.
    """

    def __init__(self, root: str | pathlib.Path,
                 max_entries: int | None = None,
                 shard_chars: int = 2,
                 max_disk_entries: int | None = None):
        if not 1 <= shard_chars <= 8:
            raise ValueError("shard_chars must be in [1, 8]")
        super().__init__(root=root, max_entries=max_entries)
        self.shard_chars = shard_chars
        self.max_disk_entries = max_disk_entries

    @property
    def n_shards(self) -> int:
        return 16 ** self.shard_chars

    def path_for(self, request_hash: str) -> pathlib.Path:
        shard = request_hash[:self.shard_chars]
        return self.root / shard / f"plan-{request_hash[:16]}.json"

    def put(self, plan: Plan) -> pathlib.Path | None:
        path = super().put(plan)
        if path is not None and self.max_disk_entries is not None:
            self._trim_shard(path.parent)
        return path

    def _trim_shard(self, shard_dir: pathlib.Path) -> None:
        budget = -(-self.max_disk_entries // self.n_shards)    # ceil
        try:
            entries = sorted(shard_dir.glob("plan-*.json"),
                             key=lambda p: p.stat().st_mtime)
        except OSError:                        # shard raced away: nothing to trim
            return
        for stale in entries[:max(0, len(entries) - budget)]:
            try:
                stale.unlink()
                get_registry().counter(
                    "plan_cache_evictions",
                    "persisted plans evicted by shard trimming").inc()
                log.info("evicted plan cache file %s (shard over budget)",
                         stale)
            except OSError:                    # concurrent eviction lost the race
                pass

    def disk_entries(self) -> int:
        """Total persisted plans across every shard (diagnostics only)."""
        if not self.root.exists():
            return 0
        return sum(1 for _ in self.root.glob("*/plan-*.json"))

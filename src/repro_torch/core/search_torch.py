"""Device-resident schedule search: annealing over the lowered array IR.

The port's counterpart of ``repro/core/search_jax.py``.  A population of
chains walks the assignment space on the card: each step every chain
mutates one (workload, group) site to a random allowed accelerator
(proposals that break transition legality revert to the current state),
scores the mutant through the *lean* event machine
(:func:`repro_torch.core.simulate_torch.make_event_machine` with
``record=False``), and the population is selected by the Metropolis +
incumbent kernel (:mod:`repro_torch.kernels.search`).  Every
``exchange_every`` steps each island's best incumbent replaces its worst
current member.

The host side (:class:`SearchTables`, :func:`build_tables`, the legality
check, the scattered initial population, :func:`default_init`) is copied
verbatim from the reference, so both searches start from identical tables
and populations.  The random draws are the reference's threefry draws,
bit for bit (:mod:`repro_torch.core.prng`), so for the same ``(seed,
population, steps, island, exchange_every)`` the port explores the same
chains as ``repro``'s ``anneal_search``:

* per-chain RNG streams are ``fold_in(fold_in(key(seed),
  global_chain_index), step)``, so results do not depend on chunking;
* islands are fixed ``island``-sized slices of the global chain order and
  chunk boundaries align to them (``chunk % island == 0``);
* uniform draws are float32 in both precision modes, then cast to the
  objectives' dtype;
* the global winner is the (objective, chain index) lexicographic min.

Torch has no ``while_loop``: the steps and the event machine's waves are
host loops over tensors on the card (see :mod:`repro_torch.core.
simulate_torch`).  ``devices=None`` runs the population in island-aligned
chunks with island migration; ``devices=1`` runs it in one call with the
reference's ring migration wrapped locally; more devices are not ported.

The scalar simulator stays authoritative: this module reports the device
incumbent and its device objective; :mod:`repro_torch.core.solver_anneal`
re-simulates the winner on the host scalar path before any
:class:`~repro_torch.core.plan.Plan` is minted.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from . import prng
from .accelerators import Platform
from .contention import ContentionModel
from .graph import DNNGraph
from .lowering import _platform_tables, graph_tables
from .simulate_torch import (_tensor, dtype_of, make_event_machine,
                             surface_params)
from ..kernels.search import anneal_select
from ..obs import get_tracer
from ..runtime import resolve_device

OBJECTIVES = ("latency", "throughput", "sum_inverse")
MIGRATIONS = ("auto", "island", "ring")
FANOUTS = ("auto", "shard_map", "pmap")

#: chains per island — the migration neighborhood.  Must divide both the
#: population and the chunk so islands never straddle a device call.
DEFAULT_ISLAND = 32
#: chains per device call; population shards into island-aligned chunks.
DEFAULT_CHUNK = 8192


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length()


# ---------------------------------------------------------------------------
# SearchTables: the frozen device-side problem
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SearchTables:
    """Per-(workload, group, accelerator) lookup tables for one problem.

    ``gmax`` is padded to the next power of two so nearby graph depths
    share compiled executables; rows at ``i >= ngroups[m]`` are dead
    (``allowed`` all-False, never reached by the event machine).
    """

    acc_names: tuple[str, ...]
    w: int
    gmax: int
    amax: int
    dur_t: np.ndarray          # (w, gmax, A) ms; 0 where not allowed
    dem_t: np.ndarray          # (w, gmax, A) demand fraction
    allowed: np.ndarray        # (w, gmax, A) bool
    n_allowed: np.ndarray      # (w, gmax) int
    legal_after: np.ndarray    # (w, gmax) bool
    move_ms: np.ndarray        # (w, gmax) output move cost
    tau_pair: np.ndarray       # (A, A) fixed in+out transition cost
    ngroups: np.ndarray        # (w,) live groups per workload
    iters: np.ndarray          # (w,)
    dep: np.ndarray            # (w,) -1 = no dependency
    arrival: np.ndarray        # (w,) ms
    domshare: np.ndarray       # (A, A) contention-domain sharing
    model_of_acc: np.ndarray   # (A,) surface index, -1 = unmodeled
    models: tuple
    surfaces: tuple
    max_transitions: int

    @property
    def kinds(self) -> tuple[str, ...]:
        return tuple(s.kind for s in self.surfaces)

    def decode(self, asg: np.ndarray) -> tuple[tuple[str, ...], ...]:
        """(w, gmax) index row -> per-workload accelerator-name tuples."""
        return tuple(
            tuple(self.acc_names[int(asg[m, i])]
                  for i in range(int(self.ngroups[m])))
            for m in range(self.w))

    def encode(self, assignments: Sequence[Sequence[str]]) -> np.ndarray:
        """Per-workload accelerator names -> a (w, gmax) index row."""
        idx = {a: j for j, a in enumerate(self.acc_names)}
        out = np.zeros((self.w, self.gmax), dtype=np.int32)
        for m, asg in enumerate(assignments):
            ng = int(self.ngroups[m])
            if len(asg) != ng:
                raise ValueError(
                    f"workload {m}: assignment has {len(asg)} groups, "
                    f"graph has {ng}")
            for i, a in enumerate(asg):
                out[m, i] = idx[a]
            if ng < self.gmax:
                out[m, ng:] = out[m, ng - 1]   # dead rows: repeat last acc
        return out

    def legal(self, asg: np.ndarray) -> bool:
        """Host mirror of the device legality predicate for one row."""
        for m in range(self.w):
            ng = int(self.ngroups[m])
            trans = 0
            for i in range(ng):
                if not self.allowed[m, i, int(asg[m, i])]:
                    return False
                if i + 1 < ng and asg[m, i] != asg[m, i + 1]:
                    if not self.legal_after[m, i]:
                        return False
                    trans += 1
            if trans > self.max_transitions:
                return False
        return True


def build_tables(
    platform: Platform,
    graphs: Sequence[DNNGraph],
    model: ContentionModel | Mapping[str, ContentionModel],
    max_transitions: int,
    iterations: Sequence[int] | None = None,
    depends_on: Sequence[int | None] | None = None,
    arrival_ms: Sequence[float] | None = None,
) -> SearchTables:
    """Freeze one scheduling problem into device-search lookup tables."""
    acc_names, domshare, model_of_acc, models, surfaces = _platform_tables(
        platform, model)
    if any(s is None for s in surfaces):
        bad = sorted({type(m).__name__
                      for m, s in zip(models, surfaces) if s is None})
        raise ValueError(
            f"solver 'anneal' needs lowerable contention surfaces, but "
            f"{', '.join(bad)} has no registered surface lowering "
            f"(repro_torch.core.lowering.register_surface_lowering); use "
            f"solver='bb' or 'greedy' for this model")
    w = len(graphs)
    if w == 0:
        raise ValueError("cannot search an empty problem")
    amax = len(acc_names)
    gmax = _next_pow2(max(len(g) for g in graphs))
    dur_t = np.zeros((w, gmax, amax))
    dem_t = np.zeros((w, gmax, amax))
    allowed = np.zeros((w, gmax, amax), dtype=bool)
    legal_after = np.zeros((w, gmax), dtype=bool)
    move_ms = np.zeros((w, gmax))
    tau_pair = np.zeros((amax, amax))
    ngroups = np.zeros(w, dtype=np.int64)
    for m, g in enumerate(graphs):
        ng = len(g)
        ngroups[m] = ng
        time_t, dem, legal, move, tp = graph_tables(platform, g)
        tau_pair = tp
        ok = ~np.isnan(time_t)
        if not ok.any(axis=1).all():
            i = int(np.flatnonzero(~ok.any(axis=1))[0])
            raise ValueError(
                f"graph {g.name!r}[{i}] runs on no accelerator of "
                f"platform {platform.name!r}")
        allowed[m, :ng] = ok
        dur_t[m, :ng] = np.nan_to_num(time_t)
        dem_t[m, :ng] = dem
        legal_after[m, :ng] = legal
        move_ms[m, :ng] = move
    its = np.asarray(list(iterations or [1] * w), dtype=np.int64)
    deps = np.asarray([-1 if d is None else int(d)
                       for d in (depends_on or [None] * w)], dtype=np.int64)
    arr = np.asarray(list(arrival_ms or [0.0] * w))
    return SearchTables(
        acc_names=acc_names, w=w, gmax=gmax, amax=amax,
        dur_t=dur_t, dem_t=dem_t, allowed=allowed,
        n_allowed=allowed.sum(axis=-1).astype(np.int64),
        legal_after=legal_after, move_ms=move_ms, tau_pair=tau_pair,
        ngroups=ngroups, iters=its, dep=deps, arrival=arr,
        domshare=domshare, model_of_acc=model_of_acc,
        models=models, surfaces=surfaces,
        max_transitions=int(max_transitions))


def _legal_rows(tables: SearchTables, asg: np.ndarray) -> np.ndarray:
    """Vectorized legality over a (P, w, gmax) batch of index rows."""
    w, gmax = tables.w, tables.gmax
    widx = np.arange(w)[None, :, None]
    gidx = np.arange(gmax)[None, None, :]
    live = gidx < tables.ngroups[None, :, None]
    ok = (tables.allowed[widx, gidx, asg] | ~live).all(axis=(1, 2))
    pair_live = (np.arange(1, gmax)[None, None, :]
                 < tables.ngroups[None, :, None])
    diff = (asg[:, :, 1:] != asg[:, :, :-1]) & pair_live
    ok &= ~(diff & ~tables.legal_after[None, :, :-1]).any(axis=(1, 2))
    ok &= (diff.sum(axis=2) <= tables.max_transitions).all(axis=1)
    return ok


def _scatter_population(tables: SearchTables, row: np.ndarray,
                        pop: int, seed: int) -> np.ndarray:
    """Diversify the initial population: chain 0 keeps ``row`` exactly
    (the never-regress anchor), every other chain takes a seeded random
    walk of legal single-site mutations so islands start in distinct
    basins instead of all climbing out of the same one.  Depends only on
    ``seed`` — chunking, backend, and precision cannot perturb it."""
    asg = np.repeat(row[None].astype(np.int32), pop, axis=0)
    if pop == 1:
        return asg
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 0x5eed]))
    sites = np.array([(m, i) for m in range(tables.w)
                      for i in range(int(tables.ngroups[m]))])
    for _ in range(max(4, 2 * len(sites))):
        pick = sites[rng.integers(0, len(sites), size=pop)]
        wi, gi = pick[:, 0], pick[:, 1]
        k = rng.integers(0, tables.n_allowed[wi, gi])
        acc = (np.cumsum(tables.allowed[wi, gi], axis=1)
               > k[:, None]).argmax(axis=1)
        prop = asg.copy()
        prop[np.arange(pop), wi, gi] = acc.astype(np.int32)
        ok = _legal_rows(tables, prop)
        asg[ok] = prop[ok]
    asg[0] = row
    return asg


def default_init(tables: SearchTables) -> np.ndarray:
    """A legal all-on-one-accelerator starting row: per workload, the
    everywhere-allowed accelerator with the smallest total duration."""
    out = np.zeros((tables.w, tables.gmax), dtype=np.int32)
    for m in range(tables.w):
        ng = int(tables.ngroups[m])
        everywhere = tables.allowed[m, :ng].all(axis=0)
        if not everywhere.any():
            raise ValueError(
                f"workload {m} has no accelerator allowed on every group; "
                f"pass an explicit init_assignment")
        total = np.where(everywhere, tables.dur_t[m, :ng].sum(axis=0),
                         np.inf)
        out[m, :] = int(np.argmin(total))
    return out



# ---------------------------------------------------------------------------
# the search on the device
# ---------------------------------------------------------------------------

def _device_tables(tables: SearchTables, dt: torch.dtype, dev) -> dict:
    """The frozen problem as tensors on the device."""
    def t(a, dtype):
        return _tensor(a, dtype, dev)

    i64 = torch.int64
    return {
        "dur_t": t(tables.dur_t, dt),
        "dem_t": t(tables.dem_t, dt),
        "allowed": t(tables.allowed, torch.bool),
        "n_allowed": t(tables.n_allowed, i64),
        "legal_after": t(tables.legal_after, torch.bool),
        "move_ms": t(tables.move_ms, dt),
        "tau_pair": t(tables.tau_pair, dt),
        "ngroups": t(tables.ngroups, i64),
        "cum_live": t(np.cumsum(tables.ngroups), i64),
        "iters": t(tables.iters, i64),
        "dep": t(tables.dep, i64),
        "arrival": t(tables.arrival, dt),
        "domshare": t(tables.domshare, dt),
        "model_of_acc": t(tables.model_of_acc, i64),
        "surf": tuple(surface_params(s, dt, dev) for s in tables.surfaces),
    }


class _Chains:
    """One device call's worth of chains (the reference's ``_make_run``):
    mutate -> lean evaluate -> select -> migrate, ``steps`` times."""

    def __init__(self, tables: SearchTables, tb: dict, obj_kind: str,
                 island: int, migrate: str, backend: str, bits: int):
        self.tables, self.tb = tables, tb
        self.obj_kind, self.island, self.migrate = obj_kind, island, migrate
        self.backend, self.bits = backend, bits
        self.machine = make_event_machine(tables.kinds, 1, record=False)
        dev = tb["dur_t"].device
        w, gmax = tables.w, tables.gmax
        self.widx = torch.arange(w, device=dev)[None, :, None]
        self.gidx = torch.arange(gmax, device=dev)[None, None, :]
        self.live = (torch.arange(gmax, device=dev)[None, :]
                     < tb["ngroups"][:, None])                 # (w, gmax)
        self.total_live = int(tables.ngroups.sum())

    def gather(self, table, asg):
        return table[self.widx, self.gidx, asg]

    def legal_all(self, asg):
        tb, live = self.tb, self.live
        ok = (self.gather(tb["allowed"], asg) | ~live).all(2).all(1)
        if self.tables.gmax > 1:
            moved = (asg[:, :, :-1] != asg[:, :, 1:]) & live[:, 1:]
            ok &= (~moved | tb["legal_after"][:, :-1]).all(2).all(1)
            ok &= (moved.sum(2) <= self.tables.max_transitions).all(1)
        return ok

    def evaluate(self, asg):
        tb, w, gmax = self.tb, self.tables.w, self.tables.gmax
        P = asg.shape[0]
        dt = tb["dur_t"].dtype
        dur = self.gather(tb["dur_t"], asg)
        dem = self.gather(tb["dem_t"], asg)
        tau = torch.zeros(P, w, gmax, dtype=dt, device=asg.device)
        if gmax > 1:
            a0, a1 = asg[:, :, :-1], asg[:, :, 1:]
            moved = (a0 != a1) & self.live[:, 1:]
            tau[:, :, :-1] = torch.where(
                moved, tb["move_ms"][:, :-1] + tb["tau_pair"][a0, a1], 0.0)
        finish, err = self.machine(
            asg.long(), dur, dem, tau, tb["ngroups"].expand(P, w),
            tb["iters"].expand(P, w), tb["dep"].expand(P, w), tb["arrival"],
            tb["domshare"], tb["model_of_acc"], tb["surf"])
        if self.obj_kind == "latency":
            obj = finish.max(1).values
        elif self.obj_kind == "throughput":
            mk = finish.max(1).values
            iters_sum = tb["iters"].sum().to(dt)
            obj = torch.where(mk > 0, -1e3 * iters_sum / mk,
                              torch.tensor(-float("inf"), dtype=dt,
                                           device=mk.device))
        else:  # sum_inverse
            obj = -torch.where(finish > 0, 1.0 / finish,
                               torch.zeros((), dtype=dt,
                                           device=finish.device)).sum(1)
        return torch.where(err != 0, float("inf"), obj)

    def mutate(self, key, asg):
        tb = self.tb
        P = asg.shape[0]
        ks, ka = prng.split(key)
        u = prng.randint(ks, 0, self.total_live, self.bits)
        cum = tb["cum_live"]
        m = (u[:, None] >= cum[None, :]).sum(1)
        prev = torch.where(m > 0, cum[(m - 1).clamp_min(0)], 0)
        i = u - prev
        na = tb["n_allowed"][m, i]
        k = prng.randint(ka, 0, na.clamp_min(1), self.bits)
        hits = tb["allowed"][m, i].to(torch.int64).cumsum(-1)    # (P, A)
        a = (hits > k[:, None]).to(torch.uint8).argmax(-1)     # first True
        prop = asg.clone()
        prop[torch.arange(P, device=asg.device), m, i] = a.to(asg.dtype)
        return torch.where(self.legal_all(prop)[:, None, None], prop, asg)

    def migrate_step(self, cur, cur_obj, best, best_obj):
        """Elitist island migration: the island's best incumbent replaces
        its worst current member (then, for ``ring``, the previous
        island's elite replaces the worst again, wrapping locally)."""
        island, (w, gmax) = self.island, (self.tables.w, self.tables.gmax)
        P = cur.shape[0]
        nisl = P // island
        r = torch.arange(nisl, device=cur.device)
        obj_i = cur_obj.reshape(nisl, island).clone()
        bo_i = best_obj.reshape(nisl, island)
        src = bo_i.argmin(1)                       # first-tie elite
        dst = obj_i.argmax(1)                      # worst current
        elite = best.reshape(nisl, island, w, gmax)[r, src]
        elite_obj = bo_i[r, src]
        cur_i = cur.reshape(nisl, island, w, gmax).clone()
        cur_i[r, dst] = elite
        obj_i[r, dst] = elite_obj
        if self.migrate == "ring":
            donor = torch.cat([elite[-1:], elite[:-1]])
            donor_obj = torch.cat([elite_obj[-1:], elite_obj[:-1]])
            dst2 = obj_i.argmax(1)                 # worst after the fold
            cur_i[r, dst2] = donor
            obj_i[r, dst2] = donor_obj
        return cur_i.reshape(P, w, gmax), obj_i.reshape(P)

    def run(self, chain_idx, asg0, seed: int, n_steps: int, ex_every: int,
            t0: float, t1: float):
        dt = self.tb["dur_t"].dtype
        P = asg0.shape[0]
        L = self.tables.w * self.tables.gmax
        chain_keys = prng.fold_in(prng.key(seed, P, asg0.device), chain_idx)
        cur = best = asg0
        cur_obj = best_obj = self.evaluate(asg0)
        t0_, t1_ = (torch.tensor(v, dtype=dt) for v in (t0, t1))
        denom = torch.tensor(max(n_steps - 1, 1), dtype=dt)
        for step in range(n_steps):
            km, ku = prng.split(prng.fold_in(chain_keys, step))
            prop = self.mutate(km, cur)
            prop_obj = self.evaluate(prop)
            u = prng.uniform_f32(ku).to(dt)
            # the reference's schedule, in the objectives' dtype
            frac = torch.tensor(step, dtype=dt) / denom
            temp = float(t0_ * (t1_ / t0_) ** frac)
            c, cur_obj, b, best_obj = anneal_select(
                cur.reshape(P, L), prop.reshape(P, L), best.reshape(P, L),
                cur_obj, prop_obj, best_obj, u, temp, backend=self.backend)
            cur = c.reshape(asg0.shape)
            best = b.reshape(asg0.shape)
            if (step + 1) % ex_every == 0:
                cur, cur_obj = self.migrate_step(cur, cur_obj, best,
                                                 best_obj)
        return best_obj, best


# ---------------------------------------------------------------------------
# host driver
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SearchOutcome:
    """The device search's winner — device-reported, pre-authoritative."""

    assignment: tuple[tuple[str, ...], ...]
    objective: float            # device objective of the incumbent
    chain: int                  # global index of the winning chain
    evaluated: int              # event-machine evaluations performed
    population: int
    steps: int
    seed: int
    precision: str
    backend: str
    devices: int | None = None  # mesh width; None = legacy chunked path
    migrate: str = "island"     # resolved migration topology
    fanout: str | None = None   # resolved mesh fan-out (shard_map/pmap)


def _nearest_multiple(value: int, quantum: int) -> int:
    """The multiple of ``quantum`` nearest to ``value`` (>= quantum)."""
    lo = (value // quantum) * quantum
    hi = lo + quantum
    if lo < quantum:
        return hi
    return lo if (value - lo) <= (hi - value) else hi



def _validate_knobs(population: int, island: int, exchange_every: int,
                    steps: int, chunk: int | None, devices: int | None,
                    migrate: str, fanout: str) -> tuple[int | None, str]:
    """Fail fast on inconsistent knob combinations.

    The reference's checks and messages, minus the mesh: ``devices`` is
    ``None`` (island-aligned chunks, island migration) or ``1`` (one
    call, ring migration by default), and ``fanout`` stays ``"auto"``.
    Every rejection names the offending knob and the nearest legal value.
    Returns the resolved ``(chunk, migrate)``.
    """
    if island < 1 or exchange_every < 1 or steps < 0 or population < 1:
        raise ValueError("population/steps/island/exchange_every must be "
                         "positive")
    if island > population:
        raise ValueError(
            f"island ({island}) exceeds population ({population}); "
            f"nearest legal value: island={population}")
    if population % island:
        raise ValueError(
            f"population ({population}) is not a multiple of island "
            f"({island}); nearest legal value: population="
            f"{_nearest_multiple(population, island)}")
    if migrate not in MIGRATIONS:
        raise ValueError(f"unknown migrate {migrate!r}; "
                         f"one of {', '.join(MIGRATIONS)}")
    if fanout not in FANOUTS:
        raise ValueError(f"unknown fanout {fanout!r}; "
                         f"one of {', '.join(FANOUTS)}")
    if fanout != "auto":
        raise ValueError(
            f"fanout ({fanout!r}) fans a search out over a device mesh, "
            f"which repro_torch does not run yet; nearest legal value: "
            f"fanout='auto'")
    if devices is not None:
        if devices != 1:
            # the multi-card mesh is ROADMAP queue 1 item 8
            raise ValueError(
                f"devices ({devices}): repro_torch searches on one device; "
                f"nearest legal value: devices=1")
    elif migrate == "ring":
        raise ValueError(
            "migrate='ring' requires devices=N: the ring spans the "
            "global island order, which the legacy chunked path "
            "processes in separate device calls; nearest legal "
            "value: migrate='island'")
    if chunk is not None:
        if chunk < 1:
            raise ValueError(f"chunk ({chunk}) must be >= 1")
        if chunk % island:
            raise ValueError(
                f"chunk ({chunk}) must be a multiple of island "
                f"({island}): islands may not straddle device calls; "
                f"nearest legal value: chunk="
                f"{_nearest_multiple(chunk, island)}")
        if chunk > population:
            raise ValueError(
                f"chunk ({chunk}) exceeds population ({population}); "
                f"nearest legal value: chunk={population}")
    mig = migrate if migrate != "auto" else (
        "ring" if devices is not None else "island")
    return chunk, mig


def anneal_search(
    tables: SearchTables,
    *,
    objective: str = "latency",
    seed: int = 0,
    population: int = 1024,
    steps: int = 128,
    island: int = DEFAULT_ISLAND,
    exchange_every: int = 16,
    chunk: int | None = None,
    precision: str = "float32",
    backend: str = "auto",
    devices: int | None = None,
    migrate: str = "auto",
    fanout: str = "auto",
    init_assignment: np.ndarray | Sequence[Sequence[str]] | None = None,
    init_objective: float | None = None,
    device=None,
) -> SearchOutcome:
    """Run the annealing/genetic search over ``tables`` on ``device``.

    ``population`` chains (a multiple of ``island``) run ``steps``
    temperature steps each; ``chunk`` bounds the chains per device call
    and must be island-aligned (default: one full-population call, capped
    at :data:`DEFAULT_CHUNK`).  ``precision="float32"`` ranks in single
    precision; ``"x64"`` evaluates in float64.  ``backend`` selects the
    select-kernel dispatch (``cuda`` / ``torch`` / ``ref`` / ``auto``, by
    the device); the slowdown kernel always dispatches by the device.
    ``device`` defaults to ``cuda`` and never enters a result's identity.

    The same ``(seed, population, steps, island, exchange_every)`` always
    explores the same chains as ``repro``'s ``anneal_search`` and returns
    the same incumbent regardless of ``chunk`` and backend.  Inconsistent
    knob combinations raise ``ValueError`` naming the knob and the nearest
    legal value.
    """
    if objective not in OBJECTIVES:
        raise ValueError(f"unknown objective {objective!r}; "
                         f"one of {', '.join(OBJECTIVES)}")
    dt = dtype_of(precision)
    chunk, migrate = _validate_knobs(
        population, island, exchange_every, steps, chunk, devices,
        migrate, fanout)
    dev = resolve_device(device)
    pop = population
    if devices is not None:
        chunk = pop               # one call: the ring spans every island
    elif chunk is None:
        chunk = max(island, min((DEFAULT_CHUNK // island) * island, pop))

    if init_assignment is None:
        asg_row = default_init(tables)
    elif isinstance(init_assignment, np.ndarray):
        asg_row = np.asarray(init_assignment, dtype=np.int32)
        if asg_row.shape != (tables.w, tables.gmax):
            raise ValueError(
                f"init_assignment shape {asg_row.shape} != "
                f"{(tables.w, tables.gmax)}")
    else:
        asg_row = tables.encode(init_assignment)
    if not tables.legal(asg_row):
        raise ValueError("init_assignment is not a legal schedule "
                         "(allowed accelerators / transition budget)")

    # temperature scale: the initial objective when the caller knows it,
    # else a contention-free serial-latency proxy — only the *scale*
    # matters, the schedule is geometric between t0 and t1.
    if init_objective is not None and np.isfinite(init_objective):
        scale = abs(float(init_objective))
    else:
        scale = float(max(
            float(tables.iters[m]) * tables.dur_t[m, :, :].max(axis=-1).sum()
            for m in range(tables.w)))
    scale = max(scale, 1e-6)
    t0, t1 = 0.1 * scale, 1e-4 * scale

    best_objs = np.empty(pop)
    best_rows = np.empty((pop, tables.w, tables.gmax), dtype=np.int64)
    chains = _Chains(tables, _device_tables(tables, dt, dev), objective,
                     island, migrate, backend,
                     bits=64 if precision == "x64" else 32)
    asg0_full = torch.as_tensor(
        _scatter_population(tables, asg_row, pop, seed), device=dev)

    tracer = get_tracer()
    with tracer.span("anneal_search", "search", population=pop,
                     steps=steps, island=island, seed=seed,
                     backend=backend, devices=devices,
                     objective=objective) as search_sp:
        incumbent = np.inf
        for ci, lo in enumerate(range(0, pop, chunk)):
            hi = min(lo + chunk, pop)
            with tracer.span("anneal.chunk", "search", chunk=ci, lo=lo,
                             hi=hi, includes_compile=False) as sp:
                bo, br = chains.run(
                    torch.arange(lo, hi, device=dev), asg0_full[lo:hi],
                    seed, steps, exchange_every, t0, t1)
                best_objs[lo:hi] = bo.double().cpu().numpy()
                best_rows[lo:hi] = br.cpu().numpy()
            if tracer.enabled:
                chunk_objs = best_objs[lo:hi]
                finite = chunk_objs[np.isfinite(chunk_objs)]
                # the fraction of chains that ended strictly better than
                # the seed schedule is the host-visible acceptance proxy
                # (feasible fraction when no seed objective is known).
                if init_objective is not None and np.isfinite(
                        init_objective):
                    accepted = int((finite < init_objective).sum())
                else:
                    accepted = int(finite.size)
                sp.set(accept_rate=round(accepted / (hi - lo), 4))
                if finite.size and float(finite.min()) < incumbent:
                    incumbent = float(finite.min())
                    tracer.instant(
                        "anneal.incumbent", "search",
                        objective=incumbent,
                        chain=int(lo + np.argmin(best_objs[lo:hi])))

        winner = int(np.argmin(best_objs))   # first min = lowest chain index
        if not np.isfinite(best_objs[winner]):
            raise RuntimeError(
                "device search found no feasible schedule (every chain "
                "error-poisoned); check the contention model coverage")
        search_sp.set(evaluated=pop * (steps + 1), chain=winner,
                      objective_value=float(best_objs[winner]))
    return SearchOutcome(
        assignment=tables.decode(best_rows[winner]),
        objective=float(best_objs[winner]),
        chain=winner,
        evaluated=pop * (steps + 1),
        population=pop,
        steps=steps,
        seed=seed,
        precision=precision,
        backend=backend,
        devices=devices,
        migrate=migrate,
        fanout=None,
    )

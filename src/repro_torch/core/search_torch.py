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

Torch has no ``while_loop``.  Where the reference jits one device
program, the port captures each step's body as CUDA graphs on the card
and replays them from one host loop (:meth:`_Chains.run`): mutate and a
fixed budget of W event-machine waves (W = the waves the first, eager,
evaluation needed); while any lane is still active, a graph of
:data:`~repro_torch.core.simulate_torch.CHECK_EVERY` more waves;
score and select; migrate, on its steps.  Finished lanes are frozen, so
the extra waves leave the result bit for bit the same, and a step costs
one host sync (the "any lane active" flag) plus one per overflow replay.
The annealing temperature and the step folded into the chains' keys live
on the device (a precomputed (steps,) schedule and a step counter the
graph increments).  Off the card, and with ``eager=True``, the same step
functions run eagerly (:func:`repro_torch.kernels.graph.capture`).
``devices=None`` runs the population in island-aligned chunks with
island migration; ``devices=1`` runs it in one call with the reference's
ring migration wrapped locally; ``devices=N`` runs it on N
``torch.distributed`` ranks, the ring's seam crossing ranks at each
exchange step (:class:`_Seam`; :func:`anneal_search` says how the ranks
come to be).

The scalar simulator stays authoritative: this module reports the device
incumbent and its device objective; :mod:`repro_torch.core.solver_anneal`
re-simulates the winner on the host scalar path before any
:class:`~repro_torch.core.plan.Plan` is minted.
"""
from __future__ import annotations

import time
import traceback
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import prng
from .accelerators import Platform
from .contention import ContentionModel
from .graph import DNNGraph
from .lowering import _platform_tables, graph_tables
from .simulate_torch import (CHECK_EVERY, _tensor, dtype_of,
                             make_event_machine, surface_params)
from ..kernels import graph as _graph
from ..kernels import search as _select_kernel
from ..kernels import slowdown as _slowdown_kernel
from ..kernels.search import anneal_select
from .. import ranks as _ranks
from ..ranks import RankFailure
from ..obs import get_tracer
from ..runtime import resolve_device

OBJECTIVES = ("latency", "throughput", "sum_inverse")
MIGRATIONS = ("auto", "island", "ring")
#: ``ranks`` is the port's fan-out; the reference's jax fan-outs
#: (``shard_map``, ``pmap``) are named so that they are refused with it
FANOUTS = ("auto", "ranks", "shard_map", "pmap")

#: chains per island — the migration neighborhood.  Must divide both the
#: population and the chunk so islands never straddle a device call.
DEFAULT_ISLAND = 32
#: chains per device call; population shards into island-aligned chunks.
DEFAULT_CHUNK = 8192


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length()


def temperature_schedule(t0: float, t1: float, n_steps: int,
                         dt: torch.dtype) -> list[float]:
    """The reference's geometric schedule ``t0 * (t1 / t0) ** (step /
    max(n_steps - 1, 1))``, each entry computed in the objectives' dtype
    on the host (CPU tensors), so the card's copy holds the very values
    an eager step would pass: no device ``pow`` that might differ by an
    ulp and flip a Metropolis decision."""
    t0_, t1_ = (torch.tensor(v, dtype=dt) for v in (t0, t1))
    denom = torch.tensor(max(n_steps - 1, 1), dtype=dt)
    return [float(t0_ * (t1_ / t0_) ** (torch.tensor(step, dtype=dt)
                                         / denom))
            for step in range(n_steps)]


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

    def start(self, asg):
        """The lean event machine over ``asg``, before its first wave."""
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
        return self.machine.start(
            asg.long(), dur, dem, tau, tb["ngroups"].expand(P, w),
            tb["iters"].expand(P, w), tb["dep"].expand(P, w), tb["arrival"],
            tb["domshare"], tb["model_of_acc"], tb["surf"])

    def evaluate(self, asg):
        """(P,) objectives of ``asg`` (inf where the machine erred), and
        the waves the machine ran."""
        waves = self.start(asg)
        waves.drive()
        return self.objective(*waves.result()), waves.count

    def objective(self, finish, err):
        tb = self.tb
        dt = tb["dur_t"].dtype
        if self.obj_kind == "latency":
            obj = finish.max(1).values
        elif self.obj_kind == "throughput":
            mk = finish.max(1).values
            iters_sum = tb["iters"].sum().to(dt)
            obj = torch.where(mk > 0, -1e3 * iters_sum / mk,
                              torch.full((), -float("inf"), dtype=dt,
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

    def fold(self, cur, cur_obj, best, best_obj):
        """Elitist island migration: the island's best incumbent replaces
        its worst current member.  Returns the folded ``(cur, cur_obj)``
        as (islands, island, ...) and the islands' elites and their
        objectives."""
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
        return cur_i, obj_i, elite, elite_obj

    def ring(self, cur_i, obj_i, elite, elite_obj, seam, seam_obj):
        """The ring: island j's worst member after the fold is replaced by
        island j-1's elite in the global island order; ``seam`` is the
        elite of the island before this call's first (the reference's
        ``search_jax.py:425-449``)."""
        r = torch.arange(cur_i.shape[0], device=cur_i.device)
        donor = torch.cat([seam, elite[:-1]])
        donor_obj = torch.cat([seam_obj, elite_obj[:-1]])
        dst2 = obj_i.argmax(1)                     # worst after the fold
        cur_i[r, dst2] = donor
        obj_i[r, dst2] = donor_obj
        return cur_i, obj_i

    def run(self, chain_idx, asg0, seed: int, n_steps: int, ex_every: int,
            t0: float, t1: float, eager: bool, seam=None):
        """``n_steps`` steps of the chains ``chain_idx`` from ``asg0``;
        returns ``(best_obj, best)`` and sets :attr:`stats`.

        The steps are replays of graphs over static buffers: ``head``
        (fold the device step into the keys, mutate, start the machine, W
        waves, raise the flag if a lane is still active), ``more``
        (CHECK_EVERY waves, the flag again) while the flag is up,
        ``tail`` (score, draw, select with the device temperature into
        the state in place, step + 1), and on the exchange steps the
        migration: ``fold`` (each island's elite replaces its worst
        member, and the elites are kept), then, for ``ring``, the
        ``seam``'s exchange on the host (the last island's elite goes to
        the next rank and the previous rank's arrives; a collective
        cannot be captured) and ``ring`` (it goes to the first island,
        each other island's elite to the next island).  Off the card, or
        with ``eager`` (:func:`repro_torch.kernels.graph.capture`), the
        same functions run eagerly.

        ``seam``: a :class:`_Seam` on one rank of several; by default
        :class:`_LocalSeam`, whose ring closes on this rank's own last
        island.  If this rank fails, it still joins the next exchange,
        flagged, so that every rank stops there; the error is raised
        after it."""
        seam = _LocalSeam() if seam is None else seam
        try:
            return self._run(chain_idx, asg0, seed, n_steps, ex_every, t0,
                             t1, eager, seam)
        except Exception:
            seam.fail()
            raise

    def _run(self, chain_idx, asg0, seed, n_steps, ex_every, t0, t1, eager,
             seam):
        dt = self.tb["dur_t"].dtype
        P = asg0.shape[0]
        w, gmax = self.tables.w, self.tables.gmax
        L = w * gmax
        nisl = P // self.island
        dev = asg0.device
        chain_keys = prng.fold_in(prng.key(seed, P, dev), chain_idx)
        temps = temperature_schedule(t0, t1, n_steps, dt)
        cur_obj, W = self.evaluate(asg0)
        #: waves of the first evaluation (the graphs' budget), the
        #: overflow replays the steps needed past it, whether they replay
        #: captured graphs
        self.stats = {"waves": W, "overflow_replays": 0,
                      "graph": _graph.captures(dev, eager)}
        if not n_steps:
            return cur_obj, asg0
        cur, best = asg0.clone(), asg0.clone()
        best_obj = cur_obj.clone()
        step = torch.zeros((), dtype=torch.int64, device=dev)
        temp_of = torch.tensor(temps, dtype=dt, device=dev)
        flag = torch.zeros((), dtype=torch.bool, device=dev)
        elite = torch.zeros(nisl, w, gmax, dtype=asg0.dtype, device=dev)
        elite_obj = torch.zeros(nisl, dtype=dt, device=dev)
        inbound = torch.zeros(1, w, gmax, dtype=asg0.dtype, device=dev)
        inbound_obj = torch.zeros(1, dtype=dt, device=dev)
        stage = {}

        def head():
            km, ku = prng.split(prng.fold_in(chain_keys, step))
            prop = self.mutate(km, cur)
            waves = self.start(prop)
            for _ in range(W):
                waves.wave()
            flag.copy_(waves.active().any())
            stage.update(prop=prop, ku=ku, waves=waves)

        def more():
            for _ in range(CHECK_EVERY):
                stage["waves"].wave()
            flag.copy_(stage["waves"].active().any())

        def tail(commit=True):
            prop_obj = self.objective(*stage["waves"].result())
            u = prng.uniform_f32(stage["ku"]).to(dt)
            temp = temp_of.index_select(0, step.view(1))
            state = (cur.view(P, L), cur_obj, best.view(P, L), best_obj)
            if not commit:          # the warm-up: the same launch, on copies
                state = tuple(t.clone() for t in state)
            c, co, b, bo = state
            anneal_select(c, stage["prop"].view(P, L), b, co, prop_obj, bo,
                          u, temp, out=state, backend=self.backend)
            if commit:
                step.add_(1)

        def fold(commit=True):
            c, co, el, elo = self.fold(cur, cur_obj, best, best_obj)
            if commit:
                cur.copy_(c.view(cur.shape))
                cur_obj.copy_(co.view(cur_obj.shape))
                elite.copy_(el)
                elite_obj.copy_(elo)

        def ring(commit=True):
            c = cur.view(nisl, self.island, w, gmax)
            co = cur_obj.view(nisl, self.island)
            if not commit:
                c, co = c.clone(), co.clone()
            self.ring(c, co, elite, elite_obj, inbound, inbound_obj)

        bodies = {"head": head, "more": more, "tail": tail, "fold": fold}
        if self.migrate == "ring":
            bodies["ring"] = ring
        # one uncommitted pass of every body first (on a side stream), so
        # each kernel's one-time set-up happens before capture
        _graph.warm_up(lambda: [fn() if name in ("head", "more") else
                                fn(False) for name, fn in bodies.items()],
                       dev, eager)
        g = {name: _graph.capture(fn, dev, eager)
             for name, fn in bodies.items()}
        self.stats["launches_per_graph"] = {name: gr.launches
                                            for name, gr in g.items()}
        for i in range(len(temps)):
            g["head"].replay()
            while bool(flag):                       # the step's one sync
                g["more"].replay()
                self.stats["overflow_replays"] += 1
            g["tail"].replay()
            if (i + 1) % ex_every:
                continue
            g["fold"].replay()
            if "ring" not in g:
                continue
            got = seam.exchange(elite[-1:], elite_obj[-1:])
            if got is None:                         # another rank failed
                raise RankFailure("stopped: another rank failed")
            inbound.copy_(got[0])
            inbound_obj.copy_(got[1])
            g["ring"].replay()
        return best_obj, best


class _LocalSeam:
    """The ring's seam on one rank: the last island's elite is the first
    island's (the ring wraps locally)."""

    def exchange(self, seam, seam_obj):
        return seam, seam_obj

    def fail(self) -> None:
        pass


class _Seam:
    """The ring's seam between ranks (the reference's ``ppermute`` at
    ``search_jax.py:437-442``): at each exchange step rank ``r`` sends its
    last island's elite and objective to rank ``r + 1`` mod N and takes
    rank ``r - 1``'s.  It is one ``all_gather`` of a few hundred bytes,
    staged through host memory when the backend is ``gloo`` (which
    carries CPU tensors); the objective travels as its bits, with a flag
    that says whether the sender is still running.  Every rank makes the
    same ``exchanges`` calls, so a failed rank joins the next one flagged
    (:meth:`fail`) and every rank stops there."""

    def __init__(self, rank: int, world: int, exchanges: int, row: int):
        self.rank, self.world, self.row = rank, world, row
        self.left = exchanges
        self.broken = False
        self.ms: list[float] = []

    def exchange(self, seam, seam_obj):
        """The previous rank's ``(seam, seam_obj)``, on ``seam``'s device,
        or None when any rank was flagged."""
        t0 = time.perf_counter()
        bits = seam_obj.view(_BITS[seam_obj.dtype]).long()
        out = self._gather(torch.cat([bits.new_ones(1), bits,
                                      seam.reshape(-1).long()]))
        if out is None:
            return None
        prev = out[(self.rank - 1) % self.world].to(seam.device)
        got = (prev[2:].to(seam.dtype).reshape(seam.shape),
               prev[1:2].to(_BITS[seam_obj.dtype]).view(seam_obj.dtype))
        self.ms.append((time.perf_counter() - t0) * 1e3)
        return got

    def fail(self) -> None:
        """Join the next exchange flagged, if one is left."""
        if self.left > 0 and not self.broken:
            self._gather(torch.zeros(2 + self.row, dtype=torch.int64))

    def _gather(self, payload):
        stage = ("cpu" if dist.get_backend() == "gloo"
                 else torch.device("cuda", torch.cuda.current_device()))
        payload = payload.to(stage)
        out = [torch.empty_like(payload) for _ in range(self.world)]
        dist.all_gather(out, payload)
        self.left -= 1
        if not all(int(o[0]) for o in out):
            self.broken = True
            return None
        return out


_BITS = {torch.float32: torch.int32, torch.float64: torch.int64}


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
                    migrate: str, fanout: str,
                    device=None) -> tuple[int | None, str, str | None]:
    """Fail fast on inconsistent knob combinations.

    The reference's checks and messages.  ``devices`` counts ranks: no
    more than the visible devices of ``device``'s type unless
    :func:`repro_torch.ranks.share_devices` let ranks share them
    (the reference's ``xla_env.apply``), and, inside a process group,
    its world size.  ``fanout`` resolves to ``"ranks"`` (the port's one
    fan-out: a rank per device, :func:`anneal_search`); the reference's
    ``shard_map`` and ``pmap`` are refused.  Every rejection names the
    offending knob and the nearest legal value.  Returns the resolved
    ``(chunk, migrate, fanout)``.
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
    if devices is not None:
        if devices < 1:
            raise ValueError(f"devices ({devices}) must be >= 1")
        if _in_group():
            avail = dist.get_world_size()
            if devices not in (1, avail):
                raise ValueError(
                    f"devices ({devices}) is not the world size ({avail}) "
                    f"of the process group the search runs in; nearest "
                    f"legal value: devices={avail}")
        else:
            dev = torch.device("cuda" if device is None else device)
            avail = _ranks.rank_capacity(dev)
            if devices > avail:
                raise ValueError(
                    f"devices ({devices}) exceeds the {avail} visible "
                    f"{dev.type} device(s); nearest legal value: "
                    f"devices={avail} (let N ranks share them with "
                    f"repro_torch.ranks.share_devices(N) before the "
                    f"search starts)")
        quantum = island * devices
        if population % quantum:
            raise ValueError(
                f"population ({population}) is not a multiple of "
                f"island*devices ({quantum}); nearest legal value: "
                f"population={_nearest_multiple(population, quantum)}")
        if fanout in ("shard_map", "pmap"):
            raise ValueError(
                f"fanout ({fanout!r}) is a jax mesh fan-out; repro_torch "
                f"fans out over torch.distributed ranks; nearest legal "
                f"value: fanout='ranks'")
    else:
        if fanout != "auto":
            raise ValueError(
                f"fanout ({fanout!r}) requires devices=N (the mesh "
                f"path); nearest legal value: fanout='auto'")
        if migrate == "ring":
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
    return chunk, mig, ("ranks" if devices is not None else None)


def _in_group() -> bool:
    """Whether the caller runs inside a process group of its own (every
    rank calls the search), not a :class:`~repro_torch.ranks.RankPool`
    this process leads."""
    return (dist.is_available() and dist.is_initialized()
            and not _ranks.in_pool())


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
    eager: bool = False,
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
    On the card each step replays captured CUDA graphs; ``eager=True``
    runs the same step functions eagerly there (as the CPU always does),
    to compare the two.  It never changes the result.

    ``devices=N`` runs the population on N ranks (``fanout="ranks"``)
    with ``migrate="ring"``: rank ``r`` runs the global chains ``[r P/N,
    (r+1) P/N)``, each keyed on its global index, and the ring's seam
    crosses ranks at every exchange step (:class:`_Seam`).  Called inside
    a process group of N ranks, every rank calls it with the same
    arguments; called from a plain process, the process becomes rank 0
    of a :class:`~repro_torch.ranks.RankPool` whose N - 1 helper
    ranks start on first use and stay up.  Every rank returns the same
    outcome, and the incumbent is bit-identical for a fixed ``(seed,
    population, island, exchange_every)`` at any N that divides the
    island count.  ``devices=None`` keeps the chunked path with island
    migration.

    The same ``(seed, population, steps, island, exchange_every)`` always
    explores the same chains as ``repro``'s ``anneal_search`` and returns
    the same incumbent regardless of ``chunk`` and backend.  Inconsistent
    knob combinations raise ``ValueError`` naming the knob and the nearest
    legal value.
    """
    if objective not in OBJECTIVES:
        raise ValueError(f"unknown objective {objective!r}; "
                         f"one of {', '.join(OBJECTIVES)}")
    dtype_of(precision)
    chunk, migrate, fanout_r = _validate_knobs(
        population, island, exchange_every, steps, chunk, devices,
        migrate, fanout, device)
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
    knobs = dict(objective=objective, seed=seed, population=pop,
                 steps=steps, island=island, exchange_every=exchange_every,
                 chunk=chunk, precision=precision, backend=backend,
                 devices=devices, migrate=migrate, fanout=fanout_r,
                 asg_row=asg_row, t0=0.1 * scale, t1=1e-4 * scale,
                 init_objective=init_objective, device=dev, eager=eager)
    if devices is None or devices == 1:
        return _search(tables, knobs, 0, 1)
    if _in_group():
        return _search(tables, knobs, dist.get_rank(), devices)
    return _ranks.rank_pool(devices, dev).run(
        "repro_torch.core.search_torch:_rank_search", tables, knobs)


def _rank_search(tables: SearchTables, knobs: dict) -> SearchOutcome:
    """One rank's share of a :class:`~repro_torch.ranks.RankPool`
    search (every rank of the pool runs it)."""
    return _search(tables, knobs, dist.get_rank(), dist.get_world_size())


def _search(tables: SearchTables, kn: dict, rank: int,
            world: int) -> SearchOutcome:
    """The search of validated knobs ``kn`` as rank ``rank`` of
    ``world``: every chunk of the population on one rank, or this rank's
    slice and the gather of every rank's incumbents."""
    dt = dtype_of(kn["precision"])
    dev = kn["device"]
    if world > 1 and dev.type == "cuda" and dist.get_backend() == "nccl":
        dev = torch.device("cuda", rank)      # a card of its own
    pop, steps, seed = kn["population"], kn["steps"], kn["seed"]
    init_objective = kn["init_objective"]
    best_objs = np.empty(pop)
    best_rows = np.empty((pop, tables.w, tables.gmax), dtype=np.int64)
    chains = _Chains(tables, _device_tables(tables, dt, dev), kn["objective"],
                     kn["island"], kn["migrate"], kn["backend"],
                     bits=64 if kn["precision"] == "x64" else 32)
    asg0_full = torch.as_tensor(
        _scatter_population(tables, kn["asg_row"], pop, seed), device=dev)
    run = dict(seed=seed, n_steps=steps, ex_every=kn["exchange_every"],
               t0=kn["t0"], t1=kn["t1"], eager=kn["eager"])

    tracer = get_tracer()
    with tracer.span("anneal_search", "search", population=pop,
                     steps=steps, island=kn["island"], seed=seed,
                     backend=kn["backend"], devices=kn["devices"],
                     objective=kn["objective"]) as search_sp:
        if world > 1:
            per = pop // world
            lo = rank * per
            with tracer.span("anneal.chunk", "search", chunk=0, lo=0,
                             hi=pop, includes_compile=False) as sp:
                ranks = _rank_share(chains, tables, asg0_full, lo, lo + per,
                                    run, rank, world, best_objs, best_rows)
                sp.set(**chains.stats, ranks=ranks)
        incumbent = np.inf
        for ci, lo in enumerate(range(0, pop, kn["chunk"]) if world == 1
                                else ()):
            hi = min(lo + kn["chunk"], pop)
            with tracer.span("anneal.chunk", "search", chunk=ci, lo=lo,
                             hi=hi, includes_compile=False) as sp:
                bo, br = chains.run(
                    torch.arange(lo, hi, device=dev), asg0_full[lo:hi],
                    **run)
                best_objs[lo:hi] = bo.double().cpu().numpy()
                best_rows[lo:hi] = br.cpu().numpy()
            if tracer.enabled:
                sp.set(**chains.stats)
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
        precision=kn["precision"],
        backend=kn["backend"],
        devices=kn["devices"],
        migrate=kn["migrate"],
        fanout=kn["fanout"],
    )


def _rank_share(chains, tables, asg0_full, lo, hi, run, rank, world,
                best_objs, best_rows) -> list[dict]:
    """Run this rank's chains ``[lo, hi)`` with the seam crossing ranks,
    then gather every rank's incumbents into ``best_objs``/``best_rows``
    and every rank's stats (returned, by rank).  A rank that failed
    reports its traceback in the gather, and then every rank raises
    :class:`~repro_torch.ranks.RankFailure` naming it."""
    exchanges = (run["n_steps"] // run["ex_every"]
                 if chains.migrate == "ring" else 0)
    seam = _Seam(rank, world, exchanges, tables.w * tables.gmax)
    counted = (_slowdown_kernel, _select_kernel)
    before = [m.launches for m in counted]
    error = result = None
    try:
        bo, br = chains.run(torch.arange(lo, hi, device=asg0_full.device),
                            asg0_full[lo:hi], seam=seam, **run)
        result = (bo.double().cpu().numpy(), br.cpu().numpy())
    except RankFailure:
        error = "stopped when another rank failed"
    except Exception:
        error = traceback.format_exc()
    stats = dict(getattr(chains, "stats", {}), rank=rank, error=error,
                 launches={m.__name__.rsplit(".", 1)[-1]: m.launches - b
                           for m, b in zip(counted, before)},
                 seam_ms=seam.ms)
    gathered = [None] * world
    dist.all_gather_object(gathered, (stats, result))
    failed = [s for s, _ in gathered if s["error"] is not None]
    if failed:
        raise RankFailure("anneal_search failed on rank(s) " + "; ".join(
            f"{s['rank']}: {s['error']}" for s in failed))
    per = hi - lo
    for r, (_, (bo, br)) in enumerate(gathered):
        best_objs[r * per:(r + 1) * per] = bo
        best_rows[r * per:(r + 1) * per] = br
    return [s for s, _ in gathered]


def compile_seconds(
    tables: SearchTables,
    *,
    objective: str = "latency",
    population: int = 1024,
    island: int = DEFAULT_ISLAND,
    backend: str = "auto",
    precision: str = "float32",
    devices: int | None = None,
    migrate: str = "auto",
    fanout: str = "auto",
    device=None,
) -> float:
    """Seconds to make one rank's search ready to step: the counterpart
    of the reference's AOT ``lower(...).compile()`` timer, which the port
    has no executable for.  Times a one-step run of one rank's share of
    the chains (``population / devices``) in this process: the kernels'
    libraries loaded (built if missing), the first eager evaluation that
    sizes the wave budget, the warm-up pass, the graph captures and the
    one step (no seam is exchanged).  Records the ``search.compile`` span and
    the ``search_compile_s`` gauge, as the reference does."""
    from ..obs import get_registry
    _, mig, _ = _validate_knobs(population, island, 16, 1, None, devices,
                                migrate, fanout, device)
    dev = resolve_device(device)
    ndev = devices or 1
    per = population // ndev
    dt = dtype_of(precision)
    tb = _device_tables(tables, dt, dev)
    asg0 = torch.as_tensor(_scatter_population(
        tables, default_init(tables), population, 0)[:per], device=dev)
    with get_tracer().span("search.compile", "search",
                           population=population, devices=ndev,
                           backend=backend) as sp:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        chains = _Chains(tables, tb, objective, island, mig, backend,
                         bits=64 if precision == "x64" else 32)
        chains.run(torch.arange(per, device=dev), asg0, 0, 1, 2, 1.0, 1e-3,
                   False)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        secs = time.perf_counter() - t0
        sp.set(compile_s=round(secs, 6))
    get_registry().gauge(
        "search_compile_s",
        "seconds to make one rank's search ready to step").set(secs)
    return secs

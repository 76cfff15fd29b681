"""Torch evaluator: the lockstep timeline state machine over a population.

The port's counterpart of ``repro/core/simulate_jax.py``, and the fourth
interpretation of the lowered :class:`~repro_torch.core.lowering.
ProblemSpec` IR (after the authoritative scalar simulator, the NumPy
lockstep loop and the reference's XLA loop).  One candidate's Eq. 2-8
event machine is written once over ``(N, W)`` tensors, N candidates by W
workloads, and runs on the card by default.

Torch has no vmapped ``while_loop``, so:

* **the host loops over waves.**  Each wave is one batch of tensor ops on
  every candidate; termination is tested every :data:`CHECK_EVERY` waves
  with a single ``.item()``, the only host<->device sync of the loop.
  The search's captured CUDA graphs instead run a fixed budget of waves
  untested, then test (:mod:`repro_torch.core.search_torch`).
* **finished lanes freeze.**  A vmapped ``while_loop`` applies its body to
  every lane and keeps the old state wherever the lane's own condition
  is false; here every state field, ``t`` and the guard included, is
  updated in place with ``torch.where(active, new, old)``, so a finished
  lane's finish times and guard count are exactly the reference's.  Extra
  waves past the last active lane change nothing, so any number of waves
  at or past the deepest lane's gives the same result bit for bit.
* **contention.**  Slowdowns come from the spec's lowered surfaces: the
  proportional closed form in torch, the PCCS piecewise surface through
  :mod:`repro_torch.kernels.slowdown` (the hand-written CUDA kernel on a
  CUDA tensor, its plain version on a CPU tensor).

The wave body follows the reference line for line: the rank-unrolled FIFO
claim (``torch.argmin`` returns the first minimum, the FIFO tie by
index), the idle jump with a re-claim in the same wave, the dtype-scaled
event tolerance and the per-candidate guard budget.  Errors are codes
re-raised on the host in the reference's order: ``KeyError`` for an
unmodelled accelerator, ``RuntimeError`` for deadlock, ``RuntimeError``
for guard exhaustion.

``precision="x64"`` (default) runs float64; ``"float32"`` runs single
precision (ranking-grade; event tolerances scale with the dtype).  The
scalar simulator remains authoritative: solvers re-simulate their final
incumbent through :func:`repro_torch.core.simulate.simulate`.
"""
from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch

from .accelerators import Platform
from .contention import ContentionModel
from .graph import DNNGraph
from .lowering import (ProblemSpec, TOL as _TOL, lower_assignments,
                       lower_workloads)
from .simulate import Workload
from .simulate_batch import BatchTimeline, _empty_batch
from ..kernels.slowdown import piecewise_slowdown
from ..runtime import resolve_device

#: host-side error codes surfaced by the wave loop.
_ERR_DEADLOCK = 1
_ERR_UNMODELED = 2
_ERR_GUARD = 4

#: default candidate-axis shard: each shard's wave loop stops at its own
#: deepest candidate.
DEFAULT_CHUNK = 16384
#: waves between termination tests (one device sync each).
CHECK_EVERY = 4

PRECISIONS = {"x64": torch.float64, "float32": torch.float32}


def dtype_of(precision: str) -> torch.dtype:
    try:
        return PRECISIONS[precision]
    except KeyError:
        raise ValueError(f"unknown precision {precision!r} "
                         f"(expected 'x64' or 'float32')") from None


def _tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    """A copy of array ``a`` as a tensor (the spec's arrays are frozen)."""
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def surface_params(surface, dtype: torch.dtype, device) -> dict:
    """One lowered surface's parameters as tensors of ``dtype``."""
    def t(x):
        return _tensor(np.asarray(x, float), dtype, device)

    p: dict[str, Any] = {"factor": float(surface.factor)}
    if surface.kind == "proportional":
        p["capacity"] = t(surface.capacity)
        p["sensitivity"] = t(surface.sensitivity)
    elif surface.kind == "piecewise":
        p["own_knots"] = t(surface.own_knots)
        p["ext_knots"] = t(surface.ext_knots)
        p["table"] = t(surface.table)
    else:
        raise ValueError(f"unknown surface kind {surface.kind!r}")
    return p


def surface_eval(kind: str, params: Mapping[str, Any], own, ext):
    """Torch evaluation of one lowered surface (mirrors
    ``repro_torch.core.lowering.surface_slowdown``)."""
    if kind == "proportional":
        cap = params["capacity"]
        own_ = torch.clamp_min(own, 0.0)
        ext_ = torch.clamp_min(ext, 0.0)
        total = own_ + ext_
        s = 1.0 + params["sensitivity"] * torch.clamp_max(own_ / cap, 1.0) \
            * (total / cap - 1.0)
        s = torch.where((own_ == 0.0) | (total <= cap),
                        torch.ones((), dtype=own.dtype, device=own.device), s)
    else:  # piecewise — the PCCS surface kernel
        s = piecewise_slowdown(own, ext, params["own_knots"],
                               params["ext_knots"], params["table"],
                               backend="auto")
    f = params["factor"]
    if f == 1.0:
        return s
    return 1.0 + torch.as_tensor(f, dtype=s.dtype) * (s - 1.0)


class Waves:
    """One population's event machine between waves (:func:`
    make_event_machine`'s ``run.start``).  The state tensors keep their
    storage for the machine's life: every wave updates them in place."""

    def __init__(self, state: dict, body, active_of, record: bool):
        self.state = state
        self._body, self._active_of, self._record = body, active_of, record
        #: waves run so far
        self.count = 0

    def active(self) -> torch.Tensor:
        """(N,) bool: the lanes still running."""
        return self._active_of(self.state)

    def wave(self) -> None:
        """One wave; finished lanes keep their state."""
        s = self.state
        active = self.active()
        new = self._body(s)
        N = active.shape[0]
        for k, v in new.items():
            a = active.view(N, *([1] * (v.dim() - 1)))
            torch.where(a, v, s[k], out=s[k])
        self.count += 1

    def drive(self) -> None:
        """Waves until no lane is active, tested before every
        :data:`CHECK_EVERY`-th wave, from the first."""
        while self.count % CHECK_EVERY or bool(self.active().any()):
            self.wave()

    def result(self):
        """``(finish, lat, contention, busy, err)`` with ``record``, else
        ``(finish, err)``; ``err`` flags the lanes still running."""
        s = self.state
        err = s["err"] | torch.where(s["done"].all(1), 0, _ERR_GUARD)
        if self._record:
            return (s["finish"], s["lat"], s["contention"], s["busy"], err)
        return s["finish"], err


def make_event_machine(kinds: tuple[str, ...], max_it: int,
                       record: bool = True):
    """Build the Eq. 2-8 event machine over a population of candidates.

    Returns ``run(acc, dur, dem, tau, ngroups, iters, dep, arrival,
    domshare, model_of_acc, surf_params)`` over ``(N, W, G)`` group tables
    (``acc`` int64, the rest of the evaluation dtype), ``(N, W)`` int64
    ``ngroups``/``iters``/``dep`` and dtype ``arrival`` (expanded views
    are fine), ``(A, A)`` ``domshare``, ``(A,)`` int64 ``model_of_acc`` and
    one :func:`surface_params` dict per surface.  With ``record=True``
    (the evaluator path) it returns ``(finish, lat, contention, busy,
    err)``; with ``record=False`` only ``(finish, err)``, the lean machine
    the search evaluates its mutants through.  ``run.start`` takes the
    same arguments and returns the :class:`Waves` before the first wave.
    """

    def start(acc, dur, dem, tau, ngroups, iters, dep, arrival, domshare,
              model_of_acc, surf_params) -> Waves:
        N, W, _ = acc.shape
        A = domshare.shape[0]
        dt, dev = dur.dtype, dur.device
        i64 = torch.int64
        idx = torch.arange(W, device=dev)
        arange_a = torch.arange(A, device=dev)
        inf = torch.full((), float("inf"), dtype=dt, device=dev)
        zero = torch.zeros((), dtype=dt, device=dev)
        one_ = torch.ones((), dtype=dt, device=dev)
        # event tolerance scales with the working precision (as the
        # reference: lowering.TOL in float64, 1e-5 in float32).
        tol = _TOL if dt == torch.float64 else 1e-5
        dep_row = dep.clamp(0, W - 1)
        macc_of = model_of_acc.to(dt)
        # scalar-simulator guard, per candidate.
        max_waves = 200000 + 200 * (ngroups * iters).sum(1)

        def take(table, g):
            return table.gather(2, g[..., None]).squeeze(-1)

        def claim(t, cur_oh, group, ready, it, started, done, is_run,
                  it_start):
            """One FIFO claim sweep (the reference's ``claim``): eligible
            waiting workloads in (ready, index) order take their
            accelerator if free."""
            dep_ok = (dep < 0) | done.gather(1, dep_row) \
                | (it.gather(1, dep_row) > it)
            eligible = ~done & ~is_run & dep_ok & (ready <= t[:, None] + tol)
            acc_busy = (cur_oh & is_run[:, :, None]).any(1)       # (N, A)
            left = eligible
            for _ in range(W):   # rank-r claim by argmin, unrolled
                key = torch.where(left, ready, inf)
                wr = key.argmin(1)              # first min -> FIFO tie
                sel = idx[None, :] == wr[:, None]
                my_busy = (cur_oh & acc_busy[:, None, :]).any(2)  # (N, W)
                claim_v = sel & left & ~my_busy
                is_run = is_run | claim_v
                acc_busy = acc_busy | (cur_oh & claim_v[:, :, None]).any(1)
                if record:   # iteration-start bookkeeping feeds lat only
                    fresh = claim_v & (group == 0) & ~started
                    it_start = torch.where(fresh, t[:, None], it_start)
                    started = started | fresh
                left = left & ~sel
            return is_run, started, it_start

        s = dict(
            t=torch.zeros(N, dtype=dt, device=dev),
            guard=torch.zeros(N, dtype=i64, device=dev),
            group=torch.zeros(N, W, dtype=i64, device=dev),
            cur_acc=acc[:, :, 0].clone(),
            own=dem[:, :, 0].clone(),
            remaining=dur[:, :, 0].clone(),
            ready=arrival.to(dt).expand(N, W).clone(),
            it=torch.zeros(N, W, dtype=i64, device=dev),
            done=torch.zeros(N, W, dtype=torch.bool, device=dev),
            is_run=torch.zeros(N, W, dtype=torch.bool, device=dev),
            finish=torch.zeros(N, W, dtype=dt, device=dev),
            err=torch.zeros(N, dtype=i64, device=dev),
        )
        if record:   # observability state the search ranking never reads
            s.update(
                it_start=arrival.to(dt).expand(N, W).clone(),
                started=torch.zeros(N, W, dtype=torch.bool, device=dev),
                lat=torch.full((N, W, max_it), float("nan"), dtype=dt,
                               device=dev),
                contention=torch.zeros(N, dtype=dt, device=dev),
                busy=torch.zeros(N, A, dtype=dt, device=dev),
            )

        def active_of(st):
            return ~st["done"].all(1) & (st["guard"] < max_waves)

        def body(st):
            t = st["t"]
            group, cur_acc, own = st["group"], st["cur_acc"], st["own"]
            remaining, ready = st["remaining"], st["ready"]
            it = st["it"]
            it_start, started = st.get("it_start"), st.get("started")
            done, is_run = st["done"], st["is_run"]
            err = st["err"]
            cur_oh = cur_acc[:, :, None] == arange_a               # (N,W,A)

            # 1) FIFO claims at the current time.
            is_run, started, it_start = claim(
                t, cur_oh, group, ready, it, started, done, is_run,
                it_start)
            any_run = is_run.any(1)

            # idle gap: jump to the next pending boundary and re-claim in
            # the same wave (the scalar simulator's `continue`, fused).
            pend = torch.where(~done & (ready > t[:, None] + tol), ready, inf)
            tmin = pend.min(1).values
            idle = ~any_run
            dead = idle & ~torch.isfinite(tmin)
            err = err | torch.where(dead, _ERR_DEADLOCK, 0)
            done = done | dead[:, None]     # poison-exit the lane
            t = torch.where(idle & ~dead, tmin, t)
            is_run, started, it_start = claim(
                t, cur_oh, group, ready, it, started, done, is_run,
                it_start)
            any_run = is_run.any(1)

            # 2) per-interval slowdowns from the lowered surfaces.
            cur_ohf = cur_oh.to(dt)
            own_eff = torch.where(is_run, own, zero)
            acc_dem = (cur_ohf * own_eff[:, :, None]).sum(1)        # (N, A)
            ext = (cur_ohf * (acc_dem @ domshare.T)[:, None, :]).sum(2)
            contended = is_run & (own > 0.0) & (ext > 0.0)
            macc = (cur_ohf * macc_of).sum(2).to(i64)
            slow = torch.ones_like(own)
            for mid, kind in enumerate(kinds):   # unrolled over models
                sv = surface_eval(kind, surf_params[mid], own, ext)
                slow = torch.where(contended & (macc == mid),
                                   torch.maximum(one_, sv), slow)
            unmod = (contended & (macc < 0)).any(1)
            err = err | torch.where(unmod, _ERR_UNMODELED, 0)
            done = done | unmod[:, None]

            # 3) next event horizon: earliest running completion, capped by
            # ready boundaries strictly inside the interval.
            run_rem = torch.where(is_run, remaining * slow, inf)
            horizon = t + run_rem.min(1).values
            cap = torch.where(~done & ~is_run & (ready > t[:, None] + tol)
                              & (ready < horizon[:, None] - tol), ready,
                              inf).min(1).values
            horizon = torch.minimum(horizon, cap)
            horizon = torch.where(any_run, horizon, t)
            span = horizon - t

            # 4) integrate the contention interval.
            prog = torch.where(is_run, span[:, None] / slow, zero)
            remaining = remaining - prog
            if record:
                contention = st["contention"] + torch.where(
                    is_run, span[:, None] * (1.0 - 1.0 / slow), zero).sum(1)
                busy = st["busy"] + (cur_ohf * prog[:, :, None]).sum(1)
            t = torch.where(any_run, horizon, t)

            # 5) process completions.
            fin = is_run & (remaining <= tol)
            is_run = is_run & ~fin
            tau_cur = take(tau, group)
            has_next = fin & (group + 1 < ngroups)
            last = fin & ~has_next
            if record:
                lat = torch.where(
                    last[:, :, None]
                    & (torch.arange(max_it, device=dev) == it[:, :, None]),
                    (t[:, None] - it_start)[:, :, None], st["lat"])
            it2 = it + last.to(i64)
            if record:
                started = started & ~last
            fin_wl = last & (it2 >= iters)
            done = done | fin_wl
            finish = torch.where(fin_wl, t[:, None], st["finish"])
            restart = last & ~fin_wl
            new_group = torch.where(has_next, group + 1,
                                    torch.where(restart, 0, group))
            refresh = has_next | restart
            cur_acc = torch.where(refresh, take(acc, new_group), cur_acc)
            own = torch.where(refresh, take(dem, new_group), own)
            remaining = torch.where(refresh, take(dur, new_group), remaining)
            ready = torch.where(has_next, t[:, None] + tau_cur,
                                torch.where(restart, t[:, None], ready))

            nxt = dict(t=t, guard=st["guard"] + 1, group=new_group,
                       cur_acc=cur_acc, own=own, remaining=remaining,
                       ready=ready, it=it2, done=done, is_run=is_run,
                       finish=finish, err=err)
            if record:
                nxt.update(it_start=it_start, started=started, lat=lat,
                           contention=contention, busy=busy)
            return nxt

        return Waves(s, body, active_of, record)

    def run(*args):
        waves = start(*args)
        waves.drive()
        return waves.result()

    run.start = start
    return run


def unlowerable_models(spec: ProblemSpec) -> tuple[str, ...]:
    """Type names of the spec's contention models with no array-IR surface."""
    return tuple(type(m).__name__
                 for m, s in zip(spec.models, spec.surfaces) if s is None)


def _raise_for(err: np.ndarray, spec: ProblemSpec) -> None:
    """Re-raise the wave loop's error codes as the scalar simulator's
    exceptions, in the reference's order."""
    if not err.any():
        return
    code = int(np.bitwise_or.reduce(err))
    if code & _ERR_UNMODELED:
        uncovered = [a for a, m in zip(spec.acc_names, spec.model_of_acc)
                     if m < 0]
        raise KeyError(f"no contention model covers accelerator(s) "
                       f"{uncovered!r}")
    if code & _ERR_DEADLOCK:
        raise RuntimeError("deadlock: nothing running, nothing pending")
    raise RuntimeError("torch simulator did not converge (event storm)")


def simulate_spec(spec: ProblemSpec, *, precision: str = "x64",
                  chunk: int = DEFAULT_CHUNK, device=None) -> BatchTimeline:
    """Evaluate a lowered problem spec through the torch wave loop.

    ``precision="x64"`` (default) runs float64, ``"float32"`` single
    precision.  ``chunk`` shards the candidate axis: each shard's loop
    stops at its own deepest candidate.  ``device`` defaults to ``cuda``
    (:func:`repro_torch.runtime.resolve_device`).
    """
    bad = unlowerable_models(spec)
    if bad:
        raise ValueError(
            f"evaluator 'torch' needs lowerable contention surfaces, but "
            f"{', '.join(sorted(set(bad)))} has no registered surface "
            f"lowering (repro_torch.core.lowering.register_surface_lowering)"
            f"; use evaluator='batch' or 'scalar' for this model")
    dt = dtype_of(precision)
    dev = resolve_device(device)
    n = spec.n
    max_it = int(spec.iters.max())
    run = make_event_machine(tuple(s.kind for s in spec.surfaces), max_it,
                             record=True)
    surf = tuple(surface_params(s, dt, dev) for s in spec.surfaces)
    domshare = _tensor(spec.domshare, dt, dev)
    model_of_acc = _tensor(spec.model_of_acc, torch.int64, dev)

    finish = np.zeros((n, spec.w))
    lat = np.full((n, spec.w, max_it), np.nan)
    contention = np.zeros(n)
    busy = np.zeros((n, spec.amax))
    err = np.zeros(n, dtype=np.int64)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)

        def arr(a, dtype):
            return _tensor(a[lo:hi], dtype, dev)

        i64 = torch.int64
        fin, la, con, bu, er = run(
            arr(spec.acc, i64), arr(spec.dur, dt), arr(spec.dem, dt),
            arr(spec.tau, dt), arr(spec.ngroups, i64), arr(spec.iters, i64),
            arr(spec.dep, i64), arr(spec.arrival, dt), domshare,
            model_of_acc, surf)
        finish[lo:hi] = fin.double().cpu().numpy()
        lat[lo:hi] = la.double().cpu().numpy()
        contention[lo:hi] = con.double().cpu().numpy()
        busy[lo:hi] = bu.double().cpu().numpy()
        err[lo:hi] = er.cpu().numpy()
    _raise_for(err, spec)
    return BatchTimeline(
        makespan=finish.max(axis=1),
        finish_times=finish,
        iteration_latencies=lat,
        iterations=spec.iters.copy(),
        contention_ms=contention,
        busy_ms=busy,
        acc_names=spec.acc_names,
    )


# ---------------------------------------------------------------------------
# registry-shaped wrappers (the evaluator entry points)
# ---------------------------------------------------------------------------

def simulate_batch(
    platform: Platform,
    workloads_batch: Sequence[Sequence[Workload]],
    model: ContentionModel | Mapping[str, ContentionModel],
    validate: bool = True,
    precision: str = "x64",
    device=None,
) -> BatchTimeline:
    """Lower per-candidate Workload lists and evaluate them with torch."""
    if len(workloads_batch) == 0:
        return _empty_batch(platform)
    return simulate_spec(lower_workloads(platform, workloads_batch, model,
                                         validate), precision=precision,
                         device=device)


def simulate_assignments(
    platform: Platform,
    graphs: Sequence[DNNGraph],
    assignments_batch: Sequence[Sequence[Sequence[str]]],
    model: ContentionModel | Mapping[str, ContentionModel],
    iterations: Sequence[int] | None = None,
    depends_on: Sequence[int | None] | None = None,
    validate: bool = True,
    precision: str = "x64",
    device=None,
) -> BatchTimeline:
    """Lower fixed-graph assignment vectors and evaluate them with torch."""
    if len(assignments_batch) == 0:
        return _empty_batch(platform)
    return simulate_spec(lower_assignments(
        platform, graphs, assignments_batch, model, iterations=iterations,
        depends_on=depends_on, validate=validate), precision=precision,
        device=device)

"""Optimal schedule generation with Z3 (§3.4–3.5).

Two encodings are provided:

* :func:`solve` (default) — **CEGAR loop**: Z3 searches the assignment space
  under sound *linear lower-bound* timing constraints (contention-free path
  time per DNN, Eq. 2 without C; per-accelerator load, the queueing bound
  implied by Eq. 9).  Every candidate Z3 proposes is evaluated **exactly** by
  the event-driven simulator (which integrates Eqs. 5/7/8 over contention
  intervals); the incumbent bound is tightened and the candidate blocked, so
  the UNSAT certificate at the end proves optimality of the incumbent w.r.t.
  the exact interval-based contention model.  This sidesteps the
  nonlinear-real fixed point of Eqs. 5/7 while keeping optimality.

* :func:`solve_monolithic` — the paper's Eqs. 1–11 written directly into Z3
  (start/end reals, Eq. 8 overlap cases as If-expressions, multiplication for
  Eq. 5).  Nonlinear real arithmetic: only practical for small instances;
  kept as the faithful reference encoding and cross-checked in tests.

The solver is *anytime*: ``deadline_s`` caps wall-clock; the incumbent is
always a valid schedule (initialized from the best naive baseline, §5.3), so
D-HaX-CoNN can interleave solving with execution.
"""
from __future__ import annotations

import time
from typing import Callable, Mapping, Sequence

try:
    import z3
    HAVE_Z3 = True
except ImportError:  # pragma: no cover - z3 is installed in CI
    HAVE_Z3 = False

from .accelerators import Platform
from .baselines import BASELINES
from .contention import ContentionModel
from .graph import DNNGraph
from .simulate import Workload, simulate
from .solver_bb import Solution

_EPS = 1e-6


class _Encoding:
    """Shared structural encoding: assignment ints + LB time expressions."""

    def __init__(self, platform: Platform, graphs: Sequence[DNNGraph],
                 iterations: Sequence[int], max_transitions: int | None,
                 depends_on: Sequence[int | None] | None = None):
        self.platform = platform
        self.graphs = graphs
        self.acc_names = list(platform.names)
        self.acc_idx = {a: k for k, a in enumerate(self.acc_names)}
        self.s = z3.Solver()
        self.x: list[list[z3.ArithRef]] = []
        for n, g in enumerate(graphs):
            row = []
            for i, grp in enumerate(g):
                v = z3.Int(f"x_{n}_{i}")
                allowed = [self.acc_idx[a] for a in self.acc_names
                           if a in grp.times]
                self.s.add(z3.Or([v == k for k in allowed]))
                row.append(v)
            self.x.append(row)
            # §3.1 legality: collapse illegal boundaries.
            for i in range(len(g) - 1):
                if not g[i].can_transition_after:
                    self.s.add(row[i] == row[i + 1])
            if max_transitions is not None:
                trans = z3.Sum([
                    z3.If(row[i] != row[i + 1], 1, 0)
                    for i in range(len(g) - 1)
                ])
                self.s.add(trans <= max_transitions)

        # Lower-bound completion time per DNN (Eq. 2 with C == 1).
        self.iterations = list(iterations)
        self.total_inferences = sum(iterations)
        deps = list(depends_on or [None] * len(graphs))
        path = []                     # single-iteration contention-free path
        for n, g in enumerate(graphs):
            terms = []
            for i, grp in enumerate(g):
                expr = z3.RealVal(0)
                for a in self.acc_names:
                    if a in grp.times:
                        expr = z3.If(self.x[n][i] == self.acc_idx[a],
                                     z3.RealVal(grp.time_on(a)), expr)
                terms.append(expr)
            for i in range(len(g) - 1):
                tau = z3.RealVal(0)
                for a in self.acc_names:
                    for b in self.acc_names:
                        if a == b:
                            continue
                        cost = platform.transition_cost_ms(g[i].out_bytes, a, b)
                        tau = z3.If(
                            z3.And(self.x[n][i] == self.acc_idx[a],
                                   self.x[n][i + 1] == self.acc_idx[b]),
                            z3.RealVal(cost), tau)
                terms.append(tau)
            path.append(z3.Sum(terms))
        self.T = []
        for n in range(len(graphs)):
            T = path[n] * z3.RealVal(iterations[n])
            # pipeline fill: consumer cannot start iteration 0 before the
            # producer chain finished its first iteration.
            m = deps[n]
            while m is not None:
                T = T + path[m]
                m = deps[m]
            self.T.append(T)

        # Per-accelerator load bound (queueing consequence of Eq. 9).
        self.load = []
        for a in self.acc_names:
            terms = []
            for n, g in enumerate(graphs):
                for i, grp in enumerate(g):
                    if a in grp.times:
                        terms.append(z3.If(
                            self.x[n][i] == self.acc_idx[a],
                            z3.RealVal(grp.time_on(a) * iterations[n]),
                            z3.RealVal(0)))
            self.load.append(z3.Sum(terms) if terms else z3.RealVal(0))

    def bound_constraint(self, objective: str, best: float):
        """Sound pruning constraint: LB(objective) must beat ``best``."""
        if objective == "latency":
            cs = [T < best - _EPS for T in self.T]
            cs += [ld < best - _EPS for ld in self.load]
            return z3.And(cs)
        if objective == "throughput":
            # obj = -1e3·N/makespan; makespan >= every path/load bound, so a
            # candidate can only beat ``best`` (< 0) if all bounds stay below
            # the constant 1e3·N/(-best).
            cap = 1e3 * self.total_inferences / (-best) - _EPS
            cs = [T < cap for T in self.T]
            cs += [ld < cap for ld in self.load]
            return z3.And(cs)
        if objective == "sum_inverse":
            # true obj = -Σ 1/T_n^exact >= -Σ 1/T_n^LB  (T_exact >= T_LB);
            # necessary condition to beat best: -Σ 1/T_LB < best.
            inv = [z3.RealVal(1) / T for T in self.T]
            return -z3.Sum(inv) < best - _EPS
        raise ValueError(objective)

    def extract(self, m) -> list[tuple[str, ...]]:
        out = []
        for n, g in enumerate(self.graphs):
            out.append(tuple(
                self.acc_names[m.evaluate(self.x[n][i]).as_long()]
                for i in range(len(g))))
        return out

    def block(self, asgs: list[tuple[str, ...]]):
        lits = []
        for n, asg in enumerate(asgs):
            for i, a in enumerate(asg):
                lits.append(self.x[n][i] != self.acc_idx[a])
        self.s.add(z3.Or(lits))


def _incumbent(platform, graphs, model, objective, iterations, depends_on):
    """Best baseline schedule — the CEGAR (and D-HaX-CoNN) starting point."""
    best = None
    for fn in BASELINES.values():
        try:
            wls = fn(platform, graphs, iterations=iterations,
                     depends_on=depends_on)
            res = simulate(platform, wls, model, record_timeline=False)
        except (ValueError, KeyError):
            continue
        obj = res.objective(objective)
        if best is None or obj < best.objective:
            best = Solution(wls, res, obj, objective, 0, optimal=False)
    if best is None:
        raise RuntimeError("no baseline produced a valid schedule")
    return best


def solve(
    platform: Platform,
    graphs: Sequence[DNNGraph],
    model: ContentionModel | Mapping[str, ContentionModel],
    objective: str = "latency",
    max_transitions: int | None = 3,
    iterations: Sequence[int] | None = None,
    depends_on: Sequence[int | None] | None = None,
    deadline_s: float | None = None,
    on_improve: Callable[[Solution, float], None] | None = None,
) -> Solution:
    """CEGAR-optimal contention-aware schedule (the HaX-CoNN solver)."""
    if not HAVE_Z3:
        from . import solver_bb
        return solver_bb.solve(platform, graphs, model, objective,
                               max_transitions or 3, iterations, depends_on)
    its = list(iterations or [1] * len(graphs))
    deps = list(depends_on or [None] * len(graphs))
    t0 = time.perf_counter()
    best = _incumbent(platform, graphs, model, objective, its, deps)
    # Tighten the incumbent with a cheap single-transition exhaustive pass
    # (the paper's optimal schedules use one transition per DNN; a strong
    # incumbent lets the CEGAR bound prune most of the space immediately).
    try:
        from . import solver_bb
        quick = solver_bb.solve(platform, graphs, model, objective,
                                max_transitions=1, iterations=its,
                                depends_on=deps)
        if quick.objective < best.objective - _EPS:
            best = quick
            best.optimal = False
    except ValueError:
        pass
    enc = _Encoding(platform, graphs, its, max_transitions, deps)
    evaluated = 0
    optimal = False
    while True:
        if deadline_s is not None and time.perf_counter() - t0 > deadline_s:
            break
        enc.s.push()
        enc.s.add(enc.bound_constraint(objective, best.objective))
        if deadline_s is not None:
            remain = deadline_s - (time.perf_counter() - t0)
            enc.s.set("timeout", max(1, int(remain * 1000)))
        r = enc.s.check()
        if r == z3.sat:
            m = enc.s.model()
        enc.s.pop()
        if r == z3.unsat:
            optimal = True          # no unblocked assignment can beat best
            break
        if r != z3.sat:             # timeout / unknown
            break
        asgs = enc.extract(m)
        enc.block(asgs)
        wls = [Workload(g, a, iterations=it, depends_on=dep)
               for g, a, it, dep in zip(graphs, asgs, its, deps)]
        res = simulate(platform, wls, model, record_timeline=False)
        evaluated += 1
        obj = res.objective(objective)
        if obj < best.objective - _EPS:
            best = Solution(wls, res, obj, objective, evaluated, False)
            if on_improve is not None:
                on_improve(best, time.perf_counter() - t0)
    best.evaluated = evaluated
    best.optimal = optimal
    return best


def solve_monolithic(
    platform: Platform,
    graphs: Sequence[DNNGraph],
    model: ContentionModel,
    objective: str = "latency",
    max_transitions: int | None = 2,
    timeout_s: float = 60.0,
) -> Solution:
    """The paper's Eqs. 1–11 encoded directly (nonlinear real arithmetic).

    Contention is encoded pairwise: layer i of DNN n overlapping layer j of
    DNN m (on different accelerators of a shared domain) dilates execution by
    the PCCS slowdown of the pair.  ``et = st + t * C`` with C from overlap
    fractions (Eq. 5/7); Eq. 8's case analysis is the max/min overlap form;
    Eq. 9 forbids same-accelerator overlap.  Small instances only.
    """
    if not HAVE_Z3:
        raise RuntimeError("z3 not available")
    if len(graphs) != 2:
        raise NotImplementedError("monolithic encoding: exactly 2 DNNs")
    its = [1] * len(graphs)
    enc = _Encoding(platform, graphs, its, max_transitions)
    s = enc.s
    acc_names = enc.acc_names

    st, et, dur = [], [], []
    for n, g in enumerate(graphs):
        st.append([z3.Real(f"st_{n}_{i}") for i in range(len(g))])
        et.append([z3.Real(f"et_{n}_{i}") for i in range(len(g))])
        dur.append([z3.Real(f"d_{n}_{i}") for i in range(len(g))])

    def t_expr(n, i):
        g = graphs[n]
        expr = z3.RealVal(0)
        for a in acc_names:
            if a in g[i].times:
                expr = z3.If(enc.x[n][i] == enc.acc_idx[a],
                             z3.RealVal(g[i].time_on(a)), expr)
        return expr

    def demand_expr(n, i):
        g = graphs[n]
        expr = z3.RealVal(0)
        for a in acc_names:
            if a in g[i].times:
                expr = z3.If(enc.x[n][i] == enc.acc_idx[a],
                             z3.RealVal(g[i].demand_on(a)), expr)
        return expr

    # chain constraints + transition costs (Eqs. 2-4).
    for n, g in enumerate(graphs):
        s.add(st[n][0] >= 0)
        for i in range(len(g)):
            s.add(dur[n][i] >= t_expr(n, i))
            s.add(et[n][i] == st[n][i] + dur[n][i])
            if i + 1 < len(g):
                tau = z3.RealVal(0)
                for a in acc_names:
                    for b in acc_names:
                        if a == b:
                            continue
                        c = platform.transition_cost_ms(g[i].out_bytes, a, b)
                        tau = z3.If(z3.And(enc.x[n][i] == enc.acc_idx[a],
                                           enc.x[n][i + 1] == enc.acc_idx[b]),
                                    z3.RealVal(c), tau)
                s.add(st[n][i + 1] == et[n][i] + tau)

    # Eq. 7/8: duration dilation from pairwise overlap, linearized per pair
    # with the slowdown sampled at the pair's demands (PCCS is evaluated
    # outside the solver — its inputs are assignment-dependent constants).
    eps = platform.epsilon_ms
    for i in range(len(graphs[0])):
        for j in range(len(graphs[1])):
            ov = z3.Real(f"ov_{i}_{j}")
            lo = z3.If(st[0][i] >= st[1][j], st[0][i], st[1][j])
            hi = z3.If(et[0][i] <= et[1][j], et[0][i], et[1][j])
            s.add(ov == z3.If(hi - lo > 0, hi - lo, z3.RealVal(0)))
            # Eq. 9: same accelerator -> no overlap beyond epsilon.
            s.add(z3.Implies(enc.x[0][i] == enc.x[1][j], ov <= eps))

    for n in range(2):
        m = 1 - n
        for i in range(len(graphs[n])):
            extra = []
            for j in range(len(graphs[m])):
                a_pairs = z3.RealVal(0)
                for a in acc_names:
                    for b in acc_names:
                        if a == b:
                            continue
                        dom = platform.shared_domain_of(a, b)
                        if dom is None:
                            continue
                        own = graphs[n][i].demand_on(a) \
                            if a in graphs[n][i].times else 0.0
                        ext = graphs[m][j].demand_on(b) \
                            if b in graphs[m][j].times else 0.0
                        sd = model.slowdown(own, ext)
                        a_pairs = z3.If(
                            z3.And(enc.x[n][i] == enc.acc_idx[a],
                                   enc.x[m][j] == enc.acc_idx[b]),
                            z3.RealVal(sd - 1.0), a_pairs)
                ovname = f"ov_{i}_{j}" if n == 0 else f"ov_{j}_{i}"
                extra.append(z3.Real(ovname) * a_pairs)
            # dur = t + Σ overlap·(s-1): wall-time extension of Eq. 5.
            s.add(dur[n][i] == t_expr(n, i) + z3.Sum(extra))

    obj = z3.Real("obj")
    if objective == "latency":
        s.add(obj >= et[0][-1], obj >= et[1][-1])
        s.add(z3.Or(obj == et[0][-1], obj == et[1][-1]))
    else:
        s.add(obj == -(z3.RealVal(1) / et[0][-1] + z3.RealVal(1) / et[1][-1]))

    opt_best = None
    s.set("timeout", int(timeout_s * 1000))
    # branch&bound on obj via successive tightening
    while s.check() == z3.sat:
        m_ = s.model()
        val = m_.evaluate(obj)
        num = float(val.numerator_as_long()) / float(val.denominator_as_long())
        asgs = enc.extract(m_)
        opt_best = (num, asgs)
        s.add(obj < z3.RealVal(num) - _EPS)
    if opt_best is None:
        raise RuntimeError("monolithic encoding UNSAT — no valid schedule")
    num, asgs = opt_best
    wls = [Workload(g, a) for g, a in zip(graphs, asgs)]
    # N.B. objective value re-reported from the exact simulator for
    # comparability with the CEGAR path.
    from .contention import ContentionModel as _CM  # noqa: F401
    res = simulate(platform, wls, model, record_timeline=False)
    return Solution(wls, res, res.objective(objective), objective, 0, True)

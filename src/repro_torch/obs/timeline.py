"""Plan/simulation timelines as per-accelerator Gantt charts.

Converts the scalar simulator's recorded :class:`~repro_torch.core.simulate.
SimResult` timeline (one :class:`Interval` per constant-slowdown span
of a layer group) into:

* **Chrome-trace/Perfetto JSON** — one track per accelerator, complete
  events per executed interval, contention intervals (slowdown > 1)
  flagged in a dedicated category, and inter-accelerator transitions
  rendered as spans bridging the source and destination groups — the
  paper's Fig. 5 schedule diagram, loadable at ``ui.perfetto.dev``.

* **ASCII** — a terminal Gantt (one row per accelerator, ``#`` busy,
  ``▒`` contended, ``·`` idle) for quick CLI inspection without a
  browser.

Pure functions over frozen dataclasses; no tracer required (the
timeline is derived from a recorded artifact, not observed live).
"""
from __future__ import annotations

import json
import pathlib
from typing import Any, Sequence

__all__ = [
    "ascii_gantt",
    "plan_ascii",
    "plan_chrome",
    "timeline_events",
    "timeline_chrome",
    "write_chrome",
]

_PID = 1


def _names(result, workload_names: Sequence[str] | None) -> list[str]:
    n = 1 + max((iv.workload for iv in result.timeline), default=0)
    if workload_names is None:
        return [f"wl{i}" for i in range(n)]
    return [str(x) for x in workload_names]


def timeline_events(result, workload_names: Sequence[str] | None = None,
                    ) -> list[dict[str, Any]]:
    """Chrome trace events for a recorded simulation timeline.

    Tracks (tids) are the platform accelerators in first-execution
    order.  Every interval becomes a complete event; contended
    intervals (slowdown > 1) carry ``cat="contention"`` so Perfetto
    can color/filter them.  A transition — consecutive groups of the
    same workload iteration on *different* accelerators with a time
    gap — becomes a bridging span on the destination track.
    """
    names = _names(result, workload_names)
    tids: dict[str, int] = {}

    def tid(acc: str) -> int:
        t = tids.get(acc)
        if t is None:
            t = tids[acc] = len(tids) + 1
        return t

    events: list[dict[str, Any]] = []
    # last executed interval per (workload, iteration) to detect
    # transitions; timeline is start-ordered by construction.
    last: dict[tuple[int, int], Any] = {}
    for iv in result.timeline:
        contended = iv.slowdown > 1.0 + 1e-12
        key = (iv.workload, iv.iteration)
        prev = last.get(key)
        if (prev is not None and prev.group != iv.group
                and prev.acc != iv.acc and iv.start > prev.end + 1e-12):
            events.append({
                "ph": "X", "name": f"{names[iv.workload]} transition "
                                   f"{prev.acc}->{iv.acc}",
                "cat": "transition",
                "ts": round(prev.end * 1e3, 3),
                "dur": round((iv.start - prev.end) * 1e3, 3),
                "pid": _PID, "tid": tid(iv.acc),
                "args": {"workload": names[iv.workload],
                         "from": prev.acc, "to": iv.acc,
                         "group": iv.group},
            })
        last[key] = iv
        events.append({
            "ph": "X",
            "name": f"{names[iv.workload]}[g{iv.group}] it{iv.iteration}",
            "cat": "contention" if contended else "compute",
            "ts": round(iv.start * 1e3, 3),
            "dur": round((iv.end - iv.start) * 1e3, 3),
            "pid": _PID, "tid": tid(iv.acc),
            "args": {"workload": names[iv.workload], "group": iv.group,
                     "iteration": iv.iteration,
                     "slowdown": round(iv.slowdown, 6)},
        })
    meta = [{"ph": "M", "name": "thread_name", "pid": _PID, "tid": t,
             "args": {"name": acc}} for acc, t in tids.items()]
    return meta + events


def timeline_chrome(result, workload_names: Sequence[str] | None = None,
                    ) -> dict[str, Any]:
    """Full Chrome trace-event object for one simulation result."""
    return {
        "traceEvents": timeline_events(result, workload_names),
        "displayTimeUnit": "ms",
        "otherData": {
            "producer": "repro_torch.obs.timeline",
            "clock": "schedule_ms",
            "makespan_ms": round(result.makespan, 6),
            "contention_ms": round(result.contention_ms, 6),
        },
    }


def _plan_result(plan):
    """The plan's simulation result with a recorded timeline.

    Solvers evaluate candidates with ``record_timeline=False`` (interval
    recording would dominate the search), so a :class:`Plan`'s stored
    result usually has an empty timeline — re-run the authoritative
    simulator over the winning assignment when that is the case.
    """
    res = plan.result
    if res.timeline:
        return res
    from ..core.simulate import simulate
    return simulate(plan.request.platform, plan.solution.workloads,
                    plan.request.model, record_timeline=True)


def plan_chrome(plan) -> dict[str, Any]:
    """Gantt trace for a solved :class:`~repro_torch.core.plan.Plan`."""
    names = [wl.graph.name for wl in plan.solution.workloads]
    doc = timeline_chrome(_plan_result(plan), names)
    doc["otherData"].update(
        request_hash=plan.request_hash, solver=plan.solver,
        objective=round(plan.objective, 6))
    return doc


def write_chrome(doc: dict[str, Any], path) -> pathlib.Path:
    """Deterministic Perfetto-JSON write (sorted keys, fixed separators)."""
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(doc, sort_keys=True, separators=(",", ":"))
                 + "\n")
    return p


def ascii_gantt(result, workload_names: Sequence[str] | None = None,
                width: int = 72) -> str:
    """Terminal Gantt: one row per accelerator over the makespan.

    ``#`` uncontended execution, ``▒`` contended (slowdown > 1),
    ``·`` idle.  A final legend row maps cells back to workloads where
    a single workload owns the whole cell.
    """
    names = _names(result, workload_names)
    span = max(result.makespan, 1e-9)
    accs: list[str] = []
    for iv in result.timeline:
        if iv.acc not in accs:
            accs.append(iv.acc)
    rows = {acc: ["·"] * width for acc in accs}
    for iv in result.timeline:
        lo = int(iv.start / span * width)
        hi = max(lo + 1, int(round(iv.end / span * width)))
        ch = "▒" if iv.slowdown > 1.0 + 1e-12 else "#"
        for c in range(lo, min(hi, width)):
            rows[iv.acc][c] = ch
    label_w = max((len(a) for a in accs), default=0)
    lines = [f"gantt 0..{result.makespan:.2f} ms   "
             f"(# compute  ▒ contended  · idle)"]
    for acc in accs:
        lines.append(f"{acc:>{label_w}} |{''.join(rows[acc])}|")
    lines.append(f"{'':>{label_w}}  workloads: "
                 + ", ".join(f"{i}={n}" for i, n in enumerate(names)))
    return "\n".join(lines)


def plan_ascii(plan, width: int = 72) -> str:
    names = [wl.graph.name for wl in plan.solution.workloads]
    return ascii_gantt(_plan_result(plan), names, width)

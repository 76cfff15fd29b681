"""Reads a ``torch.profiler`` trace of a slice of the window.

The trace is the profiler's own Chrome-format export (``traceEvents``;
times in microseconds on one clock for host and device).  Device
operations are the events of the categories in :data:`DEVICE_CATS`; host
spans are the benchmark's ``record_function`` ranges (``pb.*``).

* :func:`by_name` is ``chip_smoke.py``'s ``device_ms_by_kernel`` (device
  time summed by kernel name), copied here and read from the trace's
  events rather than from ``key_averages``.
* The busy time is the *union* of the device operations' intervals, not
  their sum: ``chip_smoke.py``'s busy share summed kernel times, which
  counts twice whatever two streams run at once.
"""
from __future__ import annotations

import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CAT = "user_annotation"


def load(path) -> list[dict]:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def device_ops(events: list[dict]) -> list[tuple[float, float, str]]:
    """(start_us, end_us, name) of every device operation, by start."""
    out = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
           for e in events
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    return sorted(out)


def host_spans(events: list[dict], prefix: str = "pb.") -> list[tuple]:
    """(start_us, end_us, name) of the benchmark's host ranges."""
    return sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                   e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") == HOST_CAT
                  and e.get("name", "").startswith(prefix))


def merged(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The union of ``intervals`` clipped to ``[lo, hi]``, as disjoint
    sorted intervals."""
    out: list[list[float]] = []
    for a, b, *_ in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_us(intervals, lo: float, hi: float) -> float:
    return sum(b - a for a, b in merged(intervals, lo, hi))


def idle_gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of ``[lo, hi]`` in which no device operation ran."""
    gaps, t = [], lo
    for a, b in merged(intervals, lo, hi):
        if a > t:
            gaps.append((t, a))
        t = b
    if hi > t:
        gaps.append((t, hi))
    return gaps


def by_name(ops) -> dict[str, float]:
    """Device seconds summed by operation name."""
    out: dict[str, float] = {}
    for a, b, name in ops:
        out[name] = out.get(name, 0.0) + (b - a) / 1e6
    return out


#: what the host was doing, by the innermost benchmark span at a moment
LABELS = (("pb.prefill", "admission: a prefill being enqueued"),
          ("pb.replay", "decode graph replay being enqueued"),
          ("pb.step.", "in an engine step outside prefill and replay "
                       "(sampling, .cpu() of the tokens, bookkeeping)"),
          ("pb.gateway", "gateway, between two tenants' steps"),
          ("pb.generator", "the traffic generator submitting requests"),
          ("pb.wait", "no work: waiting for the next arrival"))


def label_at(spans, t: float) -> str:
    """What the host spans say the host was doing at ``t`` (the
    innermost span holding it; spans are (start, end, name))."""
    inner = None
    for a, b, name in spans:
        if a <= t <= b and (inner is None or b - a < inner[1] - inner[0]):
            inner = (a, b, name)
    if inner is None:
        return "harness, between steps"
    name = inner[2]
    for prefix, text in LABELS:
        if name.startswith(prefix):
            return (f"{text} [{name[len('pb.step.'):]}]"
                    if prefix == "pb.step." else text)
    return name

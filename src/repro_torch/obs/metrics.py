"""Counters/gauges/histograms registry with JSON + Prometheus export.

One registry replaces the repo's three hand-rolled ``metrics()`` dict
shapes (serving engine, multiplexing gateway, fleet gateway/admission
controller).  Two layers:

* **Series classes** — :class:`Counter`, :class:`Gauge`,
  :class:`Histogram`, each supporting labeled child series
  (``counter.labels(tenant="chat-3").inc()``), a JSON-able
  :meth:`snapshot`, and Prometheus text exposition.

* **Schemas** — the canonical per-provider metric shapes.  The
  serving stack's ``METRIC_KEYS`` is *derived* from
  :data:`TENANT_SCHEMA` here, so the engine, the multi-tenant
  gateway, the fleet report and the admission controller all conform
  to one schema by construction; the old flat dicts remain as thin
  views built by :func:`conform`.

No third-party dependencies; everything is plain dict/list under a
lock, cheap enough to live in serving paths.
"""
from __future__ import annotations

import json
import math
import threading
from typing import Any, Iterable, Mapping

__all__ = [
    "ADMISSION_SCHEMA",
    "Counter",
    "GATEWAY_SCHEMA",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "TENANT_SCHEMA",
    "conform",
    "get_registry",
    "set_registry",
]

# ---------------------------------------------------------------------------
# Canonical metric schemas.
#
# ``TENANT_SCHEMA`` is the single source of truth for the per-tenant
# serving shape: ``serve.engine.METRIC_KEYS`` is ``tuple(TENANT_SCHEMA)``
# and every provider (ServingEngine.metrics, FleetReport.tenant_metrics,
# MultiTenantGateway per-tenant rows) emits through ``conform`` so key
# order and completeness hold by construction.  Values document the
# metric kind + meaning for docs/observability.md.
# ---------------------------------------------------------------------------

TENANT_SCHEMA: dict[str, tuple[str, str]] = {
    "steps": ("counter", "decode steps executed for this tenant"),
    "active": ("gauge", "requests currently decoding"),
    "queue_depth": ("gauge", "requests admitted but not yet started"),
    "admitted": ("counter", "requests admitted past the KV budget"),
    "completed": ("counter", "requests fully decoded"),
    "deferred": ("counter", "admission deferrals (KV budget pressure)"),
    "tokens_out": ("counter", "decode tokens emitted"),
    "last_step_ms": ("gauge", "latency of the most recent decode step"),
    "mean_step_ms": ("gauge", "mean decode-step latency"),
}

GATEWAY_SCHEMA: dict[str, tuple[str, str]] = {
    "steps": ("counter", "gateway scheduling steps executed"),
    "kv_bytes_in_use": ("gauge", "KV-cache bytes currently allocated"),
    "deferred_admissions": ("counter", "admissions deferred at the gate"),
    "reschedules": ("counter", "§4.4 slowdown-triggered re-schedules"),
}

ADMISSION_SCHEMA: dict[str, tuple[str, str]] = {
    "kv_bytes_in_use": ("gauge", "KV bytes held by admitted requests"),
    "budget_bytes": ("gauge", "admission KV budget"),
    "shed": ("counter", "requests shed (rejected) at admission"),
    "deferred": ("counter", "requests deferred (queued) at admission"),
    "throttled": ("counter", "arrivals refused by the duty gate"),
    "duty": ("gauge", "per-tenant duty-cycle fractions in (0, 1]"),
}


def conform(schema: Mapping[str, tuple[str, str]],
            values: Mapping[str, Any], **extra: Any) -> dict[str, Any]:
    """Build a dict in exact schema order from ``values``.

    Missing keys raise ``KeyError`` — a provider that stops emitting a
    canonical metric fails loudly instead of drifting.  ``extra``
    appends provider-specific keys after the canonical block (the
    fleet gateway's ``tenants`` sub-dict, for example).
    """
    out = {k: values[k] for k in schema}
    out.update(extra)
    return out


# ---------------------------------------------------------------------------
# Series
# ---------------------------------------------------------------------------


def _label_key(labels: Mapping[str, str]) -> tuple[tuple[str, str], ...]:
    return tuple(sorted(labels.items()))


def _fmt_labels(labels: Iterable[tuple[str, str]]) -> str:
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}" if inner else ""


def _fmt_value(v: float) -> str:
    if v != v:  # NaN
        return "NaN"
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


class _Series:
    """Shared machinery: name/help, labeled children, thread safety."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "") -> None:
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._children: dict[tuple[tuple[str, str], ...], Any] = {}

    def labels(self, **labels: str):
        key = _label_key(labels)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._new_child()
            return child

    def _iter_children(self):
        with self._lock:
            return list(self._children.items())


class Counter(_Series):
    """Monotonic counter, optionally labeled."""

    kind = "counter"

    def __init__(self, name: str, help: str = "") -> None:
        super().__init__(name, help)
        self._value = 0.0

    class _Child:
        __slots__ = ("value",)

        def __init__(self) -> None:
            self.value = 0.0

        def inc(self, amount: float = 1.0) -> None:
            self.value += amount

    def _new_child(self) -> "_Child":
        return Counter._Child()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> dict[str, Any]:
        out: dict[str, Any] = {"kind": self.kind, "value": self._value}
        series = {_fmt_labels(k): c.value for k, c in self._iter_children()}
        if series:
            out["series"] = series
        return out

    def expose(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} counter"]
        children = self._iter_children()
        if not children:
            lines.append(f"{self.name} {_fmt_value(self._value)}")
        for key, child in children:
            lines.append(f"{self.name}{_fmt_labels(key)} "
                         f"{_fmt_value(child.value)}")
        return lines


class Gauge(_Series):
    """Point-in-time value, optionally labeled."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "") -> None:
        super().__init__(name, help)
        self._value = 0.0

    class _Child:
        __slots__ = ("value",)

        def __init__(self) -> None:
            self.value = 0.0

        def set(self, value: float) -> None:
            self.value = float(value)

        def inc(self, amount: float = 1.0) -> None:
            self.value += amount

        def dec(self, amount: float = 1.0) -> None:
            self.value -= amount

    def _new_child(self) -> "_Child":
        return Gauge._Child()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> dict[str, Any]:
        out: dict[str, Any] = {"kind": self.kind, "value": self._value}
        series = {_fmt_labels(k): c.value for k, c in self._iter_children()}
        if series:
            out["series"] = series
        return out

    def expose(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} gauge"]
        children = self._iter_children()
        if not children:
            lines.append(f"{self.name} {_fmt_value(self._value)}")
        for key, child in children:
            lines.append(f"{self.name}{_fmt_labels(key)} "
                         f"{_fmt_value(child.value)}")
        return lines


#: default histogram buckets (milliseconds-flavored; serving latencies).
DEFAULT_BUCKETS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                   500.0, 1000.0, 2500.0, 5000.0)


class Histogram(_Series):
    """Cumulative-bucket histogram (Prometheus semantics)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Iterable[float] = DEFAULT_BUCKETS) -> None:
        super().__init__(name, help)
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)  # +Inf tail
        self._sum = 0.0
        self._n = 0

    def _new_child(self) -> "Histogram":
        return Histogram(self.name, self.help, self.buckets)

    def observe(self, value: float) -> None:
        with self._lock:
            self._sum += value
            self._n += 1
            for i, edge in enumerate(self.buckets):
                if value <= edge:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    @property
    def count(self) -> int:
        return self._n

    @property
    def sum(self) -> float:
        return self._sum

    def quantile(self, q: float) -> float:
        """Approximate quantile from the cumulative buckets."""
        with self._lock:
            if self._n == 0:
                return 0.0
            target = q * self._n
            seen = 0
            for i, edge in enumerate(self.buckets):
                seen += self._counts[i]
                if seen >= target:
                    return edge
            return self.buckets[-1] if self.buckets else 0.0

    def snapshot(self) -> dict[str, Any]:
        cum, total = [], 0
        for c in self._counts[:-1]:
            total += c
            cum.append(total)
        out: dict[str, Any] = {
            "kind": self.kind, "count": self._n, "sum": self._sum,
            "buckets": {_fmt_value(e): cum[i]
                        for i, e in enumerate(self.buckets)},
        }
        series = {_fmt_labels(k): c.snapshot()
                  for k, c in self._iter_children()}
        if series:
            out["series"] = series
        return out

    def _expose_one(self, labels: tuple[tuple[str, str], ...]) -> list[str]:
        lines = []
        total = 0
        for i, edge in enumerate(self.buckets):
            total += self._counts[i]
            le = labels + (("le", _fmt_value(edge)),)
            lines.append(f"{self.name}_bucket{_fmt_labels(le)} {total}")
        le = labels + (("le", "+Inf"),)
        lines.append(f"{self.name}_bucket{_fmt_labels(le)} {self._n}")
        lines.append(f"{self.name}_sum{_fmt_labels(labels)} "
                     f"{_fmt_value(self._sum)}")
        lines.append(f"{self.name}_count{_fmt_labels(labels)} {self._n}")
        return lines

    def expose(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} histogram"]
        children = self._iter_children()
        if not children:
            lines.extend(self._expose_one(()))
        for key, child in children:
            lines.extend(child._expose_one(key))
        return lines


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


class MetricsRegistry:
    """Named-series registry; idempotent creation, JSON + Prometheus out."""

    def __init__(self, namespace: str = "repro") -> None:
        self.namespace = namespace
        self._lock = threading.Lock()
        self._series: dict[str, _Series] = {}

    def _get(self, cls, name: str, help: str, **kwargs):
        full = f"{self.namespace}_{name}" if self.namespace else name
        with self._lock:
            s = self._series.get(full)
            if s is None:
                s = self._series[full] = cls(full, help, **kwargs)
            elif not isinstance(s, cls):
                raise TypeError(
                    f"metric {full!r} already registered as {s.kind}")
            return s

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def snapshot(self) -> dict[str, Any]:
        """JSON-able snapshot of every registered series."""
        with self._lock:
            series = dict(self._series)
        return {name: s.snapshot() for name, s in sorted(series.items())}

    def to_json(self, *, indent: int | None = None) -> str:
        seps = (",", ": ") if indent is not None else (",", ":")
        return json.dumps(self.snapshot(), sort_keys=True, indent=indent,
                          separators=seps)

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (one series per family)."""
        with self._lock:
            series = dict(self._series)
        lines: list[str] = []
        for _, s in sorted(series.items()):
            lines.extend(s.expose())
        return "\n".join(lines) + "\n"

    def write(self, path) -> None:
        import pathlib

        p = pathlib.Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(self.to_json(indent=2) + "\n")

    def clear(self) -> None:
        with self._lock:
            self._series.clear()


_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry."""
    return _registry


def set_registry(registry: MetricsRegistry | None) -> MetricsRegistry:
    """Install a registry globally (``None`` → fresh default); returns prev."""
    global _registry
    prev = _registry
    _registry = MetricsRegistry() if registry is None else registry
    return prev
